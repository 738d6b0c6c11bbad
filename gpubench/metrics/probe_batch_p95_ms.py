"""The 95th percentile of every batch's wall time in the window, ms, its
fetch and encode included."""

from gpubench.stats import percentile


def read(ctx):
    return percentile([(t1 - t0) * 1e3 for t0, t1, _, _ in ctx.window.items], 95)
