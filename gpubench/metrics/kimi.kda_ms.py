"""Device ms a train step of the KDA kernels (``kda_`` in their names:
the pair blocks and the state pass of Kimi-Linear's chunked gated delta
rule, forward, recompute and backward), summed over the traced window's
steps."""

PATTERN = r"kda_"


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps"):
        return None
    seconds = ctx.trace.seconds(PATTERN)
    if not seconds:
        return None
    return seconds / ctx.counts["steps"] * 1e3
