"""The read kernel's share of its roofline, %: the bytes a pass must move
(``peaks.read_pass_bytes``) over the datasheet's 3.35 TB/s, over the device
time of a pass: every launch of its two kernels (``column_partials``,
``finish_columns``) in the trace's raw kernel events, summed by name, over
the passes the window issued.  Read only where the trace holds one launch of
each a pass, no more and no fewer: a trace that lost launches reads
nothing, not a pass made short."""

from gpubench import peaks

KERNELS = ("column_partials", "finish_columns")


def read(ctx):
    if ctx.trace is None:
        return None
    passes = ctx.counts.get("read_passes", 0)
    if not passes or any(ctx.trace.count(k) != passes for k in KERNELS):
        return None
    pass_s = sum(ctx.trace.seconds(k) for k in KERNELS) / passes
    return 100.0 * ctx.counts["read_pass_bytes"] / peaks.HBM_BYTES_PER_S / pass_s
