"""The forward KDA kernels' share of their roofline, %: the KDA forward
calls of the traced window (a forward and a recompute a KDA layer a step)
times the least time of one (``flops_kimi_linear.kda_call_bound_s``: its
bf16 inputs and outputs each moved once, or its state products at the bf16
peak, whichever is longer; frozen, whatever implements it), over the
device time of the kernels named ``kda_..._fwd``."""

PATTERN = r"kda_\w*fwd"


def read(ctx):
    calls = ctx.counts.get("kda_forward_calls")
    if ctx.trace is None or not calls:
        return None
    seconds = ctx.trace.seconds(PATTERN)
    if not seconds:
        return None
    return 100.0 * calls * ctx.counts["kda_forward_bound_s"] / seconds
