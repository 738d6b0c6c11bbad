"""The backward KDA kernels' share of their roofline, %: the KDA backward
calls of the traced window (one a KDA layer a step) times the least time of
one (``flops_kimi_linear.kda_call_bound_s``: the inputs and o's gradient
read and the inputs' gradients written once in bf16, or twice the forward's
state products at the bf16 peak, whichever is longer; frozen), over the
device time of the kernels named ``kda_..._bwd``."""

PATTERN = r"kda_\w*bwd"


def read(ctx):
    calls = ctx.counts.get("kda_backward_calls")
    if ctx.trace is None or not calls:
        return None
    seconds = ctx.trace.seconds(PATTERN)
    if not seconds:
        return None
    return 100.0 * calls * ctx.counts["kda_backward_bound_s"] / seconds
