"""The probe's bf16 GEMMs' share of their roofline, %: 2·n³ operations a
product over the datasheet's 989 TFLOP/s, over the device time of a
product: every launch of cuBLAS's GEMM kernels in the trace, summed, over
the products the window's chains ran.  Read only where the trace holds one
launch a product, no more and no fewer."""

from gpubench import peaks

KERNELS = r"(?i)gemm|nvjet|xmma|cutlass"


def read(ctx):
    if ctx.trace is None:
        return None
    gemms = ctx.counts.get("gemms", 0)
    if not gemms or ctx.trace.count(KERNELS) != gemms:
        return None
    return 100.0 * ctx.counts["gemm_flops"] / (peaks.BF16_TFLOPS * 1e12) / (ctx.trace.seconds(KERNELS) / gemms)
