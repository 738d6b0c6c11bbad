"""Model FLOPs utilisation of the train step, %: the model's FLOPs a step
(``peaks.train_flops_per_step``, recompute not counted) times the steps the
traced window completed, over the window and the GPUs' datasheet bf16
peak.  It is ``train_tokens_per_s`` of the traced window times a constant,
not a measurement of its own: the step's share of the peak that bounds every
kernel's roofline, read where the profiler slows the step by a few %."""

from gpubench import peaks


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps"):
        return None
    flops = ctx.counts["flops_per_step"] * ctx.counts["steps"]
    return 100.0 * flops / ctx.window.seconds / (peaks.BF16_TFLOPS * 1e12 * ctx.counts["gpus"])
