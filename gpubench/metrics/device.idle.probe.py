"""The share of the traced window in which no kernel, copy or set ran on
the GPU, %, in the probe cells (mean over the GPUs used)."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_percent(ctx.devices)
