"""Device ms a train step of the attention kernels, forward and backward
(the recompute's forward included), summed: the fused causal attention of
every MLA layer.  The kernel names are frozen as the trace of the
``deepseek-v2-lite`` step on an H100 showed them (torch 2.11, cuDNN's
SDPA): ``cudnn_generated_fort_native_sdpa_sm90_flash_fprop``/``_bprop``
and cuDNN's two helpers of the backward (``compute_dot_do_o``,
``convert_dq_to_16bits``); PyTorch's memory-efficient kernels
(``fmha_cutlassF``/``B``), its fallback, match too."""

PATTERN = (r"cudnn_generated_fort_native_sdpa|cudnn::fusion::compute_dot_do_o"
           r"|cudnn::fusion::convert_dq_to_16bits|fmha_cutlass")


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps"):
        return None
    seconds = ctx.trace.seconds(PATTERN)
    if not seconds:
        return None
    return seconds / ctx.counts["steps"] * 1e3
