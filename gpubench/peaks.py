"""The yardstick's fixed numbers: datasheet peaks of one H100 SXM5, and the
operations and bytes of the work the cells drive, counted from shapes.

Frozen here, beside the benchmark, so that a change to the program cannot
move a denominator: the program keeps its own copies
(``tpudash_torch/registry.py``, ``models/workload.py::flops_per_step``).
"""

from __future__ import annotations

#: NVIDIA H100 SXM5 data sheet, dense rates without sparsity
BF16_TFLOPS = 989.0
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S_EACH_WAY = 450e9


def read_pass_bytes(rows: int, cols: int) -> int:
    """Bytes one pass of the read kernel (``out = prev + Σ_rows x``) must
    move: each f32 input byte once (``x`` and ``prev``) and the output once.
    268,500,992 at the probe's 8192 × 8192."""
    return 4 * (rows * cols + 2 * cols)


def gemm_flops(m: int, k: int, n: int) -> float:
    """Operations of one (m × k) @ (k × n) product."""
    return 2.0 * m * k * n


def train_flops_per_step(vocab: int, d_model: int, n_layers: int, d_ff: int, seq: int,
                         batch: int, **_) -> float:
    """Model FLOPs of one train step of the demo transformer: 3 × the
    forward's products (forward and backward), the forward that the
    per-layer recompute repeats not counted.  5.4632 TFLOP at the workload
    source's defaults."""
    T, d, f, L, B = seq, d_model, d_ff, n_layers, batch
    attn = 2 * T * d * 3 * d + 2 * T * T * d * 2 + 2 * T * d * d
    mlp = 2 * T * d * f * 2
    return 3.0 * B * (L * (attn + mlp) + 2 * T * d * vocab)
