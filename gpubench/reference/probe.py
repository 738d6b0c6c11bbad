"""Plain references of the probe batch's two layers: the read kernel's
column sums and the bf16 matmul chain."""

from __future__ import annotations

import torch

from gpubench.reference.precision import QUANT, f32_matmul


def read_columns(x: torch.Tensor, passes: int, precision: str = "f32",
                 block_rows: int = 128) -> torch.Tensor:
    """Each column of ``passes`` chained read passes over ``x`` (``acc =
    prev + Σ_rows x``, from zeros), in float64 for ``"f32"``; for ``"bf16"``
    (the control) ``x``, each block's partial and each fold rounded to
    bf16."""
    if precision == "f32":
        return x.double().sum(0) * passes
    if precision != "bf16":
        raise ValueError(f"no read reference in {precision}")
    rows, cols = x.shape
    acc = torch.zeros(cols, dtype=torch.bfloat16, device=x.device)
    for _ in range(passes):
        s = acc
        for r in range(0, rows, block_rows):
            part = x[r:r + block_rows].to(torch.bfloat16).float().sum(0).to(torch.bfloat16)
            s = (s.float() + part.float()).to(torch.bfloat16)
        acc = s
    return acc.double()


def chain(x: torch.Tensor, w: torch.Tensor, iters: int, precision: str = "bf16") -> tuple:
    """``iters`` chained products ``acc @ w`` from ``x``, each of f32 sums
    over the operands as ``precision`` rounds them, rounded to bf16; returns
    (the sum of the result's elements, their root sum of squares), float64."""
    quant = QUANT[precision]
    acc = x
    with f32_matmul(), torch.no_grad():
        wq = quant(w)
        for _ in range(iters):
            acc = torch.matmul(quant(acc), wq).to(torch.bfloat16)
    a = acc.double()
    return a.sum().item(), a.square().sum().sqrt().item()
