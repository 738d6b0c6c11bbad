"""Operand rounding of the references' products: the precision a
configuration states, and the next one below it, which the controls use."""

from __future__ import annotations

import contextlib

import torch

#: the largest finite float8_e4m3fn
FP8_E4M3_MAX = 448.0


def exact(x: torch.Tensor) -> torch.Tensor:
    """The operand as it is (bf16 operands are exact in f32)."""
    return x.float()


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """The operand rounded to float8 e4m3 with one scale a tensor (its
    largest magnitude to 448), back in f32: the step below bf16."""
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, FP8_E4M3_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


QUANT = {"bf16": exact, "fp8": fp8_e4m3}


@contextlib.contextmanager
def f32_matmul():
    """Products of f32 operands in f32: no TF32 on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
