"""Inputs the benchmark makes from ``--seed`` and hands to the program and to
the reference alike: the same seed on the same device gives the same
tensors.  Everything is drawn on the device, in a few large calls."""

from __future__ import annotations

import torch

#: the bf16 leaves of the demo transformer, in drawing order, with their
#: shapes and init scales (the workload's own: ``tpudash_torch/models/
#: workload.py::init_params``); the norms are ones, in f32
BF16_LEAVES = ("embed", "blocks.wqkv", "blocks.wo", "blocks.w_up", "blocks.w_down", "unembed")


def leaf_shapes(m: dict) -> dict:
    V, d, f, L = m["vocab"], m["d_model"], m["d_ff"], m["n_layers"]
    return {
        "embed": ((V, d), 0.02),
        "blocks.wqkv": ((L, d, 3 * d), d**-0.5),
        "blocks.wo": ((L, d, d), d**-0.5),
        "blocks.w_up": ((L, d, f), d**-0.5),
        "blocks.w_down": ((L, f, d), f**-0.5),
        "unembed": ((d, V), d**-0.5),
    }


def model_params(m: dict, seed: int, device) -> dict:
    """The parameter tree of the configuration ``m`` (the keys of
    ``WorkloadConfig``): one normal draw for every bf16 leaf, scaled per
    leaf and cast; norms ones in f32."""
    shapes = leaf_shapes(m)
    sizes = [torch.Size(shapes[k][0]).numel() for k in BF16_LEAVES]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, n in zip(BF16_LEAVES, sizes):
        shape, scale = shapes[name]
        out[name] = (flat[at:at + n].view(shape) * scale).to(torch.bfloat16)
        at += n
    del flat
    d, L = m["d_model"], m["n_layers"]
    ones = {"blocks.ln1": (L, d), "blocks.ln2": (L, d), "ln_f": (d,)}
    for name, shape in ones.items():
        out[name] = torch.ones(shape, dtype=torch.float32, device=device)
    tree: dict = {"blocks": {}}
    for name, t in out.items():
        if name.startswith("blocks."):
            tree["blocks"][name.split(".", 1)[1]] = t
        else:
            tree[name] = t
    return tree


def token_pool(m: dict, n_batches: int, seed: int, device) -> torch.Tensor:
    """``n_batches`` batches of token ids, (n, batch, seq) int64."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, m["vocab"], (n_batches, m["batch"], m["seq"]), generator=g,
                         device=device)


def read_buffer(rows: int, cols: int, seed: int, device) -> torch.Tensor:
    """A normal (rows, cols) f32 buffer for the read kernel's check."""
    g = torch.Generator(device=device).manual_seed(seed + 2)
    return torch.randn((rows, cols), generator=g, device=device, dtype=torch.float32)


def chain_operands(size: int, seed: int, device, pairs: int = 1) -> list:
    """``pairs`` (x, w) bf16 of the matmul chain, drawn as the probe draws
    its own (``x ~ N(0, 1)``, ``w ~ N(0, 1) · size**-0.5``, each rounded to
    bf16, ``w`` again after its scaling), one after another from generator
    seed ``seed``: seed 0's first pair is the probe's own."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(pairs):
        x = torch.randn((size, size), generator=g, device=device).to(torch.bfloat16)
        w = torch.randn((size, size), generator=g, device=device).to(torch.bfloat16) * (size**-0.5)
        out.append((x, w))
    return out
