"""Plain reference of the demo transformer's train step: one device, no
sharding, no recompute, no graph, PyTorch's own autograd and AdamW.

The model is the workload configuration's (``configs/workload-defaults.json``):
token embedding, ``n_layers`` pre-norm blocks of fused-qkv multi-head causal
attention and a gelu-tanh MLP, a final RMSNorm and the unembedding, and the
next-token cross-entropy.  Its precision is the configuration's: bf16
weights and activations; every product of f32 sums over its operands; RMSNorm
(eps 1e-6), attention scores, softmax and the loss in f32; AdamW moments in
the parameters' dtype.  Each product's operands pass through ``quant``
(``precision.QUANT``): exact for the configuration, rounded to fp8 for the
control, forward and backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference.precision import QUANT, f32_matmul


class _Product(torch.autograd.Function):
    """``a @ b`` from f32 sums over the operands as ``quant`` rounds them,
    the result rounded to ``out``; the backward's two products alike."""

    @staticmethod
    def forward(ctx, a, b, quant, out):
        ctx.save_for_backward(a, b)
        ctx.quant = quant
        return torch.matmul(quant(a), quant(b)).to(out)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        q = ctx.quant
        ga = torch.matmul(q(g), q(b).transpose(-1, -2)).to(a.dtype)
        gb = torch.matmul(q(a).transpose(-1, -2), q(g))
        # b may be broadcast over a's leading dims: sum them away
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb.to(b.dtype), None, None


def product(a, b, quant, out=torch.bfloat16):
    return _Product.apply(a, b, quant, out)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6) * scale).to(torch.bfloat16)


def attention(x, wqkv, wo, n_heads: int, quant):
    B, T, d = x.shape
    hd = d // n_heads
    qkv = product(x, wqkv, quant)
    q, k, v = (t.reshape(B, T, n_heads, hd).transpose(1, 2) for t in qkv.split(d, dim=-1))
    scores = product(q, k.transpose(-1, -2), quant, torch.float32) * (1.0 / math.sqrt(hd))
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -1e30), dim=-1).to(torch.bfloat16)
    out = product(probs, v, quant).transpose(1, 2).reshape(B, T, d)
    return product(out, wo, quant)


def loss(params: dict, tokens: torch.Tensor, m: dict, quant) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (B, T) in f32."""
    x = params["embed"][tokens[:, :-1]]
    b = params["blocks"]
    for layer in range(m["n_layers"]):
        x = x + attention(rmsnorm(x, b["ln1"][layer]), b["wqkv"][layer], b["wo"][layer],
                          m["n_heads"], quant)
        h = F.gelu(product(rmsnorm(x, b["ln2"][layer]), b["w_up"][layer], quant).float(),
                   approximate="tanh").to(torch.bfloat16)
        x = x + product(h, b["w_down"][layer], quant)
    logits = product(rmsnorm(x, params["ln_f"]), params["unembed"], quant, torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).squeeze(-1).mean()


def named_leaves(tree: dict, prefix: str = "") -> list:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += named_leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(f"{prefix}{k}", v)]
    return out


def leaf_norms(tree: dict, n_layers: int) -> dict:
    """The f32 norm of every parameter: each layer's slice of a stacked
    block leaf is a parameter of its own (``blocks.wqkv.3``)."""
    out = {}
    for name, t in named_leaves(tree):
        t = t.detach().float()
        if name.startswith("blocks."):
            for layer in range(n_layers):
                out[f"{name}.{layer}"] = t[layer].norm().item()
        else:
            out[name] = t.norm().item()
    return out


def tree(pairs) -> dict:
    """The nested tree of (dotted name, leaf) pairs."""
    out: dict = {}
    for name, t in pairs:
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def train_steps(params: dict, batches: list, m: dict, opt: dict, precision: str = "bf16") -> dict:
    """Train ``params`` (modified in place) over ``batches`` with AdamW:
    each step's loss, every parameter's gradient norm at the first step, and
    every parameter's change over all of them."""
    quant = QUANT[precision]
    named = named_leaves(params)
    start = tree((name, t.detach().clone()) for name, t in named)
    leaves = [t.requires_grad_(True) for _, t in named]
    adamw = torch.optim.AdamW(leaves, lr=m["lr"], betas=tuple(opt["betas"]), eps=opt["eps"],
                              weight_decay=opt["weight_decay"], foreach=False)
    losses, grad_norms = [], None
    with f32_matmul():
        for i, tokens in enumerate(batches):
            adamw.zero_grad(set_to_none=True)
            value = loss(params, tokens, m, quant)
            value.backward()
            if i == 0:
                grad_norms = leaf_norms(tree((name, t.grad) for name, t in named), m["n_layers"])
            adamw.step()
            losses.append(value.item())
    change = tree((name, t.detach().float() - s.float())
                  for (name, t), (_, s) in zip(named, named_leaves(start)))
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": leaf_norms(change, m["n_layers"])}
