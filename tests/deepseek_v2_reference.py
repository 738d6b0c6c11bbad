"""A copy of ``gpubench/reference/deepseek_v2.py`` for the port's CPU
tests (``tests/test_torch_deepseek_v2.py``), kept beside them so that the
benchmark's frozen reference and the tests' may part; it imports nothing
of the program or of the benchmark.

Plain reference of DeepSeek-V2-Lite's train step on the expert share of
one GPU: one device, every product, activation and the loss in float32
(TF32 off), PyTorch's own autograd and AdamW, no kernel, no graph, no
sorted dispatch.  The parameters and AdamW's moments keep the
configuration's dtypes (bf16 matrices, f32 router and norms): a gradient
is rounded to its parameter's dtype once, and each update to it, as the
configuration's optimizer keeps them.

It follows the released modeling code (``modeling_deepseek.py`` of
``deepseek-ai/DeepSeek-V2-Lite``) and the paper (arXiv:2405.04434):

- MLA without q compression: ``q = x·W_q``; ``kv_a = x·W_kv_a`` split into
  the latent (RMSNorm, then ``·W_kv_b`` → per-head ``k_nope`` and ``v``) and
  one rope key shared by the heads; RoPE on the interleaved pairs (the
  dims regrouped (n/2, 2) → (2, n/2), then ``rotate_half``) at YaRN's
  frequencies, cos and sin times ``mscale(s, m) / mscale(s, m_all)``;
  causal softmax at ``q_head_dim**-0.5 · mscale(s, m_all)²``;
- the dense SwiGLU layers, then MoE layers: ``softmax(x·W_router)`` over
  every routed expert, the top k (``topk_method: greedy``), gates not
  renormalised unless ``norm_topk_prob``, times ``routed_scaling_factor``;
  each held expert's SwiGLU on the tokens that chose it, times its gate,
  added; the shared experts as one SwiGLU on every token;
- the loss: next-token cross-entropy plus ``aux_loss_alpha`` times each
  MoE layer's sequence-wise balance loss (``seq_aux``).

Departures, each kept by the program alike: the vocabulary is the slice
the configuration holds; the experts of other GPUs add nothing (the
configuration's share, as an ep deployment's GPU computes it); top-k ties
go to the lower expert index (``torch.topk`` promises no order); the
balance loss is part of the loss's value (the released code adds only its
gradient); activations are f32 where the released code rounds to bf16.
Attention runs in query blocks, and the loss in row blocks, each
recomputed in backward, and so is each layer, so that three steps at the
cell's sizes fit on one card.  Each product's operands pass through
``quant`` (exact, or rounded to fp8 for the precision control), forward
and backward.

The parameters are named as the program names them: ``embed``,
``layers.NN.{attn_norm, wq, wkv_a, kv_norm, wkv_b, wo, ffn_norm}``, then
``w_gate_up``/``w_down`` (dense) or ``router``, ``expert_gate_up``,
``expert_down`` (held, in, out), ``shared_gate_up``, ``shared_down``;
``final_norm``, ``unembed``.  Matrices are (in, out); a SwiGLU leaf holds
the gate's columns, then the up-projection's.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: the largest finite float8_e4m3fn
FP8_E4M3_MAX = 448.0
#: query rows a block of attention, rows a block of the loss
ATTN_BLOCK = 1024
LOSS_BLOCK = 4096


def exact(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """The operand rounded to float8 e4m3 with one scale a tensor, in f32."""
    x = x.float()
    if not x.numel():
        return x
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, FP8_E4M3_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


QUANT = {"bf16": exact, "fp8": fp8_e4m3}


@contextlib.contextmanager
def f32_matmul():
    """Products of f32 operands in f32: no TF32 on the card."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class _Product(torch.autograd.Function):
    """``a @ b`` in f32 over the operands as ``quant`` rounds them; the
    backward's two products alike."""

    @staticmethod
    def forward(ctx, a, b, quant):
        ctx.save_for_backward(a, b)
        ctx.quant = quant
        return torch.matmul(quant(a), quant(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        q = ctx.quant
        ga = torch.matmul(q(g), q(b).transpose(-1, -2))
        gb = torch.matmul(q(a).transpose(-1, -2), q(g))
        while gb.dim() > b.dim():  # b broadcast over a's leading dims
            gb = gb.sum(0)
        return ga.to(a.dtype), gb.to(b.dtype), None


def product(a, b, quant):
    return _Product.apply(a, b, quant)


# --- sizes and YaRN ------------------------------------------------------------

def mscale(s: float, m: float) -> float:
    return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0


def inv_freq(m: dict) -> torch.Tensor:
    """YaRN's inverse frequencies of the rope dims (the released
    ``DeepseekV2YarnRotaryEmbedding``)."""
    dim, base, rs = m["qk_rope_head_dim"], m["rope_theta"], m["rope_scaling"]
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    inter = extra / rs["factor"]
    mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    return (inter * (1 - mask) + extra * mask).float()


def rope_tables(m: dict, T: int, device) -> tuple:
    rs = m["rope_scaling"]
    freqs = torch.outer(torch.arange(T, dtype=torch.float32), inv_freq(m))
    emb = torch.cat([freqs, freqs], -1)
    k = mscale(rs["factor"], rs["mscale"]) / mscale(rs["factor"], rs["mscale_all_dim"])
    return (emb.cos() * k).to(device), (emb.sin() * k).to(device)


def softmax_scale(m: dict) -> float:
    rs = m["rope_scaling"]
    k = mscale(rs["factor"], rs["mscale_all_dim"])
    return (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5 * k * k


# --- the model ------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    x = x.unflatten(-1, (n // 2, 2)).transpose(-1, -2).flatten(-2)
    return x * cos + torch.cat([-x[..., n // 2:], x[..., : n // 2]], -1) * sin


def swiglu(x, w_gate_up, w_down, quant):
    gate, up = product(x, w_gate_up, quant).chunk(2, dim=-1)
    return product(F.silu(gate) * up, w_down, quant)


def _attend_block(q, k, v, i0: int, scale: float, quant):
    """Queries i0 … i0 + n − 1 of one sequence, (H, n, ·), over keys 0 … i0 + n − 1."""
    n = q.shape[1]
    s = product(q, k.transpose(-1, -2), quant) * scale
    qi = torch.arange(i0, i0 + n, device=q.device)[:, None]
    kj = torch.arange(k.shape[1], device=q.device)[None, :]
    p = torch.softmax(s.masked_fill(kj > qi, float("-inf")), dim=-1)
    return product(p, v, quant)


def attention(q, k, v, scale: float, quant):
    """Causal attention of (B, H, T, ·) in query blocks."""
    T = q.shape[2]
    out = []
    for b in range(q.shape[0]):
        rows = []
        for i0 in range(0, T, ATTN_BLOCK):
            i1 = min(T, i0 + ATTN_BLOCK)
            rows.append(checkpoint(_attend_block, q[b, :, i0:i1], k[b, :, :i1], v[b, :, :i1], i0,
                                   scale, quant, use_reentrant=False))
        out.append(torch.cat(rows, dim=1))
    return torch.stack(out)


def mla(x, lp: dict, cos, sin, m: dict, quant):
    B, T, _ = x.shape
    H, nope, rp = m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    vd, r = m["v_head_dim"], m["kv_lora_rank"]
    q = product(x, lp["wq"], quant).view(B, T, H, nope + rp)
    kv_a = product(x, lp["wkv_a"], quant)
    c = rmsnorm(kv_a[..., :r], lp["kv_norm"], m["rms_norm_eps"])
    kv = product(c, lp["wkv_b"], quant).view(B, T, H, nope + vd)
    k_nope, v = kv.split([nope, vd], dim=-1)
    q_pe = rope(q[..., nope:], cos[:, None], sin[:, None])
    k_pe = rope(kv_a[..., r:], cos, sin)
    q = torch.cat([q[..., :nope], q_pe], -1).transpose(1, 2)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, T, H, rp)], -1).transpose(1, 2)
    o = attention(q, k, v.transpose(1, 2), softmax_scale(m), quant)
    return product(o.transpose(1, 2).reshape(B, T, H * vd), lp["wo"], quant)


def top_k(probs: torch.Tensor, k: int) -> tuple:
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def moe(x, lp: dict, m: dict, held: list, quant) -> tuple:
    """(the held experts' part plus the shared experts, (S, d); the
    sequences' balance loss) for x (B, T, d)."""
    B, T, d = x.shape
    E, K = m["n_routed_experts_published"], m["num_experts_per_tok"]
    x2 = x.reshape(B * T, d)
    probs = torch.softmax(product(x2, lp["router"], quant), dim=-1)
    gates, experts = top_k(probs, K)
    if m["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * m["routed_scaling_factor"]
    load = torch.zeros(B, E, device=x.device).scatter_add_(
        1, experts.reshape(B, -1), torch.ones(B, T * K, device=x.device)) / (T * K / E)
    aux = (load * probs.view(B, T, E).mean(1)).sum(1).mean()
    y = torch.zeros_like(x2)
    for slot, e in enumerate(held):
        hit = experts == e
        # an expert that no token chose still runs, on no rows, as the
        # released code calls it: its gradient is zero, not missing, and
        # AdamW moves it on its moments
        tok = hit.any(-1).nonzero().squeeze(-1)
        g = (gates * hit).sum(-1)[tok]
        out = swiglu(x2[tok], lp["expert_gate_up"][slot], lp["expert_down"][slot], quant)
        y = y.index_add(0, tok, out * g[:, None])
    y = y + swiglu(x2, lp["shared_gate_up"], lp["shared_down"], quant)
    return y.view(B, T, d), aux


def layer(h, lp: dict, cos, sin, m: dict, held: list, quant, dense: bool):
    eps = m["rms_norm_eps"]
    h = h + mla(rmsnorm(h, lp["attn_norm"], eps), lp, cos, sin, m, quant)
    x = rmsnorm(h, lp["ffn_norm"], eps)
    if dense:
        return h + swiglu(x, lp["w_gate_up"], lp["w_down"], quant), torch.zeros((), device=h.device)
    y, aux = moe(x, lp, m, held, quant)
    return h + y, aux


def _nll_block(h, final_norm, unembed, targets, eps: float, quant):
    logits = product(rmsnorm(h, final_norm, eps), unembed, quant)
    return F.cross_entropy(logits, targets, reduction="sum")


def hidden(params: dict, tokens: torch.Tensor, m: dict, quant) -> tuple:
    """(the last layer's output (B·T, d) for ``tokens`` (B, T), the MoE
    layers' balance losses summed)."""
    T = tokens.shape[1]
    cos, sin = rope_tables(m, T, tokens.device)
    held = list(range(m["n_routed_experts"]))
    h = params["embed"].float()[tokens]  # the gradient summed in f32, rounded once
    aux = []
    for i in range(m["num_hidden_layers"]):
        h, a = checkpoint(layer, h, params["layers"][f"{i:02d}"], cos, sin, m, held, quant,
                          i < m["first_k_dense_replace"], use_reentrant=False)
        aux.append(a)
    return h.reshape(-1, h.shape[-1]), torch.stack(aux).sum()


def logits(params: dict, tokens: torch.Tensor, m: dict, quant) -> torch.Tensor:
    """The logits (B·T, vocab) of ``tokens`` (B, T), whole (small sizes)."""
    h, _ = hidden(params, tokens, m, quant)
    return product(rmsnorm(h, params["final_norm"], m["rms_norm_eps"]), params["unembed"], quant)


def loss(params: dict, tokens: torch.Tensor, m: dict, quant) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (B, T) over the slice,
    plus α · the MoE layers' balance losses, f32."""
    h, aux = hidden(params, tokens[:, :-1], m, quant)
    targets = tokens[:, 1:].reshape(-1)
    unembed = params["unembed"].float()  # the blocks' gradients summed in f32, rounded once
    total = sum(checkpoint(_nll_block, h[i:i + LOSS_BLOCK], params["final_norm"], unembed,
                           targets[i:i + LOSS_BLOCK], m["rms_norm_eps"], quant, use_reentrant=False)
                for i in range(0, h.shape[0], LOSS_BLOCK))
    return total / h.shape[0] + m["aux_loss_alpha"] * aux


# --- parameters and training ----------------------------------------------------

def param_shapes(m: dict) -> dict:
    """Every leaf's dotted name → shape, in drawing order."""
    d, H, V = m["hidden_size"], m["num_attention_heads"], m["vocab_size"]
    nope, rp = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    vd, r = m["v_head_dim"], m["kv_lora_rank"]
    n, f = m["n_routed_experts"], m["moe_intermediate_size"]
    s = m["n_shared_experts"] * f
    shapes = {"embed": (V, d)}
    for i in range(m["num_hidden_layers"]):
        p = f"layers.{i:02d}."
        shapes.update({p + "attn_norm": (d,), p + "wq": (d, H * (nope + rp)),
                       p + "wkv_a": (d, r + rp), p + "kv_norm": (r,),
                       p + "wkv_b": (r, H * (nope + vd)), p + "wo": (H * vd, d),
                       p + "ffn_norm": (d,)})
        if i < m["first_k_dense_replace"]:
            shapes.update({p + "w_gate_up": (d, 2 * m["intermediate_size"]),
                           p + "w_down": (m["intermediate_size"], d)})
        else:
            shapes.update({p + "router": (d, m["n_routed_experts_published"]),
                           p + "expert_gate_up": (n, d, 2 * f), p + "expert_down": (n, f, d),
                           p + "shared_gate_up": (d, 2 * s), p + "shared_down": (s, d)})
    shapes.update({"final_norm": (d,), "unembed": (d, V)})
    return shapes


def tree(pairs) -> dict:
    out: dict = {}
    for name, t in pairs:
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def named_leaves(t: dict, prefix: str = "") -> list:
    out = []
    for k in sorted(t):
        v = t[k]
        out += named_leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(f"{prefix}{k}", v)]
    return out


def init_params(m: dict, seed: int, device) -> dict:
    """The run's parameters from ``seed``: every matrix N(0, ``init_std``),
    rounded to bf16 but the router's (f32, as the program keeps it), drawn
    leaf after leaf from one generator on ``device``; norms ones in f32.
    The program gets the same tree."""
    g = torch.Generator(device=device).manual_seed(seed)
    pairs = []
    for name, shape in param_shapes(m).items():
        if name.endswith("norm"):
            pairs.append((name, torch.ones(shape, dtype=torch.float32, device=device)))
        else:
            t = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
            t = t.mul_(m["init_std"])
            pairs.append((name, t if name.endswith("router") else t.to(torch.bfloat16)))
    return tree(pairs)


def leaf_norms(t: dict) -> dict:
    """The f32 norm of every leaf.  An expert leaf holds every held
    expert of its layer: one expert's gradient is a sum over the few
    thousand tokens routed to it, and which tokens those are moves with
    rounding where the router's top-k sits near a tie, so that one expert's
    norm is noise at bf16; the layer's held experts together are not."""
    return {name: x.detach().float().norm().item() for name, x in named_leaves(t)}


def train_steps(params: dict, batches: list, m: dict, opt: dict, precision: str = "bf16") -> dict:
    """Train a copy of ``params`` over ``batches`` with AdamW: each step's
    loss, every parameter's gradient norm at the first step, and every
    parameter's change over all of them (against ``params``)."""
    quant = QUANT[precision]
    named = named_leaves(params)
    live = [t.detach().clone().requires_grad_(True) for _, t in named]
    model = tree((name, t) for (name, _), t in zip(named, live))
    adamw = torch.optim.AdamW(live, lr=m["lr"], betas=tuple(opt["betas"]), eps=opt["eps"],
                              weight_decay=opt["weight_decay"], foreach=False)
    losses, grad_norms = [], None
    with f32_matmul():
        for i, tokens in enumerate(batches):
            adamw.zero_grad(set_to_none=True)
            value = loss(model, tokens, m, quant)
            value.backward()
            if i == 0:
                grad_norms = leaf_norms(tree((name, t.grad) for (name, _), t in zip(named, live)))
            adamw.step()
            losses.append(value.item())
    del adamw
    with torch.no_grad():
        change = tree((name, t.float() - start.float()) for (name, start), t in zip(named, live))
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": leaf_norms(change)}
