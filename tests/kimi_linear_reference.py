"""A copy of ``gpubench/reference/kimi_linear.py`` for the port's CPU tests
(``tests/test_torch_kimi_linear.py``), kept beside them so that the
benchmark's frozen reference and the tests' may part; it imports nothing of
the program or of the benchmark (its helpers come from the tests' copy of
the DeepSeek-V2-Lite reference).

Plain reference of Kimi-Linear-48B-A3B's train step on the expert share of
one GPU: one device, every product, activation and the loss in float32
(TF32 off, for products and convolutions), PyTorch's own autograd and
AdamW, no kernel, no graph, no sorted dispatch.  The parameters and AdamW's
moments keep the configuration's dtypes (bf16 matrices; f32 router, A_log,
dt_bias, the output gate's bias and the norms): a gradient is rounded to its
parameter's dtype once, and each update to it.

It follows the Kimi Linear technical report (arXiv:2510.26692), the released
``config.json`` and the public ``fla/layers/kda.py`` of
flash-linear-attention that the released code uses:

- 3 KDA : 1 MLA by ``linear_attn_config`` (1-based ``kda_layers`` and
  ``full_attn_layers``).
- **KDA**: ``q̃, k̃, v = SiLU(conv₄(x·W_q)), SiLU(conv₄(x·W_k)),
  SiLU(conv₄(x·W_v))`` (conv₄ causal and depthwise, width 4); ``q, k`` L2
  normalised per head (``x·rsqrt(Σx² + 1e-6)``); ``g = −exp(A_log[h]) ·
  softplus(x·W_fa·W_fb + dt_bias)`` a channel; ``β = sigmoid(x·W_b)`` a head;
  with S₀ = 0, ``S′ₜ = Diag(e^{gₜ})·Sₜ₋₁``, ``Sₜ = S′ₜ + βₜ kₜ (vₜ −
  S′ₜᵀkₜ)ᵀ``, ``oₜ = d_k^−½·Sₜᵀqₜ`` (:func:`kda_recurrent`, token by token,
  the definition; :func:`kda_chunked`, the same by chunks); then ``y = W_o ·
  concat_h(RMSNorm(o_h) ⊙ w_norm ⊙ sigmoid(x·W_ga·W_gb + b_gb))``.
- **MLA** without q compression and with NoPE (``mla_use_nope``): ``q =
  x·W_q`` → heads of ``nope + rope``; ``kv_a = x·W_kv_a`` → the latent
  (RMSNorm, then ``·W_kv_b`` → per-head ``k_nope`` and ``v``) and one
  rope-wide key shared by the heads, carried unrotated; causal softmax at
  ``(nope + rope)^−½``.
- Layer 0 a SwiGLU, then MoE layers: ``sigmoid(x·W_router)`` over every
  routed expert, the top 8 (one group), the gates renormalised over the 8
  and times ``routed_scaling_factor``; each held expert's SwiGLU on the
  tokens that chose it, times its gate, added; the shared expert a SwiGLU
  on every token.
- The loss: next-token cross-entropy, no balance term.

Departures, each kept by the program alike: the vocabulary is the slice
the configuration holds; the experts of other GPUs add nothing (the
configuration's share, as an ep deployment's GPU computes it); top-k ties
go to the lower expert index; the scores' correction bias is left out (it
is zero and untrained here); activations are f32 where the released code
rounds to bf16.  KDA runs by chunks (:func:`kda_chunked`: the pair blocks
and the triangular solve of several chunks at once, each block recomputed in
backward, then the state from chunk to chunk; a chunk's pairs by
:func:`pair_blocks`, through a reference position between the blocks of 16
positions, pair by pair inside them); attention runs in query
blocks, the loss in row blocks, and each layer is recomputed in backward,
so that three steps at the cell's sizes fit on one card.  Each product's
operands pass through ``quant`` (exact, or rounded to fp8 for the precision
control), forward and backward.

The parameters are named as the program names them: ``embed``;
``layers.NN.attn_norm``, then a KDA layer's ``wqkv`` (q's, k's, v's
columns), ``conv`` (their filters, (channels, 4)), ``wfa``, ``wfb``,
``dt_bias``, ``A_log``, ``wb``, ``wga``, ``wgb``, ``gb_bias``, ``o_norm``,
``wo`` or an MLA layer's ``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``;
``ffn_norm``; ``w_gate_up``/``w_down`` (dense) or ``router``,
``expert_gate_up``, ``expert_down`` (held, in, out), ``shared_gate_up``,
``shared_down``; ``final_norm``, ``unembed``.  Matrices are (in, out); a
SwiGLU leaf holds the gate's columns, then the up-projection's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import deepseek_v2_reference as base

QUANT = base.QUANT
product, rmsnorm, swiglu, attention = base.product, base.rmsnorm, base.swiglu, base.attention
tree, named_leaves, leaf_norms, top_k = base.tree, base.named_leaves, base.leaf_norms, base.top_k
#: positions of a KDA chunk, the chunks whose pair blocks are formed at once,
#: and the positions of a diagonal block of a chunk's pairs
CHUNK = 64
CHUNK_BLOCK = 16
SUB = 16
L2_EPS = 1e-6


# --- KDA ------------------------------------------------------------------------

def kda_recurrent(q, k, v, g, beta, scale: float) -> tuple:
    """The gated delta rule token by token: (o (B, T, H, Dv), the final
    state (B, H, Dk, Dv)), from q, k, v, g (B, T, H, ·) and beta (B, T, H)."""
    B, T, H, Dk = k.shape
    S = q.new_zeros(B, H, Dk, v.shape[-1])
    out = []
    for t in range(T):
        Sp = g[:, t].exp()[..., None] * S
        pred = torch.einsum("bhcd,bhc->bhd", Sp, k[:, t])
        S = Sp + beta[:, t, :, None, None] * k[:, t, :, :, None] * (v[:, t] - pred)[:, :, None, :]
        out.append(scale * torch.einsum("bhcd,bhc->bhd", S, q[:, t]))
    return torch.stack(out, 1), S


def pair_blocks(q, k, G, sub: int = SUB) -> tuple:
    """(Akk, Aqk) of chunks (..., C, D): ``Akk[t, s] = Σ_c k_t k_s e^{G_t −
    G_s}`` below the diagonal, ``Aqk[t, s] = Σ_c q_t k_s e^{G_t − G_s}`` on and
    below it.  Within each diagonal block of ``sub`` positions pair by pair
    (the exponent masked before it is taken); below them through the last
    position r of the column's block, ``e^{G_t − G_r} · e^{G_r − G_s}``, two
    factors ≤ 1, so that the block is one product of scaled rows."""
    C, D = G.shape[-2:]
    n = min(sub, C)
    blocks = G.shape[:-2] + (C // n, n, D)
    Gb, kb, qb = G.reshape(blocks), k.reshape(blocks), q.reshape(blocks)
    lower = torch.ones(n, n, dtype=torch.bool, device=G.device).tril()
    diff = Gb[..., :, None, :] - Gb[..., None, :, :]
    E = torch.where(lower[:, :, None], diff, torch.full_like(diff, -math.inf)).exp()
    kk = (kb[..., :, None, :] * kb[..., None, :, :] * E).sum(-1) * lower.tril(-1)
    qk = (qb[..., :, None, :] * kb[..., None, :, :] * E).sum(-1)
    akk = G.new_zeros(G.shape[:-1] + (C,))
    aqk = G.new_zeros(G.shape[:-1] + (C,))
    for i in range(C // n):
        at = slice(i * n, (i + 1) * n)
        akk[..., at, at] = kk[..., i, :, :]
        aqk[..., at, at] = qk[..., i, :, :]
    for j in range(C // n - 1):
        r = (j + 1) * n - 1
        rows, cols = slice(r + 1, C), slice(j * n, r + 1)
        up = (G[..., rows, :] - G[..., r:r + 1, :]).exp()
        kc = (k[..., cols, :] * (G[..., r:r + 1, :] - G[..., cols, :]).exp()).transpose(-1, -2)
        akk[..., rows, cols] = (k[..., rows, :] * up) @ kc
        aqk[..., rows, cols] = (q[..., rows, :] * up) @ kc
    return akk, aqk


def _intra(q, k, v, G, beta):
    """For chunks (..., C, ·): w, u and Aqk of each chunk, where w, u solve
    (I + β·Akk)·[w | u] = [β e^G k | β v] (:func:`pair_blocks`)."""
    C = G.shape[-2]
    akk, aqk = pair_blocks(q, k, G)
    eye = torch.eye(C, dtype=G.dtype, device=G.device)
    rhs = torch.cat([beta * G.exp() * k, beta * v], -1)
    wu = torch.linalg.solve_triangular(eye + beta * akk, rhs, upper=False)
    return wu, aqk


def kda_chunked(q, k, v, g, beta, scale: float, chunk: int = CHUNK,
                block: int = CHUNK_BLOCK) -> tuple:
    """:func:`kda_recurrent` by chunks of ``chunk`` positions (T padded with
    zeros: a zero β, k and g leave the state as it is): the pair blocks and
    the triangular solve of ``block`` chunks at once, each such block
    recomputed in backward; then the state chunk after chunk."""
    B, T, H, Dk = k.shape
    Dv = v.shape[-1]
    N = -(-T // chunk)

    def chunks(x):
        if N * chunk > T:
            x = torch.cat([x, x.new_zeros((B, N * chunk - T) + tuple(x.shape[2:]))], 1)
        return x.view(B, N, chunk, H, *x.shape[3:]).movedim(3, 1)

    q, k, v, g = (chunks(x) for x in (q, k, v, g))
    beta = chunks(beta)[..., None]
    G = g.cumsum(-2)
    parts = [checkpoint(_intra, q[:, :, i:i + block], k[:, :, i:i + block], v[:, :, i:i + block],
                        G[:, :, i:i + block], beta[:, :, i:i + block], use_reentrant=False)
             for i in range(0, N, block)]
    wu = torch.cat([p[0] for p in parts], 2)
    aqk = torch.cat([p[1] for p in parts], 2)
    S = q.new_zeros(B, H, Dk, Dv)
    out = []
    for n in range(N):
        w, u = wu[:, :, n, :, :Dk], wu[:, :, n, :, Dk:]
        x = u - w @ S
        Gn = G[:, :, n]
        out.append(scale * ((q[:, :, n] * Gn.exp()) @ S + aqk[:, :, n] @ x))
        last = Gn[:, :, -1]
        S = last.exp()[..., None] * S + (k[:, :, n] * (last[:, :, None] - Gn).exp()).transpose(-1, -2) @ x
    o = torch.stack(out, 2).movedim(1, 3).reshape(B, N * chunk, H, Dv)[:, :T]
    return o, S


def short_conv(x, filters):
    """SiLU of the causal depthwise convolution along time of x (B, T, C)."""
    T, width = x.shape[1], filters.shape[1]
    y = F.conv1d(x.transpose(1, 2), filters.float()[:, None, :], padding=width - 1,
                 groups=filters.shape[0])[..., :T]
    return F.silu(y.transpose(1, 2))


def l2norm(x):
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)


def kda(x, lp: dict, m: dict, quant):
    B, T, _ = x.shape
    la = m["linear_attn_config"]
    H, K = la["num_heads"], la["head_dim"]
    q, k, v = short_conv(product(x, lp["wqkv"], quant), lp["conv"]).view(B, T, 3, H, K).unbind(2)
    q, k = l2norm(q), l2norm(k)
    f = product(product(x, lp["wfa"], quant), lp["wfb"], quant).view(B, T, H, K)
    g = -lp["A_log"].exp()[:, None] * F.softplus(f + lp["dt_bias"].view(H, K))
    beta = torch.sigmoid(product(x, lp["wb"], quant))
    o, _ = kda_chunked(q, k, v, g, beta, K**-0.5)
    gate = (product(product(x, lp["wga"], quant), lp["wgb"], quant) + lp["gb_bias"]).view(B, T, H, K)
    o = rmsnorm(o, lp["o_norm"], m["rms_norm_eps"]) * torch.sigmoid(gate)
    return product(o.reshape(B, T, H * K), lp["wo"], quant)


# --- the rest of the model ------------------------------------------------------

def mla(x, lp: dict, m: dict, quant):
    """MLA with NoPE: the shared key's rope-wide columns carried unrotated."""
    B, T, _ = x.shape
    H, nope, rp = m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    vd, r = m["v_head_dim"], m["kv_lora_rank"]
    q = product(x, lp["wq"], quant).view(B, T, H, nope + rp)
    kv_a = product(x, lp["wkv_a"], quant)
    c = rmsnorm(kv_a[..., :r], lp["kv_norm"], m["rms_norm_eps"])
    kv = product(c, lp["wkv_b"], quant).view(B, T, H, nope + vd)
    k_nope, v = kv.split([nope, vd], dim=-1)
    k = torch.cat([k_nope, kv_a[..., r:][:, :, None].expand(B, T, H, rp)], -1)
    o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  (nope + rp) ** -0.5, quant)
    return product(o.transpose(1, 2).reshape(B, T, H * vd), lp["wo"], quant)


def moe(x, lp: dict, m: dict, held: list, quant):
    """The held experts' part plus the shared expert, (B, T, d)."""
    B, T, d = x.shape
    x2 = x.reshape(B * T, d)
    scores = torch.sigmoid(product(x2, lp["router"], quant))
    gates, experts = top_k(scores, m["num_experts_per_token"])
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * m["routed_scaling_factor"]
    y = torch.zeros_like(x2)
    for slot, e in enumerate(held):
        hit = experts == e
        # an expert that no token chose still runs, on no rows: its gradient
        # is zero, not missing, and AdamW moves it on its moments
        tok = hit.any(-1).nonzero().squeeze(-1)
        g = (gates * hit).sum(-1)[tok]
        out = swiglu(x2[tok], lp["expert_gate_up"][slot], lp["expert_down"][slot], quant)
        y = y.index_add(0, tok, out * g[:, None])
    y = y + swiglu(x2, lp["shared_gate_up"], lp["shared_down"], quant)
    return y.view(B, T, d)


def is_kda(m: dict, layer: int) -> bool:
    return layer + 1 in m["linear_attn_config"]["kda_layers"]


def layer(h, lp: dict, m: dict, held: list, quant, kda_layer: bool, dense: bool):
    eps = m["rms_norm_eps"]
    x = rmsnorm(h, lp["attn_norm"], eps)
    h = h + (kda(x, lp, m, quant) if kda_layer else mla(x, lp, m, quant))
    x = rmsnorm(h, lp["ffn_norm"], eps)
    if dense:
        return h + swiglu(x, lp["w_gate_up"], lp["w_down"], quant)
    return h + moe(x, lp, m, held, quant)


def hidden(params: dict, tokens: torch.Tensor, m: dict, quant) -> torch.Tensor:
    """The last layer's output (B·T, d) for ``tokens`` (B, T)."""
    held = list(range(m["num_experts"]))
    h = params["embed"].float()[tokens]  # the gradient summed in f32, rounded once
    for i in range(m["num_hidden_layers"]):
        h = checkpoint(layer, h, params["layers"][f"{i:02d}"], m, held, quant, is_kda(m, i),
                       i < m["first_k_dense_replace"], use_reentrant=False)
    return h.reshape(-1, h.shape[-1])


def logits(params: dict, tokens: torch.Tensor, m: dict, quant) -> torch.Tensor:
    """The logits (B·T, vocab) of ``tokens`` (B, T), whole (small sizes)."""
    h = hidden(params, tokens, m, quant)
    return product(rmsnorm(h, params["final_norm"], m["rms_norm_eps"]), params["unembed"], quant)


def loss(params: dict, tokens: torch.Tensor, m: dict, quant) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (B, T) over the slice, f32."""
    h = hidden(params, tokens[:, :-1], m, quant)
    targets = tokens[:, 1:].reshape(-1)
    unembed = params["unembed"].float()  # the blocks' gradients summed in f32, rounded once
    total = sum(checkpoint(base._nll_block, h[i:i + base.LOSS_BLOCK], params["final_norm"],
                           unembed, targets[i:i + base.LOSS_BLOCK], m["rms_norm_eps"], quant,
                           use_reentrant=False)
                for i in range(0, h.shape[0], base.LOSS_BLOCK))
    return total / h.shape[0]


# --- parameters and training ----------------------------------------------------

def param_shapes(m: dict) -> dict:
    """Every leaf's dotted name → shape, in drawing order."""
    d, V = m["hidden_size"], m["vocab_size"]
    la = m["linear_attn_config"]
    Hk, K = la["num_heads"], la["head_dim"]
    hk, rank = Hk * K, K  # the decay's and the gate's low rank: the head width (assumed)
    H, nope, rp = m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    vd, r = m["v_head_dim"], m["kv_lora_rank"]
    n, f = m["num_experts"], m["moe_intermediate_size"]
    s = m["num_shared_experts"] * f
    shapes = {"embed": (V, d)}
    for i in range(m["num_hidden_layers"]):
        p = f"layers.{i:02d}."
        shapes[p + "attn_norm"] = (d,)
        if is_kda(m, i):
            shapes.update({p + "wqkv": (d, 3 * hk), p + "conv": (3 * hk, la["short_conv_kernel_size"]),
                           p + "wfa": (d, rank), p + "wfb": (rank, hk), p + "dt_bias": (hk,),
                           p + "A_log": (Hk,), p + "wb": (d, Hk), p + "wga": (d, rank),
                           p + "wgb": (rank, hk), p + "gb_bias": (hk,), p + "o_norm": (K,),
                           p + "wo": (hk, d)})
        else:
            shapes.update({p + "wq": (d, H * (nope + rp)), p + "wkv_a": (d, r + rp),
                           p + "kv_norm": (r,), p + "wkv_b": (r, H * (nope + vd)),
                           p + "wo": (H * vd, d)})
        shapes[p + "ffn_norm"] = (d,)
        if i < m["first_k_dense_replace"]:
            shapes.update({p + "w_gate_up": (d, 2 * m["intermediate_size"]),
                           p + "w_down": (m["intermediate_size"], d)})
        else:
            shapes.update({p + "router": (d, m["num_experts_published"]),
                           p + "expert_gate_up": (n, d, 2 * f), p + "expert_down": (n, f, d),
                           p + "shared_gate_up": (d, 2 * s), p + "shared_down": (s, d)})
    shapes.update({"final_norm": (d,), "unembed": (d, V)})
    return shapes


def init_leaf(name: str, shape: tuple, std: float, g: torch.Generator, device) -> torch.Tensor:
    """Norms ones; ``A_log`` log U(1, 16); ``dt_bias`` softplus⁻¹ of exp
    U(ln 0.001, ln 0.1) (floored at 1e-4); ``gb_bias`` zeros; ``conv``
    U(−½, ½); every other matrix N(0, std), bf16 but the router's."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("norm"):
        return torch.ones(shape, dtype=torch.float32, device=device)
    if leaf == "gb_bias":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if leaf in ("A_log", "dt_bias", "conv"):
        u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
        if leaf == "A_log":
            return torch.log(1.0 + 15.0 * u)
        if leaf == "conv":
            return (u - 0.5).to(torch.bfloat16)
        dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3))).clamp(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    t = torch.randn(shape, generator=g, device=device, dtype=torch.float32) * std
    return t if leaf == "router" else t.to(torch.bfloat16)


def init_params(m: dict, seed: int, device) -> dict:
    """The run's parameters from ``seed``, drawn leaf after leaf from one
    generator on ``device`` (:func:`init_leaf`).  The program gets the same
    tree."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tree((name, init_leaf(name, shape, m["init_std"], g, device))
                for name, shape in param_shapes(m).items())


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
    with base.f32_matmul():
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
