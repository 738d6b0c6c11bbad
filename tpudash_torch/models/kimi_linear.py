"""Kimi-Linear-48B-A3B (the Kimi Linear technical report, arXiv:2510.26692;
the released ``config.json`` of ``moonshotai/Kimi-Linear-48B-A3B-Instruct``),
trained as the workload source's third model on the expert share of one GPU.

The block is pre-norm: ``h += Attn(RMSNorm(h)); h += FFN(RMSNorm(h))``, then a
final RMSNorm, the untied unembedding over the vocabulary (or the slice of
it this GPU holds) and next-token cross-entropy.  Attention is a hybrid, 3
KDA : 1 MLA: the 1-based layers of ``kda_layers`` are Kimi Delta Attention,
those of ``full_attn_layers`` MLA.  Each layer is recomputed in backward.

- **KDA** (per layer, x the normed (T, d) stream, H heads of width K):
  ``q̃, k̃, v = SiLU(conv₄(x·W_q)), SiLU(conv₄(x·W_k)), SiLU(conv₄(x·W_v))``,
  conv₄ a causal depthwise convolution of width 4 along time;
  ``q = q̃/‖q̃‖, k = k̃/‖k̃‖`` per head; the log-decay a channel ``g =
  −exp(A_log[h])·softplus(x·W_fa·W_fb + dt_bias)``, α = exp(g); the step
  size ``β = sigmoid(x·W_b)``, one a head; the state a head, S₀ = 0:
  ``S′ₜ = Diag(αₜ)·Sₜ₋₁``, ``Sₜ = S′ₜ + βₜ kₜ (vₜ − S′ₜᵀkₜ)ᵀ``, ``oₜ =
  K^−½·Sₜᵀqₜ``; then ``y = W_o · concat_h(RMSNorm(o_h) ⊙ w_norm ⊙
  sigmoid(x·W_ga·W_gb + b_gb))``.  The recurrence runs by chunks of 64
  (``kernels.kda_chunk``: the WY form of Gated DeltaNet with a decay a
  channel); on GPUs its pair blocks and its state pass over a sequence's
  chunks are hand-written kernels each way (``ops/csrc/kda.cu``), with no
  loop over chunks in Python; on the CPU the same chain runs their plain
  versions.
- **MLA** with NoPE (``mla_use_nope``, no rope_scaling): DeepSeek-V2-Lite's
  ``deepseek_v2._mla`` and its kernels at 32 heads, given rope tables of
  cos 1 and sin 0, so that the 64 shared-key columns are carried, not
  rotated (the kernels' regrouping of them permutes q's and k's alike, which
  leaves every q·k as it is); the softmax scale is 192^−½.
- **FFN**: layer 0 a SwiGLU of width ``dense_width``; the others MoE:
  ``shared(x) + Σ_{j ≤ 8, e_j held here} g_j · expert_{e_j}(x)`` with the
  scores ``sigmoid(x·W_router)`` over every routed expert in f32 (the
  correction bias is zero: untrained, it adds nothing), the top 8 by
  ``moe._top_k``'s stable order, the gates renormalised over all 8 choices
  (held or not) and scaled by ``routed_scaling_factor``; then only the held
  experts' part, through DeepSeek-V2-Lite's dropless dispatch
  (``deepseek_v2._held_experts``) unchanged.  No balance loss: the config
  gives no coefficient.

Precision: bf16 weights and activations, each product's f32 sums rounded to
bf16; the router's weights f32.  In f32: RMSNorm (rounded once to bf16), the
SiLU after each convolution (the convolution's bf16 output), the L2 norms,
the gate g, β, every decay, the state S and its gradient, the chunked
products, the gated norm (rounded once to bf16 before W_o), the router's
sigmoid, the gates' combine and the loss.  ``A_log``, ``dt_bias``, the
output gate's bias and the norms' scales are f32 leaves.

Spans (``torch.profiler.record_function``): ``kimi.kda``, ``kimi.kda.proj``,
``kimi.kda.conv``, ``kimi.kda.chunk``, ``kimi.kda.out``,
``kimi.moe.route``; MLA and the dispatch keep their shared functions'
(``dsv2.mla``, ``dsv2.moe.*``).  Counters: the train step adds the tokens
routed to each held expert, summed over the layers, and one step into a
device tensor (:func:`routing_counters`), inside the graph.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from tpudash_torch.models import deepseek_v2 as dsv2
from tpudash_torch.models import moe, workload
from tpudash_torch.models.graphed import compiled
from tpudash_torch.ops import kernels

#: the workload source's name of the model
NAME = "kimi-linear"
#: the L2 norm's eps (the released code's ``l2norm``)
L2_EPS = 1e-6


@dataclass(frozen=True)
class KimiLinearConfig:
    """The published widths of Kimi-Linear-48B-A3B, with the vocabulary
    slice and the experts held on one GPU of an ep 16 deployment."""

    vocab: int = 20480
    d_model: int = 2304
    n_layers: int = 27
    #: 1-based layer numbers, as ``linear_attn_config`` gives them
    kda_layers: tuple = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26)
    full_attn_layers: tuple = (4, 8, 12, 16, 20, 24, 27)
    kda_heads: int = 32
    kda_head_dim: int = 128
    short_conv: int = 4
    #: the low rank of the decay's and the output gate's projections
    gate_rank: int = 128
    n_heads: int = 32
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    first_k_dense: int = 1
    dense_width: int = 9216
    #: the router's width: every routed expert of the layer
    n_experts: int = 256
    #: the experts this GPU holds, in the router's numbering
    experts_held: tuple = tuple(range(16))
    top_k: int = 8
    expert_width: int = 1024
    n_shared_experts: int = 1
    routed_scaling_factor: float = 2.446
    norm_eps: float = 1e-5
    init_std: float = 0.02
    seq: int = 8192
    batch: int = 4
    lr: float = 3e-4

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_held(self) -> int:
        return len(self.experts_held)

    @property
    def shared_width(self) -> int:
        return self.n_shared_experts * self.expert_width

    @property
    def softmax_scale(self) -> float:
        return self.q_head_dim**-0.5

    @property
    def kda_width(self) -> int:
        return self.kda_heads * self.kda_head_dim

    def is_kda(self, layer: int) -> bool:
        """Whether the 0-based ``layer`` is a KDA layer (else MLA)."""
        if layer + 1 in self.kda_layers:
            return True
        if layer + 1 in self.full_attn_layers:
            return False
        raise ValueError(f"layer {layer + 1} is in neither kda_layers nor full_attn_layers")


#: the sizes ``Config.extra`` may set, as ``workload_<name>``: the
#: deployment's, never a width
EXTRA_SIZES = dsv2.EXTRA_SIZES


def config_from_extra(extra: dict) -> KimiLinearConfig:
    """The config at the published widths with the ``workload_*`` sizes of
    ``Config.extra`` (:data:`EXTRA_SIZES`); ``workload_experts_held`` is a
    count n, the experts 0 … n − 1."""
    kw = {k: int(extra[f"workload_{k}"]) for k in EXTRA_SIZES if f"workload_{k}" in extra}
    if "workload_experts_held" in extra:
        kw["experts_held"] = tuple(range(int(extra["workload_experts_held"])))
    return KimiLinearConfig(**kw)


# --- parameters ---------------------------------------------------------------

layer_key = dsv2.layer_key


def param_shapes(cfg: KimiLinearConfig) -> dict:
    """Every leaf's dotted name → shape, in the tree's order of layers.
    Matrices are bf16 (stored (in, out); an expert group (held, in, out));
    the router's f32, and ``A_log`` (a head), ``dt_bias``, ``gb_bias`` and
    the norms' scales (names ending in ``norm``) f32.  ``wqkv`` holds q's,
    k's and v's columns, ``conv`` their filters (channels, 4); the SwiGLU
    leaves hold the gate's columns, then the up-projection's."""
    d, V = cfg.d_model, cfg.vocab
    Hk, K, hk, r = cfg.kda_heads, cfg.kda_head_dim, cfg.kda_width, cfg.gate_rank
    H = cfg.n_heads
    shapes = {"embed": (V, d)}
    for layer in range(cfg.n_layers):
        p = f"layers.{layer_key(layer)}."
        shapes[p + "attn_norm"] = (d,)
        if cfg.is_kda(layer):
            shapes.update({
                p + "wqkv": (d, 3 * hk), p + "conv": (3 * hk, cfg.short_conv),
                p + "wfa": (d, r), p + "wfb": (r, hk), p + "dt_bias": (hk,), p + "A_log": (Hk,),
                p + "wb": (d, Hk),
                p + "wga": (d, r), p + "wgb": (r, hk), p + "gb_bias": (hk,),
                p + "o_norm": (K,), p + "wo": (hk, d),
            })
        else:
            shapes.update({
                p + "wq": (d, H * cfg.q_head_dim),
                p + "wkv_a": (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                p + "kv_norm": (cfg.kv_lora_rank,),
                p + "wkv_b": (cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                p + "wo": (H * cfg.v_head_dim, d),
            })
        shapes[p + "ffn_norm"] = (d,)
        if layer < cfg.first_k_dense:
            shapes.update({p + "w_gate_up": (d, 2 * cfg.dense_width),
                           p + "w_down": (cfg.dense_width, d)})
        else:
            f, s, E, n = cfg.expert_width, cfg.shared_width, cfg.n_experts, cfg.n_held
            shapes.update({p + "router": (d, E),
                           p + "expert_gate_up": (n, d, 2 * f),
                           p + "expert_down": (n, f, d),
                           p + "shared_gate_up": (d, 2 * s),
                           p + "shared_down": (s, d)})
    shapes.update({"final_norm": (d,), "unembed": (d, V)})
    return shapes


def init_leaf(name: str, shape: tuple, std: float, generator: torch.Generator) -> torch.Tensor:
    """One leaf drawn from ``generator`` on its device: norms ones;
    ``A_log`` log U(1, 16); ``dt_bias`` softplus⁻¹ of exp U(ln 0.001, ln 0.1)
    (floored at 1e-4); ``gb_bias`` zeros; a convolution's filters U(−½, ½)
    (PyTorch's default for a depthwise filter of 4 taps); every other matrix
    N(0, std), bf16 but the router's."""
    dev = generator.device
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("norm"):
        return torch.ones(shape, dtype=torch.float32, device=dev)
    if leaf == "gb_bias":
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    u = torch.rand(shape, generator=generator, device=dev, dtype=torch.float32) \
        if leaf in ("A_log", "dt_bias", "conv") else None
    if leaf == "A_log":
        return torch.log(1.0 + 15.0 * u)
    if leaf == "dt_bias":
        dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3))).clamp(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    if leaf == "conv":
        return (u - 0.5).to(torch.bfloat16)
    t = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32) * std
    return t if leaf == "router" else t.to(torch.bfloat16)


def init_params(cfg: KimiLinearConfig, generator: torch.Generator) -> dict:
    """The parameter tree drawn leaf after leaf from ``generator`` on its
    device (:func:`init_leaf`)."""
    return workload._unflatten((name, init_leaf(name, shape, cfg.init_std, generator))
                               for name, shape in param_shapes(cfg).items())


# --- the layers ---------------------------------------------------------------

def _short_conv(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of x (B, T, C) bf16 along
    time with ``filters`` (C, 4): the convolution's bf16 output, SiLU in f32."""
    T, width = x.shape[1], filters.shape[1]
    y = F.conv1d(x.transpose(1, 2), filters[:, None, :], padding=width - 1,
                 groups=filters.shape[0])[..., :T]
    return F.silu(y.transpose(1, 2).float())


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


def _gated_norm(o: torch.Tensor, gate: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``RMSNorm(o) ⊙ scale ⊙ sigmoid(gate)`` over each head's last dim, f32."""
    return o * torch.rsqrt((o * o).mean(-1, keepdim=True) + eps) * scale * torch.sigmoid(gate)


def _kda(x, lp: dict, cfg: KimiLinearConfig) -> torch.Tensor:
    """Kimi Delta Attention of the normed (B, T, d) stream."""
    B, T, _ = x.shape
    H, K = cfg.kda_heads, cfg.kda_head_dim
    with record_function("kimi.kda"):
        with record_function("kimi.kda.proj"):
            qkv = torch.matmul(x, lp["wqkv"])
            f = torch.matmul(torch.matmul(x, lp["wfa"]), lp["wfb"])
            gate = torch.matmul(torch.matmul(x, lp["wga"]), lp["wgb"])
            b = torch.matmul(x, lp["wb"])
        with record_function("kimi.kda.conv"):
            q, k, v = _short_conv(qkv, lp["conv"]).view(B, T, 3, H, K).unbind(2)
            q, k = _l2norm(q), _l2norm(k)
            g = -torch.exp(lp["A_log"])[:, None] * F.softplus(
                f.float().view(B, T, H, K) + lp["dt_bias"].view(H, K))
            beta = torch.sigmoid(b.float())
        with record_function("kimi.kda.chunk"):
            o, _ = kernels.kda_chunk(q, k, v, g, beta, K**-0.5)
        with record_function("kimi.kda.out"):
            gate = (gate.float() + lp["gb_bias"]).view(B, T, H, K)
            o = _gated_norm(o, gate, lp["o_norm"], cfg.norm_eps).to(torch.bfloat16)
            return torch.matmul(o.reshape(B, T, H * K), lp["wo"])


def _route(x, router, cfg: KimiLinearConfig):
    """(gates (S, K) f32, experts (S, K)): the top-k of the sigmoid scores,
    renormalised over the k choices and scaled."""
    scores = torch.sigmoid(torch.matmul(x.float(), router))
    gates, experts = moe._top_k(scores, cfg.top_k)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return gates * cfg.routed_scaling_factor, experts


def _moe_ffn(x, lp: dict, slot_of, cfg: KimiLinearConfig) -> tuple:
    """(FFN output (B, T, d), tokens a held expert)."""
    B, T, d = x.shape
    x2 = x.reshape(B * T, d)
    with record_function("kimi.moe.route"):
        gates, experts = _route(x2, lp["router"], cfg)
    routed, counts = dsv2._held_experts(x2, gates, experts, slot_of, lp, cfg)
    return (routed + dsv2._shared(x2, lp)).view(B, T, d), counts


def _layer(h, lp: dict, cos, sin, slot_of, cfg: KimiLinearConfig, kda: bool, dense: bool) -> tuple:
    """One block: (h, tokens a held expert)."""
    x = workload._rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + (_kda(x, lp, cfg) if kda else dsv2._mla(x, lp, cos, sin, cfg))
    x = workload._rmsnorm(h, lp["ffn_norm"], cfg.norm_eps)
    if dense:
        counts = torch.zeros(cfg.n_held, dtype=torch.int64, device=h.device)
        return h + dsv2._dense_ffn(x, lp["w_gate_up"], lp["w_down"]), counts
    y, counts = _moe_ffn(x, lp, slot_of, cfg)
    return h + y, counts


class Constants:
    """What a step reads that is not a parameter, made once on the device
    (never inside a graph's capture): MLA's NoPE tables (cos 1, sin 0) for
    ``cfg.seq`` positions and the held-slot map."""

    def __init__(self, cfg: KimiLinearConfig, device):
        self.cos = torch.ones(cfg.seq, cfg.qk_rope_head_dim, dtype=torch.float32, device=device)
        self.sin = torch.zeros(cfg.seq, cfg.qk_rope_head_dim, dtype=torch.float32, device=device)
        slot_of = torch.full((cfg.n_experts,), cfg.n_held, dtype=torch.int64)
        slot_of[list(cfg.experts_held)] = torch.arange(cfg.n_held)
        self.slot_of = slot_of.to(device)


def forward(params: dict, tokens: torch.Tensor, cfg: KimiLinearConfig, consts: Constants) -> tuple:
    """tokens (B, T) → (logits (B, T, vocab) f32, tokens a held expert
    summed over the layers)."""
    T = tokens.shape[1]
    cos, sin = consts.cos[:T], consts.sin[:T]
    h = F.embedding(tokens, params["embed"])
    counts = []
    for layer in range(cfg.n_layers):
        lp = params["layers"][layer_key(layer)]
        # nothing draws random numbers: no RNG state to stash (a CUDA
        # graph's capture refuses the stash)
        h, c = checkpoint(_layer, h, lp, cos, sin, consts.slot_of, cfg, cfg.is_kda(layer),
                          layer < cfg.first_k_dense, use_reentrant=False,
                          preserve_rng_state=False)
        counts.append(c)
    h = workload._rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(h, params["unembed"]).float()
    return logits, torch.stack(counts).sum(0)


def loss_fn(params: dict, tokens: torch.Tensor, cfg: KimiLinearConfig, consts: Constants) -> tuple:
    """(next-token cross-entropy, tokens a held expert)."""
    logits, counts = forward(params, tokens[:, :-1], cfg, consts)
    ce = F.cross_entropy(logits.reshape(-1, cfg.vocab), tokens[:, 1:].reshape(-1))
    return ce, counts


# --- training -----------------------------------------------------------------

#: the routing counters and their series are DeepSeek-V2-Lite's
routing_counters = dsv2.routing_counters
load_stats = dsv2.load_stats


def make_optimizer(params: dict, cfg: KimiLinearConfig) -> torch.optim.AdamW:
    """The workload's AdamW (``workload._adamw``) over every leaf."""
    return workload._adamw(workload.leaves(params), cfg)


def make_train_state(cfg: KimiLinearConfig, generator: torch.Generator):
    """(params, optimizer); the parameters require grad."""
    params = init_params(cfg, generator)
    for p in workload.leaves(params):
        p.requires_grad_(True)
    return params, make_optimizer(params, cfg)


def train_step(params: dict, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
               cfg: KimiLinearConfig, consts: Constants, counters: torch.Tensor) -> torch.Tensor:
    """One step, in place, as ``workload.train_step``; adds the step's
    routing counts to ``counters``.  Returns the loss before the update,
    unread."""
    optimizer.zero_grad(set_to_none=True)
    loss, counts = loss_fn(params, tokens, cfg, consts)
    loss.backward()
    optimizer.step()
    with torch.no_grad():
        counters[:-1] += counts
        counters[-1] += 1
    return loss.detach()


def make_train_step(cfg: KimiLinearConfig, device, counters: torch.Tensor):
    """``step(params, optimizer, tokens)``, ``graphed.compiled``: on a GPU
    one CUDA graph, captured at its first call; on the CPU eager.  On a GPU
    the norm's, the dispatch's, MLA's and KDA's kernels are built (or
    loaded) first, the four nvcc runs side by side."""
    if torch.device(device).type == "cuda":
        kernels.build_kernels((*kernels.NORM_KERNELS, *kernels.MOE_KERNELS, *kernels.MLA_KERNELS,
                               *kernels.KDA_KERNELS))
    consts = Constants(cfg, device)
    return compiled(lambda p, o, t: train_step(p, o, t, cfg, consts, counters))


def kda_chunk_flops(cfg: KimiLinearConfig, positions: int, chunk: int = kernels.KDA_CHUNK) -> float:
    """Forward FLOPs of the chunked products of one KDA layer over
    ``positions`` positions, a head and chunk: k·kᵀ and q·kᵀ, the
    triangular solve for w and u, w·S, kdᵀ·v_new, q·S and Aqk·v_new."""
    C, Dk, Dv = chunk, cfg.kda_head_dim, cfg.kda_head_dim
    per_chunk = 2 * 2 * C * C * Dk + C * C * (Dk + Dv) + 3 * 2 * C * Dk * Dv + 2 * C * C * Dv
    return per_chunk * positions / C * cfg.kda_heads


def flops_per_step(cfg: KimiLinearConfig, routed_tokens_per_step: float | None = None) -> float:
    """Model FLOPs of a train step: 3 × the forward's products (the
    recompute not counted); causal attention counted over its T(T+1)/2
    pairs; KDA by its projections, its convolutions and its chunked
    products at chunk 64 (:func:`kda_chunk_flops`); the routed experts by
    ``routed_tokens_per_step`` (held (token, choice) pairs summed over the
    layers; by default the uniform share top_k · n_held / n_experts of every
    token)."""
    B, T = cfg.batch, cfg.seq - 1
    d, S = cfg.d_model, cfg.batch * (cfg.seq - 1)
    hk, r, Hk = cfg.kda_width, cfg.gate_rank, cfg.kda_heads
    H, nope, rope, vd, lat = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                              cfg.v_head_dim, cfg.kv_lora_rank)
    kda_proj = d * 3 * hk + 2 * (d * r + r * hk) + d * Hk + hk * d
    kda = 2 * S * kda_proj + 2 * S * 3 * hk * cfg.short_conv + kda_chunk_flops(cfg, S)
    mla_proj = d * H * (nope + rope) + d * (lat + rope) + lat * H * (nope + vd) + H * vd * d
    mla = 2 * S * mla_proj + 2 * B * H * (T * (T + 1) // 2) * (nope + rope + vd)
    n_kda = sum(cfg.is_kda(i) for i in range(cfg.n_layers))
    n_moe = cfg.n_layers - cfg.first_k_dense
    dense = 2 * S * 3 * d * cfg.dense_width
    shared = 2 * S * (3 * d * cfg.shared_width + d * cfg.n_experts)
    if routed_tokens_per_step is None:
        routed_tokens_per_step = S * n_moe * cfg.top_k * cfg.n_held / cfg.n_experts
    routed = 2 * routed_tokens_per_step * 3 * d * cfg.expert_width
    fwd = (n_kda * kda + (cfg.n_layers - n_kda) * mla + cfg.first_k_dense * dense
           + n_moe * shared + routed + 2 * S * d * cfg.vocab)
    return 3.0 * fwd
