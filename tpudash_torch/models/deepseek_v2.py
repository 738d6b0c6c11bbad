"""DeepSeek-V2-Lite (arXiv:2405.04434; the released ``config.json`` of
``deepseek-ai/DeepSeek-V2-Lite``), trained as the workload source's second
model on the expert share of one GPU.

The block is pre-norm: ``h += MLA(RMSNorm(h)); h += FFN(RMSNorm(h))``, then
a final RMSNorm, the untied unembedding over the vocabulary (or the slice
of it this GPU holds) and next-token cross-entropy.  Each layer is
recomputed in backward, as ``workload.forward`` does.

- **MLA**, training form (no absorption, no q compression):
  ``q = x·W_q`` → heads of ``nope + rope``; ``kv_a = x·W_kv_a`` → the
  ``kv_lora_rank``-wide latent ``c`` (RMSNorm'd) and one ``rope``-wide key
  shared by every head; ``c·W_kv_b`` → per head ``k_nope`` and ``v``.  RoPE
  takes the published code's interleaved pairs (the rope dims regrouped
  (n/2, 2) → (2, n/2) before ``rotate_half``) at YaRN's frequencies;
  causal attention at ``(nope + rope)**-0.5 · mscale²`` runs fused (on
  GPUs cuDNN's or the memory-efficient kernel, never one that keeps the
  T×T scores), then ``o·W_o``.  Between the projections and attention,
  ``kernels.mla_qk_rope`` builds q = [nope | RoPE(rope)], k = [k_nope |
  the shared key's RoPE on every head] and v (``kv``'s view): on GPUs one
  hand-written kernel each way (``ops/csrc/mla_rope.cu``), which reads
  the projections and writes q and k once, and backward writes the
  gradients of q's and kv's projections and of the shared key once; on
  the CPU the chain of :func:`_rope`, cats and a split under autograd.
- **FFN**: the first ``first_k_dense`` layers a SwiGLU; the others
  ``shared(x) + Σ_{j ≤ top_k, e_j held here} g_j · expert_{e_j}(x)`` with
  ``g = softmax(x·W_router)`` over every routed expert in f32 and the top
  ``top_k`` by ``moe._top_k``'s stable order.  The layer is told which
  experts it holds (``experts_held``): it routes over all of them and
  computes only its own experts' part, with no stand-in for the others.
  The dispatch is index-based and drops no token: the (token, choice) pairs
  are sorted stably by held expert into a buffer with room for every
  token's held choices, ``cap = S·min(top_k, n_held)`` rows, of which the
  first ``n_valid`` (the last of the experts' end offsets) are valid; the
  tokens are gathered into it, the experts' SwiGLUs run as two grouped
  products over the sorted rows (``torch._grouped_mm`` with each expert's
  end offset on the device), and each token adds its experts' outputs
  times its gates, token-major (``pos``, the inverse of the sort, gives
  the row of each of its choices).  On GPUs the gather, the SwiGLU between
  the products and the gated combine, and their backwards, are hand-written
  kernels (``ops/csrc/moe_dispatch.cu``) that read ``n_valid`` on the
  device and touch valid rows only; there is no dropped row and no atomic
  add.  Every shape is static, so the step is one CUDA graph.
- **Loss**: cross-entropy plus ``aux_loss_alpha`` times the sequence-wise
  expert-balance loss of every MoE layer (the released code's
  ``seq_aux``), over all the router's outputs.  The released code leaves
  the balance term out of the loss's value and adds its gradient; here it
  is part of both.

Precision: bf16 weights and activations, each product's f32 sums rounded
to bf16; the router's weights f32 (as ``moe.py`` keeps them; the released
code keeps them in the model's dtype and computes the gate in f32);
RMSNorm, RoPE, the attention softmax, SwiGLU's gate (rounded once), the
router's softmax, the gates' combine (each gate applied in f32 to the down
product's output, the sum over a token's choices in f32 in choice order,
rounded once to bf16 before the shared experts' output is added) and the
loss in f32; norms' scales f32.  The logits are
the unembedding product rounded to bf16, then f32, as the released code's
``lm_head(h).float()``.

Spans (``torch.profiler.record_function``): ``dsv2.mla``,
``dsv2.moe.route``, ``dsv2.moe.dispatch``, ``dsv2.moe.experts``,
``dsv2.moe.combine``, ``dsv2.moe.shared``.  Counters: the train step adds
the tokens routed to each held expert, summed over the layers, and one
step into a device tensor (:func:`routing_counters`), inside the graph.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from tpudash_torch.models import moe, workload
from tpudash_torch.models.graphed import compiled
from tpudash_torch.ops import kernels

#: the workload source's name of the model
NAME = "deepseek-v2-lite"


@dataclass(frozen=True)
class DeepseekV2Config:
    """The published widths of DeepSeek-V2-Lite, with the vocabulary slice
    and the experts held on one GPU of an ep 8 deployment."""

    vocab: int = 12800
    d_model: int = 2048
    n_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    n_layers: int = 27
    first_k_dense: int = 1
    dense_width: int = 10944
    #: the router's width: every routed expert of the layer
    n_experts: int = 64
    #: the experts this GPU holds, in the router's numbering
    experts_held: tuple = tuple(range(8))
    top_k: int = 6
    expert_width: int = 1408
    n_shared_experts: int = 2
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    aux_loss_alpha: float = 0.001
    #: RMSNorm's eps (the released config's rms_norm_eps)
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    init_std: float = 0.006
    seq: int = 4096
    batch: int = 8
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
        m = yarn_mscale(self.rope_factor, self.mscale_all_dim)
        return self.q_head_dim**-0.5 * m * m


#: the sizes ``Config.extra`` may set, as ``workload_<name>``: the
#: deployment's, never a width
EXTRA_SIZES = ("vocab", "n_layers", "seq", "batch")


def config_from_extra(extra: dict) -> DeepseekV2Config:
    """The config at the published widths with the ``workload_*`` sizes of
    ``Config.extra`` (:data:`EXTRA_SIZES`); ``workload_experts_held`` is a
    count n, the experts 0 … n − 1."""
    kw = {k: int(extra[f"workload_{k}"]) for k in EXTRA_SIZES if f"workload_{k}" in extra}
    if "workload_experts_held" in extra:
        kw["experts_held"] = tuple(range(int(extra["workload_experts_held"])))
    return DeepseekV2Config(**kw)


# --- YaRN ---------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """``0.1·m·ln s + 1`` (1 for s ≤ 1), the released code's ``yarn_get_mscale``."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """The rope dims' inverse frequencies, f32 (rope/2,): the extrapolated
    ``θ^(-2i/n)`` below the correction range that β_fast and β_slow give
    over the original positions, the interpolated ones (÷ factor) above
    it, and a linear ramp between."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / base**exps
    inter = 1.0 / (cfg.rope_factor * base**exps)
    low = max(math.floor(_correction_dim(cfg.beta_fast, dim, base,
                                         cfg.original_max_position_embeddings)), 0)
    high = min(math.ceil(_correction_dim(cfg.beta_slow, dim, base,
                                         cfg.original_max_position_embeddings)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp  # 1 where the frequency is extrapolated
    return inter * (1 - keep) + extra * keep


def rope_tables(cfg: DeepseekV2Config, positions: int, device) -> tuple:
    """(cos, sin), f32 (positions, rope), scaled by ``mscale(factor,
    mscale) / mscale(factor, mscale_all_dim)`` (1 at the published
    settings)."""
    freqs = torch.outer(torch.arange(positions, dtype=torch.float32), yarn_inv_freq(cfg))
    emb = torch.cat([freqs, freqs], dim=-1)
    m = yarn_mscale(cfg.rope_factor, cfg.mscale) / yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim)
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE over the last dim of ``x`` (..., T, [H,] rope) in f32, rounded
    to bf16: the interleaved pairs regrouped first, as the released
    ``apply_rotary_pos_emb`` does.  ``cos``/``sin`` are (T, 1 or more
    broadcast dims..., rope)."""
    n = x.shape[-1]
    x = x.float().unflatten(-1, (n // 2, 2)).transpose(-1, -2).flatten(-2)
    rotated = torch.cat([-x[..., n // 2:], x[..., : n // 2]], dim=-1)
    return (x * cos + rotated * sin).to(torch.bfloat16)


# --- parameters ---------------------------------------------------------------

def layer_key(layer: int) -> str:
    return f"{layer:02d}"


def param_shapes(cfg: DeepseekV2Config) -> dict:
    """Every leaf's dotted name → shape, in the tree's order of layers.
    Matrices are bf16 (stored (in, out); an expert group (held, in, out)),
    except the router's, f32 as ``moe.py`` keeps it; norms' scales (names
    ending in ``norm``) f32.  The SwiGLU leaves hold the gate's columns,
    then the up-projection's."""
    d, H, V = cfg.d_model, cfg.n_heads, cfg.vocab
    shapes = {"embed": (V, d)}
    for layer in range(cfg.n_layers):
        p = f"layers.{layer_key(layer)}."
        shapes.update({
            p + "attn_norm": (d,),
            p + "wq": (d, H * cfg.q_head_dim),
            p + "wkv_a": (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            p + "kv_norm": (cfg.kv_lora_rank,),
            p + "wkv_b": (cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            p + "wo": (H * cfg.v_head_dim, d),
            p + "ffn_norm": (d,),
        })
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


def init_params(cfg: DeepseekV2Config, generator: torch.Generator) -> dict:
    """The parameter tree drawn from ``generator`` on its device: every
    matrix N(0, ``init_std``) (the paper's 0.006), bf16 but the router's,
    norms ones."""
    dev = generator.device
    pairs = []
    for name, shape in param_shapes(cfg).items():
        if name.endswith("norm"):
            t = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            t = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
            t = t * cfg.init_std
            if not name.endswith("router"):
                t = t.to(torch.bfloat16)
        pairs.append((name, t))
    return workload._unflatten(pairs)


# --- the layers ---------------------------------------------------------------

def _attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Causal attention over head-major (B, H, T, ·) bf16 tensors, f32
    softmax inside; on GPUs restricted to the fused kernels, so that no
    T×T score tensor exists."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)
    return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)


def _mla(x, lp: dict, cos, sin, cfg: DeepseekV2Config) -> torch.Tensor:
    """Multi-head latent attention of the normed (B, T, d) stream.  ``cfg``
    gives the widths, ``norm_eps`` and ``softmax_scale``; Kimi-Linear's
    config passes as well (its NoPE layers take tables of cos 1, sin 0)."""
    B, T, _ = x.shape
    H, nope, rope, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    with record_function("dsv2.mla"):
        q = torch.matmul(x, lp["wq"]).view(B, T, H, nope + rope)
        kv_a = torch.matmul(x, lp["wkv_a"])
        c = workload._rmsnorm(kv_a[..., :r].contiguous(), lp["kv_norm"], cfg.norm_eps)
        kv = torch.matmul(c, lp["wkv_b"]).view(B, T, H, nope + cfg.v_head_dim)
        q, k, v = kernels.mla_qk_rope(q, kv, kv_a, cos, sin)
        o = _attention_core(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            cfg.softmax_scale)
        return torch.matmul(o.transpose(1, 2).reshape(B, T, H * cfg.v_head_dim), lp["wo"])


def _swiglu(h: torch.Tensor) -> torch.Tensor:
    """``silu(gate)·up`` of a product holding the gate's columns then the
    up-projection's, in f32, rounded once."""
    gate, up = h.chunk(2, dim=-1)
    return (F.silu(gate.float()) * up.float()).to(torch.bfloat16)


def _dense_ffn(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_swiglu(torch.matmul(x, w_gate_up)), w_down)


def _shared(x, lp: dict) -> torch.Tensor:
    """The shared experts, one SwiGLU of their summed width, on every token."""
    with record_function("dsv2.moe.shared"):
        return _dense_ffn(x, lp["shared_gate_up"], lp["shared_down"])


def _route(x, router, cfg: DeepseekV2Config):
    """(router probabilities (S, E) f32, gates (S, K) f32, experts (S, K))."""
    probs = torch.softmax(torch.matmul(x.float(), router), dim=-1)
    gates, experts = moe._top_k(probs, cfg.top_k)
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(-1, keepdim=True)
    return probs, gates * cfg.routed_scaling_factor, experts


def seq_balance_loss(probs: torch.Tensor, experts: torch.Tensor, batch: int,
                     cfg: DeepseekV2Config) -> torch.Tensor:
    """The released code's ``seq_aux`` term before its α: for each
    sequence, Σ_e (its choices of e ÷ (T·K/E)) · (its mean probability of
    e); the mean over the sequences.  Over every routed expert."""
    E, K = cfg.n_experts, cfg.top_k
    p = probs.view(batch, -1, E)
    T = p.shape[1]
    load = torch.zeros(batch, E, dtype=torch.float32, device=probs.device)
    load.scatter_add_(1, experts.reshape(batch, -1),
                      torch.ones(batch, T * K, dtype=torch.float32, device=probs.device))
    load = load / (T * K / E)
    return (load * p.mean(1)).sum(1).mean()


def dispatch_layout(experts: torch.Tensor, slot_of: torch.Tensor, n_held: int) -> tuple:
    """Where the (token, choice) pairs of ``experts`` (S, K) lie in the
    buffer sorted stably by held slot (``slot_of`` maps each routed expert
    to its slot, or to ``n_held`` where another GPU holds it): (tokens a
    held expert (n_held,) int64, each expert's end offset (n_held,) int32,
    the valid rows ``offs[-1:]``, ``pos`` (S, K) int32 the row of each
    pair).  A pair is held iff its row is below the valid count."""
    S, K = experts.shape
    slots = slot_of[experts].reshape(-1)  # (S·K,)
    counts = torch.zeros(n_held + 1, dtype=torch.int64, device=experts.device)
    counts.scatter_add_(0, slots, torch.ones_like(slots))
    offs = counts[:n_held].cumsum(0).to(torch.int32)
    order = torch.sort(slots, stable=True).indices
    pos = torch.empty(S * K, dtype=torch.int32, device=experts.device)
    pos.scatter_(0, order, torch.arange(S * K, dtype=torch.int32, device=experts.device))
    return counts[:n_held], offs, offs[-1:], pos.view(S, K)


def _held_experts(x, gates, experts, slot_of, lp: dict, cfg: DeepseekV2Config) -> tuple:
    """The held experts' part of the routed FFN for the tokens x (S, d):
    (y (S, d) bf16, tokens a held expert (n_held,) int64).

    The S·K (token, choice) pairs sort stably by held slot
    (:func:`dispatch_layout`); the first ``cap = S·min(K, n_held)`` sorted
    pairs have room for every held pair, and the valid ones are the first
    Σ counts.  The gather, the SwiGLU and the combine
    (``kernels.moe_gather``, ``moe_swiglu``, ``moe_combine``) touch valid
    rows only, in both directions of autograd; the grouped products compute
    only their groups, so no row past them is read."""
    S, K, n = x.shape[0], cfg.top_k, cfg.n_held
    cap = S * min(K, n)
    with record_function("dsv2.moe.dispatch"):
        counts, offs, n_valid, pos = dispatch_layout(experts, slot_of, n)
        xs = kernels.moe_gather(x, pos, n_valid, cap)
    with record_function("dsv2.moe.experts"):
        h = kernels.moe_swiglu(torch._grouped_mm(xs, lp["expert_gate_up"], offs=offs), n_valid)
        ys = torch._grouped_mm(h, lp["expert_down"], offs=offs)
    with record_function("dsv2.moe.combine"):
        return kernels.moe_combine(ys, gates, pos, n_valid), counts


def _moe_ffn(x, lp: dict, slot_of, cfg: DeepseekV2Config) -> tuple:
    """(FFN output (B, T, d), balance loss, tokens a held expert)."""
    B, T, d = x.shape
    x2 = x.reshape(B * T, d)
    with record_function("dsv2.moe.route"):
        probs, gates, experts = _route(x2, lp["router"], cfg)
        aux = seq_balance_loss(probs, experts, B, cfg)
    routed, counts = _held_experts(x2, gates, experts, slot_of, lp, cfg)
    return (routed + _shared(x2, lp)).view(B, T, d), aux, counts


def _layer(h, lp: dict, cos, sin, slot_of, cfg: DeepseekV2Config, dense: bool) -> tuple:
    """One block: (h, balance loss, tokens a held expert)."""
    h = h + _mla(workload._rmsnorm(h, lp["attn_norm"]), lp, cos, sin, cfg)
    x = workload._rmsnorm(h, lp["ffn_norm"])
    if dense:
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        counts = torch.zeros(cfg.n_held, dtype=torch.int64, device=h.device)
        return h + _dense_ffn(x, lp["w_gate_up"], lp["w_down"]), zero, counts
    y, aux, counts = _moe_ffn(x, lp, slot_of, cfg)
    return h + y, aux, counts


class Constants:
    """What a step reads that is not a parameter, made once on the device
    (never inside a graph's capture): the rope tables for ``cfg.seq``
    positions and the held-slot map."""

    def __init__(self, cfg: DeepseekV2Config, device):
        self.cos, self.sin = rope_tables(cfg, cfg.seq, device)
        slot_of = torch.full((cfg.n_experts,), cfg.n_held, dtype=torch.int64)
        slot_of[list(cfg.experts_held)] = torch.arange(cfg.n_held)
        self.slot_of = slot_of.to(device)


def forward(params: dict, tokens: torch.Tensor, cfg: DeepseekV2Config, consts: Constants) -> tuple:
    """tokens (B, T) → (logits (B, T, vocab) f32, the layers' summed
    balance loss, tokens a held expert summed over the layers)."""
    T = tokens.shape[1]
    cos, sin = consts.cos[:T], consts.sin[:T]
    h = F.embedding(tokens, params["embed"])
    aux, counts = [], []
    for layer in range(cfg.n_layers):
        lp = params["layers"][layer_key(layer)]
        # nothing draws random numbers: no RNG state to stash (a CUDA
        # graph's capture refuses the stash)
        h, a, c = checkpoint(_layer, h, lp, cos, sin, consts.slot_of, cfg,
                             layer < cfg.first_k_dense, use_reentrant=False,
                             preserve_rng_state=False)
        aux.append(a)
        counts.append(c)
    h = workload._rmsnorm(h, params["final_norm"])
    logits = torch.matmul(h, params["unembed"]).float()
    return logits, torch.stack(aux).sum(), torch.stack(counts).sum(0)


def loss_fn(params: dict, tokens: torch.Tensor, cfg: DeepseekV2Config, consts: Constants) -> tuple:
    """(next-token cross-entropy + α · balance loss, tokens a held expert)."""
    logits, aux, counts = forward(params, tokens[:, :-1], cfg, consts)
    ce = F.cross_entropy(logits.reshape(-1, cfg.vocab), tokens[:, 1:].reshape(-1))
    return ce + cfg.aux_loss_alpha * aux, counts


# --- training -----------------------------------------------------------------

def routing_counters(cfg: DeepseekV2Config, device) -> torch.Tensor:
    """The device counters a train step adds to: tokens routed to each held
    expert, summed over the layers, then the steps taken (n_held + 1,)."""
    return torch.zeros(cfg.n_held + 1, dtype=torch.int64, device=device)


def make_optimizer(params: dict, cfg: DeepseekV2Config) -> torch.optim.AdamW:
    """The workload's AdamW (``workload._adamw``) over every leaf."""
    return workload._adamw(workload.leaves(params), cfg)


def make_train_state(cfg: DeepseekV2Config, generator: torch.Generator):
    """(params, optimizer); the parameters require grad."""
    params = init_params(cfg, generator)
    for p in workload.leaves(params):
        p.requires_grad_(True)
    return params, make_optimizer(params, cfg)


def train_step(params: dict, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
               cfg: DeepseekV2Config, consts: Constants, counters: torch.Tensor) -> torch.Tensor:
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


def make_train_step(cfg: DeepseekV2Config, device, counters: torch.Tensor):
    """``step(params, optimizer, tokens)``, ``graphed.compiled``: on a GPU
    one CUDA graph, captured at its first call; on the CPU eager.  On a GPU
    the norm's, the dispatch's and MLA's kernels are built (or loaded)
    first, the three nvcc runs side by side."""
    if torch.device(device).type == "cuda":
        kernels.build_kernels((*kernels.NORM_KERNELS, *kernels.MOE_KERNELS, *kernels.MLA_KERNELS))
    consts = Constants(cfg, device)
    return compiled(lambda p, o, t: train_step(p, o, t, cfg, consts, counters))


def dispatch_rows(cfg: DeepseekV2Config) -> int:
    """Rows of the MoE layers' sorted buffers a step, summed over the
    layers: ``S·min(top_k, n_held)`` a layer, S = batch · (seq − 1)."""
    S = cfg.batch * (cfg.seq - 1)
    return S * min(cfg.top_k, cfg.n_held) * (cfg.n_layers - cfg.first_k_dense)


def load_stats(counters: list, steps: int, cfg: DeepseekV2Config) -> dict:
    """From two readings of :func:`routing_counters` apart (host lists), the
    runner's series: tokens a held expert a step (summed over the layers),
    the busiest held expert over the mean of them, and the share of the
    sorted buffers' rows that were valid (the rows the dispatch kernels
    touch, of :func:`dispatch_rows`)."""
    per = [c / steps for c in counters] if steps else [0.0] * len(counters)
    mean = sum(per) / len(per) if per else 0.0
    rows = dispatch_rows(cfg)
    return {"moe_tokens_per_held_expert": per,
            "moe_load_max_over_mean": max(per) / mean if mean > 0 else 0.0,
            "moe_valid_row_share": sum(per) / rows if rows > 0 else 0.0}


def flops_per_step(cfg: DeepseekV2Config, routed_tokens_per_step: float | None = None) -> float:
    """Model FLOPs of a train step: 3 × the forward's products (the
    recompute not counted), causal attention counted over its
    T(T+1)/2 pairs, the routed experts by ``routed_tokens_per_step``
    (held (token, choice) pairs summed over the layers; by default the
    uniform share top_k · n_held / n_experts of every token)."""
    B, T = cfg.batch, cfg.seq - 1
    d, H = cfg.d_model, cfg.n_heads
    S = B * T
    r, nope, rope, vd = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    proj = d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd) + H * vd * d
    attn = 2 * S * proj + 2 * B * H * (T * (T + 1) // 2) * (nope + rope + vd)
    n_moe = cfg.n_layers - cfg.first_k_dense
    dense = 2 * S * 3 * d * cfg.dense_width
    shared = 2 * S * (3 * d * cfg.shared_width + d * cfg.n_experts)
    if routed_tokens_per_step is None:
        routed_tokens_per_step = S * n_moe * cfg.top_k * cfg.n_held / cfg.n_experts
    routed = 2 * routed_tokens_per_step * 3 * d * cfg.expert_width
    fwd = (cfg.n_layers * attn + cfg.first_k_dense * dense + n_moe * shared + routed
           + 2 * S * d * cfg.vocab)
    return 3.0 * fwd
