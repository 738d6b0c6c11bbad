"""Model FLOPs of a train step of Kimi-Linear-48B-A3B on the expert share of
one GPU, and the least work of one call of its KDA kernels, counted from the
configuration's shapes (``configs/kimi-linear-ep16.json``'s keys): frozen
here, beside the benchmark, so that a change to the program cannot move a
denominator of ``train.mfu`` or of the KDA rooflines.

A step is 3 × the forward's products (forward and backward; the forward
that the per-layer recompute repeats is not counted).  The forward's
products, over the ``batch · (seq − 1)`` positions the model sees:

- KDA: the q/k/v, decay (two low-rank factors), β, output-gate (two factors)
  and o projections, the short convolutions (4 taps a channel), and the
  chunked gated delta rule by its products at chunk 64, a head and chunk:
  k·kᵀ and q·kᵀ (2·C²·Dk each), the triangular solve for w and u
  (C²·(Dk + Dv)), w·S, kdᵀ·v_new and q·S (2·C·Dk·Dv each) and Aqk·v_new
  (2·C²·Dv);
- MLA: the q, kv_a, kv_b and o projections, and causal attention over its
  T(T + 1)/2 (query, key) pairs a sequence and head, q·k at ``nope + rope``
  and p·v at ``v_head_dim``;
- the dense layer's SwiGLU (gate, up, down);
- each MoE layer's router and shared expert on every position, and its held
  experts on the (position, choice) pairs routed to them: the pairs the
  window's counters saw, or, without them, the uniform share ``top_k ·
  held / routed`` of every position;
- the unembedding over the vocabulary slice.

3.4846 GFLOP a position forward at the uniform share, 342.51 TFLOP a step
at batch 4 × seq 8192 (8,191 positions a sequence).

A KDA call is one layer's chunked rule over the step's positions: a
forward (the forward pass and the recompute each make one a KDA layer) or
a backward.  Its least work, whatever implements it:

- bytes: the inputs and outputs in bf16, each once; forward q, k, v, the
  decay's and β's pre-activations read and o written; backward those inputs
  and o's gradient read, and their gradients written;
- FLOPs: the state products alone, which every chunk size does: q·S, the
  state's prediction of v and its update, 2·Dk·Dv a position and head each
  (forward), twice that (backward).

At the cell's shapes a forward call's bound is its bytes, 1,344.1 MB, 0.4012
ms at 3.35 TB/s (its products, 103.07 GFLOP, take 0.104 ms at 989 TFLOP/s); a
backward call's 2,419.8 MB, 0.7223 ms.
"""

from __future__ import annotations

from gpubench import peaks

#: the chunk the products are counted at
CHUNK = 64


def positions(m: dict, t: dict) -> int:
    return t["batch"] * (t["seq"] - 1)


def kda_layers(m: dict) -> int:
    return len([n for n in m["linear_attn_config"]["kda_layers"] if n <= m["num_hidden_layers"]])


def uniform_routed_pairs(m: dict, t: dict) -> float:
    """Held (position, choice) pairs a step, summed over the MoE layers, at
    the uniform share."""
    n_moe = m["num_hidden_layers"] - m["first_k_dense_replace"]
    share = m["num_experts_per_token"] * m["num_experts"] / m["num_experts_published"]
    return positions(m, t) * n_moe * share


def kda_chunk_flops(m: dict, positions_: int) -> float:
    """Forward FLOPs of one KDA layer's chunked products over ``positions_``."""
    la = m["linear_attn_config"]
    C, Dk, Dv = CHUNK, la["head_dim"], la["head_dim"]
    per_chunk = 2 * 2 * C * C * Dk + C * C * (Dk + Dv) + 3 * 2 * C * Dk * Dv + 2 * C * C * Dv
    return per_chunk * positions_ / C * la["num_heads"]


def train_flops_per_step(m: dict, t: dict, routed_pairs: "float | None" = None) -> float:
    """Model FLOPs of one train step; ``routed_pairs`` the held (position,
    choice) pairs of the step summed over the layers."""
    B, T = t["batch"], t["seq"] - 1
    S = B * T
    d, L = m["hidden_size"], m["num_hidden_layers"]
    la = m["linear_attn_config"]
    Hk, K = la["num_heads"], la["head_dim"]
    hk, rank = Hk * K, K
    kda_proj = d * 3 * hk + 2 * (d * rank + rank * hk) + d * Hk + hk * d
    kda = 2 * S * kda_proj + 2 * S * 3 * hk * la["short_conv_kernel_size"] + kda_chunk_flops(m, S)
    H, nope, rp = m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    vd, r = m["v_head_dim"], m["kv_lora_rank"]
    mla_proj = d * H * (nope + rp) + d * (r + rp) + r * H * (nope + vd) + H * vd * d
    mla = 2 * S * mla_proj + 2 * B * H * (T * (T + 1) // 2) * (nope + rp + vd)
    n_kda, dense_layers = kda_layers(m), m["first_k_dense_replace"]
    dense = 2 * S * 3 * d * m["intermediate_size"]
    shared = 2 * S * (3 * d * m["num_shared_experts"] * m["moe_intermediate_size"]
                      + d * m["num_experts_published"])
    if routed_pairs is None:
        routed_pairs = uniform_routed_pairs(m, t)
    routed = 2 * routed_pairs * 3 * d * m["moe_intermediate_size"]
    forward = (n_kda * kda + (L - n_kda) * mla + dense_layers * dense + (L - dense_layers) * shared
               + routed + 2 * S * d * m["vocab_size"])
    return 3.0 * forward


def kda_call_bytes(m: dict, t: dict, backward: bool) -> int:
    """Least bytes of one KDA call: its bf16 inputs and outputs, each once."""
    la = m["linear_attn_config"]
    S, H = positions(m, t), la["num_heads"]
    wide, narrow = S * H * la["head_dim"], S * H  # q, k, v, the decay's, o; β's
    if backward:  # read the inputs and o's gradient, write the inputs' gradients
        return 2 * ((4 * wide + narrow + wide) + (4 * wide + narrow))
    return 2 * (4 * wide + narrow + wide)


def kda_call_flops(m: dict, t: dict, backward: bool) -> float:
    """The state products of one KDA call: q·S, the prediction of v and the
    update, 2·Dk·Dv a position and head each; the backward twice that."""
    la = m["linear_attn_config"]
    forward = 3 * 2 * positions(m, t) * la["num_heads"] * la["head_dim"] ** 2
    return 2 * forward if backward else forward


def kda_call_bound_s(m: dict, t: dict, backward: bool) -> float:
    """The least time of one KDA call on an H100 SXM5: the larger of its
    bytes over the HBM rate and its FLOPs over the bf16 peak."""
    return max(kda_call_bytes(m, t, backward) / peaks.HBM_BYTES_PER_S,
               kda_call_flops(m, t, backward) / (peaks.BF16_TFLOPS * 1e12))


def kda_calls_per_step(m: dict) -> dict:
    """KDA calls a step: a forward for the forward pass and one for the
    recompute, and a backward, a KDA layer."""
    n = kda_layers(m)
    return {"forward": 2 * n, "backward": n}
