"""Model FLOPs of a train step of DeepSeek-V2-Lite on the expert share of
one GPU, counted from the configuration's shapes (``configs/
deepseek-v2-lite-ep8.json``'s keys): frozen here, beside the benchmark, so
that a change to the program cannot move the denominator of ``train.mfu``.

A step is 3 × the forward's products (forward and backward; the forward
that the per-layer recompute repeats is not counted).  The forward's
products, over the ``batch · (seq − 1)`` positions the model sees:

- MLA: the q, kv_a, kv_b and o projections, and causal attention over its
  T(T + 1)/2 (query, key) pairs a sequence and head, q·k at
  ``nope + rope`` and p·v at ``v_head_dim``;
- the dense layers' SwiGLU (gate, up, down);
- each MoE layer's router and shared experts on every position, and its
  held experts on the (position, choice) pairs routed to them: the pairs
  the window's counters saw, or, without them, the uniform share
  ``top_k · held / routed`` of every position;
- the unembedding over the vocabulary slice.

2.7402 GFLOP a position forward at the uniform share, 269.31 TFLOP a step
at batch 8 × seq 4096 (4,095 positions a sequence).
"""

from __future__ import annotations


def positions(m: dict, t: dict) -> int:
    return t["batch"] * (t["seq"] - 1)


def uniform_routed_pairs(m: dict, t: dict) -> float:
    """Held (position, choice) pairs a step, summed over the MoE layers, at
    the uniform share."""
    n_moe = m["num_hidden_layers"] - m["first_k_dense_replace"]
    share = m["num_experts_per_tok"] * m["n_routed_experts"] / m["n_routed_experts_published"]
    return positions(m, t) * n_moe * share


def train_flops_per_step(m: dict, t: dict, routed_pairs: "float | None" = None) -> float:
    """Model FLOPs of one train step; ``routed_pairs`` the held (position,
    choice) pairs of the step summed over the layers."""
    B, T = t["batch"], t["seq"] - 1
    S = B * T
    d, H = m["hidden_size"], m["num_attention_heads"]
    nope, rp = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    vd, r = m["v_head_dim"], m["kv_lora_rank"]
    L, dense_layers = m["num_hidden_layers"], m["first_k_dense_replace"]
    proj = d * H * (nope + rp) + d * (r + rp) + r * H * (nope + vd) + H * vd * d
    attn = 2 * S * proj + 2 * B * H * (T * (T + 1) // 2) * (nope + rp + vd)
    dense = 2 * S * 3 * d * m["intermediate_size"]
    shared = 2 * S * (3 * d * m["n_shared_experts"] * m["moe_intermediate_size"]
                      + d * m["n_routed_experts_published"])
    if routed_pairs is None:
        routed_pairs = uniform_routed_pairs(m, t)
    routed = 2 * routed_pairs * 3 * d * m["moe_intermediate_size"]
    forward = (L * attn + dense_layers * dense + (L - dense_layers) * shared + routed
               + 2 * S * d * m["vocab_size"])
    return 3.0 * forward
