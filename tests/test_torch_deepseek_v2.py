"""The port's DeepSeek-V2-Lite (tpudash_torch.models.deepseek_v2) held
against the plain f32 reference (tests/deepseek_v2_reference.py, a copy of
the benchmark's) on the CPU, at a tiny size with the published structure:
d 64, 4 heads of nope 16 + rope 8 (v 16), latent 32, 3 layers (one dense),
16 routed experts of width 24 with 8 held, top-3, 2 shared experts, seq 32.

Tolerances.  The port rounds every product and activation to bf16 (2^-8
relative), the reference keeps f32, so each comparison is of the size a few
bf16 roundings through 3 layers give, and none is exact:

- logits, and a MoE layer's output: max gap ≤ 2^-6 of the reference's
  largest magnitude (read: 0.0046-0.0053 over three seeds);
- loss: 2^-12 relative (read ≤ 1.2e-5); every leaf's gradient: its norm
  gap ≤ 2^-4 of the reference's norm (read ≤ 0.023), and the cosine between
  the two ≥ 0.99 (read ≥ 0.9957);
- after 3 AdamW steps: each leaf's change within 2^-5 of the reference's,
  by norm (read ≤ 0.0142: Adam's update is near ±lr an element, and a bf16
  leaf rounds its update).

The router's weights are drawn 40× the others' scale (N(0, 0.24)): its
logits then sit far apart against bf16 noise, so that the port and the
reference choose the same experts for every token; a near tie would move a
token to another expert, a difference of routing and not of arithmetic.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import dataclasses
import math

import torch

import deepseek_v2_reference as R
from tpudash_torch.config import Config, load_config
from tpudash_torch.models import deepseek_v2 as D
from tpudash_torch.models import workload as W
from tpudash_torch.models.runner import WorkloadRunner
from tpudash_torch.sources.workload import TorchWorkloadSource
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the reference's configuration keys (the benchmark's configuration file's)
M = {
    "hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "kv_lora_rank": 32, "num_hidden_layers": 3, "first_k_dense_replace": 1,
    "intermediate_size": 96, "n_routed_experts_published": 16, "n_routed_experts": 8,
    "num_experts_per_tok": 3, "moe_intermediate_size": 24, "n_shared_experts": 2,
    "norm_topk_prob": False, "routed_scaling_factor": 1.0, "aux_loss_alpha": 0.001,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "vocab_size": 128, "init_std": 0.006, "lr": 3e-4,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096},
}
CFG = D.DeepseekV2Config(
    vocab=128, d_model=64, n_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    kv_lora_rank=32, n_layers=3, dense_width=96, n_experts=16, experts_held=tuple(range(8)),
    top_k=3, expert_width=24, n_shared_experts=2, seq=32, batch=4)
OPT = {"betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.01}
ROUTER_SCALE = 40.0


def _params(seed: int, cfg=CFG) -> dict:
    params = D.init_params(cfg, torch.Generator().manual_seed(seed))
    for key, lp in params["layers"].items():
        if "router" in lp:
            lp["router"] = lp["router"] * ROUTER_SCALE
    return params


def _tokens(seed: int, cfg=CFG) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=g)


def _f32(params: dict) -> dict:
    return R.tree((n, t.detach().float().clone()) for n, t in W.named_leaves(params))


def _grads(loss, leaves) -> list:
    return torch.autograd.grad(loss, leaves)


def test_the_model_against_the_reference_logits_loss_and_every_gradient():
    params, tokens = _params(1), _tokens(2)
    consts = D.Constants(CFG, "cpu")
    logits, _, _ = D.forward(params, tokens[:, :-1], CFG, consts)
    want = R.logits(_f32(params), tokens[:, :-1], M, R.exact).view(logits.shape)
    scale = want.abs().max()
    assert (logits - want).abs().max() <= 2**-6 * scale

    names = [n for n, _ in W.named_leaves(params)]
    mine = [t.requires_grad_(True) for _, t in W.named_leaves(params)]
    loss, _ = D.loss_fn(params, tokens, CFG, consts)
    ref_params = _f32(params)
    theirs = [t.requires_grad_(True) for _, t in R.named_leaves(ref_params)]
    ref_loss = R.loss(ref_params, tokens, M, R.exact)
    assert abs(loss.item() - ref_loss.item()) <= 2**-12 * abs(ref_loss.item())
    assert abs(ref_loss.item() - math.log(CFG.vocab)) < 1.0  # ln V at init
    for name, a, b in zip(names, _grads(loss, mine), _grads(ref_loss, theirs)):
        a, b = a.float().flatten(), b.flatten()
        assert (a.norm() - b.norm()).abs() <= 2**-4 * b.norm(), name
        assert torch.dot(a, b) >= 0.99 * a.norm() * b.norm(), name


def test_three_adamw_steps_against_the_reference():
    cfg = CFG
    params = _params(3)
    start = R.tree((n, t.detach().clone()) for n, t in W.named_leaves(params))
    batches = [_tokens(10 + i) for i in range(3)]
    for t in W.leaves(params):
        t.requires_grad_(True)
    opt = D.make_optimizer(params, cfg)
    counters = D.routing_counters(cfg, "cpu")
    step = D.make_train_step(cfg, torch.device("cpu"), counters)
    losses = [step(params, opt, b).item() for b in batches]
    want = R.train_steps(start, batches, {**M, "lr": cfg.lr}, OPT)
    for got, ref in zip(losses, want["losses"]):
        assert abs(got - ref) <= 2**-12 * abs(ref)
    change = R.tree((n, t.detach().float() - s.float()) for (n, t), (_, s)
                    in zip(W.named_leaves(params), R.named_leaves(start)))
    got = R.leaf_norms(change)
    for name, ref in want["change_norms"].items():
        assert abs(got[name] - ref) <= 2**-5 * ref, name
    # the counters: every step counted, every held (token, choice) pair once
    assert counters[-1].item() == 3
    assert 0 < counters[:-1].sum().item() <= 3 * (CFG.n_layers - 1) * CFG.batch * (CFG.seq - 1) * 3


def _moe_input(seed: int, S: int = 64) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(S, CFG.d_model, generator=g).to(torch.bfloat16)


def test_two_shares_of_eight_experts_add_up_to_the_whole_layer():
    """Shares 0-7 and 8-15 of a 16-expert layer, with the shared experts
    counted once, give the uncut reference's whole MoE layer."""
    whole = _params(4, CFG)["layers"]["01"]
    g = torch.Generator().manual_seed(5)
    for key, shape in (("expert_gate_up", (16, 64, 48)), ("expert_down", (16, 24, 64))):
        whole[key] = (torch.randn(shape, generator=g) * 0.1).to(torch.bfloat16)
    x = _moe_input(6)
    parts = []
    for held in (tuple(range(8)), tuple(range(8, 16))):
        cfg = dataclasses.replace(CFG, experts_held=held)
        lp = {**whole, "expert_gate_up": whole["expert_gate_up"][list(held)],
              "expert_down": whole["expert_down"][list(held)]}
        y, _, counts = D._moe_ffn(x.view(1, -1, 64), lp, D.Constants(cfg, "cpu").slot_of, cfg)
        parts.append((y.view(-1, 64).float(), counts))
    shared = D._shared(x, whole).float()
    total = parts[0][0] + parts[1][0] - shared
    m = {**M, "n_routed_experts": 16}
    want, _ = R.moe(x.float().view(1, -1, 64), _f32({"l": whole})["l"], m, list(range(16)), R.exact)
    want = want.view(-1, 64)
    assert (total - want).abs().max() <= 2**-6 * want.abs().max()
    # every token's three choices land in one share or the other
    assert parts[0][1].sum() + parts[1][1].sum() == x.shape[0] * CFG.top_k


def test_yarn_frequencies_and_softmax_scale_at_the_published_settings():
    cfg = D.DeepseekV2Config()
    assert cfg.softmax_scale == pytest.approx(0.1147214, abs=1e-7)
    published = {"qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rope_scaling": M["rope_scaling"]}
    assert R.softmax_scale(published) == pytest.approx(0.1147214, abs=1e-7)
    assert D.yarn_mscale(40, 0.707) == pytest.approx(1.2608037, abs=1e-7)
    f = D.yarn_inv_freq(cfg)
    # the correction range over 4096 positions: dims below 10 extrapolate
    # (θ^(-2i/64)), dims from 23 interpolate (÷ 40), a linear ramp between
    assert f.shape == (32,)
    assert f[0] == 1.0 and f[10].item() == pytest.approx(10000 ** (-20 / 64), rel=1e-6)
    assert f[23].item() == pytest.approx(10000 ** (-46 / 64) / 40, rel=1e-6)
    ramp = 6 / 13  # dim 16: (16 - 10) / (23 - 10) of the way to interpolated
    assert f[16].item() == pytest.approx(0.01 * (1 - ramp) + 0.01 / 40 * ramp, rel=1e-6)
    ref = R.inv_freq({"qk_rope_head_dim": 64, "rope_theta": 10000,
                      "rope_scaling": M["rope_scaling"]})
    assert torch.allclose(f, ref, rtol=1e-6)
    cos, sin = D.rope_tables(cfg, 16, "cpu")
    assert torch.equal(cos[0], torch.ones(64)) and torch.equal(sin[0], torch.zeros(64))


def test_a_zipf_skewed_batch_that_overloads_one_expert_loses_no_token():
    """Zipf ids (exponent 1.1) and a router that sends every token to expert
    3 first: expert 3 takes all S tokens, far above the 3·S·8/16/8 a held
    expert takes on average, and the layer still equals the reference."""
    S = 256
    g = torch.Generator().manual_seed(7)
    p = torch.arange(1, CFG.vocab + 1, dtype=torch.float64) ** -1.1
    ids = torch.multinomial(p.float(), S, replacement=True, generator=g)
    embed = (torch.randn(CFG.vocab, 64, generator=g)).to(torch.bfloat16)
    x = embed[ids].abs()  # positive: a positive router column wins for every token
    lp = _params(8)["layers"]["01"]
    router = torch.randn(64, 16, generator=g) * 0.05
    router[:, 3] = 1.0
    lp["router"] = router
    y, _, counts = D._moe_ffn(x.view(1, S, 64), lp, D.Constants(CFG, "cpu").slot_of, CFG)
    assert counts[3].item() == S
    probs = torch.softmax(x.float() @ lp["router"].float(), -1)
    _, experts = R.top_k(probs, CFG.top_k)
    assert counts.sum().item() == (experts < 8).sum().item()  # every held pair, once
    want, _ = R.moe(x.float().view(1, S, 64), _f32({"l": lp})["l"], M, list(range(8)), R.exact)
    want = want.view(S, 64)
    assert (y.view(S, 64).float() - want).abs().max() <= 2**-6 * want.abs().max()


def test_the_runner_trains_the_model_on_the_cpu_and_refuses_two_devices():
    import time

    runner = WorkloadRunner(CFG, steps_per_sync=2, device="cpu").start()
    try:
        deadline = time.monotonic() + 60
        while runner.metrics()["steps"] < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        m = runner.metrics()
        assert m["steps"] >= 4 and math.isfinite(m["loss"])
        assert len(m["moe_tokens_per_held_expert"]) == 8
        assert sum(m["moe_tokens_per_held_expert"]) > 0 and m["moe_load_max_over_mean"] >= 1.0
        # held pairs ÷ the sorted buffers' rows, S·min(K, held) a MoE layer
        assert 0 < m["moe_valid_row_share"] <= 1.0
        assert m["achieved_tflops"] > 0
    finally:
        runner.stop()
    with pytest.raises(ValueError, match="one GPU, not 2"):
        WorkloadRunner(CFG, devices=["cpu", "cpu"])


def test_the_workload_source_builds_the_chosen_model():
    assert load_config({"TPUDASH_WORKLOAD_MODEL": "deepseek-v2-lite"}).workload_model == \
        "deepseek-v2-lite"
    assert load_config({}).workload_model == "demo"
    extra = {"workload_vocab": 128, "workload_d_model": 64, "workload_n_layers": 2,
             "workload_experts_held": 4, "workload_seq": 16, "workload_batch": 2}  # no width
    src = TorchWorkloadSource(Config(source="workload", workload_model="deepseek-v2-lite",
                                     extra=extra), device="cpu")
    cfg = src.runner.cfg
    assert isinstance(cfg, D.DeepseekV2Config)
    assert (cfg.vocab, cfg.n_layers, cfg.experts_held) == (128, 2, (0, 1, 2, 3))
    assert (cfg.seq, cfg.batch) == (16, 2)
    assert (cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.expert_width) == (2048, 16, 512, 1408)
    assert D.config_from_extra({}) == D.DeepseekV2Config()
    with pytest.raises(ValueError, match="workload_model"):
        TorchWorkloadSource(Config(source="workload", workload_model="llama"), device="cpu")
