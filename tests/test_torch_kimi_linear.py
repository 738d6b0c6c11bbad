"""The port's Kimi-Linear (tpudash_torch.models.kimi_linear) held against the
plain f32 reference (tests/kimi_linear_reference.py, a copy of the
benchmark's) on the CPU, at a tiny size with the published structure: d 64,
4 layers (KDA 1-3, MLA 4: one period of 3 KDA : 1 MLA), KDA 2 heads of 16
with a gate rank of 16, MLA 4 heads of nope 16 + rope 8 (v 16), latent 32,
layer 0 dense, 16 routed experts of width 24 with 8 held, top-3, 1 shared
expert, seq 80 (79 positions: one whole chunk of 64 and one padded).

Tolerances.  The chunked gated delta rule is exact mathematics, so the
chunked forms are held to the recurrence in float64 to 1e-10 (read ≤ 2e-15).
The port rounds every product and activation to bf16 (2^-8 relative), the
reference keeps f32, so each comparison of the model is of the size a few
bf16 roundings through 4 layers give, and none is exact:

- a KDA or MLA layer's output and a MoE layer's: max gap ≤ 2^-6 of the
  reference's largest magnitude (read ≤ 0.0056);
- the logits: max gap ≤ 2^-5 of the largest (read 0.017-0.023 over three
  seeds: the residual stream sits at the embedding's 0.02 scale, and its
  bf16 gap grows by about 0.5 % a layer), and their cosine ≥ 0.9999;
- loss: 2^-12 relative; every leaf's gradient: its norm gap ≤ 2^-4 of the
  reference's norm, and the cosine between the two ≥ 0.99;
- after 3 AdamW steps: each leaf's change within 2^-5 of the reference's,
  by norm, or of one step's (lr a value) where the steps cancel (Adam's
  update is near ±lr an element, and a bf16 leaf rounds its update; a KDA
  ``A_log`` whose gradient flips sign moves 7 % of one step in three, and
  its gap, 7.5e-7, is 4 % of that).

The router's weights are drawn 40× the others' scale: its scores then sit
far apart against bf16 noise, so that the port and the reference choose the
same experts for every token.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import dataclasses
import math

import torch

import kimi_linear_reference as R
from tpudash_torch.config import Config, load_config
from tpudash_torch.models import kimi_linear as KL
from tpudash_torch.models import workload as W
from tpudash_torch.models.runner import WorkloadRunner
from tpudash_torch.ops import kernels
from tpudash_torch.sources.workload import TorchWorkloadSource
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the reference's configuration keys (the benchmark's configuration file's)
M = {
    "hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "kv_lora_rank": 32, "num_hidden_layers": 4, "first_k_dense_replace": 1,
    "intermediate_size": 96, "num_experts_published": 16, "num_experts": 8,
    "num_experts_per_token": 3, "moe_intermediate_size": 24, "num_shared_experts": 1,
    "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-5, "vocab_size": 128, "init_std": 0.02,
    "lr": 3e-4,
    "linear_attn_config": {"kda_layers": [1, 2, 3], "full_attn_layers": [4], "num_heads": 2,
                           "head_dim": 16, "short_conv_kernel_size": 4},
}
CFG = KL.KimiLinearConfig(
    vocab=128, d_model=64, n_layers=4, kda_layers=(1, 2, 3), full_attn_layers=(4,), kda_heads=2,
    kda_head_dim=16, gate_rank=16, n_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, kv_lora_rank=32, dense_width=96, n_experts=16, experts_held=tuple(range(8)),
    top_k=3, expert_width=24, n_shared_experts=1, seq=80, batch=2)
OPT = {"betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.01}
ROUTER_SCALE = 40.0


def _params(seed: int, cfg=CFG) -> dict:
    params = KL.init_params(cfg, torch.Generator().manual_seed(seed))
    for lp in params["layers"].values():
        if "router" in lp:
            lp["router"] = lp["router"] * ROUTER_SCALE
    return params


def _tokens(seed: int, cfg=CFG) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=g)


def _f32(params: dict) -> dict:
    return R.tree((n, t.detach().float().clone()) for n, t in W.named_leaves(params))


def _kda_inputs(seed: int, B=2, T=37, H=3, D=8, dtype=torch.float64) -> list:
    g = torch.Generator().manual_seed(seed)
    q = R.l2norm(torch.randn(B, T, H, D, generator=g, dtype=dtype))
    k = R.l2norm(torch.randn(B, T, H, D, generator=g, dtype=dtype))
    v = torch.randn(B, T, H, D, generator=g, dtype=dtype)
    # decays from e^-3 to 1 a step: over a chunk of 16, e^-48 at the least
    gl = -3.0 * torch.rand(B, T, H, D, generator=g, dtype=dtype)
    beta = torch.rand(B, T, H, generator=g, dtype=dtype)
    return [x.requires_grad_(True) for x in (q, k, v, gl, beta)]


def _grads(outputs, inputs, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    total = sum((o * torch.randn(o.shape, generator=g, dtype=o.dtype)).sum() for o in outputs)
    return torch.autograd.grad(total, inputs)


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_the_references_chunks_match_the_recurrence_in_float64(chunk):
    """Output, final state and every input's gradient; T = 37 is no
    multiple of any chunk, so the last chunk is padded."""
    inputs = _kda_inputs(1)
    want = R.kda_recurrent(*inputs, 0.3)
    got = R.kda_chunked(*inputs, 0.3, chunk=chunk, block=2)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-10
    for a, b in zip(_grads(got, inputs, 2), _grads(want, inputs, 2)):
        assert (a - b).abs().max() <= 1e-10


@pytest.mark.parametrize("T", [65, 150, 191])
def test_the_ports_chunked_chain_matches_the_recurrence_in_float64(T):
    """``kernels.kda_chunk`` on the CPU: the kernels' plain versions, their
    closed-form backwards included, against the definition.  Each T spans
    two to three chunks of 64 and is no multiple of 64, so the state passes
    between chunks and the last chunk is padded."""
    inputs = _kda_inputs(3, T=T)
    want = R.kda_recurrent(*inputs, 0.3)
    got = kernels.kda_chunk(*inputs, 0.3)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-10
    for a, b in zip(_grads(got, inputs, 4), _grads(want, inputs, 4)):
        assert (a - b).abs().max() <= 1e-10


def test_the_pair_blocks_closed_form_backward_is_autograds():
    g = torch.Generator().manual_seed(5)
    shape = (2, 2, 3, 8, 6)
    q, k = (torch.randn(shape, generator=g, dtype=torch.float64).requires_grad_(True)
            for _ in range(2))
    G = (-torch.rand(shape, generator=g, dtype=torch.float64)).cumsum(-2).requires_grad_(True)
    akk, aqk = kernels.kda_pairs_ref(q, k, G)
    # only the strict lower triangle of akk and the lower of aqk are nonzero
    assert torch.equal(akk, akk.tril(-1)) and torch.equal(aqk, aqk.tril())
    da, db = torch.randn_like(akk), torch.randn_like(aqk)
    want = torch.autograd.grad((akk * da).sum() + (aqk * db).sum(), [q, k, G])
    got = kernels.kda_pairs_grads_ref(q, k, G, da, db)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-12


def test_the_state_pass_reverse_and_its_products_are_autograds():
    g = torch.Generator().manual_seed(6)
    w, u, kd = (torch.randn(2, 2, 4, 8, 6, generator=g, dtype=torch.float64).requires_grad_(True)
                for _ in range(3))
    gamma = torch.rand(2, 2, 4, 6, generator=g, dtype=torch.float64).requires_grad_(True)
    states, v_new = kernels.kda_state_ref(w, u, kd, gamma)
    assert states.shape == (2, 2, 5, 6, 6) and torch.equal(states[:, :, 0], torch.zeros(2, 2, 6, 6))
    gS, gv = torch.randn_like(states), torch.randn_like(v_new)
    want = torch.autograd.grad((states * gS).sum() + (v_new * gv).sum(), [w, u, kd, gamma])
    dnext, dv = kernels.kda_state_reverse_ref(w, kd, gamma, gS, gv)
    got = kernels.kda_state_grads(states, v_new, dnext, dv)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-12


def _layer_input(seed: int, cfg=CFG) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(cfg.batch, cfg.seq - 1, cfg.d_model, generator=g)
    return W._rmsnorm(x.to(torch.bfloat16), torch.ones(cfg.d_model), cfg.norm_eps)


def test_a_kda_layer_against_the_reference():
    lp = _params(7)["layers"]["01"]
    x = _layer_input(8)
    got = KL._kda(x, lp, CFG).float()
    want = R.kda(x.float(), _f32({"l": lp})["l"], M, R.QUANT["bf16"])
    assert (got - want).abs().max() <= 2**-6 * want.abs().max()


def test_a_nope_mla_layer_against_the_reference():
    from tpudash_torch.models import deepseek_v2 as D

    lp = _params(9)["layers"]["03"]
    x = _layer_input(10)
    consts = KL.Constants(CFG, "cpu")
    T = x.shape[1]
    got = D._mla(x, lp, consts.cos[:T], consts.sin[:T], CFG).float()
    want = R.mla(x.float(), _f32({"l": lp})["l"], M, R.QUANT["bf16"])
    assert (got - want).abs().max() <= 2**-6 * want.abs().max()
    assert CFG.softmax_scale == (16 + 8) ** -0.5
    assert KL.KimiLinearConfig().softmax_scale == 192**-0.5


def test_the_sigmoid_router_renormalises_over_all_choices_then_scales():
    g = torch.Generator().manual_seed(11)
    x = torch.randn(50, 64, generator=g).to(torch.bfloat16)
    router = torch.randn(64, 16, generator=g)
    gates, experts = KL._route(x, router, CFG)
    scores = torch.sigmoid(x.float() @ router)
    want_g, want_e = R.top_k(scores, 3)
    assert torch.equal(experts, want_e)
    assert torch.allclose(gates, want_g / want_g.sum(-1, keepdim=True) * 2.446, rtol=1e-6)
    # every token's gates add up to the scale, whichever of its experts are held here
    assert torch.allclose(gates.sum(-1), torch.full((50,), 2.446), rtol=1e-6)


def test_the_model_against_the_reference_logits_loss_and_every_gradient():
    params, tokens = _params(1), _tokens(2)
    consts = KL.Constants(CFG, "cpu")
    logits, _ = KL.forward(params, tokens[:, :-1], CFG, consts)
    want = R.logits(_f32(params), tokens[:, :-1], M, R.QUANT["bf16"]).view(logits.shape)
    assert (logits - want).abs().max() <= 2**-5 * want.abs().max()
    assert torch.dot(logits.flatten(), want.flatten()) >= 0.9999 * logits.norm() * want.norm()

    names = [n for n, _ in W.named_leaves(params)]
    mine = [t.requires_grad_(True) for _, t in W.named_leaves(params)]
    loss, _ = KL.loss_fn(params, tokens, CFG, consts)
    ref_params = _f32(params)
    theirs = [t.requires_grad_(True) for _, t in R.named_leaves(ref_params)]
    ref_loss = R.loss(ref_params, tokens, M, R.QUANT["bf16"])
    assert abs(loss.item() - ref_loss.item()) <= 2**-12 * abs(ref_loss.item())
    assert abs(ref_loss.item() - math.log(CFG.vocab)) < 1.0  # ln V at init
    for name, a, b in zip(names, torch.autograd.grad(loss, mine),
                          torch.autograd.grad(ref_loss, theirs)):
        a, b = a.float().flatten(), b.flatten()
        assert (a.norm() - b.norm()).abs() <= 2**-4 * b.norm(), name
        assert torch.dot(a, b) >= 0.99 * a.norm() * b.norm(), name


def test_three_adamw_steps_against_the_reference():
    params = _params(3)
    start = R.tree((n, t.detach().clone()) for n, t in W.named_leaves(params))
    batches = [_tokens(10 + i) for i in range(3)]
    for t in W.leaves(params):
        t.requires_grad_(True)
    opt = KL.make_optimizer(params, CFG)
    counters = KL.routing_counters(CFG, "cpu")
    step = KL.make_train_step(CFG, torch.device("cpu"), counters)
    losses = [step(params, opt, b).item() for b in batches]
    want = R.train_steps(start, batches, {**M, "lr": CFG.lr}, OPT)
    for got, ref in zip(losses, want["losses"]):
        assert abs(got - ref) <= 2**-12 * abs(ref)
    change = R.tree((n, t.detach().float() - s.float()) for (n, t), (_, s)
                    in zip(W.named_leaves(params), R.named_leaves(start)))
    got = R.leaf_norms(change)
    sizes = {n: t.numel() for n, t in W.named_leaves(params)}
    for name, ref in want["change_norms"].items():
        assert abs(got[name] - ref) <= 2**-5 * max(ref, CFG.lr * math.sqrt(sizes[name])), name
    assert counters[-1].item() == 3
    assert 0 < counters[:-1].sum().item() <= 3 * (CFG.n_layers - 1) * CFG.batch * (CFG.seq - 1) * 3


@pytest.mark.parametrize("shares", [2, 4])
def test_disjoint_shares_of_the_experts_add_up_to_the_whole_layer(shares):
    """Shares of a 16-expert layer, with the shared expert counted once,
    give the uncut reference's whole MoE layer: the gates are renormalised
    over all 8 choices before a share keeps its own."""
    whole = _params(4)["layers"]["01"]
    g = torch.Generator().manual_seed(5)
    for key, shape in (("expert_gate_up", (16, 64, 48)), ("expert_down", (16, 24, 64))):
        whole[key] = (torch.randn(shape, generator=g) * 0.1).to(torch.bfloat16)
    x = torch.randn(64, 64, generator=g).to(torch.bfloat16)
    n = 16 // shares
    total, counted = -(shares - 1) * KL.dsv2._shared(x, whole).float(), 0
    for i in range(shares):
        held = tuple(range(i * n, (i + 1) * n))
        cfg = dataclasses.replace(CFG, experts_held=held)
        lp = {**whole, "expert_gate_up": whole["expert_gate_up"][list(held)],
              "expert_down": whole["expert_down"][list(held)]}
        y, counts = KL._moe_ffn(x.view(1, -1, 64), lp, KL.Constants(cfg, "cpu").slot_of, cfg)
        total = total + y.view(-1, 64).float()
        counted += counts.sum().item()
    want = R.moe(x.float().view(1, -1, 64), _f32({"l": whole})["l"], {**M, "num_experts": 16},
                 list(range(16)), R.QUANT["bf16"]).view(-1, 64)
    assert (total - want).abs().max() <= 2**-6 * want.abs().max()
    assert counted == x.shape[0] * CFG.top_k  # every (token, choice) pair in one share


def test_the_published_layer_pattern_and_sizes():
    cfg = KL.KimiLinearConfig()
    kinds = [cfg.is_kda(i) for i in range(cfg.n_layers)]
    assert sum(kinds) == 20
    assert [i + 1 for i, k in enumerate(kinds) if not k] == [4, 8, 12, 16, 20, 24, 27]
    shapes = KL.param_shapes(cfg)
    count = sum(math.prod(s) for s in shapes.values())
    experts = sum(math.prod(s) for n, s in shapes.items() if "expert_" in n)
    assert experts == 16 * 3 * 2304 * 1024 * 26
    assert 4.2e9 < count < 4.4e9  # ≈ 1,350 M outside the held experts, 2,944 M in them
    # the forward's FLOPs a token: ≈ 3,500 M at the published sizes
    per_token = KL.flops_per_step(cfg) / 3 / (cfg.batch * (cfg.seq - 1))
    assert 3.3e9 < per_token < 3.7e9
    assert KL.config_from_extra({}) == cfg


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
        assert 0 < m["moe_valid_row_share"] <= 1.0
        assert m["achieved_tflops"] > 0
    finally:
        runner.stop()
    with pytest.raises(ValueError, match="kimi-linear workload trains on one GPU, not 2"):
        WorkloadRunner(CFG, devices=["cpu", "cpu"])


def test_the_workload_source_builds_kimi_linear():
    assert load_config({"TPUDASH_WORKLOAD_MODEL": "kimi-linear"}).workload_model == "kimi-linear"
    extra = {"workload_vocab": 128, "workload_n_layers": 4, "workload_experts_held": 4,
             "workload_seq": 16, "workload_batch": 2}  # no width
    src = TorchWorkloadSource(Config(source="workload", workload_model="kimi-linear",
                                     extra=extra), device="cpu")
    cfg = src.runner.cfg
    assert isinstance(cfg, KL.KimiLinearConfig) and src.runner.model is KL
    assert (cfg.vocab, cfg.n_layers, cfg.experts_held) == (128, 4, (0, 1, 2, 3))
    assert (cfg.seq, cfg.batch) == (16, 2)
    assert (cfg.d_model, cfg.kda_heads, cfg.kda_head_dim, cfg.expert_width) == (2304, 32, 128, 1024)
    with pytest.raises(ValueError, match="workload_model"):
        TorchWorkloadSource(Config(source="workload", workload_model="llama"), device="cpu")
