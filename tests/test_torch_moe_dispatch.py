"""The MoE dispatch of the port's DeepSeek-V2-Lite
(tpudash_torch.models.deepseek_v2._held_experts over
tpudash_torch.ops.kernels.moe_gather / moe_swiglu / moe_combine) held to the
formulation it replaced, on the CPU through the plain versions: the tokens
padded with a zero row and gathered by ``F.embedding``, the SwiGLU of the
whole buffer, and an f32 ``index_add`` of every row times its gate into
(S + 1) rows, the last a dropped row for the invalid ones
(:func:`_padded_dispatch`).

The batch is Zipf-skewed (ids drawn with P(r) ∝ r^-1.1, so rows repeat),
one held expert takes every token but one, and that one token chooses no
held expert.  Every row of the sorted buffer past the valid count, in the
dispatch's own outputs (the plain versions fill them with NaN) and in the
grouped products' outputs and input gradients (:class:`_PoisonedGroupedMM`),
holds NaN, so a read of one would show in a result.

Tolerances: the output and the gradients of the two grouped products'
weights are the same bits (the same f32 values rounded at the same points);
the combine adds a token's choices in choice order where ``index_add`` added
them in sorted order (the same bits at this size, since a token adds at most
two or three terms), so y is within one bf16 ulp; the gather's gradient adds
a token's m choices in f32 where the embedding's backward rounded each
partial sum to bf16, so x's gradient is within m·2^-8 of the sum of the
terms' magnitudes; the gates' gradients are f32 dot products of width d in
two orders, within 2^-18 of the sum of the terms' magnitudes.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import dataclasses

import torch
import torch.nn.functional as F

from tpudash_torch.models import deepseek_v2 as D
from tpudash_torch.ops import kernels as K
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASE = D.DeepseekV2Config(
    vocab=128, d_model=64, n_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    kv_lora_rank=32, n_layers=3, dense_width=96, n_experts=16, experts_held=tuple(range(8)),
    top_k=3, expert_width=24, n_shared_experts=2, seq=33, batch=4)
#: (top_k, experts held): fewer choices than held experts, more, as many
SHAPES = [(3, 8), (4, 2), (2, 2), (6, 8)]
S = 128
OVERLOADED = 1  # a held expert every token but the last chooses


def _cfg(top_k: int, held: int) -> D.DeepseekV2Config:
    return dataclasses.replace(BASE, top_k=top_k, experts_held=tuple(range(held)))


def _routing(cfg: D.DeepseekV2Config, seed: int) -> tuple:
    """(gates (S, K) f32, experts (S, K) int64): each token's K distinct
    experts drawn with Zipf weights over a random order of the experts;
    every token but the last chooses OVERLOADED first, and the last chooses
    no held expert."""
    g = torch.Generator().manual_seed(seed)
    E, Kc = cfg.n_experts, cfg.top_k
    weights = torch.arange(1, E + 1, dtype=torch.float64) ** -1.1
    order = torch.randperm(E, generator=g)
    experts = torch.empty(S, Kc, dtype=torch.int64)
    for t in range(S - 1):
        w = weights.clone()
        w[(order == OVERLOADED).nonzero()] = 0.0
        rest = order[torch.multinomial(w.float(), Kc - 1, replacement=False, generator=g)]
        experts[t] = torch.cat([torch.tensor([OVERLOADED]), rest])
    others = torch.arange(cfg.n_held, E)
    experts[S - 1] = others[torch.randperm(len(others), generator=g)[:Kc]]
    gates = torch.rand(S, Kc, generator=g) * 0.5 + 0.01
    return gates, experts


def _tokens(cfg: D.DeepseekV2Config, seed: int) -> torch.Tensor:
    """x (S, d) bf16: rows of an embedding at Zipf-drawn ids."""
    g = torch.Generator().manual_seed(seed)
    p = torch.arange(1, cfg.vocab + 1, dtype=torch.float64) ** -1.1
    ids = torch.multinomial(p.float(), S, replacement=True, generator=g)
    embed = torch.randn(cfg.vocab, cfg.d_model, generator=g)
    return embed[ids].to(torch.bfloat16)


def _experts(cfg: D.DeepseekV2Config, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    d, f, n = cfg.d_model, cfg.expert_width, cfg.n_held
    return {"expert_gate_up": (torch.randn(n, d, 2 * f, generator=g) * 0.2).to(torch.bfloat16),
            "expert_down": (torch.randn(n, f, d, generator=g) * 0.2).to(torch.bfloat16)}


def _slot_of(cfg: D.DeepseekV2Config) -> torch.Tensor:
    return D.Constants(dataclasses.replace(cfg, seq=4), "cpu").slot_of


def _padded_dispatch(x, gates, experts, slot_of, lp: dict, cfg: D.DeepseekV2Config) -> tuple:
    """The formulation the dispatch kernels replaced: every pass over the
    whole buffer, invalid rows gathered from a zero row and added into a
    dropped row S."""
    Sx, Kc, n = x.shape[0], cfg.top_k, cfg.n_held
    cap = Sx * min(Kc, n)
    slots = slot_of[experts].reshape(-1)
    counts = torch.zeros(n + 1, dtype=torch.int64)
    counts.scatter_add_(0, slots, torch.ones_like(slots))
    offs = counts[:n].cumsum(0)
    order = torch.sort(slots, stable=True).indices[:cap]
    valid = torch.arange(cap) < offs[-1]
    rows = torch.where(valid, order // Kc, Sx)
    xs = F.embedding(rows, F.pad(x, (0, 0, 0, 1)))
    offs32 = offs.to(torch.int32)
    h = D._swiglu(torch._grouped_mm(xs, lp["expert_gate_up"], offs=offs32))
    ys = torch._grouped_mm(h, lp["expert_down"], offs=offs32)
    g = torch.where(valid, gates.reshape(-1).gather(0, order), 0.0)
    y = torch.zeros(Sx + 1, x.shape[1], dtype=torch.float32)
    y = y.index_add(0, rows, ys.float() * g[:, None])
    return y[:Sx].to(torch.bfloat16), counts[:n]


_GROUPED_MM = torch._grouped_mm


class _PoisonedGroupedMM(torch.autograd.Function):
    """``torch._grouped_mm`` whose rows past the last offset, in its output
    and in its input's gradient, hold NaN."""

    @staticmethod
    def forward(ctx, a, b, offs):
        ctx.save_for_backward(a, b, offs)
        out = _GROUPED_MM(a, b, offs=offs)
        out[int(offs[-1]):] = float("nan")
        return out

    @staticmethod
    def backward(ctx, grad):
        a, b, offs = ctx.saved_tensors
        with torch.enable_grad():
            a_, b_ = a.detach().requires_grad_(True), b.detach().requires_grad_(True)
            da, db = torch.autograd.grad(_GROUPED_MM(a_, b_, offs=offs), (a_, b_), grad)
        da = da.clone()
        da[int(offs[-1]):] = float("nan")
        return da, db, None


def _poisoned_grouped_mm(a, b, offs=None):
    return _PoisonedGroupedMM.apply(a, b, offs)


def _ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


def _leaves(cfg, seed):
    x = _tokens(cfg, seed).requires_grad_(True)
    gates, experts = _routing(cfg, seed + 1)
    lp = {k: v.requires_grad_(True) for k, v in _experts(cfg, seed + 2).items()}
    return x, gates.requires_grad_(True), experts, lp


def _grads(y, x, gates, lp, dy):
    return torch.autograd.grad(y, (x, gates, lp["expert_gate_up"], lp["expert_down"]), dy)


@pytest.mark.parametrize("top_k,held", SHAPES)
def test_pos_inverts_the_stable_sort(top_k, held):
    cfg = _cfg(top_k, held)
    _, experts = _routing(cfg, 3)
    slot_of = _slot_of(cfg)
    counts, offs, n_valid, pos = D.dispatch_layout(experts, slot_of, held)
    slots = slot_of[experts].reshape(-1)
    order = torch.sort(slots, stable=True).indices
    assert pos.shape == (S, top_k) and pos.dtype == torch.int32
    assert torch.equal(pos.reshape(-1)[order].long(), torch.arange(S * top_k))
    assert torch.equal(order[pos.reshape(-1).long()], torch.arange(S * top_k))
    held_pairs = (experts < held).sum().item()
    assert n_valid.item() == offs[-1].item() == counts.sum().item() == held_pairs
    assert held_pairs <= S * min(top_k, held)  # cap: room for every held pair
    assert torch.equal((pos < n_valid).reshape(-1), (slots < held))
    # the rows of expert e are its (token, choice) pairs in token order
    starts = torch.cat([torch.zeros(1, dtype=torch.int32), offs[:-1]])
    for e in range(held):
        t, k = (experts == e).nonzero(as_tuple=True)
        want = torch.arange(starts[e].item(), offs[e].item())
        assert torch.equal(pos[t, k].long().sort().values, want)
        assert torch.equal(pos[t, k].long(), want)  # nonzero walks tokens in order
    assert counts[OVERLOADED].item() == S - 1


@pytest.mark.parametrize("top_k,held", SHAPES)
def test_the_layer_and_its_gradients_against_the_padded_dispatch(top_k, held, monkeypatch):
    cfg = _cfg(top_k, held)
    slot_of = _slot_of(cfg)
    x, gates, experts, lp = _leaves(cfg, 11)
    dy = torch.randn(S, cfg.d_model, generator=torch.Generator().manual_seed(12)).bfloat16()
    want_y, want_counts = _padded_dispatch(x, gates, experts, slot_of, lp, cfg)
    want = _grads(want_y, x, gates, lp, dy)
    monkeypatch.setattr(torch, "_grouped_mm", _poisoned_grouped_mm)
    y, counts = D._held_experts(x, gates, experts, slot_of, lp, cfg)
    got = _grads(y, x, gates, lp, dy)
    assert torch.equal(counts, want_counts)
    assert torch.isfinite(y.float()).all() and all(torch.isfinite(g.float()).all() for g in got)
    assert ((y.float() - want_y.float()).abs() <= _ulp_bf16(want_y.float())).all()
    assert torch.equal(y[-1], torch.zeros_like(y[-1]))  # the token with no held choice
    dx, dgates, dgu, ddown = got
    assert torch.equal(dgu, want[2]) and torch.equal(ddown, want[3])
    # the gradient into the buffer and the down product's rows, for the bounds
    _, offs, n_valid, pos = D.dispatch_layout(experts, slot_of, held)
    xs = K.moe_gather_ref(x.detach(), pos, n_valid, S * min(top_k, held)).requires_grad_(True)
    act = K.moe_swiglu(_GROUPED_MM(xs, lp["expert_gate_up"].detach(), offs=offs), n_valid)
    ys = _GROUPED_MM(act, lp["expert_down"].detach(), offs=offs)
    (dxs,) = torch.autograd.grad(K.moe_combine(ys, gates.detach(), pos, n_valid), (xs,), dy)
    ys = ys.detach()
    # |dx − want| ≤ m · 2^-8 · Σ_k |dxs| over a token's m ≤ min(K, held)
    # choices: the embedding's backward rounded each partial sum to bf16
    mass = K.moe_gather_grad_ref(dxs.abs(), pos, n_valid).float()
    err = (dx.float() - want[0].float()).abs()
    assert (err <= min(top_k, held) * 2**-8 * mass).all()
    assert torch.equal(dx[-1], torch.zeros_like(dx[-1]))
    # |dgates − want| ≤ 2^-18 · Σ_d |dy·ys|, both sums of the same f32 terms
    held_pair = experts < held
    mass = torch.zeros_like(dgates)
    rows = pos[held_pair].long()
    mass[held_pair] = (dy.float()[held_pair.nonzero()[:, 0]] * ys[rows].float()).abs().sum(-1)
    assert ((dgates - want[1]).abs() <= 2**-18 * mass).all()
    assert torch.equal(dgates[~held_pair], torch.zeros_like(dgates[~held_pair]))


def _layout(cfg, seed):
    _, experts = _routing(cfg, seed)
    return D.dispatch_layout(experts, _slot_of(cfg), cfg.n_held)


def _nan_past(t: torch.Tensor, n: int) -> torch.Tensor:
    t = t.clone()
    t[n:] = float("nan")
    return t


@pytest.mark.parametrize("top_k,held", SHAPES)
def test_the_plain_versions_read_no_row_past_the_valid_count(top_k, held):
    """Each plain version on inputs whose rows past n_valid hold NaN: finite
    results equal to the same expression written out per pair."""
    cfg = _cfg(top_k, held)
    counts, offs, n_valid, pos = _layout(cfg, 5)
    n, cap = n_valid.item(), S * min(top_k, held)
    g = torch.Generator().manual_seed(6)
    d, f = cfg.d_model, cfg.expert_width
    x = torch.randn(S, d, generator=g).bfloat16()
    gates = torch.rand(S, top_k, generator=g)
    xs = K.moe_gather_ref(x, pos, n_valid, cap)
    assert xs.shape == (cap, d) and torch.isnan(xs[n:].float()).all()
    pairs = [(t, k, int(pos[t, k])) for t in range(S) for k in range(top_k) if pos[t, k] < n]
    assert len(pairs) == n
    for t, k, p in pairs:
        assert torch.equal(xs[p], x[t])
    rows = _nan_past(torch.randn(cap, d, generator=g).bfloat16(), n)
    dx = K.moe_gather_grad_ref(rows, pos, n_valid)
    y = K.moe_combine_ref(rows, gates, pos, n_valid)
    dy = torch.randn(S, d, generator=g).bfloat16()
    dys, dgates = K.moe_combine_grad_ref(dy, rows, gates, pos, n_valid)
    want_dx = torch.zeros(S, d)
    want_y = torch.zeros(S, d)
    want_dg = torch.zeros(S, top_k)
    for t, k, p in sorted(pairs):  # token, then choice order
        want_dx[t] = want_dx[t] + rows[p].float()
        want_y[t] = want_y[t] + gates[t, k] * rows[p].float()
        assert torch.equal(dys[p], (gates[t, k] * dy[t].float()).bfloat16())
        want_dg[t, k] = (dy[t].float() * rows[p].float()).sum()
    assert torch.equal(dx, want_dx.bfloat16()) and torch.equal(y, want_y.bfloat16())
    assert torch.equal(dgates, want_dg)
    assert torch.isnan(dys[n:].float()).all()
    h = _nan_past(torch.randn(cap, 2 * f, generator=g).bfloat16(), n)
    act = K.moe_swiglu_ref(h, n_valid)
    assert torch.equal(act[:n], D._swiglu(h[:n])) and torch.isnan(act[n:].float()).all()
    dact = _nan_past(torch.randn(cap, f, generator=g).bfloat16(), n)
    dh = K.moe_swiglu_grad_ref(h, dact, n_valid)
    hv = h[:n].clone().requires_grad_(True)
    (want_dh,) = torch.autograd.grad(D._swiglu(hv), (hv,), dact[:n])
    assert torch.equal(dh[:n], want_dh) and torch.isnan(dh[n:].float()).all()


@pytest.mark.parametrize("top_k,held", SHAPES)
def test_the_autograd_functions_run_the_plain_versions_on_the_cpu(top_k, held):
    cfg = _cfg(top_k, held)
    _, _, n_valid, pos = _layout(cfg, 7)
    n, cap = n_valid.item(), S * min(top_k, held)
    g = torch.Generator().manual_seed(8)
    d, f = cfg.d_model, cfg.expert_width
    x = torch.randn(S, d, generator=g).bfloat16().requires_grad_(True)
    xs = K.moe_gather(x, pos, n_valid, cap)
    dxs = _nan_past(torch.randn(cap, d, generator=g).bfloat16(), n)
    (dx,) = torch.autograd.grad(xs, (x,), dxs)
    assert torch.equal(xs[:n], K.moe_gather_ref(x.detach(), pos, n_valid, cap)[:n])
    assert torch.equal(dx, K.moe_gather_grad_ref(dxs, pos, n_valid))
    h = _nan_past(torch.randn(cap, 2 * f, generator=g).bfloat16(), n).requires_grad_(True)
    act = K.moe_swiglu(h, n_valid)
    dact = _nan_past(torch.randn(cap, f, generator=g).bfloat16(), n)
    (dh,) = torch.autograd.grad(act, (h,), dact)
    assert torch.equal(dh[:n], K.moe_swiglu_grad_ref(h.detach(), dact, n_valid)[:n])
    ys = _nan_past(torch.randn(cap, d, generator=g).bfloat16(), n).requires_grad_(True)
    gates = torch.rand(S, top_k, generator=g).requires_grad_(True)
    y = K.moe_combine(ys, gates, pos, n_valid)
    dy = torch.randn(S, d, generator=g).bfloat16()
    dys, dgates = torch.autograd.grad(y, (ys, gates), dy)
    want_dys, want_dgates = K.moe_combine_grad_ref(dy, ys.detach(), gates.detach(), pos, n_valid)
    assert torch.equal(y, K.moe_combine_ref(ys.detach(), gates.detach(), pos, n_valid))
    assert torch.equal(dys[:n], want_dys[:n]) and torch.equal(dgates, want_dgates)


def _refusal_inputs():
    pos = torch.zeros(4, 2, dtype=torch.int32)
    n = torch.tensor([3], dtype=torch.int32)
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    rows = torch.zeros(8, 64, dtype=torch.bfloat16)
    gates = torch.zeros(4, 2)
    return pos, n, x, rows, gates


MOE_REFUSALS = {
    "gather on cpu": (ValueError, lambda p, n, x, r, g: K.moe_gather_forward(x, p, n, 8)),
    "gather's backward on cpu": (ValueError, lambda p, n, x, r, g: K.moe_gather_backward(r, p, n)),
    "swiglu on cpu": (ValueError, lambda p, n, x, r, g: K.moe_swiglu_forward(
        torch.zeros(8, 48, dtype=torch.bfloat16), n)),
    "swiglu's backward on cpu": (ValueError, lambda p, n, x, r, g: K.moe_swiglu_backward(
        torch.zeros(8, 48, dtype=torch.bfloat16), torch.zeros(8, 24, dtype=torch.bfloat16), n)),
    "combine on cpu": (ValueError, lambda p, n, x, r, g: K.moe_combine_forward(r, g, p, n)),
    "combine's backward on cpu": (ValueError, lambda p, n, x, r, g: K.moe_combine_backward(
        x, r, g, p, n)),
    "f32 rows": (TypeError, lambda p, n, x, r, g: K.moe_gather_forward(x.float(), p, n, 8)),
    "int64 pos": (TypeError, lambda p, n, x, r, g: K.moe_gather_forward(x, p.long(), n, 8)),
    "nine choices": (ValueError, lambda p, n, x, r, g: K.moe_gather_forward(
        x, torch.zeros(4, 9, dtype=torch.int32), n, 8)),
    "width not a multiple of 8": (ValueError, lambda p, n, x, r, g: K.moe_gather_forward(
        torch.zeros(4, 60, dtype=torch.bfloat16), p, n, 8)),
    "halves not a multiple of 8": (ValueError, lambda p, n, x, r, g: K.moe_swiglu_forward(
        torch.zeros(8, 40, dtype=torch.bfloat16), n)),
    "two valid counts": (TypeError, lambda p, n, x, r, g: K.moe_gather_forward(
        x, p, torch.tensor([3, 4], dtype=torch.int32), 8)),
    "bf16 gates": (TypeError, lambda p, n, x, r, g: K.moe_combine_forward(r, g.bfloat16(), p, n)),
    "strided rows": (ValueError, lambda p, n, x, r, g: K.moe_gather_backward(
        torch.zeros(64, 8, dtype=torch.bfloat16).t(), p, n)),
    "x of another token count": (ValueError, lambda p, n, x, r, g: K.moe_combine_backward(
        r, r, g, p, n)),
}


@pytest.mark.parametrize("case", sorted(MOE_REFUSALS))
def test_the_dispatch_kernels_refuse_what_they_do_not_take_and_build_nothing(case, monkeypatch):
    def no_nvcc(*a, **k):
        raise AssertionError("nothing may be built for an argument the kernels refuse")

    monkeypatch.setattr(K.subprocess, "Popen", no_nvcc)
    exc, call = MOE_REFUSALS[case]
    before = K.launch_counts()
    with pytest.raises(exc):
        call(*_refusal_inputs())
    assert K.launch_counts() == before
    assert all(k._fn is None for k in K.MOE_KERNELS)


def test_the_dispatch_kernels_share_one_source_and_count_their_launches():
    assert {k.source.name for k in K.MOE_KERNELS} == {"moe_dispatch.cu"}
    assert len({k.symbol for k in K.MOE_KERNELS}) == 6
    assert set(K.MOE_KERNELS) <= set(K.KERNELS)
    names = [k.name for k in K.MOE_KERNELS]
    assert names == ["moe_gather_fwd", "moe_gather_bwd", "moe_swiglu_fwd", "moe_swiglu_bwd",
                     "moe_combine_fwd", "moe_combine_bwd"]
    assert set(names) <= set(K.launch_counts())


def test_the_valid_row_share_of_the_runner_series():
    cfg = D.DeepseekV2Config(batch=8, seq=4096)
    assert D.dispatch_rows(cfg) == 8 * 4095 * 6 * 26
    per = [3000.0 * 26] * 8  # tokens a held expert a step, summed over the layers
    stats = D.load_stats([c * 2 for c in per], 2, cfg)
    assert stats["moe_load_max_over_mean"] == 1.0
    assert stats["moe_valid_row_share"] == pytest.approx(8 * 3000 / (8 * 4095 * 6))
    assert D.load_stats([0] * 8, 0, cfg)["moe_valid_row_share"] == 0.0
    # the uniform share: top_k · held ÷ experts of each token, of min(top_k, held) rows
    uniform = 8 * 4095 * 6 * 8 / 64 * 26
    assert D.load_stats([uniform / 8] * 8, 1, cfg)["moe_valid_row_share"] == pytest.approx(0.125)


def test_the_step_on_the_cpu_builds_no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU step must not build the kernels")

    monkeypatch.setattr(K, "build_kernels", refuse)
    cfg = dataclasses.replace(BASE, seq=8, batch=2)
    counters = D.routing_counters(cfg, "cpu")
    params, opt = D.make_train_state(cfg, torch.Generator().manual_seed(0))
    step = D.make_train_step(cfg, torch.device("cpu"), counters)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=torch.Generator())
    assert torch.isfinite(step(params, opt, tokens))
    assert counters[-1].item() == 1
