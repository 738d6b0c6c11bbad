"""MLA's RoPE and q/k assembly of the port's DeepSeek-V2-Lite
(tpudash_torch.ops.kernels.mla_qk_rope, the glue between the projections of
models/deepseek_v2.py::_mla and attention) held to the chain it replaced, on
the CPU through the plain versions: the model's ``_rope`` on q's rope part
and on the shared key, two cats and ``kv.split``, differentiated by autograd
(:func:`_chain`, a copy of that chain).

The autograd function's CPU branch runs the plain forward and the closed
form of the backward that the kernels compute (``mla_rope_grads_ref``):
RoPE's transpose in f32 at autograd's rounding points, and the shared key's
gradient as the heads' sum in f32 in head order, rounded to bf16.  Against
autograd of the chain, q, k, v and the gradients of q_raw and kv are the
same bits; kv_a's gradient is zero in the latent's columns and within one
bf16 ulp in the rope columns (autograd's expand backward may add the heads
in another order).  Shapes: the tests' config's widths, the published ones
over a few tokens, and a head row with no nope part; B > 1 and T shorter
than the cos table throughout.
"""

import dataclasses

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import torch

from tpudash_torch.models import deepseek_v2 as D
from tpudash_torch.ops import kernels as K
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: (B, T, cos table rows, H, nope, rope, v, r)
SHAPES = {
    "test config": (2, 5, 9, 4, 16, 8, 16, 32),
    "published widths": (2, 3, 8, 16, 128, 64, 128, 512),
    "no nope part": (3, 7, 7, 3, 0, 16, 8, 0),
}


def _chain(q_raw, kv, kv_a, cos, sin, nope, vd, r):
    """The glue as _mla ran it before the kernels: (q, k, v) (B, T, H, ·)."""
    B, T, H, _ = q_raw.shape
    rope = cos.shape[-1]
    k_nope, v = kv.split([nope, vd], dim=-1)
    q_pe = D._rope(q_raw[..., nope:], cos[:, None], sin[:, None])
    k_pe = D._rope(kv_a[..., r:], cos, sin)
    q = torch.cat([q_raw[..., :nope], q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, T, H, rope)], dim=-1)
    return q, k, v


def _inputs(shape: str, seed: int = 0) -> dict:
    B, T, table, H, nope, rope, vd, r = SHAPES[shape]
    g = torch.Generator().manual_seed(seed)

    def rand(*size):
        return torch.randn(size, generator=g).bfloat16()

    cfg = dataclasses.replace(D.DeepseekV2Config(), qk_rope_head_dim=rope)
    cos, sin = D.rope_tables(cfg, table, "cpu")
    return dict(q_raw=rand(B, T, H, nope + rope), kv=rand(B, T, H, nope + vd),
                kv_a=rand(B, T, r + rope), cos=cos[:T], sin=sin[:T], nope=nope, vd=vd, r=r,
                grads=(rand(B, T, H, nope + rope), rand(B, T, H, nope + rope), rand(B, T, H, vd)))


def _leaves(x: dict) -> list:
    return [x[k].clone().requires_grad_(True) for k in ("q_raw", "kv", "kv_a")]


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    ulp = torch.pow(2.0, torch.floor(torch.log2(w.abs().clamp_min(2.0**-126))) - 7)
    return ((g - w).abs() / ulp).max().item()


def _against_the_chain(got_out, got_grads, want_out, want_grads, r: int) -> None:
    assert all(torch.equal(a, b) for a, b in zip(got_out, want_out))
    assert torch.equal(got_grads[0], want_grads[0])  # q_raw
    assert torch.equal(got_grads[1], want_grads[1])  # kv
    assert bool((got_grads[2][..., :r] == 0).all())
    assert torch.equal(got_grads[2][..., :r], want_grads[2][..., :r])
    assert _ulps(got_grads[2][..., r:], want_grads[2][..., r:]) <= 1.0


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_function_is_the_chain_forward_and_backward(shape):
    x = _inputs(shape)
    chain_leaves, leaves = _leaves(x), _leaves(x)
    want = _chain(*chain_leaves, x["cos"], x["sin"], x["nope"], x["vd"], x["r"])
    want_grads = torch.autograd.grad(want, chain_leaves, x["grads"])
    got = K._MLAQKRope.apply(*leaves, x["cos"], x["sin"])
    got_grads = torch.autograd.grad(got, leaves, x["grads"])
    _against_the_chain(got, got_grads, want, want_grads, x["r"])
    assert got[2]._base is leaves[1] or got[2].data_ptr() == leaves[1].data_ptr() + 2 * x["nope"]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_closed_form_backward_takes_any_order_of_the_gradients_rows(shape):
    x = _inputs(shape, seed=1)
    leaves = _leaves(x)
    want = torch.autograd.grad(_chain(*leaves, x["cos"], x["sin"], x["nope"], x["vd"], x["r"]),
                               leaves, x["grads"])
    head_major = [g.transpose(1, 2).contiguous().transpose(1, 2) for g in x["grads"]]
    for grads in (x["grads"], head_major):
        got = K.mla_rope_grads_ref(*grads, x["cos"], x["sin"], x["r"])
        _against_the_chain(want, got, want, want, x["r"])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_model_entry_on_the_cpu_is_the_chain_under_autograd(shape):
    x = _inputs(shape, seed=2)
    chain_leaves, leaves = _leaves(x), _leaves(x)
    want = _chain(*chain_leaves, x["cos"], x["sin"], x["nope"], x["vd"], x["r"])
    got = K.mla_qk_rope(*leaves, x["cos"], x["sin"])
    assert all(t.grad_fn is not None and "MLAQKRope" not in type(t.grad_fn).__name__ for t in got)
    for a, b in zip(torch.autograd.grad(got, leaves, x["grads"]),
                    torch.autograd.grad(want, chain_leaves, x["grads"])):
        assert torch.equal(a, b)


def test_the_layer_reaches_the_models_rope_on_the_cpu(monkeypatch):
    """A patch of deepseek_v2._rope (gpubench's planted fault) reaches the
    CPU path, once for q and once for the shared key."""
    calls = []
    rope = D._rope

    def counted(x, cos, sin):
        calls.append(tuple(x.shape))
        return rope(x, cos, sin)

    monkeypatch.setattr(D, "_rope", counted)
    cfg = dataclasses.replace(D.DeepseekV2Config(vocab=128, d_model=64, n_heads=4,
                                                 qk_nope_head_dim=16, qk_rope_head_dim=8,
                                                 v_head_dim=16, kv_lora_rank=32, n_layers=1),
                              seq=6, batch=2)
    lp = D.init_params(cfg, torch.Generator().manual_seed(0))["layers"]["00"]
    cos, sin = D.rope_tables(cfg, 5, "cpu")
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(1)).bfloat16()
    assert D._mla(x, lp, cos, sin, cfg).shape == (2, 5, 64)
    assert calls == [(2, 5, 4, 8), (2, 5, 8)]


def _refusal_inputs():
    x = _inputs("test config")
    return x["q_raw"], x["kv"], x["kv_a"], x["cos"], x["sin"], x["grads"]


#: each argument the wrappers refuse, with what they raise
MLA_REFUSALS = {
    "cpu tensors, forward": (ValueError, "CUDA devices",
                             lambda q, kv, ka, c, s, g: K.mla_rope_forward(q, kv, ka, c, s)),
    "cpu tensors, backward": (ValueError, "CUDA devices",
                              lambda q, kv, ka, c, s, g: K.mla_rope_backward(*g, c, s, 32)),
    "f32 q_raw": (TypeError, "bf16 q_raw",
                  lambda q, kv, ka, c, s, g: K.mla_rope_forward(q.float(), kv, ka, c, s)),
    "bf16 cos": (ValueError, "f32",
                 lambda q, kv, ka, c, s, g: K.mla_rope_forward(q, kv, ka, c.bfloat16(), s)),
    "f16 dv": (TypeError, "bf16 dv",
               lambda q, kv, ka, c, s, g: K.mla_rope_backward(g[0], g[1], g[2].half(), c, s, 32)),
    "odd rope": (ValueError, "even rope",
                 lambda q, kv, ka, c, s, g: K.mla_rope_forward(
                     q[..., :23].contiguous(), kv[..., :31].contiguous(), ka[..., :39].contiguous(),
                     c[:, :7].contiguous(), s[:, :7].contiguous())),
    "rope not a multiple of 8": (ValueError, "even rope",
                                 lambda q, kv, ka, c, s, g: K.mla_rope_backward(
                                     *g, torch.zeros(5, 12), torch.zeros(5, 12), 32)),
    "nope not a multiple of 8": (ValueError, "nope 12",
                                 lambda q, kv, ka, c, s, g: K.mla_rope_forward(
                                     q[..., 4:].contiguous(), kv[..., 4:].contiguous(), ka, c, s)),
    "r not a multiple of 8": (ValueError, "r 28",
                              lambda q, kv, ka, c, s, g: K.mla_rope_forward(
                                  q, kv, ka[..., 4:].contiguous(), c, s)),
    "a strided forward input": (ValueError, "contiguous",
                                lambda q, kv, ka, c, s, g: K.mla_rope_forward(
                                    q.transpose(1, 2).contiguous().transpose(1, 2), kv, ka, c, s)),
    "a cos table of other rows": (ValueError, r"\(5, 8\)",
                                  lambda q, kv, ka, c, s, g: K.mla_rope_forward(
                                      q, kv, ka, torch.zeros(9, 8), torch.zeros(9, 8))),
    "dq's rows not contiguous": (ValueError, "contiguous rows",
                                 lambda q, kv, ka, c, s, g: K.mla_rope_backward(
                                     g[0].transpose(2, 3).contiguous().transpose(2, 3), g[1], g[2],
                                     c, s, 32)),
    "a head stride off 16 bytes": (ValueError, "multiples of 8",
                                   lambda q, kv, ka, c, s, g: K.mla_rope_backward(
                                       g[0], g[1], torch.zeros(2, 5, 4, 20).bfloat16()[..., :16],
                                       c, s, 32)),
    "more heads than the key's shared memory": (ValueError, "shared memory",
                                                lambda q, kv, ka, c, s, g: K.mla_rope_backward(
                                                    *(torch.zeros(1, 1, 200, w).bfloat16()
                                                      for w in (72, 72, 16)),
                                                    torch.zeros(1, 64), torch.zeros(1, 64), 32)),
    "dk of another shape": (ValueError, "dk must have",
                            lambda q, kv, ka, c, s, g: K.mla_rope_backward(
                                g[0], g[1][..., :16], g[2], c, s, 32)),
}


@pytest.mark.parametrize("case", sorted(MLA_REFUSALS))
def test_the_mla_kernels_refuse_what_they_do_not_take_and_build_nothing(case, monkeypatch):
    def no_nvcc(*a, **k):
        raise AssertionError("nothing may be built for an argument the kernels refuse")

    monkeypatch.setattr(K.subprocess, "Popen", no_nvcc)
    exc, match, call = MLA_REFUSALS[case]
    before = K.launch_counts()
    with pytest.raises(exc, match=match):
        call(*_refusal_inputs())
    assert K.launch_counts() == before
    assert all(k._fn is None for k in K.MLA_KERNELS)


def test_the_mla_kernels_share_one_source_and_count_their_launches():
    assert {k.source.name for k in K.MLA_KERNELS} == {"mla_rope.cu"}
    assert len({k.symbol for k in K.MLA_KERNELS}) == 2
    assert set(K.MLA_KERNELS) <= set(K.KERNELS)
    names = [k.name for k in K.MLA_KERNELS]
    assert names == ["mla_rope_fwd", "mla_rope_bwd"]
    assert set(names) <= set(K.launch_counts())
    assert len(K.KERNELS) == len({k.name for k in K.KERNELS}) == 16
    assert len({k.source for k in K.KERNELS}) == 6


def test_no_mla_kernel_name_is_read_as_attention():
    """dsv2.attention_ms sums the kernels its PATTERN matches: the glue's
    kernels are not attention."""
    import importlib.util
    import re
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "gpubench" / "metrics" / "dsv2.attention_ms.py"
    spec = importlib.util.spec_from_file_location("attention_ms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    source = (Path(K.CSRC_DIR) / "mla_rope.cu").read_text()
    kernels = re.findall(r"^(mla_rope_\w+)\(", source, flags=re.M)
    assert kernels == ["mla_rope_forward", "mla_rope_backward"]
    assert not any(re.search(mod.PATTERN, f"(anonymous namespace)::{k}(") for k in kernels)


def test_the_dsv2_step_on_the_cpu_builds_and_launches_no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU step must not build the kernels")

    monkeypatch.setattr(K, "build_kernels", refuse)
    monkeypatch.setattr(K.subprocess, "Popen", refuse)
    cfg = D.DeepseekV2Config(vocab=128, d_model=64, n_heads=4, qk_nope_head_dim=16,
                             qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32, n_layers=2,
                             dense_width=96, n_experts=16, experts_held=tuple(range(8)), top_k=3,
                             expert_width=24, seq=8, batch=2)
    counters = D.routing_counters(cfg, "cpu")
    params, opt = D.make_train_state(cfg, torch.Generator().manual_seed(0))
    step = D.make_train_step(cfg, torch.device("cpu"), counters)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=torch.Generator())
    before = K.launch_counts()
    assert torch.isfinite(step(params, opt, tokens))
    assert K.launch_counts() == before
    assert all(k._fn is None for k in K.MLA_KERNELS)
