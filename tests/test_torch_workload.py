"""The port's training workload (tpudash_torch.models, sources.workload) held
against the reference's (tpudash.models, sources.workload) on the CPU.

The reference runs once per file: module-scoped fixtures hold its initial
parameters, logits, loss, the parameters after one train step and the loss
after three.  The port gets the reference's own parameters through
``params_from_numpy``.  Tolerances are in bf16 units (u = 2^-8, one bf16
ulp relative to the value's scale):

- _rmsnorm, _sdpa, _attention: one unit of the output's scale; the two
  compute the same rounding points, so on this data they agree exactly.
- _mlp: two units: the reference's ``jax.nn.gelu`` rounds each of its
  elementwise steps to bf16 (``1 + tanh`` near −1 cancels), the port's
  ``F.gelu`` rounds once.
- logits: four units of the logit scale: the gelu difference passes through
  every layer.  A forward whose mask lets each position see the next one
  misses it by more than 30×.
- loss: 2^-10 of the reference loss (the loss averages the logit errors);
  the shifted mask misses it too.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import asyncio
import math
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch
from aiohttp.test_utils import TestClient, TestServer

from tpudash.models import workload as J
from tpudash_torch import schema as tschema
from tpudash_torch.config import Config
from tpudash_torch.exporter.server import WARMUP_TASK, make_app
from tpudash_torch.models import workload as T
from tpudash_torch.models.checkpoint import CheckpointError, WorkloadCheckpointer
from tpudash_torch.models.runner import WorkloadRunner
from tpudash_torch.ops import kernels as K
from tpudash_torch.sources.base import SourceError
from tpudash_torch.sources.workload import (
    WORKLOAD_LOSS,
    WORKLOAD_STEPS_PER_S,
    WORKLOAD_TFLOPS,
    TorchWorkloadSource,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, seq=16, batch=2)
JCFG, TCFG = J.WorkloadConfig(**SIZES), T.WorkloadConfig(**SIZES)
U = 2.0**-8  # one bf16 unit, relative
LOSS_RTOL = 2.0**-10
TINY = dict(workload_vocab=64, workload_d_model=32, workload_n_heads=2,
            workload_n_layers=1, workload_d_ff=64, workload_seq=16, workload_batch=4)
TINY_CFG = T.WorkloadConfig(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                            seq=16, batch=4)


# --- the reference, run once ------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    params = J.init_params(jax.random.PRNGKey(0), JCFG)
    tokens = np.random.default_rng(0).integers(0, JCFG.vocab, (JCFG.batch, JCFG.seq))
    jt = jnp.asarray(tokens, jnp.int32)
    # two compiles in all: the step returns the loss BEFORE its update, so
    # steps 1 and 4 give the losses at init and after three steps
    step = jax.jit(lambda p, o, t: J.train_step(p, o, t, JCFG))
    p, o = params, J.make_optimizer(JCFG).init(params)
    losses, after = [], []
    for _ in range(4):
        p, o, loss = step(p, o, jt)
        losses.append(float(loss))
        after.append(p)
    return {
        "params": jax.device_get(params),
        "tokens": tokens,
        "logits": np.asarray(jax.jit(lambda p, t: J.forward(p, t, JCFG))(params, jt)),
        "loss": losses[0],
        "params_1": jax.device_get(after[0]),
        "loss_3": losses[3],
    }


def _port_state(ref):
    params = T.params_from_numpy(ref["params"], "cpu")
    for p in T.leaves(params):
        p.requires_grad_(True)
    return params, T.make_optimizer(params, TCFG)


def _tokens(ref):
    return torch.from_numpy(ref["tokens"])


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _torch(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.detach().float().numpy()


# --- modules ----------------------------------------------------------------------

def _module_cases():
    rng = np.random.default_rng(1)
    d, f, H, hd = JCFG.d_model, JCFG.d_ff, JCFG.n_heads, JCFG.head_dim
    x = _bf16(rng.standard_normal((2, 16, d)))
    scale = rng.standard_normal(d).astype(np.float32)
    q, k, v = (_bf16(rng.standard_normal((2, H, 16, hd))) for _ in range(3))
    wqkv, wo = _bf16(rng.standard_normal((d, 3 * d)) * d**-0.5), _bf16(rng.standard_normal((d, d)) * d**-0.5)
    up, down = _bf16(rng.standard_normal((d, f)) * d**-0.5), _bf16(rng.standard_normal((f, d)) * f**-0.5)
    return {
        "_rmsnorm": (lambda: J._rmsnorm(jnp.asarray(x), jnp.asarray(scale)),
                     lambda: T._rmsnorm(_torch(x), torch.from_numpy(scale)), 1),
        "_sdpa": (lambda: J._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)),
                  lambda: T._sdpa(_torch(q), _torch(k), _torch(v)), 1),
        "_attention": (lambda: J._attention(jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(wo), JCFG),
                       lambda: T._attention(_torch(x), _torch(wqkv), _torch(wo), TCFG), 1),
        "_mlp": (lambda: J._mlp(jnp.asarray(x), jnp.asarray(up), jnp.asarray(down)),
                 lambda: T._mlp(_torch(x), _torch(up), _torch(down)), 2),
    }


MODULES = _module_cases()


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_reference(name):
    ref_fn, port_fn, units = MODULES[name]
    want = np.asarray(ref_fn()).astype(np.float32)
    got = _np(port_fn())
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= units * U * np.abs(want).max()


def _sdpa_sees_next(q, k, v):
    """_sdpa with a mask that lets each position see the next one."""
    t, hd = q.shape[2], q.shape[3]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd**-0.5
    seen = torch.ones((t, t), dtype=torch.bool).tril(1)
    probs = torch.softmax(scores.masked_fill(~seen, -1e30), dim=-1).to(torch.bfloat16)
    return torch.matmul(probs, v)


def test_forward_logits_and_loss_match_reference(ref):
    params = T.params_from_numpy(ref["params"], "cpu")
    with torch.no_grad():
        logits = T.forward(params, _tokens(ref), TCFG)
        loss = T.loss_fn(params, _tokens(ref), TCFG).item()
    assert logits.dtype == torch.float32 and logits.shape == ref["logits"].shape
    assert np.abs(_np(logits) - ref["logits"]).max() <= 4 * U * np.abs(ref["logits"]).max()
    assert abs(loss - ref["loss"]) <= LOSS_RTOL * ref["loss"]


@pytest.mark.parametrize("what", ["_sdpa", "logits", "loss"])
def test_a_mask_that_sees_the_next_position_fails_the_tolerance(what, ref, monkeypatch):
    monkeypatch.setattr(T, "_sdpa", _sdpa_sees_next)
    if what == "_sdpa":
        ref_fn, port_fn, units = MODULES["_sdpa"]
        want = np.asarray(ref_fn()).astype(np.float32)
        assert np.abs(_np(port_fn()) - want).max() > 30 * units * U * np.abs(want).max()
        return
    params = T.params_from_numpy(ref["params"], "cpu")
    with torch.no_grad():
        if what == "logits":
            got = _np(T.forward(params, _tokens(ref), TCFG))
            assert np.abs(got - ref["logits"]).max() > 30 * 4 * U * np.abs(ref["logits"]).max()
        else:
            got = T.loss_fn(params, _tokens(ref), TCFG).item()
            assert abs(got - ref["loss"]) > LOSS_RTOL * ref["loss"]


# --- training ----------------------------------------------------------------------

def _bf16_ulp(a):
    """One bf16 ulp of each element of ``a`` (f32 array of bf16 values)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _pairs(want, got, name=""):
    if isinstance(want, dict):
        for k in want:
            yield from _pairs(want[k], got[k], f"{name}.{k}" if name else k)
        return
    yield name, np.asarray(want), got


def test_every_parameter_after_one_adamw_step_matches_reference(ref):
    """The first AdamW update is about lr·sign(grad) for every element, so
    the two agree to rounding except where a gradient lies at the rounding
    level of the two backward passes and its sign differs: such an element
    moves 2·lr apart.  Per tensor: no element more than 2·lr plus one ulp
    from the reference, and at most 2 % more than one ulp (f32 ulps for the
    f32 norms).  A wrong lr, bias correction or sign moves almost every
    element of the f32 norms by more than an ulp."""
    params, opt = _port_state(ref)
    T.train_step(params, opt, _tokens(ref), TCFG)
    lr = TCFG.lr
    for name, want, got in _pairs(ref["params_1"], params):
        bf16 = want.dtype.name == "bfloat16"
        want = want.astype(np.float32)
        got = _np(got)
        ulp = _bf16_ulp(want) if bf16 else np.spacing(np.abs(want))
        err = np.abs(got - want)
        assert got.dtype == np.float32 and got.shape == want.shape, name
        assert (err <= 2 * lr + ulp).all(), name
        assert (err > ulp).mean() <= 0.02, name


def test_loss_after_three_steps_matches_reference(ref):
    params, opt = _port_state(ref)
    losses = [T.train_step(params, opt, _tokens(ref), TCFG).item() for _ in range(3)]
    with torch.no_grad():
        loss_3 = T.loss_fn(params, _tokens(ref), TCFG).item()
    assert abs(losses[0] - ref["loss"]) <= LOSS_RTOL * ref["loss"]
    assert abs(loss_3 - ref["loss_3"]) <= LOSS_RTOL * ref["loss_3"]


def test_moments_stay_in_the_parameters_dtype(ref):
    params, opt = _port_state(ref)
    T.train_step(params, opt, _tokens(ref), TCFG)
    for p in T.leaves(params):
        st = opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == p.dtype
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        3e-4, (0.9, 0.999), 1e-8, 0.01)
    assert len(group["params"]) == len(T.leaves(params)) == 9  # norms included


# --- the reference's own model tests, ported (tests/test_models.py) ---------------

def _init(cfg=TCFG, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed))


def test_init_params_tree_matches_reference(ref):
    params = _init()
    for name, want, got in _pairs(ref["params"], params):
        assert tuple(got.shape) == want.shape, name
        assert got.dtype == (torch.bfloat16 if want.dtype.name == "bfloat16" else torch.float32)
        if want.dtype.name == "bfloat16":  # same scale: std within 10 %
            assert abs(got.float().std().item() / want.astype(np.float32).std() - 1) < 0.1, name
        else:
            assert bool((got == 1).all()), name


def test_params_from_numpy_is_exact(ref):
    params = T.params_from_numpy(ref["params"], "cpu")
    for name, want, got in _pairs(ref["params"], params):
        assert np.array_equal(_np(got), want.astype(np.float32)), name


def test_forward_is_causal():
    params = _init()
    t1 = torch.randint(0, TCFG.vocab, (1, TCFG.seq), generator=torch.Generator().manual_seed(1))
    t2 = t1.clone()
    t2[0, -1] = (t1[0, -1] + 1) % TCFG.vocab
    with torch.no_grad():
        l1, l2 = T.forward(params, t1, TCFG), T.forward(params, t2, TCFG)
    np.testing.assert_allclose(_np(l1[0, :-1]), _np(l2[0, :-1]), rtol=1e-5)
    assert not np.allclose(_np(l1[0, -1]), _np(l2[0, -1]))


def test_loss_finite_and_near_uniform_at_init():
    tokens = torch.randint(0, TCFG.vocab, (TCFG.batch, TCFG.seq),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        loss = T.loss_fn(_init(), tokens, TCFG).item()
    assert math.isfinite(loss)
    assert abs(loss - math.log(TCFG.vocab)) < 1.0


def test_train_step_decreases_loss():
    params, opt = T.make_train_state(TCFG, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, TCFG.vocab, (TCFG.batch, TCFG.seq),
                           generator=torch.Generator().manual_seed(1))
    first = T.train_step(params, opt, tokens, TCFG).item()
    for _ in range(9):
        loss = T.train_step(params, opt, tokens, TCFG).item()
    assert loss < first  # memorizing one batch must reduce loss


@pytest.mark.parametrize("sizes", [SIZES, {}, dict(
    vocab=2048, d_model=1024, n_heads=16, n_layers=8, d_ff=4096, seq=512, batch=16)])
def test_flops_per_step_matches_reference(sizes):
    got = T.flops_per_step(T.WorkloadConfig(**sizes))
    assert got == J.flops_per_step(J.WorkloadConfig(**sizes))
    if sizes.get("batch") == 16:  # the workload source's defaults: 5.46 TFLOP
        assert round(got / 1e12, 2) == 5.46


# --- runner and source (tests/test_workload_source.py) -----------------------------

def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_runner_trains_and_reports():
    runner = WorkloadRunner(TINY_CFG, steps_per_sync=2, device="cpu").start()
    try:
        assert _wait(lambda: runner.metrics()["steps"] >= 4), runner.error
        m = runner.metrics()
        assert m["steps"] >= 4 and m["steps"] % 2 == 0
        assert math.isfinite(m["loss"])
        assert m["steps_per_second"] > 0 and m["achieved_tflops"] > 0
        assert m["achieved_tflops"] == pytest.approx(
            T.flops_per_step(TINY_CFG) * m["steps_per_second"] / 1e12)
    finally:
        runner.stop()
    assert not runner.running


def test_runner_stop_is_idempotent():
    runner = WorkloadRunner(TINY_CFG, device="cpu")
    runner.stop()  # never started — no crash
    runner.start()
    runner.stop()
    runner.stop()
    assert not runner.running


def test_workload_source_end_to_end():
    src = TorchWorkloadSource(Config(source="workload", extra=dict(TINY)), device="cpu")
    try:
        assert src.runner.cfg == TINY_CFG
        assert _wait(lambda: src.runner.start().metrics()["steps"] >= 1)
        samples = src.fetch()
        got = {s.metric: s.value for s in samples}
        assert set(got) == {tschema.TENSORCORE_UTIL, tschema.HBM_USED, tschema.HBM_TOTAL,
                            WORKLOAD_LOSS, WORKLOAD_STEPS_PER_S, WORKLOAD_TFLOPS}
        assert {s.chip for s in samples} == {tschema.ChipKey("local", "localhost", 0)}
        assert {s.accelerator_type for s in samples} == {"nvidia-h100-80gb"}
        assert 0 <= got[tschema.TENSORCORE_UTIL] <= 100
        # utilisation divides by the H100 record's 989 TFLOP/s, not v5e's
        assert got[tschema.TENSORCORE_UTIL] == pytest.approx(got[WORKLOAD_TFLOPS] / 989.0 * 100)
        assert got[tschema.HBM_TOTAL] == 80 * 1024**3
    finally:
        src.close()
    assert not src.runner.running


def test_workload_source_defaults_are_the_reference_sizes():
    src = TorchWorkloadSource(Config(source="workload"), device="cpu")
    assert src.runner.cfg == T.WorkloadConfig(
        vocab=2048, d_model=1024, n_heads=16, n_layers=8, d_ff=4096, seq=512, batch=16)
    assert src.runner.steps_per_sync == 8
    assert (src.runner.checkpoint_dir, src.runner.checkpoint_every) == ("", 64)


def test_source_skips_nan_and_surfaces_a_crash_as_source_error():
    src = TorchWorkloadSource(Config(source="workload", extra=dict(TINY)), device="cpu")
    src.runner.start = lambda: src.runner  # no training: loss and rates are NaN
    names = {s.metric for s in src.fetch()}
    assert WORKLOAD_LOSS not in names and tschema.HBM_USED in names
    src.runner.error = "workload crashed: boom"
    with pytest.raises(SourceError, match="boom"):
        src.fetch()


def test_no_gpu_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(source="workload", extra=dict(TINY))
    for make in (lambda: TorchWorkloadSource(cfg), lambda: make_app(cfg),
                 lambda: WorkloadRunner(TINY_CFG)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_exporter_serves_the_workload_source():
    async def go():
        client = TestClient(TestServer(make_app(
            Config(source="workload", extra={**TINY, "workload_steps_per_sync": 1}),
            device="cpu")))
        await client.start_server()
        try:
            await client.app[WARMUP_TASK]  # starts the runner
            for _ in range(200):
                text = await (await client.get("/metrics")).text()
                if f"\n{WORKLOAD_LOSS}{{" in text:
                    break
                await asyncio.sleep(0.05)
            for series in (WORKLOAD_LOSS, WORKLOAD_STEPS_PER_S, WORKLOAD_TFLOPS,
                           tschema.TENSORCORE_UTIL):
                assert f"\n{series}{{" in text
            health = await (await client.get("/healthz")).json()
            assert health == {"ok": True, "source": "workload", "error": None}
        finally:
            await client.close()

    asyncio.run(go())


# --- checkpoints (tests/test_checkpoint.py) -----------------------------------------

def _state_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(b)))


def _capturable(params, cfg):
    """The AdamW that ``make_optimizer`` gives on a GPU, over CPU tensors: it
    loads and saves a state here; only a GPU steps it."""
    opt = T.make_optimizer(params, cfg)
    for g in opt.param_groups:
        g["capturable"] = True
    return opt


def test_checkpoint_round_trip_exact(tmp_path):
    params, opt = T.make_train_state(TINY_CFG, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, TINY_CFG.vocab, (TINY_CFG.batch, TINY_CFG.seq))
    T.train_step(params, opt, tokens, TINY_CFG)  # non-trivial moments
    ck = WorkloadCheckpointer(str(tmp_path))
    ck.save(7, params, opt)
    p2, o2 = T.make_train_state(TINY_CFG, torch.Generator().manual_seed(9))
    r_params, r_opt, step = ck.restore_latest(p2, o2)
    assert step == 7 and r_params is p2 and r_opt is o2
    assert _state_equal(p2, params)
    for a, b in zip(T.leaves(params), T.leaves(p2)):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[a][key], o2.state[b][key])
    # the restored state trains on identically
    assert torch.equal(T.train_step(params, opt, tokens, TINY_CFG),
                       T.train_step(p2, o2, tokens, TINY_CFG))
    assert _state_equal(p2, params)
    # a capturable AdamW's state (make_optimizer's on a GPU) round-trips
    # exactly too, into a capturable optimizer and into the CPU's
    p3, _ = T.make_train_state(TINY_CFG, torch.Generator().manual_seed(5))
    cap = _capturable(p3, TINY_CFG)
    ck.restore_latest(p3, cap)
    ck.save(8, p3, cap)
    for make in (_capturable, T.make_optimizer):
        p4, _ = T.make_train_state(TINY_CFG, torch.Generator().manual_seed(6))
        o4 = make(p4, TINY_CFG)
        assert ck.restore_latest(p4, o4)[2] == 8
        assert o4.param_groups[0]["capturable"] is (make is _capturable)
        assert _state_equal(p4, p3)
        for a, b in zip(T.leaves(p3), T.leaves(p4)):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(cap.state[a][key], o4.state[b][key])


def test_checkpoint_empty_dir_restores_none(tmp_path):
    ck = WorkloadCheckpointer(str(tmp_path))
    assert ck.restore_latest(*T.make_train_state(TINY_CFG, torch.Generator())) is None
    assert ck.latest_step() is None


def test_checkpoint_retention_keeps_newest(tmp_path):
    ck = WorkloadCheckpointer(str(tmp_path), keep=2)
    p, o = T.make_train_state(TINY_CFG, torch.Generator())
    for step in (1, 2, 3, 4):
        ck.save(step, p, o)
    assert ck.steps() == [3, 4]
    assert ck.latest_step() == 4
    assert sorted(x.name for x in tmp_path.iterdir()) == ["step_3", "step_4"]


def test_checkpoint_of_another_shape_loads_nothing(tmp_path):
    ck = WorkloadCheckpointer(str(tmp_path))
    ck.save(1, *T.make_train_state(TINY_CFG, torch.Generator()))
    other = T.WorkloadConfig(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, seq=16, batch=4)
    p, o = T.make_train_state(other, torch.Generator().manual_seed(3))
    before = [t.clone() for t in T.leaves(p)]
    with pytest.raises(CheckpointError, match="does not match"):
        ck.restore_latest(p, o)
    assert all(torch.equal(a, b) for a, b in zip(before, T.leaves(p)))


def test_runner_resumes_across_restart(tmp_path):
    ckdir = str(tmp_path / "ck")
    r1 = WorkloadRunner(TINY_CFG, steps_per_sync=1, checkpoint_dir=ckdir,
                        checkpoint_every=2, device="cpu").start()
    try:
        assert _wait(lambda: r1.steps >= 4), f"runner stalled (error={r1.error})"
    finally:
        r1.stop()
    saved = WorkloadCheckpointer(ckdir).latest_step()
    assert saved is not None and saved >= 4  # the final save on stop

    r2 = WorkloadRunner(TINY_CFG, steps_per_sync=1, checkpoint_dir=ckdir,
                        checkpoint_every=2, device="cpu").start()
    try:
        assert _wait(lambda: r2.steps > saved), f"resume stalled (error={r2.error})"
        m = r2.metrics()
        assert m["resumed_from"] == saved and m["steps"] > saved
    finally:
        r2.stop()


def test_orbax_checkpoint_of_the_reference_degrades_to_no_checkpoints(tmp_path, caplog):
    """The JAX package's orbax checkpoints also live in step_<n>
    directories; the port refuses them, and its runner trains on without
    checkpoints instead of crashing or loading garbage."""
    from tpudash.models.checkpoint import WorkloadCheckpointer as OrbaxCheckpointer

    tree = {"embed": np.ones((64, 32), np.float32), "ln_f": np.ones(32, np.float32)}
    OrbaxCheckpointer(str(tmp_path)).save(5, tree, {"mu": tree})
    assert WorkloadCheckpointer(str(tmp_path)).latest_step() == 5
    with pytest.raises(CheckpointError, match="orbax"):
        WorkloadCheckpointer(str(tmp_path)).restore_latest(
            *T.make_train_state(TINY_CFG, torch.Generator()))

    runner = WorkloadRunner(TINY_CFG, steps_per_sync=1, checkpoint_dir=str(tmp_path),
                            checkpoint_every=1, device="cpu")
    with caplog.at_level("WARNING", logger="tpudash_torch.models.runner"):
        runner.start()
        try:
            assert _wait(lambda: runner.metrics()["steps"] >= 2), runner.error
        finally:
            runner.stop()
    assert runner.error is None and runner.resumed_from is None
    assert any("checkpointing disabled" in r.getMessage() for r in caplog.records)
    assert WorkloadCheckpointer(str(tmp_path)).steps() == [5]  # nothing written over it


# --- the norm's kernels: their plain versions and wrappers on the CPU ---------------
#
# On a GPU ``_rmsnorm`` runs ``kernels.rmsnorm`` (csrc/rmsnorm.cu, forward and
# backward); chip_smoke.py's norm phase holds the kernels to these plain
# versions on the card.  Here: the CPU path is the plain expression, the
# backward's closed form is autograd's and the reference's gradient, the
# wrappers refuse what the kernels do not take before anything is built, and
# the launch plan covers every width it accepts.


def _norm_inputs(shape, seed=5):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = _torch(_bf16(rng.standard_normal(shape) * 3))
    scale = torch.from_numpy((1 + 0.2 * rng.standard_normal(d)).astype(np.float32))
    g = _torch(_bf16(rng.standard_normal(shape)))
    return x, scale, g


@pytest.mark.parametrize("shape", [(2, 16, 64), (37, 1024), (3, 8)])
def test_rmsnorm_on_cpu_is_bitwise_the_plain_expression(shape):
    x, scale, _ = _norm_inputs(shape)
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    want = (x32 * rms * scale).to(torch.bfloat16)
    got = T._rmsnorm(x, scale)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(K.rmsnorm_ref(x, scale), want)


@pytest.mark.parametrize("d", [64, 1024])
def test_rmsnorm_backward_closed_form_matches_autograd_and_the_reference(d):
    """The kernel's closed form (dx before its rounding, dscale) against
    autograd of the plain forward and ``jax.vjp`` of the reference's
    ``_rmsnorm``, x given in f32 (bf16 values) so that dx is compared before
    the bf16 rounding: within f32 noise, 2^-18 of the largest value."""
    x, scale, g = _norm_inputs((3, 40, d), seed=d)
    dx, dscale = K.rmsnorm_grads_ref(x, scale, g)
    assert dx.dtype == dscale.dtype == torch.float32 and dscale.shape == (d,)

    xr = x.float().requires_grad_(True)
    sr = scale.clone().requires_grad_(True)
    want_dx, want_ds = torch.autograd.grad(K.rmsnorm_ref(xr, sr), (xr, sr), g)

    _, vjp = jax.vjp(J._rmsnorm, jnp.asarray(x.float().numpy()), jnp.asarray(scale.numpy()))
    ref_dx, ref_ds = (np.asarray(a, np.float32)
                      for a in vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16)))

    for got, wants in ((dx, (want_dx, ref_dx)), (dscale, (want_ds, ref_ds))):
        got = got.numpy()
        for want in wants:
            want = np.asarray(want, np.float32)
            assert np.abs(got - want).max() <= 2.0**-18 * np.abs(want).max()
    # rounded once, dx is within one bf16 unit of autograd's rounded gradient
    xb = x.clone().requires_grad_(True)
    (auto_dx,) = torch.autograd.grad(K.rmsnorm_ref(xb, scale), (xb,), g)
    assert auto_dx.dtype == torch.bfloat16
    assert (dx.to(torch.bfloat16).float() - auto_dx.float()).abs().max() <= U * dx.abs().max()


def _refuses(exc, monkeypatch, fn, *args):
    def no_nvcc(*a, **k):
        raise AssertionError("nothing may be built for an argument the kernels refuse")

    monkeypatch.setattr(K.subprocess, "Popen", no_nvcc)
    before = K.launch_counts()
    with pytest.raises(exc):
        fn(*args)
    assert K.launch_counts() == before
    assert K.RMSNORM_FWD._fn is None and K.RMSNORM_BWD._fn is None


NORM_REFUSALS = {
    "cpu tensors": (ValueError, lambda: _norm_inputs((4, 64))),
    "f32 x": (TypeError, lambda: (torch.ones(4, 64), torch.ones(64), torch.ones(4, 64).bfloat16())),
    "f16 x": (TypeError, lambda: (torch.ones(4, 64).half(), torch.ones(64), torch.ones(4, 64).half())),
    "bf16 scale": (TypeError, lambda: (torch.ones(4, 64).bfloat16(), torch.ones(64).bfloat16(),
                                       torch.ones(4, 64).bfloat16())),
    "d not a multiple of 8": (ValueError, lambda: _norm_inputs((4, 60))),
    "d above the widest": (ValueError, lambda: _norm_inputs((2, K.NORM_MAX_D + 8))),
    "scale of another width": (ValueError, lambda: (torch.ones(4, 64).bfloat16(), torch.ones(32),
                                                    torch.ones(4, 64).bfloat16())),
    "non-contiguous x": (ValueError, lambda: (torch.ones(64, 4).bfloat16().t(), torch.ones(64),
                                              torch.ones(4, 64).bfloat16())),
}


@pytest.mark.parametrize("case", NORM_REFUSALS)
@pytest.mark.parametrize("which", ["forward", "backward", "function"])
def test_rmsnorm_wrappers_raise_before_launching(case, which, monkeypatch):
    exc, make = NORM_REFUSALS[case]
    x, scale, g = make()
    fn = {"forward": lambda: K.rmsnorm_forward(x, scale),
          "backward": lambda: K.rmsnorm_backward(x, scale, g),
          "function": lambda: K.rmsnorm(x, scale)}[which]
    _refuses(exc, monkeypatch, fn)


def test_rmsnorm_backward_refuses_a_gradient_of_another_shape(monkeypatch):
    x, scale, g = _norm_inputs((4, 64))
    _refuses(ValueError, monkeypatch, K.rmsnorm_backward, x, scale, g[:2])


@pytest.mark.parametrize("d", [8, 64, 256, 1000, 1024, 1032, 2048, 2056, 4096, 4104, 8192])
@pytest.mark.parametrize("rows", [1, 7, 8176])
def test_norm_plan_covers_each_row_once_with_a_fixed_backward_grid(rows, d):
    """csrc/rmsnorm.cu's plan: a team of ``warps`` warps covers a row with
    ``vecs`` 16-byte vectors a thread (at most 4) and as few warps as will
    do; the forward has a team for every row; the backward's grid depends
    on the shape alone and stays within the C entry's 264 blocks."""
    p = K._norm_plan(rows, d)
    assert p.warps in (1, 2, 4, 8) and 1 <= p.vecs <= 4
    assert p.warps * 32 * p.vecs * 8 >= d > p.warps * 32 * (p.vecs - 1) * 8
    assert p.warps == 1 or d > p.warps // 2 * 32 * 4 * 8
    teams = 8 // p.warps
    assert p.forward_grid == -(-rows // teams)
    assert p.backward_grid == min(p.forward_grid, 264)
    assert K._norm_plan(rows, d) == p


@pytest.mark.parametrize("rows, d", [(0, 64), (4, 0), (4, 12), (4, K.NORM_MAX_D + 8)])
def test_norm_plan_refuses_what_the_kernels_do_not_take(rows, d):
    with pytest.raises(ValueError):
        K._norm_plan(rows, d)


def test_rmsnorm_function_wires_its_kernels_into_autograd(monkeypatch):
    """The autograd function with its two wrappers swapped for their plain
    versions on the CPU: it saves x and scale, hands the backward a
    contiguous gradient (here an expanded one, as ``y.sum()`` gives) and
    returns both gradients as autograd of the plain forward has them."""
    seen = {}

    def forward(x, scale, eps):
        return K.rmsnorm_ref(x, scale, eps)

    def backward(x, scale, g, eps):
        seen["contiguous"] = g.is_contiguous()
        seen["eps"] = eps
        dx, dscale = K.rmsnorm_grads_ref(x, scale, g, eps)
        return dx.to(torch.bfloat16), dscale

    monkeypatch.setattr(K, "rmsnorm_forward", forward)
    monkeypatch.setattr(K, "rmsnorm_backward", backward)
    x, scale, _ = _norm_inputs((5, 64))
    xk, sk = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    K.rmsnorm(xk, sk).float().sum().backward()
    xp, sp = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    K.rmsnorm_ref(xp, sp).float().sum().backward()
    assert seen == {"contiguous": True, "eps": K.NORM_EPS}
    assert xk.grad.dtype == torch.bfloat16 and sk.grad.dtype == torch.float32
    assert (xk.grad.float() - xp.grad.float()).abs().max() <= U * xp.grad.float().abs().max()
    assert torch.allclose(sk.grad, sp.grad, rtol=1e-5, atol=1e-5)


def test_importing_the_kernels_and_the_model_compiles_nothing():
    """A fresh interpreter imports torch, then, with nvcc and the library
    loader made to fail, ops.kernels and models.workload: nothing is built
    or loaded until a kernel is asked for on a GPU."""
    code = (
        "import ctypes, subprocess\n"
        "import torch\n"
        "def refuse(*a, **k):\n"
        "    raise SystemExit('built or loaded at import: %r' % (a,))\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "from tpudash_torch.ops import kernels\n"
        "from tpudash_torch.models import workload\n"
        "assert all(k._fn is None for k in kernels.KERNELS)\n"
        "assert {'rmsnorm_fwd', 'rmsnorm_bwd'} <= set(kernels.launch_counts())\n"
        "print('clean')\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "clean", r.stderr[-2000:]
