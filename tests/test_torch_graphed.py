"""The workload's train step as one CUDA graph (tpudash_torch.models.graphed)
and the changes that make the step capturable, on the CPU.

A graph is captured and replayed only on a GPU: chip_smoke.py's graph phase
holds the graphed step against the eager one there.  On the CPU the step
runs eagerly, and these tests hold what the CPU can run:

- the capture-ready step (the per-layer recompute stashes no RNG state;
  AdamW is capturable on GPUs, the CPU's refuses it) equals the step as it
  was, bitwise over 3 steps, on one device and at dp 2 × tp 4 over 8 CPU
  devices; and its loss at each of the 3 steps is within 2^-10 of the
  reference's (tpudash.models.workload), the LOSS_RTOL of
  test_torch_workload.py and test_torch_sharded.py;
- the warm-up before a capture leaves the train state as it found it;
- graph_train_step refuses the CPU before running anything, and the runner
  trains eagerly there;
- optimizer states cross between capturable and non-capturable AdamW
  exactly, a checkpoint of the non-capturable optimizer included.
"""

import copy
import pathlib
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_probes import _forbidden_imports, _port_files
from tpudash.models import workload as J
from tpudash.parallel import mesh as jmesh
from tpudash_torch.models import graphed
from tpudash_torch.models import runner as runner_mod
from tpudash_torch.models import workload as T
from tpudash_torch.models.checkpoint import WorkloadCheckpointer
from tpudash_torch.models.runner import WorkloadRunner
from tpudash_torch.parallel.mesh import build_mesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU8 = [torch.device("cpu")] * 8
SIZES = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64, seq=16, batch=4)
JCFG, TCFG = J.WorkloadConfig(**SIZES), T.WorkloadConfig(**SIZES)
LOSS_RTOL = 2.0**-10
KINDS = ["one-device", "dp2-tp4"]


def _np_tokens(n=3):
    return [np.random.default_rng(seed).integers(0, JCFG.vocab, (JCFG.batch, JCFG.seq))
            for seed in range(n)]


def _port(kind, params, opt):
    """The runner's step of ``kind`` and its live state from a one-device
    train state."""
    if kind == "one-device":
        return (lambda p, o, t: T.train_step(p, o, t, TCFG)), (params, opt)
    step, shard_inputs = T.make_sharded_train_step(build_mesh({"dp": 2, "tp": 4}, CPU8), TCFG)
    return step, shard_inputs(params, opt)


def _tensors(state):
    """Every parameter and optimizer state tensor of a live state, in order."""
    _, opt = state
    out = []
    for p in (p for g in opt.param_groups for p in g["params"]):
        out += [p.detach(), *(opt.state[p][k] for k in sorted(opt.state[p]))]
    return out


def _run(kind, n=3, seed=0):
    step, state = _port(kind, *T.make_train_state(TCFG, torch.Generator().manual_seed(seed)))
    losses = [step(*state, torch.from_numpy(t)).item() for t in _np_tokens(n)]
    return losses, state


# --- the capture-ready step ----------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_capture_ready_step_equals_the_step_as_it_was(kind, monkeypatch):
    """Bitwise over 3 steps against the same step whose recompute stashes
    and restores the RNG state, as ``checkpoint`` does by default and as the
    step did before it became capturable."""
    real = T.checkpoint
    asked = []

    def spy(*args, **kwargs):
        asked.append(kwargs.get("preserve_rng_state"))
        return real(*args, **kwargs)

    monkeypatch.setattr(T, "checkpoint", spy)
    losses, state = _run(kind)
    assert asked and set(asked) == {False}
    monkeypatch.setattr(T, "checkpoint", lambda *a, preserve_rng_state, **k: real(*a, **k))
    before, old = _run(kind)
    assert losses == before
    assert all(torch.equal(a, b) for a, b in zip(_tensors(state), _tensors(old), strict=True))
    assert [g["capturable"] for g in state[1].param_groups] == [False]  # the CPU's AdamW


@pytest.fixture(scope="module")
def ref():
    """The reference's losses over 3 steps from one initial state: with
    ``jax.jit(train_step)`` on one device and with its sharded step at dp 2
    × tp 4 on the conftest's 8-device CPU mesh."""
    params = J.init_params(jax.random.PRNGKey(0), JCFG)
    host = jax.device_get(params)  # before the sharded step donates its inputs
    tokens = [jnp.asarray(t, jnp.int32) for t in _np_tokens()]
    step = jax.jit(lambda p, o, t: J.train_step(p, o, t, JCFG))
    p, o, losses = params, J.make_optimizer(JCFG).init(params), []
    for t in tokens:
        p, o, loss = step(p, o, t)
        losses.append(float(loss))
    sstep, shard_inputs = J.make_sharded_train_step(jmesh.build_mesh({"dp": 2, "tp": 4}), JCFG)
    p, o, _ = shard_inputs(params, J.make_optimizer(JCFG).init(params), tokens[0])
    sharded = []
    for t in tokens:
        p, o, loss = sstep(p, o, shard_inputs(p, o, t)[2])
        sharded.append(float(loss))
    return {"params": host, "one-device": losses, "dp2-tp4": sharded}


@pytest.mark.parametrize("kind", KINDS)
def test_capture_ready_step_matches_the_reference_over_three_steps(kind, ref):
    params = T.params_from_numpy(ref["params"], "cpu")
    for p in T.leaves(params):
        p.requires_grad_(True)
    step, state = _port(kind, params, T.make_optimizer(params, TCFG))
    got = [step(*state, torch.from_numpy(t)).item() for t in _np_tokens()]
    for g, w in zip(got, ref[kind], strict=True):
        assert abs(g - w) <= LOSS_RTOL * w


# --- the warm-up and the CPU's refusal ----------------------------------------------------

@pytest.mark.parametrize("trained", [False, True], ids=["fresh", "trained"])
@pytest.mark.parametrize("kind", KINDS)
def test_warm_up_leaves_the_train_state_as_it_found_it(kind, trained):
    """Two steps inside ``kept_train_state`` and then 3 steps give what 3
    steps alone give, bitwise, from a fresh optimizer (whose moments the
    warm-up makes) and from one that has stepped."""
    tokens = [torch.from_numpy(t) for t in _np_tokens()]
    step, a = _port(kind, *T.make_train_state(TCFG, torch.Generator().manual_seed(0)))
    _, b = _port(kind, *T.make_train_state(TCFG, torch.Generator().manual_seed(0)))
    if trained:
        step(*a, tokens[2])
        step(*b, tokens[2])
    with graphed.kept_train_state(b[1]):
        for t in tokens[:2]:
            step(*b, t.flip(0))
    assert all(p.grad is None for g in b[1].param_groups for p in g["params"])
    assert [step(*a, t).item() for t in tokens] == [step(*b, t).item() for t in tokens]
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b), strict=True))


def test_graph_train_step_refuses_a_cpu_device_and_runs_nothing():
    params, opt = T.make_train_state(TCFG, torch.Generator().manual_seed(0))
    calls = []
    with pytest.raises(ValueError, match=r"a CUDA graph needs CUDA devices, not \['cpu'\]"):
        graphed.graph_train_step(lambda *a: calls.append(a), params, opt,
                                 torch.zeros((TCFG.batch, TCFG.seq), dtype=torch.long))
    assert calls == [] and not opt.state
    # the devices of a step: the tokens' first, then the parameters', once each
    meta = torch.empty(2, device="meta")
    fake = types.SimpleNamespace(param_groups=[{"params": [meta, torch.zeros(2), meta]}])
    want = [torch.device("cpu"), torch.device("meta")]
    assert graphed.graph_devices(fake, torch.zeros(2)) == want


@pytest.mark.parametrize("where", [{"device": "cpu"}, {"devices": CPU8}], ids=["cpu", "cpu8"])
def test_runner_trains_eagerly_on_the_cpu(where, monkeypatch):
    captured = []
    monkeypatch.setattr(runner_mod, "graph_train_step", lambda *a: captured.append(a))
    cfg = T.WorkloadConfig(**{**SIZES, "n_heads": 2})
    runner = WorkloadRunner(cfg, steps_per_sync=2, **where).start()
    try:
        deadline = time.monotonic() + 60
        while not (runner.error or runner.steps >= 4) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert runner.error is None and runner.metrics()["steps"] >= 4
    finally:
        runner.stop()
    assert captured == []


# --- optimizer states and checkpoints ------------------------------------------------------

def _capturable(params):
    """The AdamW that ``make_optimizer`` gives on a GPU, over CPU tensors:
    it loads and saves a state here; only a GPU steps it."""
    opt = T.make_optimizer(params, TCFG)
    for g in opt.param_groups:
        g["capturable"] = True
    return opt


def _states_equal(a, b):
    pa = [p for g in a.param_groups for p in g["params"]]
    pb = [p for g in b.param_groups for p in g["params"]]
    for x, y in zip(pa, pb, strict=True):
        sa, sb = a.state[x], b.state[y]
        assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
        for k in sa:
            assert sa[k].device == x.device and torch.equal(sa[k], sb[k]), k
    return True


def test_optimizer_state_crosses_between_capturable_and_not_exactly():
    params, opt = T.make_train_state(TCFG, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_np_tokens(1)[0])
    T.train_step(params, opt, tokens, TCFG)
    # (a state_dict() holds the live tensors, and a load keeps them: copies
    # keep the three optimizers apart)
    cap = _capturable(params)
    T.load_optimizer_state(cap, copy.deepcopy(opt.state_dict()))
    assert cap.param_groups[0]["capturable"] is True and _states_equal(opt, cap)
    back = T.make_optimizer(params, TCFG)
    T.load_optimizer_state(back, copy.deepcopy(cap.state_dict()))
    assert back.param_groups[0]["capturable"] is False and _states_equal(opt, back)
    # the one that came back steps on the CPU as the original does
    twin = T._unflatten((n, t.detach().clone().requires_grad_(True))
                        for n, t in T.named_leaves(params))
    twin_opt = T.make_optimizer(twin, TCFG)
    T.load_optimizer_state(twin_opt, copy.deepcopy(opt.state_dict()))
    assert torch.equal(T.train_step(params, back, tokens, TCFG),
                       T.train_step(twin, twin_opt, tokens, TCFG))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(twin)))


def test_a_checkpoint_of_the_non_capturable_optimizer_restores_into_a_capturable_one(tmp_path):
    """The port's checkpoints before its step became a graph hold a
    non-capturable AdamW's state: ``capturable`` False in every group and
    the step counts on the host.  They restore into the capturable one."""
    params, opt = T.make_train_state(TCFG, torch.Generator().manual_seed(0))
    T.train_step(params, opt, torch.from_numpy(_np_tokens(1)[0]), TCFG)
    ck = WorkloadCheckpointer(str(tmp_path))
    ck.save(5, params, opt)
    saved = torch.load(tmp_path / "step_5" / "state.pt", weights_only=True)["opt_state"]
    assert [g["capturable"] for g in saved["param_groups"]] == [False]
    p2, _ = T.make_train_state(TCFG, torch.Generator().manual_seed(9))
    cap = _capturable(p2)
    assert ck.restore_latest(p2, cap)[2] == 5
    assert cap.param_groups[0]["capturable"] is True and _states_equal(opt, cap)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(p2)))


def test_the_import_scan_covers_the_graph_module():
    path = pathlib.Path(graphed.__file__).resolve()
    assert path in [p.resolve() for p in _port_files()]
    assert _forbidden_imports(path) == []
