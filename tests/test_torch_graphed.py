"""The train steps as CUDA graphs (tpudash_torch.models.graphed) and the
changes that make each step capturable, on the CPU.

A graph is captured and replayed only on a GPU: chip_smoke.py's graph
phases hold each graphed step against the eager one there.  On the CPU the
steps run eagerly, and these tests hold what the CPU can run, for the
runner's one-device step and every make_*_train_step's: the dp 2 × tp 4 sharded
step, GPipe at dp 2 × pp 2, the 3D step at dp 2 × pp 2 × tp 2, the MoE over
ep 4 and the ring step over dp 2 × sp 4, on the CPU meshes of their own
tests:

- the capture-ready step (the per-layer recompute stashes no RNG state;
  AdamW is capturable on GPUs, the CPU's refuses it) equals the step as it
  was, bitwise over 3 steps; and its loss at each of the 3 steps is within
  2^-10 of the reference's jitted step (tpudash.models), the LOSS_RTOL of
  test_torch_workload.py, test_torch_sharded.py, test_torch_pipeline.py,
  test_torch_moe.py and test_torch_ring_attention.py;
- the warm-up before a capture leaves the train state as it found it;
- every make_*_train_step returns a compiled step (``graphed.compiled``) that runs
  eagerly on the CPU, captures nothing there and equals its ``.eager``
  bitwise; the wrapper refuses a state over CPU and CUDA devices before
  running anything, and, with the capture swapped for an eager stand-in,
  captures once per optimizer and shape, again after ``load_state_dict``,
  returns a loss of its own at each call and lets its optimizer go;
- graph_train_step refuses the CPU before running anything, and the runner
  trains eagerly there;
- optimizer states cross between capturable and non-capturable AdamW
  exactly, a checkpoint of the non-capturable optimizer included.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import copy
import gc
import math
import pathlib
import time
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_probes import _forbidden_imports, _port_files
from tpudash.models import moe as JM
from tpudash.models import pipeline as JP
from tpudash.models import ring_attention as JR
from tpudash.models import workload as J
from tpudash.parallel import mesh as jmesh
from tpudash_torch.models import graphed
from tpudash_torch.models import moe as TM
from tpudash_torch.models import pipeline as TP
from tpudash_torch.models import ring_attention as TR
from tpudash_torch.models import workload as T
from tpudash_torch.models.checkpoint import WorkloadCheckpointer
from tpudash_torch.models.runner import WorkloadRunner
from tpudash_torch.parallel.mesh import build_mesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU8 = [torch.device("cpu")] * 8
SIZES = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64, seq=16, batch=4)
#: two stages of one layer; M = 2 microbatches of the dp row's 2 sequences
PIPE_SIZES = dict(SIZES, n_layers=2)
#: tests/test_torch_moe.py's train-step configuration
MOE_SIZES = dict(vocab=64, d_model=32, d_ff=64, n_experts=8, seq=8, batch=8, capacity_factor=2.0)
JCFG, TCFG = J.WorkloadConfig(**SIZES), T.WorkloadConfig(**SIZES)
LOSS_RTOL = 2.0**-10
#: each kind's (reference config, port config)
CFGS = {
    "one-device": (JCFG, TCFG),
    "dp2-tp4": (JCFG, TCFG),
    "gpipe-dp2-pp2": (J.WorkloadConfig(**PIPE_SIZES), T.WorkloadConfig(**PIPE_SIZES)),
    "3d-dp2-pp2-tp2": (J.WorkloadConfig(**PIPE_SIZES), T.WorkloadConfig(**PIPE_SIZES)),
    "moe-ep4": (JM.MoEConfig(**MOE_SIZES), TM.MoEConfig(**MOE_SIZES)),
    "ring-dp2-sp4": (JCFG, TCFG),
}
KINDS = list(CFGS)


def _mesh(**axes):
    return build_mesh(axes, CPU8[:math.prod(axes.values())])


#: every make_*_train_step's step over its CPU mesh, from the port's config
MAKERS = {
    "dp2-tp4": lambda cfg: T.make_sharded_train_step(_mesh(dp=2, tp=4), cfg),
    "gpipe-dp2-pp2": lambda cfg: TP.make_pipeline_train_step(_mesh(dp=2, pp=2), cfg, 2),
    "3d-dp2-pp2-tp2": lambda cfg: TP.make_pipeline3d_train_step(_mesh(dp=2, pp=2, tp=2), cfg, 2),
    "moe-ep4": lambda cfg: TM.make_moe_train_step(_mesh(ep=4), cfg),
    "ring-dp2-sp4": lambda cfg: TR.make_ring_train_step(_mesh(dp=2, sp=4), cfg),
}


def _np_tokens(n=3, kind="one-device"):
    cfg = CFGS[kind][1]
    return [np.random.default_rng(seed).integers(0, cfg.vocab, (cfg.batch, cfg.seq))
            for seed in range(n)]


def _state(kind, seed=0):
    """A fresh one-device train state of ``kind``'s configuration."""
    g = torch.Generator().manual_seed(seed)
    if kind == "moe-ep4":
        return TM.make_moe_train_state(CFGS[kind][1], g)
    return T.make_train_state(CFGS[kind][1], g)


def _port(kind, params, opt):
    """The step of ``kind`` (the runner's one-device step, or a make_*_train_step's)
    and its live state from a one-device train state; for the 3D step, a
    fresh one (its optimizer is made over the 3D tree)."""
    cfg = CFGS[kind][1]
    if kind == "one-device":
        return (lambda p, o, t: T.train_step(p, o, t, cfg)), (params, opt)
    step, shard_inputs = MAKERS[kind](cfg)
    if kind == "3d-dp2-pp2-tp2":
        assert not opt.state
        params, opt = TP.convert_params_3d(params), None
    return step, shard_inputs(params, opt)


def _tensors(state):
    """Every parameter and optimizer state tensor of a live state, in order."""
    _, opt = state
    out = []
    for p in (p for g in opt.param_groups for p in g["params"]):
        out += [p.detach(), *(opt.state[p][k] for k in sorted(opt.state[p]))]
    return out


def _run(kind, n=3, seed=0):
    step, state = _port(kind, *_state(kind, seed))
    losses = [step(*state, torch.from_numpy(t)).item() for t in _np_tokens(n, kind)]
    return losses, state


# --- the capture-ready step ----------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_capture_ready_step_equals_the_step_as_it_was(kind, monkeypatch):
    """Bitwise over 3 steps against the same step whose recompute stashes
    and restores the RNG state, as ``checkpoint`` does by default and as the
    step did before it became capturable.  The MoE's one block is not
    recomputed, as the reference's is not."""
    real = T.checkpoint
    asked = []

    def spy(*args, **kwargs):
        asked.append(kwargs.get("preserve_rng_state"))
        return real(*args, **kwargs)

    monkeypatch.setattr(T, "checkpoint", spy)
    losses, state = _run(kind)
    assert set(asked) == (set() if kind == "moe-ep4" else {False})
    monkeypatch.setattr(T, "checkpoint", lambda *a, preserve_rng_state, **k: real(*a, **k))
    before, old = _run(kind)
    assert losses == before
    assert all(torch.equal(a, b) for a, b in zip(_tensors(state), _tensors(old), strict=True))
    assert [g["capturable"] for g in state[1].param_groups] == [False]  # the CPU's AdamW


def _jmesh(**axes):
    return jmesh.build_mesh(axes, devices=jax.devices()[:math.prod(axes.values())])


@pytest.fixture(scope="module")
def ref():
    """The reference's losses over 3 steps from one initial state of each
    kind's configuration, and that state: ``jax.jit(train_step)`` on one
    device and, on the conftest's 8-device CPU mesh, its sharded step at dp
    2 × tp 4, GPipe at dp 2 × pp 2 and the 3D step at dp 2 × pp 2 × tp 2
    (M = 2), the MoE step over ep 4 and the ring step over dp 2 × sp 4."""
    host = {}
    for kind, (cfg, _) in CFGS.items():
        params = (JM.init_moe_params(jax.random.PRNGKey(0), cfg) if kind == "moe-ep4"
                  else J.init_params(jax.random.PRNGKey(0), cfg))
        host[kind] = jax.device_get(params)  # before a step donates its inputs

    def steps(kind, step, shard_inputs=None, convert=lambda p: p):
        cfg = CFGS[kind][0]
        p = convert(jax.tree.map(jnp.asarray, host[kind]))
        o, losses = J.make_optimizer(cfg).init(p), []
        for t in _np_tokens(kind=kind):
            t = jnp.asarray(t, jnp.int32)
            if shard_inputs is not None:
                p, o, t = shard_inputs(p, o, t)
            p, o, loss = step(p, o, t)
            losses.append(float(loss))
        return losses

    out = {"params": host,
           "one-device": steps("one-device", jax.jit(lambda p, o, t: J.train_step(p, o, t, JCFG))),
           "dp2-tp4": steps("dp2-tp4", *J.make_sharded_train_step(_jmesh(dp=2, tp=4), JCFG)),
           "gpipe-dp2-pp2": steps("gpipe-dp2-pp2", *JP.make_pipeline_train_step(
               _jmesh(dp=2, pp=2), CFGS["gpipe-dp2-pp2"][0], num_microbatches=2)),
           "3d-dp2-pp2-tp2": steps("3d-dp2-pp2-tp2", *JP.make_pipeline3d_train_step(
               _jmesh(dp=2, pp=2, tp=2), CFGS["3d-dp2-pp2-tp2"][0], num_microbatches=2),
               convert=JP.convert_params_3d),
           "moe-ep4": steps("moe-ep4", *JM.make_moe_train_step(_jmesh(ep=4), CFGS["moe-ep4"][0])),
           "ring-dp2-sp4": steps("ring-dp2-sp4", *JR.make_ring_train_step(_jmesh(dp=2, sp=4), JCFG))}
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_capture_ready_step_matches_the_reference_over_three_steps(kind, ref):
    params = T.params_from_numpy(ref["params"][kind], "cpu")
    for p in T.leaves(params):
        p.requires_grad_(True)
    step, state = _port(kind, params, T.make_optimizer(params, CFGS[kind][1]))
    got = [step(*state, torch.from_numpy(t)).item() for t in _np_tokens(kind=kind)]
    for g, w in zip(got, ref[kind], strict=True):
        assert abs(g - w) <= LOSS_RTOL * w


# --- the warm-up and the CPU's refusal ----------------------------------------------------

@pytest.mark.parametrize("trained", [False, True], ids=["fresh", "trained"])
@pytest.mark.parametrize("kind", KINDS)
def test_warm_up_leaves_the_train_state_as_it_found_it(kind, trained):
    """Two steps inside ``kept_train_state`` and then 3 steps give what 3
    steps alone give, bitwise, from a fresh optimizer (whose moments the
    warm-up makes) and from one that has stepped."""
    tokens = [torch.from_numpy(t) for t in _np_tokens(kind=kind)]
    step, a = _port(kind, *_state(kind))
    _, b = _port(kind, *_state(kind))
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


# --- the compiled step --------------------------------------------------------------------

def _fails(*args):
    raise AssertionError("a capture on the CPU")


@pytest.mark.parametrize("kind", list(MAKERS))
def test_every_make_train_step_compiles_its_step_and_the_cpu_runs_it_eagerly(kind, monkeypatch):
    """Each make_*_train_step's step is ``graphed.compiled``: it has ``.eager``, and
    on CPU devices it captures nothing and equals ``.eager`` bitwise over 3
    steps, in every loss, parameter and optimizer state."""
    monkeypatch.setattr(graphed, "graph_train_step", _fails)
    step, a = _port(kind, *_state(kind))
    _, b = _port(kind, *_state(kind))
    assert callable(step.eager) and step.eager is not step
    tokens = [torch.from_numpy(t) for t in _np_tokens(kind=kind)]
    got = [step(*a, t) for t in tokens]
    want = [step.eager(*b, t) for t in tokens]
    assert all(torch.equal(x, y) for x, y in zip(got, want, strict=True))
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b), strict=True))


def test_the_compiled_step_refuses_a_state_over_cpu_and_cuda_devices_and_runs_nothing():
    calls = []
    run = graphed.compiled(lambda *a: calls.append(a))
    cuda = types.SimpleNamespace(device=torch.device("cuda", 0))
    on_cuda = types.SimpleNamespace(param_groups=[{"params": [torch.zeros(2), cuda]}])
    with pytest.raises(ValueError, match=r"a CUDA graph needs CUDA devices, not \['cpu', 'cuda:0'\]"):
        run({}, on_cuda, torch.zeros((2, 3), dtype=torch.long))
    on_cpu = types.SimpleNamespace(param_groups=[{"params": [torch.zeros(2)]}])
    with pytest.raises(ValueError, match=r"not \['cuda:0', 'cpu'\]"):
        run({}, on_cpu, cuda)
    assert calls == []


def test_the_compiled_step_captures_once_per_state_and_shape_and_lets_its_optimizer_go(monkeypatch):
    """With the devices reported as one GPU and the capture swapped for an
    eager stand-in that, as a graph, warms up and undoes it, keeps a static
    loss and holds no reference to the optimizer: the first call applies
    exactly one step; each call returns a loss of its own; one capture
    serves every call with the same optimizer and tokens' shape, another
    shape captures its own, ``load_state_dict`` makes the next call capture
    again; the optimizer and its graphs go when the caller drops it."""
    captures, statics = [], []

    def stand_in(step, params, opt, tokens_like):
        captures.append(tuple(tokens_like.shape))
        with graphed.kept_train_state(opt):
            step(params, opt, torch.zeros_like(tokens_like))
        opt_ref, loss = weakref.ref(opt), torch.zeros(())
        statics.append(weakref.ref(loss))

        def replay(tokens):
            return loss.copy_(step(params, opt_ref(), tokens))

        return replay

    monkeypatch.setattr(graphed, "graph_train_step", stand_in)
    monkeypatch.setattr(graphed, "graph_devices", lambda opt, tokens: [torch.device("cuda", 0)])

    def step(p, o, t):
        return T.train_step(p, o, t, TCFG)

    run = graphed.compiled(step)
    live, twin = _state("one-device"), _state("one-device")
    t0, t1, t2 = (torch.from_numpy(t) for t in _np_tokens())
    got = [run(*live, t0), run(*live, t1)]
    assert captures == [tuple(t0.shape)] and got[0] is not got[1]
    assert all(torch.equal(g, step(*twin, t)) for g, t in zip(got, (t0, t1)))  # one step a call
    assert torch.equal(run(*live, t2[:, :8]), step(*twin, t2[:, :8]))
    assert captures == [tuple(t0.shape), (TCFG.batch, 8)]
    live[1].load_state_dict(copy.deepcopy(live[1].state_dict()))
    assert torch.equal(run(*live, t2), step(*twin, t2))
    assert len(captures) == 3 and run(*live, t0) is not None and len(captures) == 3
    step(*twin, t0)
    assert all(torch.equal(x, y) for x, y in zip(_tensors(live), _tensors(twin), strict=True))
    opt = weakref.ref(live[1])
    del live
    gc.collect()
    assert opt() is None and all(s() is None for s in statics)


@pytest.mark.parametrize("where", [{"device": "cpu"}, {"devices": CPU8}], ids=["cpu", "cpu8"])
def test_runner_trains_eagerly_on_the_cpu(where, monkeypatch):
    captured = []
    monkeypatch.setattr(graphed, "graph_train_step", lambda *a: captured.append(a))
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
