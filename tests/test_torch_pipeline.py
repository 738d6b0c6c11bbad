"""The port's GPipe pipeline and 3D steps (tpudash_torch.models.pipeline)
held against the reference's (tpudash.models.pipeline) on the CPU.

The reference runs on the conftest's 8-device virtual CPU mesh, the port
over ``[torch.device("cpu")] * n``, at the reference test's sizes
(tests/test_pipeline.py), from the reference's initial parameters carried
across through numpy.  Each reference is compiled once, in a module-scoped
fixture.  Tolerances:

- loss: 2^-10 of the reference's (LOSS_RTOL, as in
  tests/test_torch_sharded.py);
- against the port's own unsharded loss: rtol 1e-4 for the pipeline and
  5e-3 for the 3D step, the reference's own bounds
  (tests/test_pipeline.py:49 and :100);
- parameters after one AdamW step: the per-tensor rule of
  tests/test_torch_sharded.py (no element more than 2·lr plus one ulp
  from the reference, at most 2 % more than one ulp);
- dp replicas: bitwise equal; shards and moments carried across: exact.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding

from tpudash.models import pipeline as JP
from tpudash.models import workload as J
from tpudash.parallel import mesh as jmesh
from tpudash_torch.models import pipeline as TP
from tpudash_torch.models import workload as T
from tpudash_torch.parallel.mesh import Mesh, build_mesh
from torch_replicas import all_equal, record_block_replicas
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU8 = [torch.device("cpu")] * 8
SIZES = dict(vocab=64, d_model=32, n_heads=2, n_layers=4, d_ff=64, seq=16, batch=8)
JCFG, TCFG = J.WorkloadConfig(**SIZES), T.WorkloadConfig(**SIZES)
LOSS_RTOL = 2.0**-10
PIPE_RTOL = 1e-4
RTOL_3D = 5e-3
MICROBATCHES = (1, 2, 4)


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, SIZES["vocab"], (SIZES["batch"], SIZES["seq"]))



@pytest.fixture(scope="module")
def ref():
    """The reference at dp 2 × pp 4 (dp 2 × pp 2 × tp 2 in 3D), each run
    once: its initial parameters, its losses, and its parameters after one
    train step."""
    params, _ = J.make_train_state(jax.random.PRNGKey(0), JCFG)
    host = jax.device_get(params)
    tokens = _tokens()
    jt = jnp.asarray(tokens, jnp.int32)
    out = {"params": host, "tokens": tokens}
    mesh = jmesh.build_mesh({"dp": 2, "pp": 4})
    out["loss"] = {M: float(jax.jit(JP.make_pipeline_loss(mesh, JCFG, M))(params, jt))
                   for M in MICROBATCHES}
    out["loss_pp1"] = float(jax.jit(JP.make_pipeline_loss(
        jmesh.build_mesh({"dp": 8, "pp": 1}), JCFG, 1))(params, jt))
    step, shard_inputs = JP.make_pipeline_train_step(mesh, JCFG, num_microbatches=4)
    p, o, t = shard_inputs(jax.tree.map(jnp.asarray, host), J.make_optimizer(JCFG).init(params), jt)
    p, _, out["step_loss"] = step(p, o, t)
    out["params_1"] = jax.device_get(p)

    mesh3 = jmesh.build_mesh({"dp": 2, "pp": 2, "tp": 2})
    p3 = JP.convert_params_3d(jax.tree.map(jnp.asarray, host))
    out["loss_3d"] = float(jax.jit(JP.make_pipeline3d_loss(mesh3, JCFG, 2))(p3, jt))
    specs = dict(T.named_leaves(JP._stage_param_specs_3d()))
    out["shard_shapes_3d"] = {name: NamedSharding(mesh3, specs[name]).shard_shape(a.shape)
                              for name, a in T.named_leaves(p3)}
    step3, shard3 = JP.make_pipeline3d_train_step(mesh3, JCFG, num_microbatches=2)
    p3, o3, t = shard3(p3, J.make_optimizer(JCFG).init(p3), jt)
    p3, _, out["step_loss_3d"] = step3(p3, o3, t)
    out["params_3d_1"] = jax.device_get(p3)
    return out


def _params(ref):
    return T.params_from_numpy(ref["params"], "cpu")


def _mesh(dp=2, pp=4, tp=None):
    axes = {"dp": dp, "pp": pp, **({} if tp is None else {"tp": tp})}
    return build_mesh(axes, CPU8[: dp * pp * (tp or 1)])


def _unsharded_loss(ref):
    return T.loss_fn(_params(ref), torch.from_numpy(ref["tokens"]), TCFG).item()


def _bf16_ulp(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _assert_per_tensor_rule(got_tree, want_tree):
    want = dict(T.named_leaves(want_tree))
    lr = TCFG.lr
    for name, got in T.named_leaves(got_tree):
        w = np.asarray(want[name])
        bf16 = w.dtype.name == "bfloat16"
        w = w.astype(np.float32)
        g = got.float().numpy()
        ulp = _bf16_ulp(w) if bf16 else np.spacing(np.abs(w))
        err = np.abs(g - w)
        assert g.shape == w.shape, name
        assert (err <= 2 * lr + ulp).all(), name
        assert (err > ulp).mean() <= 0.02, name


def _assert_replicas_equal(sharded, opt):
    for name, rows in T.named_leaves(sharded):
        for c, part in enumerate(rows[0]):
            for row in rows[1:]:
                assert torch.equal(part, row[c]), name
                s0, s1 = opt.state[part], opt.state[row[c]]
                assert all(torch.equal(s0[k], s1[k]) for k in ("exp_avg", "exp_avg_sq", "step")), name


# --- the pipeline against the reference ---------------------------------------------

@pytest.mark.parametrize("M", MICROBATCHES)
def test_pipeline_loss_matches_reference_and_the_unsharded_loss(ref, M):
    mesh = _mesh()
    plan = TP.pipeline_plan(mesh, TCFG)
    loss = TP.make_pipeline_loss(mesh, TCFG, M)
    got = loss(T.shard_params(_params(ref), plan), torch.from_numpy(ref["tokens"])).item()
    assert abs(got - ref["loss"][M]) <= LOSS_RTOL * ref["loss"][M]
    plain = _unsharded_loss(ref)
    assert abs(got - plain) <= PIPE_RTOL * plain


def test_single_stage_pipeline_is_the_unsharded_loss(ref):
    mesh = _mesh(dp=8, pp=1)
    loss = TP.make_pipeline_loss(mesh, TCFG, 1)
    got = loss(T.shard_params(_params(ref), TP.pipeline_plan(mesh, TCFG)),
               torch.from_numpy(ref["tokens"])).item()
    assert abs(got - ref["loss_pp1"]) <= LOSS_RTOL * ref["loss_pp1"]
    plain = _unsharded_loss(ref)
    assert abs(got - plain) <= PIPE_RTOL * plain


def _pipeline_after_one_step(ref, three_d=False):
    if three_d:
        mesh, make, M = _mesh(2, 2, 2), TP.make_pipeline3d_train_step, 2
        params = TP.convert_params_3d(_params(ref))
    else:
        mesh, make, M = _mesh(), TP.make_pipeline_train_step, 4
        params = _params(ref)
    step, shard_inputs = make(mesh, TCFG, M)
    sharded, opt = shard_inputs(params, None)
    loss = step(sharded, opt, torch.from_numpy(ref["tokens"])).item()
    return sharded, opt, loss, TP.pipeline_plan(mesh, TCFG)


@pytest.mark.parametrize("three_d", [False, True], ids=["dp2-pp4", "dp2-pp2-tp2"])
def test_every_gathered_parameter_after_one_step_matches_reference(ref, three_d):
    sharded, opt, loss, plan = _pipeline_after_one_step(ref, three_d)
    want_loss = float(ref["step_loss_3d" if three_d else "step_loss"])
    assert abs(loss - want_loss) <= LOSS_RTOL * want_loss
    _assert_per_tensor_rule(T.gather_params(sharded, plan), ref["params_3d_1" if three_d else "params_1"])
    _assert_replicas_equal(sharded, opt)


def test_pipeline3d_loss_matches_reference_and_the_unsharded_loss(ref):
    mesh = _mesh(2, 2, 2)
    plan = TP.pipeline_plan(mesh, TCFG)
    loss = TP.make_pipeline3d_loss(mesh, TCFG, 2)
    sharded = T.shard_params(TP.convert_params_3d(_params(ref)), plan)
    got = loss(sharded, torch.from_numpy(ref["tokens"])).item()
    assert abs(got - ref["loss_3d"]) <= LOSS_RTOL * ref["loss_3d"]
    plain = _unsharded_loss(ref)
    assert abs(got - plain) <= RTOL_3D * plain


def test_3d_part_shapes_are_the_reference_stage_specs(ref):
    """Each 3D block part has the shard shape of the reference's
    ``_stage_param_specs_3d``; the leaves it replicates are whole, one on
    each tp device of the stage that uses them."""
    plan = TP.pipeline_plan(_mesh(2, 2, 2), TCFG)
    sharded = T.shard_params(TP.convert_params_3d(_params(ref)), plan)
    want = ref["shard_shapes_3d"]
    for name, rows in T.named_leaves(sharded):
        assert len(rows) == 2, name
        assert {tuple(p.shape) for row in rows for p in row} == {tuple(want[name])}, name
        n_parts = 2 if not name.startswith("blocks.") else 2 * 2  # (stage,) tp column
        assert len(rows[0]) == n_parts, name


def test_every_3d_tp_replica_and_its_gradient_is_bitwise_equal(monkeypatch):
    """dp 2 × pp 2 × tp 2 after one step: each stage's tp columns hold the
    activations (captured after every layer, with their gradients) and the
    stage's norms, embed on stage 0 and ln_f and unembed on the last, and
    every replica, its gradient included, has the bits of its column
    partner's."""
    outs, grads = record_block_replicas(monkeypatch, T)
    M = 2
    step, shard_inputs = TP.make_pipeline3d_train_step(_mesh(2, 2, 2), TCFG, M)
    params = T.init_params(TCFG, torch.Generator().manual_seed(0))
    sharded, opt = shard_inputs(TP.convert_params_3d(params), None)
    step(sharded, opt, torch.from_numpy(_tokens()))
    # rows × microbatches × layers, in the forward and in the recompute
    assert len(outs) == 2 * 2 * M * TCFG.n_layers and len(grads) == 2 * M * TCFG.n_layers
    assert all(len(ys) == 2 and all_equal(ys) for ys in outs + grads)
    for name, rows in T.named_leaves(sharded):
        if name.startswith("blocks.") and TP.TP_DIMS_3D[name[len("blocks."):]] is not None:
            continue
        for row in rows:
            for group in (row[:2], row[2:]) if name.startswith("blocks.") else (row,):
                assert len(group) == 2 and all_equal(group), name
                assert all_equal([p.grad for p in group]), name


# --- the plan --------------------------------------------------------------------

def test_plan_places_each_stage_and_column_on_its_mesh_device():
    """Stage s of row r on device (r·pp + s)·tp + c, the reference mesh's
    order; a norm on every tp device of its stage, embed on every one of
    the row's stage 0, ln_f and unembed on every one of its last."""
    devs = tuple(torch.device("cuda", i) for i in range(8))
    plan3 = TP.PipelinePlan(Mesh({"dp": 2, "pp": 2, "tp": 2}, devs), TCFG)
    assert plan3.part_device("blocks.wq", 1, 3) == devs[7]  # row 1, stage 1, column 1
    assert plan3.part_device("blocks.wo", 0, 1) == devs[1]
    assert [plan3.part_device("blocks.ln2", 1, i) for i in range(4)] == list(devs[4:])
    assert [plan3.part_device("embed", 1, c) for c in range(2)] == list(devs[4:6])
    for name in ("unembed", "ln_f"):
        assert [plan3.part_device(name, 1, c) for c in range(2)] == list(devs[6:])
    plan2 = TP.PipelinePlan(Mesh({"dp": 2, "pp": 4}, devs), TCFG)
    assert [plan2.part_device("blocks.wqkv", 1, s) for s in range(4)] == list(devs[4:])
    assert plan2.part_device("unembed", 0, 0) == devs[3]


@pytest.mark.parametrize("three_d", [False, True], ids=["dp2-pp4", "dp2-pp2-tp2"])
def test_shard_and_gather_carry_params_and_moments_exactly(three_d):
    params, opt = T.make_train_state(TCFG, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, TCFG.vocab, (TCFG.batch, TCFG.seq), generator=torch.Generator().manual_seed(1))
    T.train_step(params, opt, tokens, TCFG)  # moments to carry
    if three_d:
        params = TP.convert_params_3d(params)
        for p in T.leaves(params):
            p.requires_grad_(True)
        full_opt = T.make_optimizer(params, TCFG)
        for p in T.leaves(params):
            p.grad = torch.ones_like(p)
        full_opt.step()
        mesh, make = _mesh(2, 2, 2), TP.make_pipeline3d_train_step
    else:
        full_opt, mesh, make = opt, _mesh(), TP.make_pipeline_train_step
    plan = TP.pipeline_plan(mesh, TCFG)
    _, shard_inputs = make(mesh, TCFG)
    sharded, sopt = shard_inputs(params, full_opt)
    back = T.gather_params(sharded, plan)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(back)))
    want, got = full_opt.state_dict(), T.gather_optimizer_state(sopt, sharded, plan)
    assert got["param_groups"] == want["param_groups"] and set(got["state"]) == set(want["state"])
    for i, st in want["state"].items():
        assert all(torch.equal(got["state"][i][k], st[k]) for k in st), i
    ptrs = [p.data_ptr() for p in T.shard_leaves(sharded)]
    assert len(set(ptrs)) == len(ptrs)  # every part a tensor of its own


def test_convert_params_3d_matches_reference():
    params, _ = J.make_train_state(jax.random.PRNGKey(0), JCFG)
    want = dict(T.named_leaves(jax.device_get(JP.convert_params_3d(params))))
    got = TP.convert_params_3d(T.params_from_numpy(jax.device_get(params), "cpu"))
    assert set(dict(T.named_leaves(got))) == set(want)
    for name, t in T.named_leaves(got):
        assert np.array_equal(t.float().numpy(), np.asarray(want[name]).astype(np.float32)), name


@pytest.mark.parametrize("three_d", [False, True], ids=["dp2-pp2", "dp1-pp2-tp2"])
def test_each_layer_is_recomputed_in_backward(monkeypatch, three_d):
    calls = []
    name = "_sharded_block" if three_d else "_block"
    block = getattr(T, name)
    monkeypatch.setattr(T, name, lambda *a: calls.append(1) or block(*a))
    M = 2
    if three_d:
        step, shard_inputs = TP.make_pipeline3d_train_step(_mesh(1, 2, 2), TCFG, M)
        params = TP.convert_params_3d(T.init_params(TCFG, torch.Generator()))
        dp = 1
    else:
        step, shard_inputs = TP.make_pipeline_train_step(_mesh(2, 2), TCFG, M)
        params, dp = T.init_params(TCFG, torch.Generator()), 2
    sharded, opt = shard_inputs(params, None)
    step(sharded, opt, torch.zeros((TCFG.batch, TCFG.seq), dtype=torch.long))
    # each (row, microbatch) runs each layer forward once and again in backward
    assert len(calls) == 2 * dp * M * TCFG.n_layers


@pytest.mark.parametrize("three_d", [False, True], ids=["dp2-pp4", "dp2-pp2-tp2"])
def test_pipeline_train_step_learns(three_d):
    params = T.init_params(TCFG, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, TCFG.vocab, (TCFG.batch, TCFG.seq), generator=torch.Generator().manual_seed(1))
    if three_d:
        step, shard_inputs = TP.make_pipeline3d_train_step(_mesh(2, 2, 2), TCFG)
        params = TP.convert_params_3d(params)
    else:
        step, shard_inputs = TP.make_pipeline_train_step(_mesh(), TCFG, 2)
    sharded, opt = shard_inputs(params, None)
    losses = [step(sharded, opt, tokens).item() for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# --- what the reference refuses ------------------------------------------------------

def test_a_layer_count_that_does_not_split_over_pp_raises_like_the_reference():
    bad = dict(SIZES, n_layers=3)
    with pytest.raises(ValueError, match="n_layers=3 not divisible by pp=4"):
        JP.make_pipeline_loss(jmesh.build_mesh({"dp": 2, "pp": 4}), J.WorkloadConfig(**bad), 2)
    for make in (TP.make_pipeline_loss, TP.make_pipeline_train_step):
        with pytest.raises(ValueError, match="n_layers=3 not divisible by pp=4"):
            make(_mesh(), T.WorkloadConfig(**bad), 2)


def test_heads_that_do_not_split_over_tp_raise_like_the_reference():
    with pytest.raises(ValueError, match="n_heads=2 not divisible by tp=4"):
        JP.make_pipeline3d_loss(jmesh.build_mesh({"dp": 1, "pp": 2, "tp": 4}), JCFG, 2)
    for make in (TP.make_pipeline3d_loss, TP.make_pipeline3d_train_step):
        with pytest.raises(ValueError, match="n_heads=2 not divisible by tp=4"):
            make(_mesh(1, 2, 4), TCFG, 2)


def test_a_local_batch_that_does_not_split_into_microbatches_raises_like_the_reference(ref):
    jt = jnp.asarray(ref["tokens"], jnp.int32)
    params = jax.tree.map(jnp.asarray, ref["params"])
    with pytest.raises(ValueError, match="local batch 4 not divisible by microbatches 3"):
        JP.make_pipeline_loss(jmesh.build_mesh({"dp": 2, "pp": 4}), JCFG, 3)(params, jt)
    step, shard_inputs = TP.make_pipeline_train_step(_mesh(), TCFG, 3)
    sharded, opt = shard_inputs(_params(ref), None)
    with pytest.raises(ValueError, match="local batch 4 not divisible by microbatches 3"):
        step(sharded, opt, torch.from_numpy(ref["tokens"]))
    with pytest.raises(ValueError, match="batch 7 does not split over the dp axis of size 2"):
        step(sharded, opt, torch.zeros((7, TCFG.seq), dtype=torch.long))


def test_a_mesh_of_other_axes_raises():
    with pytest.raises(ValueError, match="needs a"):
        TP.make_pipeline_train_step(build_mesh({"dp": 2, "tp": 4}, CPU8), TCFG)
    with pytest.raises(ValueError, match="needs a"):
        TP.make_pipeline_train_step(_mesh(2, 2, 2), TCFG)
    with pytest.raises(ValueError, match="needs a"):
        TP.make_pipeline3d_train_step(_mesh(), TCFG)
