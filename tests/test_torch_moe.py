"""The port's expert-parallel MoE (tpudash_torch.models.moe) held against the
reference's (tpudash.models.moe) on the CPU.

The reference runs on the conftest's 8-device virtual CPU mesh, the port
over ``[torch.device("cpu")] * ep``, at the reference test's sizes
(tests/test_moe.py), from the reference's parameters carried across
through numpy.  The reference's train step is compiled once, in a
module-scoped fixture.  Tolerances:

- routing: dispatch bitwise; combine and aux within rtol 1e-5, the
  reference's own bound on the gates (tests/test_moe.py:100-110);
- the sharded FFN against the reference's sharded FFN and against both
  dense oracles: rtol 5e-2, atol 2e-2, the reference test's bound
  (tests/test_moe.py:66-69);
- loss: 2^-10 of the reference's (LOSS_RTOL, as in
  tests/test_torch_sharded.py); parameters after one AdamW step: the
  per-tensor rule of tests/test_torch_sharded.py, an f32 leaf's ulp
  widened by the reference's own error in its first update (lr·2^-17);
- replicas: bitwise equal; shards and moments carried across: exact.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from tpudash.models import moe as JM
from tpudash.models.ring_attention import _SHARD_MAP_KW, shard_map
from tpudash.parallel import mesh as jmesh
from tpudash_torch.models import moe as TM
from tpudash_torch.models import workload as T
from tpudash_torch.parallel.mesh import Mesh, build_mesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU8 = [torch.device("cpu")] * 8
SIZES = dict(vocab=64, d_model=32, d_ff=64, n_experts=8, seq=8, batch=8)
NO_DROP = dict(SIZES, capacity_factor=8.0)  # C = S: nothing drops
STEP = dict(SIZES, capacity_factor=2.0)  # tests/test_moe.py's train-step config
LOSS_RTOL = 2.0**-10


def _cfgs(**kw):
    return JM.MoEConfig(**kw), TM.MoEConfig(**kw)


def _tmesh(ep):
    return build_mesh({"ep": ep}, CPU8[:ep])


def _jmesh(ep):
    return jmesh.build_mesh({"ep": ep}, devices=jax.devices()[:ep])


def _tokens(cfg, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (cfg.batch, cfg.seq))



@pytest.fixture(scope="module")
def ref():
    """The reference's train step at ep 4, run once: its initial
    parameters, the loss of one step, and the parameters after it."""
    jcfg, tcfg = _cfgs(**STEP)
    params, opt_state = JM.make_moe_train_state(jax.random.PRNGKey(0), jcfg)
    host = jax.device_get(params)
    tokens = _tokens(jcfg)
    step, shard_inputs = JM.make_moe_train_step(_jmesh(4), jcfg)
    p, o, t = shard_inputs(params, opt_state, jnp.asarray(tokens, jnp.int32))
    p, _, loss = step(p, o, t)
    return {"cfg": tcfg, "params": host, "tokens": tokens, "loss": float(loss),
            "params_1": jax.device_get(p)}


# --- routing -------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("router", ["random", "zero"])
def test_route_matches_reference(top_k, router):
    """Capacity 1.0 drops tokens; a zero router ties every expert, and the
    top k go to the lowest indices, as lax.top_k gives them."""
    jcfg, tcfg = _cfgs(n_experts=8, top_k=top_k, capacity_factor=1.0)
    rng = np.random.default_rng(top_k)
    x = rng.standard_normal((16, jcfg.d_model)).astype(np.float32)
    r = (np.zeros if router == "zero" else rng.standard_normal)((jcfg.d_model, 8)).astype(np.float32)
    C = TM._capacity(16, tcfg)
    assert C == JM._capacity(16, jcfg)
    want = [np.asarray(a) for a in JM._route(jnp.asarray(x), jnp.asarray(r), jcfg, C)]
    got = [a.numpy() for a in TM._route(torch.from_numpy(x), torch.from_numpy(r), tcfg, C)]
    assert np.array_equal(got[0], want[0])
    assert got[0].sum() < 16 * top_k  # some assignments dropped
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    if router == "zero":  # every token's first choice is expert 0
        assert got[0][:, 0].sum() == C and got[0][:, top_k:].sum() == 0


@pytest.mark.parametrize("S,top_k,cf", [(64, 1, 1.25), (64, 2, 1.25), (3, 1, 0.25), (16, 2, 8.0)])
def test_capacity_matches_reference(S, top_k, cf):
    jcfg, tcfg = _cfgs(top_k=top_k, capacity_factor=cf)
    assert TM._capacity(S, tcfg) == JM._capacity(S, jcfg)


# --- the expert FFN over the ep slots ---------------------------------------------------

def _reference_ffn(mesh, cfg):
    G = mesh.shape["ep"]
    return jax.jit(shard_map(
        lambda p, x: JM.moe_ffn_local(x, p, cfg, G)[0], mesh=mesh,
        in_specs=(JM.moe_param_specs(), P("ep", None)), out_specs=P("ep", None), **_SHARD_MAP_KW))


@pytest.mark.parametrize("ep", [1, 4, 8])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_reference_sharded_ffn_and_the_dense_oracles(ep, top_k):
    jcfg, tcfg = _cfgs(**NO_DROP, top_k=top_k)
    params = JM.init_moe_params(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).standard_normal((64, jcfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(_reference_ffn(_jmesh(ep), jcfg)(params, xb), np.float32)
    oracle = np.asarray(JM.dense_moe_reference(xb, params, jcfg), np.float32)

    tparams = T.params_from_numpy(jax.device_get(params), "cpu")
    sharded = T.shard_params(tparams, TM.moe_plan(_tmesh(ep), tcfg))
    slots = [{name: rows[0][g] for name, rows in sharded.items()} for g in range(ep)]
    tx = torch.from_numpy(x).bfloat16()
    ys, auxs = TM.moe_ffn(list(tx.chunk(ep, 0)), slots, tcfg)
    got = torch.cat(ys)
    assert got.dtype == torch.bfloat16 and len(auxs) == ep
    port_oracle = TM.dense_moe_reference(tx, tparams, tcfg).float().numpy()
    for other in (want, oracle, port_oracle):
        np.testing.assert_allclose(got.float().numpy(), other, rtol=5e-2, atol=2e-2)
    np.testing.assert_allclose(port_oracle, oracle, rtol=5e-2, atol=2e-2)


# --- the loss and the train step ---------------------------------------------------------

def _state(ref):
    params = T.params_from_numpy(ref["params"], "cpu")
    for p in params.values():
        p.requires_grad_(True)
    return params, T.make_optimizer(params, ref["cfg"])


def test_loss_and_every_parameter_after_one_step_match_reference(ref):
    step, shard_inputs = TM.make_moe_train_step(_tmesh(4), ref["cfg"])
    sharded, opt = shard_inputs(*_state(ref))
    loss = step(sharded, opt, torch.from_numpy(ref["tokens"])).item()
    assert abs(loss - ref["loss"]) <= LOSS_RTOL * ref["loss"]
    got = T.gather_params(sharded, TM.moe_plan(_tmesh(4), ref["cfg"]))
    lr = ref["cfg"].lr
    for name, g in T.named_leaves(got):
        w = np.asarray(ref["params_1"][name])
        bf16 = w.dtype.name == "bfloat16"
        w = w.astype(np.float32)
        g = g.float().numpy()
        e = np.floor(np.log2(np.maximum(np.abs(w), np.finfo(np.float32).tiny)))
        # an f32 leaf's ulp plus the reference's own error: optax forms the
        # bias correction 1 − 0.999 in f32 (1.3e-5 off), so its first update
        # is lr·(1 − 6.4e-6), where torch's is lr to f32 rounding.  On the
        # router (|w| ≈ 0.03) that is above one ulp for 9 % of the elements.
        ulp = 2.0 ** (e - 7) if bf16 else np.spacing(np.abs(w)) + lr * 2.0**-17
        err = np.abs(g - w)
        assert g.shape == w.shape, name
        assert (err <= 2 * lr + ulp).all(), name
        assert (err > ulp).mean() <= 0.02, name
    for name, rows in T.named_leaves(sharded):  # every slot's replica alike
        if TM.EP_DIMS[name] is None:
            assert all(torch.equal(rows[0][0], p) for p in rows[0][1:]), name
            assert all(torch.equal(opt.state[rows[0][0]]["exp_avg"], opt.state[p]["exp_avg"])
                       for p in rows[0][1:]), name


@pytest.mark.parametrize("ep", [1, 2, 8])
def test_loss_is_the_same_over_every_ep(ref, ep):
    """The loss of the reference's train-step config at ep 1, 2 and 8 against
    the reference's own loss function there."""
    jcfg = JM.MoEConfig(**STEP)
    want = float(jax.jit(JM.make_moe_loss(_jmesh(ep), jcfg))(
        jax.tree.map(jnp.asarray, ref["params"]), jnp.asarray(ref["tokens"], jnp.int32)))
    plan = TM.moe_plan(_tmesh(ep), ref["cfg"])
    with torch.no_grad():
        got = TM.make_moe_loss(plan.mesh, ref["cfg"])(
            T.shard_params(T.params_from_numpy(ref["params"], "cpu"), plan),
            torch.from_numpy(ref["tokens"])).item()
    assert abs(got - want) <= LOSS_RTOL * want


def test_moe_train_step_learns():
    cfg = TM.MoEConfig(**STEP)
    step, shard_inputs = TM.make_moe_train_step(_tmesh(4), cfg)
    sharded, opt = shard_inputs(*TM.make_moe_train_state(cfg, torch.Generator().manual_seed(0)))
    tokens = torch.from_numpy(_tokens(cfg))
    losses = [step(sharded, opt, tokens).item() for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_loss_finite_under_heavy_drop():
    cfg = TM.MoEConfig(**dict(SIZES, capacity_factor=0.25))
    plan = TM.moe_plan(_tmesh(4), cfg)
    params, _ = TM.make_moe_train_state(cfg, torch.Generator().manual_seed(0))
    loss = TM.make_moe_loss(plan.mesh, cfg)(T.shard_params(params, plan), torch.from_numpy(_tokens(cfg)))
    assert np.isfinite(loss.item())


# --- the plan ----------------------------------------------------------------------------

def test_init_has_the_reference_shapes_and_dtypes():
    jcfg, tcfg = _cfgs(**SIZES)
    want = jax.device_get(JM.init_moe_params(jax.random.PRNGKey(0), jcfg))
    got = TM.init_moe_params(tcfg, torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert (t.dtype == torch.bfloat16) == (want[name].dtype.name == "bfloat16"), name
        assert t.dtype in (torch.bfloat16, torch.float32), name
        assert abs(t.float().std().item() - float(np.asarray(want[name], np.float32).std())) < 0.2 * (
            float(np.asarray(want[name], np.float32).std()) + 1e-3), name


def test_shard_and_gather_carry_params_and_moments_exactly():
    cfg = TM.MoEConfig(**STEP)
    params, opt = TM.make_moe_train_state(cfg, torch.Generator().manual_seed(0))
    plan = TM.moe_plan(_tmesh(4), cfg)
    full_step, full_inputs = TM.make_moe_train_step(_tmesh(1), cfg)
    one, one_opt = full_inputs(params, opt)
    full_step(one, one_opt, torch.from_numpy(_tokens(cfg)))  # moments to carry
    p1, o1 = T.gather_train_state(one, one_opt, TM.moe_plan(_tmesh(1), cfg))
    _, shard_inputs = TM.make_moe_train_step(plan.mesh, cfg)
    sharded, sopt = shard_inputs(p1, o1)
    for name, rows in sharded.items():
        assert len(rows) == 1 and len(rows[0]) == 4, name
        want_shape = (cfg.n_experts // 4, *p1[name].shape[1:]) if TM.EP_DIMS[name] == 0 else p1[name].shape
        assert all(tuple(p.shape) == tuple(want_shape) for p in rows[0]), name
    back = T.gather_params(sharded, plan)
    assert all(torch.equal(a, back[n]) for n, a in p1.items())
    want, got = o1.state_dict(), T.gather_optimizer_state(sopt, sharded, plan)
    assert set(got["state"]) == set(want["state"]) == set(range(6))
    for i, st in want["state"].items():
        assert all(torch.equal(got["state"][i][k], st[k]) for k in st), i
    ptrs = [p.data_ptr() for p in T.shard_leaves(sharded)]
    assert len(set(ptrs)) == len(ptrs)


def test_plan_places_experts_on_their_slot():
    devs = tuple(torch.device("cuda", i) for i in range(4))
    plan = TM.MoEPlan(Mesh({"ep": 4}, devs), TM.MoEConfig())
    assert [plan.part_device("w_up", 0, g) for g in range(4)] == list(devs)
    assert plan.part_device("router", 0, 2) == devs[2]


def test_an_expert_count_that_does_not_split_over_ep_raises_like_the_reference():
    with pytest.raises(ValueError, match="n_experts=6 not divisible by ep=4"):
        JM.make_moe_loss(_jmesh(4), JM.MoEConfig(n_experts=6))
    for make in (TM.make_moe_loss, TM.make_moe_train_step):
        with pytest.raises(ValueError, match="n_experts=6 not divisible by ep=4"):
            make(_tmesh(4), TM.MoEConfig(n_experts=6))
    step, shard_inputs = TM.make_moe_train_step(_tmesh(4), TM.MoEConfig(**STEP))
    sharded, opt = shard_inputs(*TM.make_moe_train_state(TM.MoEConfig(**STEP), torch.Generator()))
    with pytest.raises(ValueError, match="batch 6 does not split over the ep axis of size 4"):
        step(sharded, opt, torch.zeros((6, 8), dtype=torch.long))


def test_config_defaults_are_the_reference_defaults():
    assert dataclasses.asdict(TM.MoEConfig()) == dataclasses.asdict(JM.MoEConfig())
