"""The port's dp×tp sharded train step (tpudash_torch.models.workload), its
runner, source, checkpoints and dry run, held against the reference's
(tpudash.models.workload.make_sharded_train_step, sources.workload,
__graft_entry__) on the CPU.

The reference runs on the conftest's 8-device virtual CPU mesh, the port
over ``[torch.device("cpu")] * 8``, both at dp 2 × tp 4 and at the
reference test's sizes (tests/test_models.py), with 2 heads (which do not
divide over tp = 4: every column gathers qkv and attends over every
head) and with 4 (head-aligned shards).  The reference runs once per head count.
Tolerances, as in tests/test_torch_workload.py:

- loss: 2^-10 of the reference's sharded loss (LOSS_RTOL);
- sharded against the port's own unsharded loss: rtol 1e-4, the bound of
  the reference's own test (tests/test_models.py:101);
- parameters after one AdamW step: the per-tensor rule of
  test_every_parameter_after_one_adamw_step_matches_reference;
- dp replicas: bitwise equal; shards and checkpoints: exact.

The loss is vocab-parallel, as the reference's compiled program computes
it: at dp 1 × tp 8 (the mesh of an eight-GPU host) it is held to the
reference's at LOSS_RTOL too, and no tensor of the vocabulary's width is
made in its forward or backward at tp ≥ 2.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import math

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpudash.config import Config as JConfig
from tpudash.models import workload as J
from tpudash.parallel import mesh as jmesh
from tpudash.sources.workload import WorkloadSource
from tpudash_torch import schema as tschema
from tpudash_torch.config import Config
from tpudash_torch.dryrun import dryrun_multichip, entry
from tpudash_torch.models import workload as T
from tpudash_torch.models.checkpoint import WorkloadCheckpointer
from tpudash_torch.models.runner import WorkloadRunner
from tpudash_torch.parallel.mesh import Mesh, build_mesh
from tpudash_torch.sources.workload import WORKLOAD_TFLOPS, TorchWorkloadSource
from torch_replicas import all_equal, record_block_replicas
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU8 = [torch.device("cpu")] * 8
SIZES = dict(vocab=64, d_model=32, n_layers=2, d_ff=64, seq=16, batch=4)
LOSS_RTOL = 2.0**-10
SELF_RTOL = 1e-4


def _cfgs(heads):
    return J.WorkloadConfig(n_heads=heads, **SIZES), T.WorkloadConfig(n_heads=heads, **SIZES)


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (cfg.batch, cfg.seq))


@pytest.fixture(scope="module", params=[2, 4], ids=["2-heads", "4-heads"])
def ref(request):
    """The reference's sharded step at dp 2 × tp 4, run once: its initial
    parameters, the loss of one step, the parameters after it and the
    shard shapes of ``param_shardings``."""
    jcfg, tcfg = _cfgs(request.param)
    mesh = jmesh.build_mesh({"dp": 2, "tp": 4})
    params, opt_state = J.make_train_state(jax.random.PRNGKey(0), jcfg)
    host = jax.device_get(params)
    shapes = jax.tree.map(lambda p, s: s.shard_shape(p.shape), params, J.param_shardings(mesh))
    step, shard_inputs = J.make_sharded_train_step(mesh, jcfg)
    tokens = _tokens(jcfg)
    p, o, t = shard_inputs(params, opt_state, jnp.asarray(tokens, jnp.int32))
    p, o, loss = step(p, o, t)
    return {"cfg": tcfg, "params": host, "tokens": tokens, "loss": float(loss),
            "params_1": jax.device_get(p), "shard_shapes": shapes}


def _state(ref):
    params = T.params_from_numpy(ref["params"], "cpu")
    for p in T.leaves(params):
        p.requires_grad_(True)
    return params, T.make_optimizer(params, ref["cfg"])


def _mesh(dp=2, tp=4):
    return build_mesh({"dp": dp, "tp": tp}, CPU8[: dp * tp])


def _sharded_after_one_step(ref, dp=2, tp=4):
    step, shard_inputs = T.make_sharded_train_step(_mesh(dp, tp), ref["cfg"])
    sharded, opt = shard_inputs(*_state(ref))
    loss = step(sharded, opt, torch.from_numpy(ref["tokens"])).item()
    return sharded, opt, loss


# --- the step against the reference ------------------------------------------------

def test_sharded_loss_matches_reference_and_the_unsharded_step(ref):
    _, _, loss = _sharded_after_one_step(ref)
    params, opt = _state(ref)
    plain = T.train_step(params, opt, torch.from_numpy(ref["tokens"]), ref["cfg"]).item()
    assert abs(loss - ref["loss"]) <= LOSS_RTOL * ref["loss"]
    assert abs(loss - plain) <= SELF_RTOL * plain


@pytest.mark.parametrize("heads", [2, 4], ids=["2-heads", "4-heads"])
def test_sharded_loss_at_dp1_tp8_matches_reference_and_the_unsharded_step(heads):
    """The eight-GPU default mesh (mesh_axes_for(8)): every column holds an
    eighth of the vocabulary, and the reference's compiled program reduces
    only per-token scalars over them."""
    jcfg, tcfg = _cfgs(heads)
    jparams, opt_state = J.make_train_state(jax.random.PRNGKey(0), jcfg)
    ref = {"cfg": tcfg, "params": jax.device_get(jparams), "tokens": _tokens(jcfg)}
    step, shard_inputs = J.make_sharded_train_step(jmesh.build_mesh({"dp": 1, "tp": 8}), jcfg)
    _, _, want = step(*shard_inputs(jparams, opt_state, jnp.asarray(ref["tokens"], jnp.int32)))
    _, _, loss = _sharded_after_one_step(ref, dp=1, tp=8)
    params, opt = _state(ref)
    plain = T.train_step(params, opt, torch.from_numpy(ref["tokens"]), tcfg).item()
    assert abs(loss - float(want)) <= LOSS_RTOL * float(want)
    assert abs(loss - plain) <= SELF_RTOL * plain


def _vocab_wide(cfg, tp):
    """chip_smoke's recorder over the sharded loss's forward and backward
    at dp 1 × ``tp``: every tensor of any dtype ``cfg.vocab`` wide."""
    plan = T.shard_plan(_mesh(1, tp), cfg)
    sharded = T.shard_params(T.init_params(cfg, torch.Generator().manual_seed(0)), plan)
    for t in T.shard_leaves(sharded):
        t.requires_grad_(True)
    tokens = torch.from_numpy(_tokens(cfg))
    found = chip_smoke.vocab_wide_tensors(
        lambda: T.sharded_loss_fn(sharded, tokens, plan).backward(), cfg.vocab)
    assert all(t.grad is not None for t in T.shard_leaves(sharded))
    return found


#: no other width of the model is 128, and 128 splits over tp 8
WIDE_VOCAB = dict(SIZES, vocab=128)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_the_sharded_loss_makes_no_tensor_of_the_vocabulary_width(tp):
    assert _vocab_wide(T.WorkloadConfig(n_heads=2, **WIDE_VOCAB), tp) == []


def test_the_recorder_sees_the_one_column_log_softmax_at_tp1():
    """The control of the test above: at tp 1 the one column's logits and
    its log_softmax are the vocabulary's width, forward and backward."""
    ops = {op for op, _ in _vocab_wide(T.WorkloadConfig(n_heads=2, **WIDE_VOCAB), 1)}
    assert any("_log_softmax.default" in op for op in ops)
    assert any("_log_softmax_backward_data" in op for op in ops)


def test_the_reference_program_reduces_only_per_token_scalars_for_its_loss():
    """What the port's loss copies: the reference's compiled step at dp 1 ×
    tp 4 holds no collective of the vocabulary's width, and its
    log_softmax's max and sum are all-reduces of f32[B, T − 1]."""
    import re

    jcfg = J.WorkloadConfig(n_heads=2, **WIDE_VOCAB)
    params, opt_state = J.make_train_state(jax.random.PRNGKey(0), jcfg)
    step, shard_inputs = J.make_sharded_train_step(
        jmesh.build_mesh({"dp": 1, "tp": 4}, jax.devices()[:4]), jcfg)
    p, o, t = shard_inputs(params, opt_state, jnp.zeros((jcfg.batch, jcfg.seq), jnp.int32))
    hlo = step.lower(p, o, t).compile().as_text()
    ops = re.findall(r"= (\w+)\[([\d,]*)\]\S* (all-gather|all-reduce)(?:-start)?\((.*)", hlo)
    assert ops and all(dims.split(",")[-1] != str(jcfg.vocab) for _, dims, _, _ in ops)
    loss = [(dtype, dims, kind) for dtype, dims, kind, rest in ops if "log_softmax" in rest]
    per_token = ("f32", f"{jcfg.batch},{jcfg.seq - 1}", "all-reduce")
    assert sorted(loss) == [per_token, per_token]


def test_at_tp1_the_loss_is_log_softmax_and_gather_of_the_one_column_bitwise():
    """The single-column path as it was before the loss became
    vocab-parallel: the row's logits, log_softmax, gather and the mean, its
    loss and every gradient to the bit."""
    cfg = _cfgs(4)[1]
    plan = T.shard_plan(_mesh(1, 1), cfg)
    tokens = torch.from_numpy(_tokens(cfg))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    grads = []
    for loss_of in (lambda sh: T.sharded_loss_fn(sh, tokens, plan),
                    lambda sh: -torch.log_softmax(T._row_logits(sh, tokens[:, :-1], plan, 0)[0], -1)
                    .gather(-1, tokens[:, 1:, None]).squeeze(-1).mean()):
        sharded = T.shard_params(params, plan)
        for t in T.shard_leaves(sharded):
            t.requires_grad_(True)
        loss = loss_of(sharded)
        loss.backward()
        grads.append([loss.detach(), *(t.grad for t in T.shard_leaves(sharded))])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def _bf16_ulp(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def test_every_gathered_parameter_after_one_step_matches_reference(ref):
    """The per-tensor rule of tests/test_torch_workload.py: no element more
    than 2·lr plus one ulp from the reference, at most 2 % more than one
    ulp (f32 ulps for the norms)."""
    sharded, _, _ = _sharded_after_one_step(ref)
    got_tree = T.gather_params(sharded, T.shard_plan(_mesh(), ref["cfg"]))
    lr = ref["cfg"].lr
    want_tree = dict(T.named_leaves(ref["params_1"]))
    for name, got in T.named_leaves(got_tree):
        want = np.asarray(want_tree[name])
        bf16 = want.dtype.name == "bfloat16"
        want = want.astype(np.float32)
        got = got.float().numpy()
        ulp = _bf16_ulp(want) if bf16 else np.spacing(np.abs(want))
        err = np.abs(got - want)
        assert got.shape == want.shape, name
        assert (err <= 2 * lr + ulp).all(), name
        assert (err > ulp).mean() <= 0.02, name


def test_dp_replicas_stay_bitwise_equal(ref):
    sharded, opt, _ = _sharded_after_one_step(ref)
    for name, rows in T.named_leaves(sharded):
        for c, shard in enumerate(rows[0]):
            assert torch.equal(shard, rows[1][c]), name
            s0, s1 = opt.state[shard], opt.state[rows[1][c]]
            assert all(torch.equal(s0[k], s1[k]) for k in ("exp_avg", "exp_avg_sq", "step")), name


def test_every_tp_replica_of_the_stream_the_norms_and_their_gradients_is_bitwise_equal(
        ref, monkeypatch):
    """dp 2 × tp 4 after one step: every column of a row holds the residual
    stream and the norms, and each replica, its gradient included, has the
    bits of the row's others (the reference's SPMD program, where the tp
    psum leaves every device the same sum)."""
    outs, grads = record_block_replicas(monkeypatch, T)
    sharded, _, _ = _sharded_after_one_step(ref)
    L = ref["cfg"].n_layers
    assert len(outs) == 2 * 2 * L and len(grads) == 2 * L  # rows × layers × (forward, recompute)
    for ys in outs:
        assert len(ys) == 4 and all_equal(ys)
    for gs in grads:
        assert len(gs) == 4 and all_equal(gs)
    for name in ("blocks.ln1", "blocks.ln2", "ln_f"):
        rows = dict(T.named_leaves(sharded))[name]
        for row in rows:
            assert len(row) == 4 and all_equal(row) and all_equal([p.grad for p in row]), name
        assert not torch.equal(rows[0][0], torch.ones_like(rows[0][0])), name  # it was trained


def test_the_plan_puts_each_norm_on_every_device_of_its_tp_group():
    devs = tuple(torch.device("cuda", i) for i in range(8))
    plan = T.ShardPlan(Mesh({"dp": 2, "tp": 4}, devs), _cfgs(4)[1])
    for name in ("blocks.ln1", "blocks.ln2", "ln_f"):
        assert len(plan.split(name, torch.ones(8))) == 4
        for r in range(2):
            assert [plan.part_device(name, r, c) for c in range(4)] == list(devs[4 * r:4 * r + 4])


def test_plan_shard_shapes_are_the_reference_param_shardings(ref):
    plan = T.shard_plan(_mesh(), ref["cfg"])
    sharded = T.shard_params(T.params_from_numpy(ref["params"], "cpu"), plan)
    want = dict(T.named_leaves(ref["shard_shapes"]))
    for name, rows in T.named_leaves(sharded):
        # a replicated leaf (the norms, ns(None, None)) has a replica on
        # every tp device, as a split leaf has a shard there
        assert len(rows) == 2 and len(rows[0]) == 4, name
        assert {tuple(s.shape) for row in rows for s in row} == {tuple(want[name])}, name
    assert plan.heads_aligned == (ref["cfg"].n_heads % 4 == 0)


# --- the plan ----------------------------------------------------------------------

@pytest.mark.parametrize("heads", [2, 4])
def test_shard_and_gather_are_exact_and_each_shard_is_its_own_tensor(heads):
    cfg = _cfgs(heads)[1]
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    plan = T.shard_plan(_mesh(), cfg)
    sharded = T.shard_params(params, plan)
    back = T.gather_params(sharded, plan)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(back)))
    ptrs = [s.data_ptr() for s in T.shard_leaves(sharded)] + [p.data_ptr() for p in T.leaves(back)]
    assert len(set(ptrs)) == len(ptrs)  # no shard shares memory with another or the tree


def test_head_aligned_shard_holds_its_heads_q_k_and_v_columns():
    cfg = _cfgs(4)[1]  # 4 heads over tp 4: head c on column c
    d, hd = cfg.d_model, cfg.head_dim
    wqkv = torch.arange(3 * d, dtype=torch.float32).expand(cfg.n_layers, d, 3 * d)
    plan = T.shard_plan(_mesh(), cfg)
    for c, shard in enumerate(plan.split("blocks.wqkv", wqkv)):
        cols = shard[0, 0].tolist()
        assert cols == [j * d + c * hd + i for j in range(3) for i in range(hd)]
    contiguous = T.shard_plan(_mesh(), _cfgs(2)[1]).split("blocks.wqkv", wqkv)
    assert contiguous[1][0, 0].tolist() == list(range(24, 48))  # the reference's block


def test_each_layer_is_recomputed_in_backward(monkeypatch):
    cfg = _cfgs(4)[1]
    calls = []
    block = T._sharded_block
    monkeypatch.setattr(T, "_sharded_block", lambda *a: calls.append(1) or block(*a))
    step, shard_inputs = T.make_sharded_train_step(_mesh(), cfg)
    sharded, opt = shard_inputs(*T.make_train_state(cfg, torch.Generator()))
    step(sharded, opt, torch.zeros((cfg.batch, cfg.seq), dtype=torch.long))
    # each dp row runs each layer forward once and again in its backward
    assert len(calls) == 2 * 2 * cfg.n_layers


@pytest.mark.parametrize("dp,tp", [(1, 8), (4, 2), (8, 1), (1, 1)])
def test_every_mesh_shape_keeps_the_unsharded_loss(dp, tp):
    cfg = T.WorkloadConfig(n_heads=2, **{**SIZES, "batch": 8})
    params, opt = T.make_train_state(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=torch.Generator().manual_seed(1))
    step, shard_inputs = T.make_sharded_train_step(_mesh(dp, tp), cfg)
    sharded, sopt = shard_inputs(params, opt)
    got = step(sharded, sopt, tokens).item()
    want = T.train_step(params, opt, tokens, cfg).item()
    assert abs(got - want) <= SELF_RTOL * want
    if dp == 1:  # one row: its loss is the unsharded formula
        assert got == pytest.approx(want, rel=1e-6)


def test_a_batch_that_does_not_split_over_dp_raises_like_the_reference():
    jcfg, tcfg = _cfgs(2)
    params, opt_state = J.make_train_state(jax.random.PRNGKey(0), jcfg)
    _, shard_inputs = J.make_sharded_train_step(jmesh.build_mesh({"dp": 2, "tp": 4}), jcfg)
    with pytest.raises(ValueError, match="divisible by 2"):
        shard_inputs(params, opt_state, jnp.zeros((3, jcfg.seq), jnp.int32))
    with pytest.raises(ValueError, match="batch 3 does not split over the dp axis of size 2"):
        T.make_sharded_train_step(_mesh(), T.WorkloadConfig(n_heads=2, **{**SIZES, "batch": 3}))
    step, shard_inputs = T.make_sharded_train_step(_mesh(), tcfg)
    sharded, opt = shard_inputs(*T.make_train_state(tcfg, torch.Generator()))
    with pytest.raises(ValueError, match="batch 3 does not split"):
        step(sharded, opt, torch.zeros((3, tcfg.seq), dtype=torch.long))


@pytest.mark.parametrize("dim,size", [("d_model", 34), ("d_ff", 66), ("vocab", 62)])
def test_a_dim_that_does_not_split_over_tp_raises(dim, size):
    cfg = T.WorkloadConfig(n_heads=2, **{**SIZES, dim: size})
    with pytest.raises(ValueError, match=f"{dim} {size} does not split over the tp axis of size 4"):
        T.make_sharded_train_step(_mesh(), cfg)


def test_optimizer_state_shards_and_gathers_exactly():
    cfg = _cfgs(4)[1]
    params, opt = T.make_train_state(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=torch.Generator().manual_seed(1))
    T.train_step(params, opt, tokens, cfg)  # moments to carry
    plan = T.shard_plan(_mesh(), cfg)
    _, shard_inputs = T.make_sharded_train_step(plan.mesh, cfg)
    sharded, sopt = shard_inputs(params, opt)
    want, got = opt.state_dict(), T.gather_optimizer_state(sopt, sharded, plan)
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"]) == set(range(9))
    for i, st in want["state"].items():
        assert all(torch.equal(got["state"][i][k], st[k]) for k in st), i


# --- checkpoints ---------------------------------------------------------------------

def test_state_saved_at_tp2_restores_exactly_at_tp4_and_on_one_device(tmp_path):
    """A sharded state is saved gathered; a restore fills a one-device
    state, which ``shard_inputs`` carries onto the live mesh, as the
    runner does."""
    cfg = _cfgs(4)[1]
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=torch.Generator().manual_seed(1))
    plan2 = T.shard_plan(_mesh(2, 2), cfg)
    step2, inputs2 = T.make_sharded_train_step(plan2.mesh, cfg)
    sharded2, opt2 = inputs2(*T.make_train_state(cfg, torch.Generator().manual_seed(0)))
    step2(sharded2, opt2, tokens)
    ck = WorkloadCheckpointer(str(tmp_path))
    ck.save(3, *T.gather_train_state(sharded2, opt2, plan2))
    want_params = T.gather_params(sharded2, plan2)
    want_opt = T.gather_optimizer_state(opt2, sharded2, plan2)

    one, one_opt = T.make_train_state(cfg, torch.Generator().manual_seed(9))
    assert ck.restore_latest(one, one_opt)[2] == 3
    plan4 = T.shard_plan(_mesh(2, 4), cfg)
    step4, inputs4 = T.make_sharded_train_step(plan4.mesh, cfg)
    sharded4, opt4 = inputs4(one, one_opt)
    for got_params, got_state in ((T.gather_params(sharded4, plan4),
                                   T.gather_optimizer_state(opt4, sharded4, plan4)),
                                  (one, one_opt.state_dict())):
        assert all(torch.equal(a, b) for a, b in zip(T.leaves(want_params), T.leaves(got_params)))
        for i, st in want_opt["state"].items():
            assert all(torch.equal(got_state["state"][i][k], st[k]) for k in st), i
    # a capturable AdamW (make_optimizer's on a GPU) restores the same state
    # exactly; shard_inputs carries it onto the mesh into the live sharded
    # optimizer, capturable or not as that one is (the CPU's: not)
    cap_params, _ = T.make_train_state(cfg, torch.Generator().manual_seed(8))
    cap = T.make_optimizer(cap_params, cfg)
    for g in cap.param_groups:
        g["capturable"] = True
    assert ck.restore_latest(cap_params, cap)[2] == 3 and cap.param_groups[0]["capturable"]
    sharded_c, opt_c = inputs4(cap_params, cap)
    assert opt_c.param_groups[0]["capturable"] is False
    for got_params, got_state in ((T.gather_params(sharded_c, plan4),
                                   T.gather_optimizer_state(opt_c, sharded_c, plan4)),
                                  (cap_params, cap.state_dict())):
        assert all(torch.equal(a, b) for a, b in zip(T.leaves(want_params), T.leaves(got_params)))
        for i, st in want_opt["state"].items():
            assert all(torch.equal(got_state["state"][i][k], st[k]) for k in st), i
    # and the three states train on alike, the one restored through the
    # capturable optimizer as the other at tp 4
    a_cap = step4(sharded_c, opt_c, tokens).item()
    a = step4(sharded4, opt4, tokens).item()
    assert a == a_cap
    b = T.train_step(one, one_opt, tokens, cfg).item()
    c = step2(sharded2, opt2, tokens).item()
    assert abs(a - b) <= SELF_RTOL * b and abs(c - b) <= SELF_RTOL * b


# --- runner and source over several devices ---------------------------------------------

TINY = dict(workload_vocab=64, workload_d_model=32, workload_n_heads=2, workload_n_layers=1,
            workload_d_ff=64, workload_seq=16, workload_batch=4)


def test_source_over_8_devices_emits_each_chip_like_the_reference():
    """The same runner.metrics() into the reference's WorkloadSource (8
    virtual devices) and TorchWorkloadSource (8 CPU devices): the same
    (metric, chip_id) set and the same values, but for what comes from the
    generation record: utilisation divides by the H100's 989 TFLOP/s
    there, by the TPU record's peak in the reference, and the HBM total
    falls back to each record's capacity on the CPU."""
    m = {"steps": 8, "resumed_from": None, "loss": 3.5, "steps_per_second": 2.0,
         "achieved_tflops": 40.0}
    ref_src = WorkloadSource(JConfig(source="workload", extra=dict(TINY)))
    port = TorchWorkloadSource(Config(source="workload", extra=dict(TINY)), devices=CPU8)
    for src in (ref_src, port):
        src.runner.start = lambda src=src: src.runner
        src.runner.metrics = lambda: dict(m)
    want = {(s.metric, s.chip.chip_id): s.value for s in ref_src.fetch()}
    got = {(s.metric, s.chip.chip_id): s.value for s in port.fetch()}
    assert set(got) == set(want) and {c for _, c in got} == set(range(8))
    for key, value in got.items():
        if key[0] == tschema.TENSORCORE_UTIL:
            assert value == pytest.approx(40.0 / 8 / 989.0 * 100)
        elif key[0] == tschema.HBM_TOTAL:
            assert value == 80 * 1024**3
        else:
            assert value == want[key], key
    assert got[(WORKLOAD_TFLOPS, 7)] == 5.0  # per chip


def test_source_takes_device_or_devices_not_both():
    with pytest.raises(ValueError, match="not both"):
        TorchWorkloadSource(Config(source="workload"), device="cpu", devices=CPU8)


def _wait(pred, timeout=60.0):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_runner_trains_sharded_over_8_devices():
    cfg = T.WorkloadConfig(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, seq=16, batch=4)
    runner = WorkloadRunner(cfg, steps_per_sync=2, devices=CPU8).start()
    try:
        assert _wait(lambda: runner.error or runner.steps >= 4), runner.error
        m = runner.metrics()
        assert m["steps"] >= 4 and math.isfinite(m["loss"]) and m["achieved_tflops"] > 0
    finally:
        runner.stop()


def test_runner_over_8_devices_saves_gathered_and_resumes_on_one(tmp_path):
    cfg = T.WorkloadConfig(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, seq=16, batch=4)
    ckdir = str(tmp_path / "ck")
    r1 = WorkloadRunner(cfg, steps_per_sync=1, checkpoint_dir=ckdir, checkpoint_every=2,
                        devices=CPU8).start()
    try:
        assert _wait(lambda: r1.error or r1.steps >= 2), r1.error
    finally:
        r1.stop()
    assert r1.error is None
    saved = WorkloadCheckpointer(ckdir).latest_step()
    assert saved is not None and saved >= 2
    # the file holds the full tree: it restores into a one-device state
    one, one_opt = T.make_train_state(cfg, torch.Generator())
    assert WorkloadCheckpointer(ckdir).restore_latest(one, one_opt)[2] == saved
    r2 = WorkloadRunner(cfg, steps_per_sync=1, checkpoint_dir=ckdir, checkpoint_every=2,
                        device="cpu").start()
    try:
        assert _wait(lambda: r2.error or r2.steps > saved), r2.error
        assert r2.metrics()["resumed_from"] == saved
    finally:
        r2.stop()


def test_a_mesh_error_reaches_metrics_as_the_runner_error():
    cfg = T.WorkloadConfig(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, seq=16, batch=4)
    runner = WorkloadRunner(cfg, devices=CPU8[:6]).start()  # dp 3 × tp 2: batch 4 % 3
    try:
        assert _wait(lambda: runner.error is not None)
        with pytest.raises(RuntimeError, match="batch 4 does not split over the dp axis of size 3"):
            runner.metrics()
    finally:
        runner.stop()


def test_no_gpu_and_no_devices_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: WorkloadRunner(), lambda: TorchWorkloadSource(Config(source="workload")),
                 lambda: entry(), lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# --- the dry run (__graft_entry__.py) -------------------------------------------------------

def test_dryrun_multichip_runs_both_steps_over_8_cpu_devices():
    """Every parallel step over 8 devices: sharded, ring, pipeline, 3D and
    MoE, each loss finite and near ln(vocab) at init."""
    losses = dryrun_multichip(8, CPU8)
    assert set(losses) == {"sharded", "ring", "pipeline", "3d", "moe"}
    assert all(math.isfinite(v) and abs(v - math.log(128)) < 1.0 for v in losses.values())
    with pytest.raises(RuntimeError, match="need 8 devices, have 4"):
        dryrun_multichip(8, CPU8[:4])


def test_dryrun_multichip_over_2_devices_skips_the_3d_step_like_the_reference():
    losses = dryrun_multichip(2, CPU8[:2])
    assert set(losses) == {"sharded", "ring", "pipeline", "moe"}
    assert all(math.isfinite(v) and abs(v - math.log(128)) < 1.0 for v in losses.values())


def test_entry_is_the_forward_of_the_reference_tiny_config():
    import dataclasses

    import __graft_entry__
    from tpudash_torch import dryrun

    assert dataclasses.asdict(dryrun._tiny_cfg()) == dataclasses.asdict(__graft_entry__._tiny_cfg())
    fn, (params, tokens) = entry("cpu")
    logits = fn(params, tokens)
    assert tokens.shape == (8, 32) and logits.shape == (8, 32, 128)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert torch.equal(logits, T.forward(params, tokens, dryrun._tiny_cfg()))
