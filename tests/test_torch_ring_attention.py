"""The port's ring attention and ring train step
(tpudash_torch.models.ring_attention) held against the reference's
(tpudash.models.ring_attention) on the CPU, mirroring
tests/test_ring_attention.py: the reference on the conftest's 8-device
virtual CPU mesh, the port over ``[torch.device("cpu")] * 8``, the same
numpy-seeded inputs.

Tolerances: attention outputs within 1e-5 absolute of the oracle and of the
reference's ring (the reference's own bound, f32 inputs of unit scale);
gradients within 1e-4 (likewise); the ring step's losses within 2^-10 of
the reference's (LOSS_RTOL of tests/test_torch_workload.py), and within
2^-10 of the port's plain step, whose bf16 attention probabilities the ring's
f32 accumulator does not round.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpudash.models import ring_attention as JR
from tpudash.models import workload as J
from tpudash.parallel import mesh as jmesh
from tpudash_torch.models import ring_attention as TR
from tpudash_torch.models import workload as T
from tpudash_torch.parallel.mesh import build_mesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU8 = [torch.device("cpu")] * 8
LOSS_RTOL = 2.0**-10


def _meshes(dp, sp):
    return (jmesh.build_mesh({"dp": dp, "sp": sp}, devices=jax.devices()[: dp * sp]),
            build_mesh({"dp": dp, "sp": sp}, CPU8[: dp * sp]))


def _qkv(seed, shape=(8, 32, 2, 8)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dp,sp,causal", [(2, 4, True), (2, 4, False), (8, 1, True), (1, 8, False)])
def test_ring_matches_reference_ring_and_oracle(dp, sp, causal):
    jmesh_, tmesh = _meshes(dp, sp)
    q, k, v = _qkv(dp * 10 + sp + causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = TR.ring_attention(tq, tk, tv, tmesh, causal=causal).numpy()
    want_ring = np.asarray(JR.ring_attention(*(jnp.asarray(x) for x in (q, k, v)), jmesh_, causal=causal))
    want = np.asarray(JR.reference_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal))
    port_oracle = TR.reference_attention(tq, tk, tv, causal=causal).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, want_ring, atol=1e-5)
    np.testing.assert_allclose(port_oracle, want, atol=1e-5)


def test_a_mask_by_local_position_misses_the_oracle(monkeypatch):
    """The causal mask must use global positions: with every block taken
    as if it started at position 0, the ring misses the oracle."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(7))
    mesh = build_mesh({"dp": 2, "sp": 4}, CPU8)
    ok = TR.ring_attention(q, k, v, mesh)
    np.testing.assert_allclose(ok.numpy(), TR.reference_attention(q, k, v).numpy(), atol=1e-5)
    monkeypatch.setattr(TR, "_ring_row", _ring_row_local_mask)
    bad = TR.ring_attention(q, k, v, mesh)
    assert (bad - TR.reference_attention(q, k, v)).abs().max().item() > 0.1


def _ring_row_local_mask(qs, ks, vs, causal):
    """_ring_row with src = s: every K/V block masked as if it were the
    device's own."""
    sp = len(qs)
    B, Tl, H, hd = qs[0].shape
    outs = []
    for s, q in enumerate(qs):
        qh = q.transpose(1, 2) * hd**-0.5
        scores, vals = [], []
        for i in range(sp):
            kb, vb = ks[(s - i) % sp], vs[(s - i) % sp]
            sc = torch.matmul(qh, kb.transpose(1, 2).transpose(-1, -2))
            mask = torch.ones((Tl, Tl), dtype=torch.bool).tril()
            scores.append(sc.masked_fill(~mask, -1e30))
            vals.append(vb.transpose(1, 2))
        p = torch.softmax(torch.cat(scores, -1), -1)
        outs.append(torch.matmul(p, torch.cat(vals, 2)).transpose(1, 2))
    return outs


def test_ring_attention_is_differentiable_like_the_oracle():
    q, k, v = _qkv(3, (2, 16, 2, 8))
    mesh = build_mesh({"dp": 2, "sp": 4}, CPU8)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (TR.ring_attention(tq, tk, tv, mesh) ** 2).sum().backward()
    got = [t.grad.numpy() for t in (tq, tk, tv)]
    want = jax.grad(lambda a, b, c: jnp.sum(JR.reference_attention(a, b, c) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("what,shape,match", [
    ("sequence", (8, 30, 2, 8), "sequence 30 does not split over the sp axis of size 4"),
    ("batch", (3, 32, 2, 8), "batch 3 does not split over the dp axis of size 2"),
])
def test_uneven_blocks_raise(what, shape, match):
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        TR.ring_attention(x, x, x, build_mesh({"dp": 2, "sp": 4}, CPU8))


def test_a_mesh_without_the_named_axes_raises():
    x = torch.zeros((8, 32, 2, 8))
    with pytest.raises(ValueError, match=r"needs a \(dp, sp\) mesh"):
        TR.ring_attention(x, x, x, build_mesh({"dp": 2, "tp": 4}, CPU8))


# --- the ring train step -----------------------------------------------------------------

RING_SIZES = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, seq=32, batch=4)


@pytest.fixture(scope="module")
def ring_ref():
    """Two steps of the reference's ring train step at dp 2 × sp 4: the
    loss at init and after one update."""
    cfg = J.WorkloadConfig(**RING_SIZES)
    params, opt_state = J.make_train_state(jax.random.PRNGKey(0), cfg)
    host = jax.device_get(params)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (cfg.batch, cfg.seq))
    step, shard_inputs = JR.make_ring_train_step(_meshes(2, 4)[0], cfg)
    p, o, t = shard_inputs(params, opt_state, jnp.asarray(tokens, jnp.int32))
    p, o, loss0 = step(p, o, t)
    p, o, loss1 = step(p, o, t)
    return {"params": host, "tokens": tokens, "losses": (float(loss0), float(loss1))}


def _port_ring(ring_ref):
    cfg = T.WorkloadConfig(**RING_SIZES)
    params = T.params_from_numpy(ring_ref["params"], "cpu")
    for p in T.leaves(params):
        p.requires_grad_(True)
    step, shard_inputs = TR.make_ring_train_step(build_mesh({"dp": 2, "sp": 4}, CPU8), cfg)
    replicas, opt = shard_inputs(params, T.make_optimizer(params, cfg))
    return cfg, step, replicas, opt


def test_ring_train_step_losses_match_reference(ring_ref):
    cfg, step, replicas, opt = _port_ring(ring_ref)
    tokens = torch.from_numpy(ring_ref["tokens"])
    losses = [step(replicas, opt, tokens).item() for _ in range(2)]
    for got, want in zip(losses, ring_ref["losses"]):
        assert abs(got - want) <= LOSS_RTOL * want
    for same in zip(*(T.leaves(r) for r in replicas)):  # replicas bitwise equal
        assert all(torch.equal(same[0], x) for x in same[1:])


def test_ring_loss_is_the_plain_step_loss(ring_ref):
    """The ring drops the last logit, the plain loss the last input token:
    on the same tokens both score the same T − 1 predictions."""
    cfg, step, replicas, opt = _port_ring(ring_ref)
    tokens = torch.from_numpy(ring_ref["tokens"])
    params = T.params_from_numpy(ring_ref["params"], "cpu")
    with torch.no_grad():
        plain = T.loss_fn(params, tokens, cfg).item()
    ring = step(replicas, opt, tokens).item()
    assert abs(ring - plain) <= LOSS_RTOL * plain


def test_each_ring_layer_is_recomputed_in_backward(monkeypatch):
    cfg = T.WorkloadConfig(**RING_SIZES)
    calls = []
    block = TR._ring_block
    monkeypatch.setattr(TR, "_ring_block", lambda *a: calls.append(1) or block(*a))
    step, shard_inputs = TR.make_ring_train_step(build_mesh({"dp": 2, "sp": 4}, CPU8), cfg)
    replicas, opt = shard_inputs(*T.make_train_state(cfg, torch.Generator()))
    step(replicas, opt, torch.zeros((cfg.batch, cfg.seq), dtype=torch.long))
    assert len(calls) == 2 * cfg.n_layers  # forward, then again in backward


def test_ring_train_step_decreases_loss():
    cfg = dataclasses.replace(T.WorkloadConfig(**RING_SIZES), lr=1e-2)
    step, shard_inputs = TR.make_ring_train_step(build_mesh({"dp": 2, "sp": 4}, CPU8), cfg)
    replicas, opt = shard_inputs(*T.make_train_state(cfg, torch.Generator().manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=torch.Generator().manual_seed(1))
    first = step(replicas, opt, tokens).item()
    for _ in range(4):
        loss = step(replicas, opt, tokens).item()
    assert loss < first


def test_ring_step_refuses_a_sequence_that_does_not_split():
    cfg = T.WorkloadConfig(**{**RING_SIZES, "seq": 30})
    with pytest.raises(ValueError, match="seq 30 does not split over the sp axis of size 4"):
        TR.make_ring_train_step(build_mesh({"dp": 2, "sp": 4}, CPU8), cfg)
