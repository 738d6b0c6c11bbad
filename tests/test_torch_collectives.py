"""The group collectives of the port's SPMD train steps
(tpudash_torch.parallel.collectives: psum_group, pmax_group,
allreduce_replicas, the autograd pairs and the vocab-parallel
cross-entropy) on the CPU, over one device named 2, 4 and 8 times.

The reference's collectives are XLA's ``lax.psum`` and the all-reduce that
``jax.jit`` inserts; what the port must keep of them is the sum itself.
Held here:

- every slot's result bitwise equal to one device adding the parts in f32
  in list order and rounding once (the sharded step's rule, which its
  tests hold against the reference and the unsharded step);
- every slot's maximum exactly the elementwise maximum, whatever the
  order of the parts;
- Megatron's f/g pair, the all-gather/slice pair and the replicated exit
  against the unsharded product in float64: ``torch.autograd.gradcheck``
  for the function of the shards, and the gradients of each shard and
  replica against the unsharded ones within 1e-12;
- ``vocab_parallel_nll`` against ``log_softmax`` and ``gather`` over the
  joined logits: bitwise for one column; for 2, 4 and 8 in f32, each
  token's loss and gradient within the rounding of a V-term sum,
  2·V·2^-24 relative (the sharded step's own bound on the loss, rel 1e-4,
  is far wider); ``gradcheck`` in float64.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import numpy as np
import torch

from tpudash_torch.parallel import collectives as C
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GROUPS = (2, 4, 8)
#: 2·3·5 = 30 elements divide over 2 and not over 4 or 8; 3 elements give
#: a slot of 4 or 8 an empty chunk
SHAPES = ((2, 3, 5), (4, 16), (3,))


def _parts(n, shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             * 10.0 ** rng.integers(-3, 4)).to(dtype) for _ in range(n)]


def _sequential(parts, dtype):
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(dtype)


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_psum_group_is_the_sequential_f32_sum_rounded_once_on_every_slot(n, shape, dtype):
    parts = _parts(n, shape, torch.float32)
    want = _sequential(parts, dtype)
    outs = C.psum_group(parts, dtype)
    assert len(outs) == n
    for out in outs:
        assert out.dtype == dtype and out.shape == want.shape
        assert torch.equal(out, want)
    ptrs = {t.data_ptr() for t in outs + parts}
    assert len(ptrs) == 2 * n  # each slot's result a tensor of its own


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_allreduce_replicas_is_the_old_replica_sum_on_every_replica(n, shape, dtype):
    """A bf16 gradient's replicas are added in f32 and rounded once to
    bf16, as the gathering sum that this all-reduce replaced did."""
    grads = _parts(n, shape, dtype, seed=1)
    want = _sequential(grads, dtype)
    outs = C.allreduce_replicas(grads)
    assert all(out.dtype == dtype and torch.equal(out, want) for out in outs)


def test_psum_group_adds_in_list_order():
    """f32 sums that depend on the order: 2^24 + 1 rounds to 2^24."""
    big = torch.full((5,), 2.0**24)
    one = torch.ones(5)
    assert torch.equal(C.psum_group([big, one, -big, one])[2], torch.ones(5))
    assert torch.equal(C.psum_group([big, -big, one, one])[1], torch.full((5,), 2.0))


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pmax_group_is_the_exact_maximum_on_every_slot_whatever_the_order(n, shape, dtype):
    parts = _parts(n, shape, dtype, seed=5)
    want = torch.stack(parts).amax(0)
    for order in (parts, parts[::-1]):
        outs = C.pmax_group(order)
        assert len(outs) == n
        assert all(out.dtype == dtype and torch.equal(out, want) for out in outs)
    assert len({t.data_ptr() for t in outs + parts}) == 2 * n


def test_a_group_of_one_is_a_rounded_copy():
    (x,) = _parts(1, (4, 4), torch.float32)
    (out,) = C.psum_group([x], torch.bfloat16)
    assert torch.equal(out, x.to(torch.bfloat16))
    (same,) = C.psum_group([x])
    assert torch.equal(same, x) and same.data_ptr() != x.data_ptr()


# --- the autograd pairs against the unsharded product, in float64 ------------------------

B, D, H, V = 3, 8, 16, 8


def _megatron_shards(n, seed=2):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)

    return ([t(B, D // n) for _ in range(n)], [t(D, H // n) for _ in range(n)],
            [t(H // n, D) for _ in range(n)], [t(D, V // n) for _ in range(n)])


def _sharded(n, aligned, xs, w1, w2, u):
    """x's column shards all-gathered onto every slot; f, a column-parallel
    product, tanh, a row-parallel product, g; then f and the vocab-parallel
    product, its column blocks joined on slot 0.  ``aligned=False`` routes
    the hidden activations through the gather/slice pair, as the sharded
    step's heads do when they do not divide over tp."""
    rep = C.gather_from_group(xs, -1)
    hs = [torch.tanh(x @ w) for x, w in zip(C.copy_to_group(rep), w1)]
    if not aligned:
        hs = C.scatter_to_group([torch.sin(h) for h in C.gather_from_group(hs, -1)], -1)
    ys = C.reduce_from_group([h @ w for h, w in zip(hs, w2)], torch.float64)
    return torch.cat([y @ w for y, w in zip(C.copy_to_group(ys), u)], -1)


def _unsharded(aligned, x, w1, w2, u):
    h = torch.tanh(x @ w1)
    if not aligned:
        h = torch.sin(h)
    return (h @ w2) @ u


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("aligned", [True, False], ids=["f-g", "f-gather-slice-g"])
def test_f_g_pair_gradients_pass_gradcheck_in_float64(n, aligned):
    xs, w1, w2, u = _megatron_shards(n)
    k = len(xs)

    def fn(*flat):
        return _sharded(n, aligned, flat[:k], flat[k:2 * k], flat[2 * k:3 * k], flat[3 * k:])

    assert torch.autograd.gradcheck(fn, (*xs, *w1, *w2, *u))


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("aligned", [True, False], ids=["f-g", "f-gather-slice-g"])
def test_f_g_pair_gradients_are_the_unsharded_products(n, aligned):
    xs, w1, w2, u = _megatron_shards(n)
    r = torch.from_numpy(np.random.default_rng(3).standard_normal((B, V)))
    (_sharded(n, aligned, xs, w1, w2, u) * r).sum().backward()
    full = [torch.cat([t.detach() for t in ts], dim).requires_grad_(True)
            for ts, dim in ((xs, -1), (w1, 1), (w2, 0), (u, 1))]
    out = _unsharded(aligned, *full)
    assert torch.allclose(out, _sharded(n, aligned, xs, w1, w2, u), rtol=0, atol=1e-12)
    (out * r).sum().backward()
    for ts, f, dim in zip((xs, w1, w2, u), full, (-1, 1, 0, 1)):
        assert torch.allclose(torch.cat([t.grad for t in ts], dim), f.grad, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", GROUPS)
def test_a_replicated_exit_gives_every_replica_the_whole_gradient(n):
    """The 3D step's last stage: every slot computes the loss from its
    replicas (of the activations and of a replicated weight), and the loss
    is one of them; each replica's gradient is the unsharded one."""
    xs, w1, w2, _ = _megatron_shards(n)
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.standard_normal((D, V)))
    us = [u.clone().requires_grad_(True) for _ in range(n)]
    hs = [torch.tanh(x @ w) for x, w in zip(C.copy_to_group(C.gather_from_group(xs, -1)), w1)]
    ys = C.reduce_from_group([h @ w for h, w in zip(hs, w2)], torch.float64)
    losses = [torch.logsumexp(y @ w, -1).sum() for y, w in zip(ys, us)]
    assert all(torch.equal(loss, losses[0]) for loss in losses)
    C.one_of_replicas(losses).backward()
    full_u = u.clone().requires_grad_(True)
    full_w1 = torch.cat([w.detach() for w in w1], 1).requires_grad_(True)
    x = torch.cat([t.detach() for t in xs], -1)
    torch.logsumexp((torch.tanh(x @ full_w1) @ torch.cat([w.detach() for w in w2], 0)) @ full_u,
                    -1).sum().backward()
    for w in us:
        assert torch.allclose(w.grad, full_u.grad, rtol=0, atol=1e-12)
        assert torch.equal(w.grad, us[0].grad)
    assert torch.allclose(torch.cat([w.grad for w in w1], 1), full_w1.grad, rtol=0, atol=1e-12)


# --- the vocab-parallel cross-entropy against log_softmax and gather ------------------------

NLL_V = 64


def _nll_inputs(dtype=torch.float32, seed=6):
    """(2, 5, NLL_V) logits at the scale of a trained model's, and targets
    that reach every column's range and both ends of the vocabulary."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((2, 5, NLL_V)) * 4.0).to(dtype)
    targets = torch.from_numpy(rng.integers(0, NLL_V, (2, 5)))
    targets[0, :2] = torch.tensor([0, NLL_V - 1])
    return logits, targets


def _nll_of_columns(n, logits, targets, g):
    """Each column's loss and its shard's gradient when every column's
    replica of the loss gets the gradient ``g``, as the sharded step's
    ``one_of_replicas`` gives it."""
    shards = [s.clone().requires_grad_(True) for s in logits.chunk(n, -1)]
    outs = C.vocab_parallel_nll(shards, targets)
    (C.one_of_replicas(outs) * g).sum().backward()
    return outs, torch.cat([s.grad for s in shards], -1)


@pytest.mark.parametrize("n", (1, *GROUPS))
def test_vocab_parallel_nll_is_log_softmax_and_gather(n):
    logits, targets = _nll_inputs()
    g = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 5)).astype(np.float32))
    full = logits.clone().requires_grad_(True)
    want = -torch.log_softmax(full, -1).gather(-1, targets[..., None]).squeeze(-1)
    (want * g).sum().backward()
    outs, grad = _nll_of_columns(n, logits, targets, g)
    assert len(outs) == n and all(torch.equal(o, outs[0]) for o in outs)
    assert outs[0].dtype == torch.float32 and outs[0].shape == want.shape
    if n == 1:  # the single-column path, bitwise
        assert torch.equal(outs[0], want) and torch.equal(grad, full.grad)
        return
    tol = 2 * NLL_V * 2.0**-24
    assert ((outs[0] - want).abs() <= tol * (1 + want.abs())).all()
    assert ((grad - full.grad).abs() <= tol * g.abs()[..., None]).all()


@pytest.mark.parametrize("n", GROUPS)
def test_vocab_parallel_nll_passes_gradcheck_in_float64(n):
    logits, targets = _nll_inputs(torch.float64)
    shards = [s.clone().requires_grad_(True) for s in logits.chunk(n, -1)]

    def fn(*xs):
        return C.one_of_replicas(C.vocab_parallel_nll(xs, targets))

    assert torch.autograd.gradcheck(fn, tuple(shards))
