"""Inter-device probes: the counterpart of ``tpudash/parallel/collectives.py``;
and the group collectives of the port's SPMD train steps.

A ring shift (each device sends its shard to its +1 neighbour: the
per-link number), an all-gather (each device receives n−1 shards) and a tiny
all-reduce (latency ceiling), each over a LIST of devices driven from one
process.  The same code runs on n CPU "devices" in the tests, on one card
named n times, and on n GPUs.

The ring and the all-gather move bytes by peer copies
(``dst.copy_(src, non_blocking=True)``) into buffers allocated once, not by
``torch.cuda.nccl``: NCCL refuses a device that appears twice in a
communicator, and peer copies need no process group.  Every copy lands in a
distinct buffer, so a device named twice still moves every byte
(``x.to(dev)`` would return ``x`` itself).

Timing follows ``tpudash_torch.ops.probes``: a scalar read back to the host
as the completion barrier, two work multiples, the rate on the delta.  The
devices form one ring, the ``tp`` axis of the reference's ``{"tp": n}`` mesh.
"""

from __future__ import annotations

import contextlib
import time
from typing import Sequence

import torch

from tpudash_torch.ops.probes import ProbeResult, _delta_time, _timed_scalar

AXIS = "tp"
#: spin cycles per second of the gate: the H100's top SM clock (1.98 GHz);
#: at a lower clock the gate only lasts longer
_GATE_CYCLES_PER_S = 2.0e9


def _sharded_ones(devices: Sequence[torch.device], mb_per_device: int) -> list[torch.Tensor]:
    """One (rows_per_dev, 1024) f32 shard of ones per device, the
    reference's row-sharded global array cut at the same rows."""
    rows_per_dev = max(8, (mb_per_device * 1024 * 1024) // (1024 * 4))
    return [torch.ones((rows_per_dev, 1024), dtype=torch.float32, device=d) for d in devices]


def _gate(devices: Sequence[torch.device], seconds: float) -> None:
    """Hold every GPU's current stream in a spin of ``seconds`` while the
    host issues the copies behind it, so each device runs them back to
    back.  Without it a copy that is quicker than Python's issue of the next
    one (a few µs on one card) leaves the paired delta measuring the host,
    not the copies (the reference's collectives run as one XLA program,
    with no host between copies)."""
    cycles = int(seconds * _GATE_CYCLES_PER_S)
    for d in dict.fromkeys(d for d in devices if d.type == "cuda"):
        with torch.cuda.device(d):
            torch.cuda._sleep(cycles)


def _gate_seconds(issue) -> float:
    """The gate for a probe's timed calls: twice the host time that
    ``issue(0.0)`` (the larger variant, ungated) takes to issue its copies,
    measured once before timing.  Both variants of every pair get this one
    gate, so it cancels in the delta."""
    t0 = time.perf_counter()
    out = issue(0.0)
    seconds = time.perf_counter() - t0
    out.item()
    return 2 * seconds


def _side_streams(devices: Sequence[torch.device]) -> list:
    """One stream per device slot (None on the CPU), each made to wait for
    its device's current stream, where the shards were made.  Copies that
    share one stream run one after another: a ring on one stream would
    report about 1/n of a link's rate."""
    streams = []
    for d in devices:
        if d.type != "cuda":
            streams.append(None)
            continue
        s = torch.cuda.Stream(device=d)
        s.wait_stream(torch.cuda.current_stream(d))
        streams.append(s)
    return streams


def _on(stream) -> contextlib.AbstractContextManager:
    """Make ``stream`` current on its device.  A copy between two GPUs runs
    on the SOURCE device's current stream (PyTorch's rule), so a copy issued
    here runs on the source slot's own stream."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _record(stream):
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _join(devices: Sequence[torch.device], done: list) -> None:
    """Make device 0's current stream wait for every slot's last copy.  The
    scalar is read back from device 0 only; without the join it would time
    device 0's copies alone, where the reference's readback waits for the
    whole program."""
    if devices[0].type != "cuda":
        return
    main = torch.cuda.current_stream(devices[0])
    for ev in done:
        main.wait_event(ev)


def _ring(shards: list[torch.Tensor], bufs: tuple, k: int, reverse: bool,
          gate_s: float = 0.0) -> list[torch.Tensor]:
    """``k`` ring shifts of ``shards`` (+1 each step, −1 with ``reverse``)
    through the double buffers ``bufs``, behind a gate of ``gate_s``;
    returns each slot's final buffer.

    Step t reads the buffers step t−1 wrote and writes the ones step t−1
    read, so before its copy a slot's stream waits for two events of step
    t−1: the copy that filled its source, and the copy that last read its
    destination.  Fresh events each step keep a wait from landing on a copy
    of the same step."""
    n = len(shards)
    step = -1 if reverse else 1
    devices = [s.device for s in shards]
    _gate(devices, gate_s)
    streams = _side_streams(devices)
    cur = list(shards)
    prev = None
    for t in range(k):
        nxt = list(bufs[t % 2])
        done = []
        for i in range(n):
            j = (i + step) % n
            with _on(streams[i]):
                if prev is not None and streams[i] is not None:
                    streams[i].wait_event(prev[(i - step) % n])  # cur[i] is filled
                    streams[i].wait_event(prev[j])  # nxt[j] is read
                nxt[j].copy_(cur[i], non_blocking=True)
            done.append(_record(streams[i]))
        cur, prev = nxt, done
    if prev is not None:
        _join(devices, prev)
    return cur


def ppermute_ring_bandwidth_probe(
    devices: Sequence,
    mb_per_device: int = 64,
    steps: int = 4,
    reverse: bool = False,
) -> ProbeResult:
    """Ring shift: every device sends its whole shard to its +1 neighbour
    (−1 with ``reverse``, the other cable of the pair).  Delta-timed at
    ``steps`` vs ``3·steps`` shifts; value is per-device one-way GB/s (the
    tpu_ici_tx_bytes_per_second feed; per direction for the
    tpu_ici_link_* series)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    steps = max(1, steps)
    x = _sharded_ones(devices, mb_per_device)
    bufs = tuple([torch.empty_like(s) for s in x] for _ in range(2))

    def ring_sum(k: int, gate_s: float) -> torch.Tensor:
        return _ring(x, bufs, k, reverse, gate_s)[0][0, :8].sum()

    gate_s = _gate_seconds(lambda g: ring_sum(3 * steps, g))
    dt = _delta_time(lambda: ring_sum(steps, gate_s), lambda: ring_sum(3 * steps, gate_s))
    shard_bytes = x[0].numel() * 4
    return ProbeResult(
        value=shard_bytes * (2 * steps) / dt / 1e9,
        elapsed_s=dt,
        detail={"axis": AXIS, "devices": n, "mb_per_device": mb_per_device,
                "steps": steps, "reverse": reverse},
    )


def _all_gather(shards: list[torch.Tensor], outs: list[torch.Tensor],
                gate_s: float = 0.0) -> list[torch.Tensor]:
    """Every slot's ``outs[i]`` receives all n shards in order (its own
    too, as a tiled all-gather's output holds it), behind a gate of
    ``gate_s``.  Round r sends slot k's shard to slot k+r: the n copies of
    a round run at once on the senders' streams, and no two copies write
    one place."""
    n = len(shards)
    rows = shards[0].shape[0]
    devices = [s.device for s in shards]
    _gate(devices, gate_s)
    streams = _side_streams(devices)
    for r in range(n):
        for k in range(n):
            i = (k + r) % n
            with _on(streams[k]):
                outs[i][k * rows:(k + 1) * rows].copy_(shards[k], non_blocking=True)
    _join(devices, [_record(s) for s in streams if s is not None])
    return outs


def all_gather_bandwidth_probe(devices: Sequence, mb_per_device: int = 32) -> ProbeResult:
    """All-gather: each device receives (n−1) shards.  Delta-timed at shard
    sizes S vs 3S (fixed overhead is size-independent); value is per-device
    rx GB/s (the tpu_ici_rx_bytes_per_second feed)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    x1 = _sharded_ones(devices, mb_per_device)
    x3 = _sharded_ones(devices, 3 * mb_per_device)
    out1 = [torch.empty((n * s.shape[0], s.shape[1]), device=s.device) for s in x1]
    out3 = [torch.empty((n * s.shape[0], s.shape[1]), device=s.device) for s in x3]
    def gather_sum(x, out, gate_s: float) -> torch.Tensor:
        return _all_gather(x, out, gate_s)[0][0, :8].sum()

    gate_s = _gate_seconds(lambda g: gather_sum(x3, out3, g))
    dt = _delta_time(lambda: gather_sum(x1, out1, gate_s), lambda: gather_sum(x3, out3, gate_s))
    extra_bytes = (sum(s.numel() for s in x3) - sum(s.numel() for s in x1)) * 4 // n * (n - 1)
    return ProbeResult(
        value=extra_bytes / dt / 1e9,
        elapsed_s=dt,
        detail={"axis": AXIS, "devices": n, "mb_per_device": mb_per_device},
    )


def _psum_sum(shards: list[torch.Tensor]) -> torch.Tensor:
    """``b + psum(Σ b)`` on every slot; returns ``Σ out[0][0, :8]`` after
    device 0 has waited for every device's work."""
    devices = [s.device for s in shards]
    partials = [s.sum() for s in shards]
    outs = [s + sum(p.to(d) for p in partials) for s, d in zip(shards, devices)]
    _join(devices, [_record(torch.cuda.current_stream(d)) for d in devices if d.type == "cuda"])
    return outs[0][0, :8].sum()


def psum_latency_probe(devices: Sequence) -> ProbeResult:
    """Latency ceiling: one all-reduce of a tiny array across the devices,
    scalar readback included (µs): an upper bound that contains the host
    round trip; trend, not absolute, is the signal."""
    devices = [torch.device(d) for d in devices]
    x = [torch.ones((1, 128), dtype=torch.float32, device=d) for d in devices]
    dt = _timed_scalar(_psum_sum, x)
    return ProbeResult(
        value=dt * 1e6,
        elapsed_s=dt,
        detail={"axis": AXIS, "devices": len(devices), "unit": "us"},
    )


# --- group collectives of the train steps -------------------------------------------


def _chunks(t: torch.Tensor, n: int) -> tuple:
    """``t`` flattened and cut into ``n`` contiguous chunks (views), as even
    as they come; some are empty when ``t`` has fewer than ``n`` elements."""
    return t.reshape(-1).tensor_split(n)


def _allreduce_group(parts: Sequence[torch.Tensor], combine, acc_dtype: torch.dtype,
                     out_dtype: torch.dtype) -> list:
    """``combine`` over ``parts``, one tensor of one shape per slot of a
    group (a device may fill several slots), on every slot's device:
    folded in ``acc_dtype`` in the order of ``parts`` and rounded once to
    ``out_dtype``.  Every slot gets a tensor of its own, and all of them
    hold the same bits.

    A reduce-scatter, then an all-gather: slot j folds chunk j of every part
    in list order and rounds it, then every slot gathers the rounded
    chunks.  ``combine`` is elementwise, so the chunking changes no bit: the
    result is that of one device folding the whole parts in list order.
    Round r of each phase sends from every slot k to slot k + r, so that
    no two copies of a round leave or enter one slot.  A copy runs on its
    source slot's side stream (:func:`_side_streams`, which waits for the
    slot's current stream, where its part was made); PyTorch's rule for a
    copy between devices orders it after the destination's current stream
    and that stream after it, so each chunk's fold waits for every peer's
    chunk and each gathered chunk for its fold.  The current streams wait
    for the side streams before this returns.  Within a CUDA graph's
    capture the side streams join the capture, as the graph's own do.  On
    one device named several times the copies are local and the result is
    the same.
    """
    n = len(parts)
    devices = [p.device for p in parts]
    chunks = [_chunks(p, n) for p in parts]
    outs = [torch.empty(parts[0].shape, dtype=out_dtype, device=d) for d in devices]
    out_chunks = [_chunks(o, n) for o in outs]
    streams = _side_streams(devices)
    got = [[None] * n for _ in range(n)]  # got[j][k]: chunk j of part k on slot j
    for j in range(n):
        got[j][j] = chunks[j][j]
    for r in range(1, n):
        for k in range(n):
            j = (k + r) % n
            with _on(streams[k]):
                got[j][k] = chunks[k][j].to(devices[j], non_blocking=True)
    for j in range(n):
        acc = got[j][0].to(acc_dtype)
        for k in range(1, n):
            acc = combine(acc, got[j][k].to(acc_dtype))
        out_chunks[j][j].copy_(acc)  # the one rounding
    for d, s in zip(devices, streams):
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(d))  # the rounded chunks are made
    for r in range(1, n):
        for j in range(n):
            i = (j + r) % n
            with _on(streams[j]):
                out_chunks[i][j].copy_(out_chunks[j][j], non_blocking=True)
    for d, s in zip(devices, streams):
        if s is not None:
            torch.cuda.current_stream(d).wait_stream(s)
    return outs


def psum_group(parts: Sequence[torch.Tensor], dtype: "torch.dtype | None" = None) -> list:
    """The sum of ``parts`` on every slot's device (:func:`_allreduce_group`):
    added in f32 (in the parts' own dtype where that is wider) in the order
    of ``parts`` and rounded once to ``dtype`` (default: the parts'
    dtype)."""
    return _allreduce_group(parts, torch.add, torch.promote_types(parts[0].dtype, torch.float32),
                            dtype or parts[0].dtype)


def pmax_group(parts: Sequence[torch.Tensor]) -> list:
    """The elementwise maximum of ``parts`` on every slot's device
    (:func:`_allreduce_group`), in their own dtype: exact, so the same
    whatever the order."""
    return _allreduce_group(parts, torch.maximum, parts[0].dtype, parts[0].dtype)


def allreduce_replicas(tensors: Sequence[torch.Tensor]) -> list:
    """:func:`psum_group` of one tensor's replicas (a gradient over dp rows,
    sp or ep slots, or a pipeline's row copies), rounded once to their own
    dtype: every replica's device gets the sum in replica order."""
    return psum_group(tensors)


def _concat_on_each(parts: Sequence[torch.Tensor], dim: int) -> list:
    """``cat(parts, dim)`` on every part's device."""
    return [torch.cat([p.to(d) for p in parts], dim) for d in (p.device for p in parts)]


class _CopyToGroup(torch.autograd.Function):
    """Megatron's "f": identity forward; backward, every replica's gradient
    becomes the psum of the group's, each replica holding a part of it."""

    @staticmethod
    def forward(ctx, *xs):
        return xs

    @staticmethod
    def backward(ctx, *gs):
        return tuple(psum_group(gs))


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's "g": the psum of the partials forward, rounded once to
    ``dtype``; identity backward, each partial taking its replica's
    gradient."""

    @staticmethod
    def forward(ctx, dtype, *parts):
        return tuple(psum_group(parts, dtype))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim`` forward: every slot gets the whole tensor;
    backward, each part takes its own slice of its slot's gradient."""

    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim, ctx.sizes = dim, [p.shape[dim] for p in parts]
        return tuple(_concat_on_each(parts, dim))

    @staticmethod
    def backward(ctx, *gs):
        starts = [sum(ctx.sizes[:c]) for c in range(len(gs))]
        return (None, *(g.narrow(ctx.dim, s, w) for g, s, w in zip(gs, starts, ctx.sizes)))


class _ScatterToGroup(torch.autograd.Function):
    """The inverse pair: slot c keeps chunk c (of n equal ones) of its
    replica along ``dim`` forward; backward, every slot gets the whole
    gradient, all-gathered."""

    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim
        return tuple(x.chunk(len(xs), dim)[c] for c, x in enumerate(xs))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_concat_on_each(gs, ctx.dim))


class _OneOfReplicas(torch.autograd.Function):
    """The value a group's replicas share, as the first one's; backward,
    every replica gets the gradient, as every device of an SPMD program
    gets the cotangent of its replicated output."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        return xs[0].clone()

    @staticmethod
    def backward(ctx, g):
        return tuple(g.to(d, copy=True) for d in ctx.devices)


class _VocabParallelNLL(torch.autograd.Function):
    """Each token's cross-entropy from a group's vocab-parallel logits, as
    the reference's compiled program computes it: every column keeps its
    (…, V/n) shard, and only per-token scalars cross the group (an
    all-reduce of the maxima, one of the sums of exponentials and the
    target's logit).  Backward is local to each column: softmax minus the
    one-hot target, times the token's gradient."""

    @staticmethod
    def forward(ctx, targets, *logits):
        width = logits[0].shape[-1]
        maxes = pmax_group([x.amax(-1) for x in logits])
        exps, parts, picks = [], [], []
        for c, (x, m) in enumerate(zip(logits, maxes)):
            local = targets.to(x.device) - c * width  # the target within column c's range
            hit = (local >= 0) & (local < width)
            idx = local.clamp(0, width - 1).unsqueeze(-1)
            e = torch.exp(x - m.unsqueeze(-1))
            # the target's logit from the one column that holds it, 0 from
            # the others: its sum over the group is exact
            target = torch.where(hit, x.gather(-1, idx).squeeze(-1), 0.0)
            parts.append(torch.stack([e.sum(-1), target]))
            exps.append(e)
            picks += [idx, hit]
        sums = psum_group(parts)  # the sums of exponentials and the target's logit, column order
        ctx.save_for_backward(*exps, *(s[0] for s in sums), *picks)
        # log_softmax's rounding points: (x_t − M) − log S
        return tuple(torch.log(s[0]) - (s[1] - m) for s, m in zip(sums, maxes))

    @staticmethod
    def backward(ctx, *gs):
        n = len(gs)
        saved = ctx.saved_tensors
        exps, sums, picks = saved[:n], saved[n:2 * n], saved[2 * n:]
        grads = []
        for e, s, idx, hit, g in zip(exps, sums, picks[::2], picks[1::2], gs):
            p = e / s.unsqueeze(-1)
            p.scatter_add_(-1, idx, -hit.unsqueeze(-1).to(p.dtype))  # − the one-hot target
            grads.append(p.mul_(g.unsqueeze(-1)))
        return (None, *grads)


# Every slot of a tp group holds a replica of the activations and receives
# the whole gradient of its replica, Megatron's convention: a replicated
# leaf's gradient comes out the same on every slot and is never summed over
# the group.


def copy_to_group(xs: Sequence[torch.Tensor]) -> tuple:
    """Megatron's "f" over a group's replicas: each replica, its gradient
    the psum of the group's (:func:`psum_group`, in the gradients'
    dtype)."""
    return _CopyToGroup.apply(*xs)


def reduce_from_group(parts: Sequence[torch.Tensor], dtype: torch.dtype) -> tuple:
    """Megatron's "g": the psum of ``parts`` rounded once to ``dtype`` on
    every slot; each part's gradient is its slot's."""
    return _ReduceFromGroup.apply(dtype, *parts)


def gather_from_group(parts: Sequence[torch.Tensor], dim: int) -> tuple:
    """Each slot's shard along ``dim`` (a column block) gathered whole on
    every slot; each shard's gradient is its own slice of its slot's."""
    return _GatherFromGroup.apply(dim, *parts)


def scatter_to_group(xs: Sequence[torch.Tensor], dim: int) -> tuple:
    """Slot c's chunk c of its replica along ``dim``; each replica's
    gradient is the gathered whole."""
    return _ScatterToGroup.apply(dim, *xs)


def one_of_replicas(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The value every replica holds (a copy of the first, on its device);
    each replica's gradient is the whole one."""
    return _OneOfReplicas.apply(*xs)


def vocab_parallel_nll(logit_shards: Sequence[torch.Tensor], targets: torch.Tensor) -> tuple:
    """Each token's negative log-likelihood over a tp group whose column c
    holds ``logit_shards[c]``, the (…, V/n) logits of vocabulary entries
    [c·V/n, (c+1)·V/n), on its device; ``targets`` (…) are vocabulary ids on
    any device.  Returns every column's copy, all of them the same bits:
    log S − (x_target − M), with M the group's maximum (:func:`pmax_group`)
    and S the sum of exp(x − M), added in each column, then over the
    columns in column order (:func:`psum_group`).  No tensor of the whole
    vocabulary's width is made, forward or backward.  One column is
    ``-log_softmax(x).gather(targets)``, bitwise."""
    if len(logit_shards) == 1:
        (x,) = logit_shards
        return (-torch.log_softmax(x, -1).gather(-1, targets.to(x.device).unsqueeze(-1)).squeeze(-1),)
    return _VocabParallelNLL.apply(targets, *logit_shards)
