"""Train steps as CUDA graphs: the port's counterpart of the reference's
``jax.jit`` of each train step (``tpudash/models/{runner,workload,
pipeline,moe,ring_attention}.py``).

Eager PyTorch issues every kernel and copy of a step from the host, one at
a time: over a host's GPUs the host's issue time, not the devices, sets
the pace of a multi-device step.  :func:`graph_train_step` records one step
as a CUDA graph and replays it with one launch a step; :func:`compiled`
wraps a step so that it captures on its first call on CUDA devices and
replays on every later one, as a ``jax.jit`` call compiles once.  Every
``make_*_train_step`` of the port returns its step so wrapped, and the
runner wraps its one-device step.

One graph spans every device of the step (a mesh's devices):

- the capture begins on a side stream of the home device (the tokens'), and
  each other device's side stream joins it through an event, so that the
  peer copies and the other devices' kernels are nodes of the same graph;
  every stream joins back before the capture ends;
- those side streams are their devices' current streams in the capturing
  thread, and the backward runs on that thread too: autograd's per-device
  worker threads would issue the far side of a cross-device copy, and the
  recompute of a layer, on their own current stream of that device, its
  default stream, which is not part of the capture;
- every device's allocations during the capture go to one private pool that
  the graph keeps for its life, so that activations, gradients and the loss
  lie at the same addresses at every replay.

The step must be capturable: no host sync (``.item()``, a shape that depends
on data, a synchronise), optimizer step counts on the devices (AdamW with
``capturable``), and no RNG state stashed by the per-layer recompute.  Its
Python runs once, while it is captured: ``zero_grad(set_to_none=True)`` and
``p.grad = ...`` set each ``.grad`` to a tensor of the graph's pool, and
every replay writes the gradients there.
"""

from __future__ import annotations

import contextlib
import gc
import warnings
import weakref
from typing import Callable, NamedTuple

import torch

#: eager steps before the capture, undone after it: they make the
#: optimizer's moments and the capturing thread's cuBLAS handles and
#: workspaces, none of which may be made while a graph is captured
WARMUP_STEPS = 2
#: the capture polices the capturing thread only: the step's every call is
#: made there (see above), and the exporter's other threads, which serve
#: HTTP and device traces, must not fail for a capture in progress
CAPTURE_ERROR_MODE = "thread_local"


def graph_devices(optimizer: torch.optim.Optimizer, tokens_like: torch.Tensor) -> list:
    """The distinct devices of a step: the tokens' first, then each
    parameter's, in the optimizer's order."""
    devs = [tokens_like.device] + [p.device for g in optimizer.param_groups for p in g["params"]]
    return list(dict.fromkeys(devs))


@contextlib.contextmanager
def kept_train_state(optimizer: torch.optim.Optimizer):
    """Run the body, then set every parameter and optimizer state tensor back
    to its value on entry, in place, and every gradient to None.  A state
    the optimizer made meanwhile goes to zeros, which is the state AdamW
    makes for a parameter at its first step."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    saved = [(p.detach().clone(),
              {k: v.clone() for k, v in optimizer.state[p].items()}
              if p in optimizer.state else None)
             for p in params]
    yield
    with torch.no_grad():
        for p, (value, state) in zip(params, saved):
            p.copy_(value)
            p.grad = None
            for k, v in optimizer.state.get(p, {}).items():
                if state is None:
                    v.zero_()
                else:
                    v.copy_(state[k])


@contextlib.contextmanager
def _current_streams(streams: dict):
    """Make each stream its device's current stream in this thread, after
    the work queued on the stream it replaces, and the first stream's device
    the current device; on exit, the other way round."""
    prev = {d: torch.cuda.current_stream(d) for d in streams}
    prev_device = torch.cuda.current_device()
    for d, s in streams.items():
        s.wait_stream(prev[d])
        torch.cuda.set_stream(s)
    torch.cuda.set_device(next(iter(streams)))
    try:
        yield
    finally:
        for d, s in streams.items():
            prev[d].wait_stream(s)
            torch.cuda.set_stream(prev[d])
        torch.cuda.set_device(prev_device)


def _release_pools(devices: list, pool) -> None:
    for d in devices:
        torch._C._cuda_releasePool(d, pool)


def _cuda_only(devices: list) -> None:
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"a CUDA graph needs CUDA devices, not {[str(d) for d in devices]}; "
                         "run the step eagerly there")


def graph_train_step(step: Callable, params, optimizer: torch.optim.Optimizer,
                     tokens_like: torch.Tensor):
    """Capture ``step(params, optimizer, tokens)`` as one CUDA graph over
    every device of ``optimizer``'s parameters and of ``tokens_like``, whose
    shape and dtype each step's tokens have.  ``step`` updates the state in
    place and returns the loss as a 0-d tensor: the one-device
    ``workload.train_step``, or the uncompiled step (``.eager``) that
    ``workload.make_sharded_train_step``, ``pipeline.make_pipeline_train_step``,
    ``pipeline.make_pipeline3d_train_step``, ``moe.make_moe_train_step`` or
    ``ring_attention.make_ring_train_step`` builds.

    Returns ``replay``: ``replay(tokens)`` copies ``tokens`` into the
    graph's static tokens, launches the graph and returns its static 0-d
    loss, unread, which the next replay overwrites.  The state the step starts
    from is the one given: the warm-up steps are undone before the capture,
    and the capture itself runs nothing.  Raises on a device that is not a
    GPU, before running anything: the CPU runs the step eagerly."""
    devices = graph_devices(optimizer, tokens_like)
    _cuda_only(devices)
    home, others = devices[0], devices[1:]
    tokens = torch.zeros_like(tokens_like)
    streams = {d: torch.cuda.Stream(d) for d in devices}
    graph = torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle()
    with _current_streams(streams), torch.autograd.set_multithreading_enabled(False):
        with kept_train_state(optimizer), warnings.catch_warnings():
            # AdamW warns once when a capturable instance steps uncaptured
            warnings.filterwarnings("ignore",
                                    message="This instance was constructed with capturable")
            for _ in range(WARMUP_STEPS):
                step(params, optimizer, tokens)
        for d in devices:
            torch.cuda.synchronize(d)
        gc.collect()  # no garbage tensor is freed during the capture
        for d in devices:
            # the warm-up's freed blocks stay cached in the default pool, where
            # the capture's private pool cannot reuse them: hand them back, so
            # that a step whose activations fill most of a card still captures
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
        # the graph pools the home device's allocations; the others' go to
        # the same pool id on their devices, released with the graph
        for d in others:
            torch._C._cuda_beginAllocateToPool(d.index, pool)
        weakref.finalize(graph, _release_pools, [d.index for d in others], pool)
        try:
            graph.capture_begin(pool=pool, capture_error_mode=CAPTURE_ERROR_MODE)
            try:
                for d in others:  # the other devices' streams join the capture
                    streams[d].wait_stream(streams[home])
                loss = step(params, optimizer, tokens)
                for d in others:
                    streams[home].wait_stream(streams[d])
            except BaseException:
                with contextlib.suppress(RuntimeError):  # the step's error is the one to see
                    graph.capture_end()
                raise
            graph.capture_end()
        finally:
            for d in others:
                torch._C._cuda_endAllocateToPool(d.index, pool)

    def replay(new_tokens: torch.Tensor) -> torch.Tensor:
        tokens.copy_(new_tokens)
        graph.replay()
        return loss

    return replay


def _tree_tensors(tree) -> list:
    """The tensors of a tree of dicts, tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (tuple, list)) else ()
    return [t for x in items for t in _tree_tensors(x)]


def _held(params, optimizer: torch.optim.Optimizer) -> tuple:
    """The tensors a graph of ``step(params, optimizer, ·)`` reads and
    updates in place: the tree's, then each parameter and its optimizer
    state's."""
    out = _tree_tensors(params)
    for group in optimizer.param_groups:
        for p in group["params"]:
            out.append(p)
            out += [v for v in optimizer.state.get(p, {}).values() if isinstance(v, torch.Tensor)]
    return tuple(out)


class _Graph(NamedTuple):
    replay: Callable
    held: tuple  # the tensors it was captured over


def compiled(step: Callable) -> Callable:
    """``step(params, optimizer, tokens) -> loss`` compiled, as the
    reference's ``make_*_train_step`` return a ``jax.jit`` of their step:
    returns ``run(params, optimizer, tokens)``, with ``step``'s signature,
    and ``run.eager`` is ``step``.

    - When every device of the optimizer's parameters and of the tokens is
      a CPU, ``run`` calls ``step``.  A state over CPU and CUDA devices
      raises ValueError before anything runs.
    - On CUDA devices, the first call for an optimizer and a shape, dtype
      and device of the tokens captures ``step`` (:func:`graph_train_step`,
      whose warm-up is undone) and replays the graph once: it applies
      exactly one step, as the first call of a ``jax.jit`` does.  Later
      calls copy the tokens in and replay.  A failed capture raises;
      nothing runs the step eagerly in its place.
    - Each call returns a loss of its own: a copy of the graph's static
      loss, which the next replay overwrites.
    - An optimizer's graphs, and their memory pools, live as long as the
      optimizer: they are held in a ``WeakKeyDictionary`` keyed by it, and
      nothing in them refers to it.
    - A graph updates the tensors it was captured over.  When the tree's,
      the parameters' or the optimizer state's tensors are no longer those
      (``load_state_dict`` replaces the state's), the call drops the graph
      and captures again from the state as it is.
    """
    graphs: "weakref.WeakKeyDictionary[torch.optim.Optimizer, dict]" = weakref.WeakKeyDictionary()

    def run(params, optimizer: torch.optim.Optimizer, tokens: torch.Tensor) -> torch.Tensor:
        devices = graph_devices(optimizer, tokens)
        if all(d.type == "cpu" for d in devices):
            return step(params, optimizer, tokens)
        _cuda_only(devices)
        mine = graphs.setdefault(optimizer, {})
        key = (tokens.shape, tokens.dtype, tokens.device)
        held, graph = _held(params, optimizer), mine.get(key)
        if graph is not None and len(graph.held) == len(held) and all(
                a is b for a, b in zip(graph.held, held)):
            return graph.replay(tokens).clone()
        del graph
        mine.pop(key, None)  # a stale graph and its pool go before the new capture
        replay = graph_train_step(step, params, optimizer, tokens)
        mine[key] = _Graph(replay, _held(params, optimizer))
        return replay(tokens).clone()

    run.eager = step
    return run
