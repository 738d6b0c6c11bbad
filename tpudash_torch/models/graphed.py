"""The workload's train step as one CUDA graph: the port's counterpart of
the reference's ``jax.jit`` of its step (``tpudash/models/runner.py``).

Eager PyTorch issues every kernel and copy of a step from the host, one at
a time: over a host's GPUs the host's issue time, not the devices, sets
the pace of the dp×tp step.  :func:`graph_train_step` records one step as
a CUDA graph and replays it with one launch a step.

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


class StaticBuffers(NamedTuple):
    """What a graph reads and writes at every replay."""

    tokens: torch.Tensor  # each step's tokens are copied here
    loss: torch.Tensor  # the 0-d loss the graph writes, on the tokens' device


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


def graph_train_step(step: Callable, params, optimizer: torch.optim.Optimizer,
                     tokens_like: torch.Tensor):
    """Capture ``step(params, optimizer, tokens)`` (the runner's one-device
    or sharded step: it updates the state in place and returns the loss as a
    0-d tensor) as one CUDA graph over every device of ``optimizer``'s
    parameters and of ``tokens_like``, whose shape and dtype each step's
    tokens have.

    Returns ``(replay, buffers)``: ``replay(tokens)`` copies ``tokens`` into
    ``buffers.tokens``, launches the graph and returns ``buffers.loss``,
    unread.  The state the step starts from is the one given: the warm-up
    steps are undone before the capture, and the capture itself runs
    nothing.  Raises on a device that is not a GPU, before running anything:
    the CPU runs the step eagerly."""
    devices = graph_devices(optimizer, tokens_like)
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"a CUDA graph needs CUDA devices, not {[str(d) for d in devices]}; "
                         "run the step eagerly there")
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

    return replay, StaticBuffers(tokens, loss)
