"""Checks of the workload's model paths at a tiny size: the counterpart of
``__graft_entry__.py``.

- ``entry()`` — the demo transformer's forward at the tiny configuration,
  as ``(fn, example_args)``.
- ``dryrun_multichip(n)`` — one dp×tp sharded train step and one dp×sp
  ring-attention train step over an n-device mesh at the tiny
  configuration, each checked for a finite loss.

Both run on the GPU unless given CPU devices (``entry("cpu")``,
``dryrun_multichip(8, ["cpu"] * 8)``).  The reference's pipeline, 3D and
MoE parts are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpudash_torch.models import workload as w
from tpudash_torch.models.ring_attention import make_ring_train_step
from tpudash_torch.parallel.mesh import build_mesh, local_devices, mesh_axes_for


def _tiny_cfg() -> w.WorkloadConfig:
    return w.WorkloadConfig(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, seq=32, batch=8)


def entry(device: "torch.device | str | None" = None):
    """Return (fn, example_args): the forward on the tiny configuration,
    on ``device`` (``cuda:0`` when None)."""
    dev = torch.device(device) if device is not None else local_devices()[0]
    cfg = _tiny_cfg()
    params = w.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq),
                           generator=torch.Generator(device=dev).manual_seed(1), device=dev)

    def fn(params, tokens):
        return w.forward(params, tokens, cfg)

    return fn, (params, tokens)


def _finite(loss: torch.Tensor, what: str) -> float:
    value = loss.item()
    if not math.isfinite(value):
        raise RuntimeError(f"non-finite {what} loss: {value}")
    return value


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One sharded train step over a ``mesh_axes_for(n)`` mesh, then one
    ring step over a (dp, sp) mesh with sp = that mesh's tp, on the first
    ``n_devices`` of ``devices`` (every local GPU when None).  Returns both
    losses; raises on a non-finite one."""
    devices = list(local_devices() if devices is None else devices)[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    axes = mesh_axes_for(n_devices)
    mesh = build_mesh(axes, devices)
    dp = axes["dp"]
    base = _tiny_cfg()
    # the batch must divide over the dp axis
    cfg = dataclasses.replace(base, batch=dp * max(1, -(-base.batch // dp)))
    dev = torch.device(devices[0])
    gen = torch.Generator(device=dev)

    step, shard_inputs = w.make_sharded_train_step(mesh, cfg)
    params, opt = shard_inputs(*w.make_train_state(cfg, gen.manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=gen.manual_seed(1), device=dev)
    losses = {"sharded": _finite(step(params, opt, tokens), "sharded")}

    # long-context path: ring attention over a dp×sp mesh, sp = the tp factor
    sp = axes["tp"]
    ring_mesh = build_mesh({"dp": n_devices // sp, "sp": sp}, devices)
    ring_cfg = dataclasses.replace(cfg, seq=max(cfg.seq, sp * 8))
    ring_step, ring_inputs = make_ring_train_step(ring_mesh, ring_cfg)
    params, opt = ring_inputs(*w.make_train_state(ring_cfg, gen.manual_seed(2)))
    tokens = torch.randint(0, ring_cfg.vocab, (ring_cfg.batch, ring_cfg.seq),
                           generator=gen.manual_seed(3), device=dev)
    losses["ring"] = _finite(ring_step(params, opt, tokens), "ring")
    return losses
