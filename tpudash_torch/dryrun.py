"""Checks of the workload's model paths at a tiny size: the counterpart of
``__graft_entry__.py``.

- ``entry()`` — the demo transformer's forward at the tiny configuration,
  as ``(fn, example_args)``.
- ``dryrun_multichip(n)`` — one train step each, over n devices at the
  tiny configuration, of the dp×tp sharded step, ring attention over
  dp×sp, the GPipe pipeline over dp×pp, the 3D dp×pp×tp step (when 4
  divides n) and the expert-parallel MoE over ep, with the reference's
  sizing, each checked for a finite loss.

Both run on the GPU unless given CPU devices (``entry("cpu")``,
``dryrun_multichip(8, ["cpu"] * 8)``).  On GPUs each path's step is
captured as one CUDA graph over its devices and replayed once, as the
reference jits each (every ``make_*_train_step`` returns
``graphed.compiled``); on CPU devices each runs eagerly.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpudash_torch.models import workload as w
from tpudash_torch.models.moe import MoEConfig, make_moe_train_state, make_moe_train_step
from tpudash_torch.models.pipeline import (
    convert_params_3d,
    make_pipeline3d_train_step,
    make_pipeline_train_step,
)
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
    """One train step of each parallel path on the first ``n_devices`` of
    ``devices`` (every local GPU when None), sized as the reference sizes
    them: the sharded step over a ``mesh_axes_for(n)`` mesh; the ring over
    (dp, sp) with sp = that mesh's tp; the pipeline over (dp, pp) with pp =
    min(sp, n_layers), lowered until it divides n_layers, and 2
    microbatches; the 3D step at dp n/4 × pp 2 × tp 2, only when 4 divides
    n; MoE over (ep = n,) with 2n experts.  Returns the losses by name
    (``sharded``, ``ring``, ``pipeline``, ``3d`` when run, ``moe``); raises
    on a non-finite one."""
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

    # GPipe over dp×pp: the batch splits over dp and into 2 microbatches
    pp = min(sp, cfg.n_layers)
    while cfg.n_layers % pp:
        pp -= 1
    pp_dp = n_devices // pp
    pp_cfg = dataclasses.replace(cfg, batch=2 * pp_dp * max(1, -(-cfg.batch // (2 * pp_dp))))
    pp_step, pp_inputs = make_pipeline_train_step(
        build_mesh({"dp": pp_dp, "pp": pp}, devices), pp_cfg, num_microbatches=2)
    params, opt = pp_inputs(*w.make_train_state(pp_cfg, gen.manual_seed(4)))
    tokens = torch.randint(0, pp_cfg.vocab, (pp_cfg.batch, pp_cfg.seq),
                           generator=gen.manual_seed(5), device=dev)
    losses["pipeline"] = _finite(pp_step(params, opt, tokens), "pipeline")

    # 3D: dp × pp 2 × tp 2, Megatron tp inside each stage
    if n_devices % 4 == 0:
        d3_dp = n_devices // 4
        d3_cfg = dataclasses.replace(cfg, batch=2 * d3_dp * max(1, -(-cfg.batch // (2 * d3_dp))))
        step3, inputs3 = make_pipeline3d_train_step(
            build_mesh({"dp": d3_dp, "pp": 2, "tp": 2}, devices), d3_cfg, num_microbatches=2)
        params, opt = inputs3(convert_params_3d(w.init_params(d3_cfg, gen.manual_seed(8))), None)
        tokens = torch.randint(0, d3_cfg.vocab, (d3_cfg.batch, d3_cfg.seq),
                               generator=gen.manual_seed(9), device=dev)
        losses["3d"] = _finite(step3(params, opt, tokens), "3d")

    # expert parallelism: experts split over ep, tokens exchanged both ways
    moe_cfg = MoEConfig(vocab=cfg.vocab, d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=2 * n_devices,
                        seq=cfg.seq, batch=n_devices * max(1, -(-cfg.batch // n_devices)))
    moe_step, moe_inputs = make_moe_train_step(build_mesh({"ep": n_devices}, devices), moe_cfg)
    params, opt = moe_inputs(*make_moe_train_state(moe_cfg, gen.manual_seed(6)))
    tokens = torch.randint(0, moe_cfg.vocab, (moe_cfg.batch, moe_cfg.seq),
                           generator=gen.manual_seed(7), device=dev)
    losses["moe"] = _finite(moe_step(params, opt, tokens), "moe")
    return losses
