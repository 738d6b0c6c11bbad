#!/usr/bin/env python3
"""The workload's multi-GPU paths over every GPU of one host.

    python3 tools/workload_check.py [--phases norm,sharded,ring,pipeline,pipeline3d,moe]

A check and measurement tool, not part of the package: nothing imports it.
Every ``make_*_train_step``'s step is compiled (``graphed.compiled``): on
GPUs one CUDA graph over every GPU of its mesh, captured at the first
call.  By phase:

- ``norm``: ``chip_smoke.norm_phase`` without its timing (the norm's
  kernels against autograd of the plain forward on GPU 0, at every width
  the port runs and the plan's edges, graphed and eager; their launches
  over the first call of the dp 1 × tp n step over every GPU);
- ``sharded``: ``chip_smoke.sharded_phase`` (the dp×tp sharded step,
  graphed, at the workload source's full defaults against the unsharded
  step: loss, gradients and parameters after one step, each shard on the
  GPU its plan names; step time, host issue, busy share and peak memory
  per device; ``TorchWorkloadSource`` and the exporter emitting one
  chip_id per GPU) over ``[cuda:0, cuda:0]`` (a rehearsal on one card),
  then over every GPU; then ``chip_smoke.graph_phase`` over every GPU (a
  toy graph over 2 and over every GPU; the one-GPU step on GPU 0 and the
  sharded step over every GPU, each graphed against its eager step over 8
  steps: bitwise against eager with its backward on one thread, bitwise or
  within the sharded bounds against eager as PyTorch runs it; step time,
  host issue, ops and host launch calls a step, busy share and memory of
  both; the runner capturing one graph and the exporter serving a
  utilisation per GPU);
- ``ring``: ``chip_smoke.ring_phase`` (ring attention at the defaults'
  shapes against its oracle; the graphed ring step's loss against the
  plain step's, its replicas bitwise equal) over ``[cuda:0, cuda:0]``,
  then over every GPU; then the ring step over every GPU (dp × sp as
  ``mesh_axes_for`` splits n) graphed against eager as in ``graph_phase``
  (``chip_smoke.path_graph_phase``);
- ``pipeline``: ``chip_smoke.pipeline_phase`` (graphed GPipe at dp 1 × pp
  n, M 4, against the unsharded step: loss, gradients, dp replicas, each
  part on the GPU its plan names; step time, host issue, busy share and
  peak memory per GPU), then the same step graphed against eager;
- ``pipeline3d``: the same for the 3D step at dp n/4 × pp 2 × tp 2, M 2;
- ``moe``: ``chip_smoke.moe_phase`` at ep n (the expert FFN against the
  dense oracle, the graphed step's loss, the share dropped, step time,
  host issue, busy share and peak memory per GPU), then the MoE step
  graphed against eager.

Each step's timings include ``Memcpy PtoP`` and ``Memcpy DtoD`` ms a step
summed over the GPUs and the busy share per GPU; the sharded and 3D phases
hold every tp replica of the norms (and the 3D step's embed, ln_f and
unembed) and its gradient bitwise equal over its group after a step.
``chip_smoke.py`` runs their rehearsals on one card.  ``--phases`` picks
which run (all by default).  It fails on a host with fewer than two GPUs,
and on any failed check.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


PHASES = ("norm", "sharded", "ring", "pipeline", "pipeline3d", "moe")


def main(argv: list) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated, of {', '.join(PHASES)}")
    phases = ap.parse_args(argv).phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phase in {phases}")

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tpudash_torch.ops import kernels
    from tpudash_torch.parallel.mesh import mesh_axes_for
    from tpudash_torch.registry import DEFAULT_GENERATION, resolve_generation_from_device_name

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"workload_check: {n} GPU(s); the multi-GPU paths need two or more", file=sys.stderr)
        return 1
    chip_smoke.start_device_tracing()  # before the first capture
    card = chip_smoke.card_line()
    gen = resolve_generation_from_device_name(torch.cuda.get_device_name(0)) or DEFAULT_GENERATION
    print(f"cards: {card} (x{n}); torch {torch.__version__} cuda {torch.version.cuda}")
    print("peer access: " + "; ".join(
        f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
        for i in range(n) for j in range(n) if i != j))
    dev0 = torch.device("cuda", 0)
    every_gpu = [torch.device("cuda", i) for i in range(n)]
    label = f"{n} distinct GPUs"
    if "norm" in phases:
        chip_smoke.norm_phase(every_gpu, card, gen, label, timing=False)
    kernels.reset_launch_counts()
    if "sharded" in phases:
        chip_smoke.sharded_phase([dev0, dev0], card, gen, "rehearsal on one card named twice")
        chip_smoke.sharded_phase(every_gpu, card, gen, label)
        chip_smoke.graph_phase(every_gpu, card, label)
    if "ring" in phases:
        chip_smoke.ring_phase([dev0, dev0], card, "rehearsal on one card named twice")
        chip_smoke.ring_phase(every_gpu, card, label)
        sp = mesh_axes_for(n)["tp"]
        chip_smoke.path_graph_phase("ring", every_gpu, {"dp": n // sp, "sp": sp}, card, label)
    n_layers, n_experts = chip_smoke.WORKLOAD_DEFAULTS["n_layers"], chip_smoke.MOE_DEFAULTS["n_experts"]
    if "pipeline" in phases:
        if n_layers % n == 0:
            chip_smoke.pipeline_phase(every_gpu, card, label, {"dp": 1, "pp": n}, 4)
            chip_smoke.gc_cuda(every_gpu)
            chip_smoke.path_graph_phase("pipeline", every_gpu, {"dp": 1, "pp": n}, card, label, 4)
        else:
            print(f"pipeline over {n} GPUs: NOT RUN ({n_layers} layers do not split over pp {n})")
    if "pipeline3d" in phases:
        if n % 4 == 0:
            axes = {"dp": n // 4, "pp": 2, "tp": 2}
            chip_smoke.pipeline_phase(every_gpu, card, label, axes, 2)
            chip_smoke.gc_cuda(every_gpu)
            chip_smoke.path_graph_phase("pipeline3d", every_gpu, axes, card, label, 2)
        else:
            print(f"3D step over {n} GPUs: NOT RUN (it needs a multiple of 4)")
    if "moe" in phases:
        if n_experts % n == 0:
            chip_smoke.moe_phase(every_gpu, card, label)
            chip_smoke.gc_cuda(every_gpu)
            chip_smoke.path_graph_phase("moe", every_gpu, {"ep": n}, card, label)
        else:
            print(f"MoE over {n} GPUs: NOT RUN ({n_experts} experts do not split over ep {n})")
    counts = kernels.launch_counts()
    chip_smoke.check(counts["hbm_read"] == counts["hbm_copy"] == 0,
                     f"probe kernels launched: {counts}")
    print(f"workload_check: ok ({', '.join(phases)}); kernel launches {counts}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
