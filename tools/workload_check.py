#!/usr/bin/env python3
"""The workload's multi-GPU paths over every GPU of one host.

    python3 tools/workload_check.py

A check and measurement tool, not part of the package: nothing imports it.
It runs ``chip_smoke.sharded_phase`` (the dp×tp sharded train step at the
workload source's full defaults against the unsharded step, each shard on
the GPU its plan names, step time, busy share and peak memory per device,
``TorchWorkloadSource`` and the exporter emitting one chip_id per GPU) and
``chip_smoke.ring_phase`` (ring attention at the defaults' shapes against
its oracle, one ring train step against the plain step), first over
``[cuda:0, cuda:0]`` (a rehearsal on one card) and then over every GPU of
the host.  ``chip_smoke.py`` runs the same phases; this script runs them
alone, for a host with several GPUs.  It fails on a host with fewer than
two, and on any failed check.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tpudash_torch.ops import kernels
    from tpudash_torch.registry import DEFAULT_GENERATION, resolve_generation_from_device_name

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"workload_check: {n} GPU(s); the multi-GPU paths need two or more", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    gen = resolve_generation_from_device_name(torch.cuda.get_device_name(0)) or DEFAULT_GENERATION
    print(f"cards: {card} (x{n}); torch {torch.__version__} cuda {torch.version.cuda}")
    print("peer access: " + "; ".join(
        f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
        for i in range(n) for j in range(n) if i != j))
    dev0 = torch.device("cuda", 0)
    every_gpu = [torch.device("cuda", i) for i in range(n)]
    kernels.reset_launch_counts()
    chip_smoke.sharded_phase([dev0, dev0], card, gen, "rehearsal on one card named twice")
    chip_smoke.sharded_phase(every_gpu, card, gen, f"{n} distinct GPUs")
    chip_smoke.ring_phase([dev0, dev0], card, "rehearsal on one card named twice")
    chip_smoke.ring_phase(every_gpu, card, f"{n} distinct GPUs")
    counts = kernels.launch_counts()
    chip_smoke.check(counts == {"hbm_read": 0, "hbm_copy": 0}, f"probe kernels launched: {counts}")
    print(f"workload_check: ok; probe kernel launches {counts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
