#!/usr/bin/env python3
"""The inter-GPU probes of ``TorchProbeSource`` over every GPU of one host.

    python3 tools/ici_check.py

A check and measurement tool, not part of the package: nothing imports it.
It runs ``chip_smoke.ici_phase`` (the data each collective moves, the ICI
series of ``TorchProbeSource`` at ``probe_ici_mb=16``, and the reference's
link-series rule) first over ``[cuda:0, cuda:0]`` (one card's copy rates)
and then over every GPU of the host, and prints which pairs of GPUs have
peer access.  ``chip_smoke.py`` runs the same phase; this script runs that
phase alone, for a host with several GPUs.  It fails on a host with fewer
than two.
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
        print(f"ici_check: {n} GPU(s); the inter-GPU probes need two or more", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    gen = resolve_generation_from_device_name(torch.cuda.get_device_name(0)) or DEFAULT_GENERATION
    print(f"cards: {card} (x{n})")
    print("peer access: " + "; ".join(
        f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
        for i in range(n) for j in range(n) if i != j))
    kernels.build_kernels()
    dev0 = torch.device("cuda", 0)
    chip_smoke.ici_phase([dev0, dev0], card, gen, "rehearsal on one card: device-to-device "
                         "copy rates of cuda:0 to cuda:0, not an interconnect rate")
    chip_smoke.ici_phase([torch.device("cuda", i) for i in range(n)], card, gen,
                         f"peer copies between {n} distinct GPUs")
    print("ici_check: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
