"""The readings that the DeepSeek-V2-Lite cells' limits are set from, in
one process (``calibrate.py``'s, for the ``deepseek_v2_train`` kind).

    python3 gpubench/calibrate_deepseek_v2.py --workload deepseek-v2-lite-ep8.1gpu \
        --seeds 1,2,... [--control-seeds 1,2] [--fault-seeds 1,2]

For each of ``--seeds``, the numbers that decide ``correct`` as a sound run
of the program gives them (the lower readings); for each of
``--control-seeds``, as the reference one precision down (fp8 products)
gives them in the program's place, and as the reference fed half of each
batch gives them (the upper readings); for each of ``--fault-seeds``, as
each planted fault of the program (:data:`FAULTS`) gives them.  One JSON
object a reading on standard output, with ``by_leaf``: each number's worst
gap by kind of parameter (its layer dropped from the name), where, and
the smallest share of the median parameter's norm that kind holds.  Not
run by the benchmark's own runs; the limits in the configuration were set
from its output (``PERF.md`` gives the readings).
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import compare, manifest  # noqa: E402
from gpubench.calibrate import _free  # noqa: E402

#: the planted faults of the program's model, each a mistake that a port
#: of the architecture could make
FAULTS = ("shared experts left out", "norm_topk_prob on", "rope interleave dropped")


@contextlib.contextmanager
def planted(kind: str):
    """The program's ``models/deepseek_v2.py`` with the fault ``kind``."""
    import torch

    from tpudash_torch.models import deepseek_v2 as D

    name, broken = {
        "shared experts left out": ("_shared", lambda x, lp: torch.zeros_like(x)),
        "norm_topk_prob on": ("_route", None),
        "rope interleave dropped": ("_rope", None),
    }[kind]
    orig = getattr(D, name)
    if kind == "norm_topk_prob on":
        def broken(x, router, cfg):
            probs, gates, experts = orig(x, router, cfg)
            return probs, gates / gates.sum(-1, keepdim=True), experts
    elif kind == "rope interleave dropped":
        def broken(x, cos, sin):
            n = x.shape[-1]
            x = x.float()
            rotated = torch.cat([-x[..., n // 2:], x[..., : n // 2]], dim=-1)
            return (x * cos + rotated * sin).to(torch.bfloat16)
    setattr(D, name, broken)
    try:
        yield
    finally:
        setattr(D, name, orig)


def kind_of(name: str) -> str:
    return re.sub(r"^layers\.\d+\.", "layers.", name)


def by_leaf(got: dict, want: dict) -> dict:
    names = compare.moved(want["grad_norms"])
    out = {}
    for key in ("grad_norms", "change_norms"):
        gaps = compare.norm_gaps(got[key], want[key], names)
        median = statistics.median(want[key].values())
        kinds: dict = {}
        for name, gap in gaps.items():
            k = kind_of(name)
            worst, share, at = kinds.get(k, (0.0, math.inf, ""))
            if gap > worst:
                worst, at = gap, name
            kinds[k] = (worst, min(share, want[key][name] / median), at)
        out[key] = kinds
    return out


def readings(cell, devices, seeds, control_seeds, fault_seeds, out, base=manifest.HERE) -> None:
    driver_cls = manifest.driver_class(cell.config["kind"], base)
    B = cell.traffic["batch"]

    def program(what: str, seed: int, fault: "str | None" = None) -> None:
        d = driver_cls(cell, seed, devices)
        with planted(fault) if fault else contextlib.nullcontext():
            d.setup()
        d.free()
        _free()
        want = d.reference()
        out(what, seed, d.numbers(d.readings, want), by_leaf(d.readings, want))
        del d
        _free()

    for seed in seeds:
        program("program", seed)
    for seed in control_seeds:
        d = driver_cls(cell, seed, devices)
        d.pool = d.tokens()
        want = d.reference()
        fp8 = d.reference("fp8")
        out("control fp8", seed, d.numbers(fp8, want), by_leaf(fp8, want))
        del fp8
        half = d.reference(rows=slice(0, B // 2))
        out("fault half batch", seed, d.numbers(half, want), by_leaf(half, want))
        del d, want, half
        _free()
    for seed in fault_seeds:
        for fault in FAULTS:
            program(f"fault {fault}", seed, fault)


def main(argv: list) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default=[], type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--control-seeds", default=[], type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--fault-seeds", default=[], type=lambda s: [int(x) for x in s.split(",")])
    args = ap.parse_args(argv)
    import torch

    cell = manifest.find_cell(manifest.load_manifest(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {cell.name} needs {cell.chips} CUDA devices", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]

    def out(what: str, seed: int, numbers: dict, leaves: dict) -> None:
        print(json.dumps({"cell": cell.name, "what": what, "seed": seed, "numbers": numbers,
                          "by_leaf": leaves}), flush=True)

    readings(cell, devices, args.seeds, args.control_seeds, args.fault_seeds, out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
