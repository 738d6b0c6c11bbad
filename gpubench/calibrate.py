"""The readings that a cell's limits are set from, in one process.

    python3 gpubench/calibrate.py --workload NAME --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2]

For each of ``--seeds``, the numbers that decide ``correct`` as a sound run
of the program gives them (the lower readings); for each of
``--control-seeds``, as the control gives them: the reference in the next
precision below the configuration's, put in the program's place (the upper
readings); for each of ``--fault-seeds``, as each planted fault that the
cell can have gives them.  One JSON object a reading on standard output; a
train cell's also holds ``by_leaf``, the norm numbers by kind of parameter.
Not run by the benchmark's own runs; the limits in ``configs/<name>.json``
were set from its output (``PERF.md`` gives the readings).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import compare, manifest  # noqa: E402
from gpubench.run import execute  # noqa: E402


def _free() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def exchange_left_out():
    """The train step's group collectives without their exchange: each
    slot keeps its own part, rounded as the sum would be."""
    from tpudash_torch.parallel import collectives as C

    orig = C._allreduce_group

    def local(parts, combine, acc_dtype, out_dtype):
        return [p.to(acc_dtype).to(out_dtype) for p in parts]

    C._allreduce_group = local
    try:
        yield
    finally:
        C._allreduce_group = orig


@contextlib.contextmanager
def read_fault(kind: str):
    """The probe's read pass broken: ``unchanged`` returns the running sum
    as it came in; ``half`` sums half the rows, twice (the mean over the
    rest)."""
    from tpudash_torch.ops import probes

    orig = probes.hbm_read_pass

    def broken(x, prev, block_rows=128, scratch=None):
        if kind == "unchanged":
            return prev.clone()
        half = x[: x.shape[0] // 2]
        return orig(half, prev, block_rows, None) * 2 - prev

    probes.hbm_read_pass = broken
    try:
        yield
    finally:
        probes.hbm_read_pass = orig


def by_leaf(got: dict, want: dict) -> dict:
    """Per-leaf readings of the two norm numbers: for each kind of
    parameter (a block leaf over its layers), the worst gap and the smallest
    share of the median parameter that its reference norm holds."""
    names = compare.moved(want["grad_norms"])
    out = {}
    for key in ("grad_norms", "change_norms"):
        gaps = compare.norm_gaps(got[key], want[key], names)
        median = statistics.median(want[key].values())
        kinds: dict = {}
        for name, gap in gaps.items():
            kind = name.rsplit(".", 1)[0] if name.startswith("blocks.") else name
            worst, share = kinds.get(kind, (0.0, math.inf))
            kinds[kind] = (max(worst, gap), min(share, want[key][name] / median))
        out[key] = kinds
    return out


def train(cell, devices, args, out) -> None:
    driver_cls = manifest.driver_class(cell.config["kind"])
    B = cell.config["model"]["batch"]
    for seed in args.seeds:
        d = driver_cls(cell, seed, devices)
        d.setup()
        d.free()
        _free()
        want = d.reference()
        out("program", seed, {**d.numbers(d.readings, want), "replica_gap": d.replica_gap},
            by_leaf(d.readings, want))
        del d
        _free()
    for seed in args.control_seeds:
        d = driver_cls(cell, seed, devices)
        d.pool = d.tokens()
        want = d.reference()
        fp8, half = d.reference("fp8"), d.reference(rows=slice(0, B // 2))
        out("control fp8", seed, d.numbers(fp8, want), by_leaf(fp8, want))
        out("fault half batch", seed, d.numbers(half, want), by_leaf(half, want))
    for seed in args.fault_seeds:
        d = driver_cls(cell, seed, devices)
        with exchange_left_out():
            d.setup()
            d.free()
        _free()
        want = d.reference()
        out("fault exchange left out", seed,
            {**d.numbers(d.readings, want), "replica_gap": d.replica_gap},
            by_leaf(d.readings, want))
        del d
        _free()


def probe(cell, devices, args, out) -> None:
    t0 = time.perf_counter()
    result = execute(cell, args.seeds[0], devices, args.seconds, False, t0)
    out("program window", args.seeds[0], {k: v["value"] for k, v in result["checks"].items()})
    driver_cls = manifest.driver_class(cell.config["kind"])
    d = driver_cls(cell, args.seeds[0], devices)
    d.setup()
    d.free()
    for seed in args.seeds:
        d.seed = seed
        out("program", seed, d.seeded())
    out("control window fp8 chain", 0, d.window_control())
    for seed in args.control_seeds:
        d.seed = seed
        out("control bf16 read, fp8 chain", seed, d.seeded(control=True))
    for seed in args.fault_seeds:
        d.seed = seed
        for kind in ("unchanged", "half"):
            with read_fault(kind):
                out(f"fault read {kind}", seed, d.seeded())


def main(argv: list) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--control-seeds", default=[], type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--fault-seeds", default=[], type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    cell = manifest.find_cell(manifest.load_manifest(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {cell.name} needs {cell.chips} CUDA devices", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]

    def out(what: str, seed: int, numbers: dict, leaves: "dict | None" = None) -> None:
        line = {"cell": cell.name, "what": what, "seed": seed, "numbers": numbers}
        if leaves:
            line["by_leaf"] = leaves
        print(json.dumps(line), flush=True)

    {"train": train, "probe": probe}[cell.config["kind"]](cell, devices, args, out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
