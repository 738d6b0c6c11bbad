"""One run of one cell of ``BENCHMARK.json`` on this machine's GPUs.

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (``setup_s``: from the start of this process to the first timed
item) builds the program's state for the cell and warms every shape the
window uses; the window then runs items back to back (a closed loop with
one caller) for ``--seconds``.  With ``--trace 0`` the last line of
standard output reports the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, read from a device trace of the same window.  After
the window the program's state is freed and the reference checks what the
window produced; each number compared is printed beside its limit, as the
last lines of standard error and under ``checks``, the result's last key.

Exits non-zero without a result when there is no CUDA device or fewer than
the cell needs, when the program cannot be imported, and when JAX or the
JAX package is loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
#: every compile cache at a fixed path inside the checkout (the program's
#: own kernels build into tpudash_torch/ops/build/, also inside it)
for _var, _dir in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(ROOT / "gpubench" / ".cache" / _dir))

from gpubench import compare, manifest  # noqa: E402

#: top-level module names that must not be loaded (whole names: the
#: program's ``tpudash_torch`` is not ``tpudash``)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpudash"})


@dataclass
class Window:
    start: float
    end: float
    #: (start, end, units, ok) of every item
    items: list

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Context:
    """What a metric reader reads."""
    devices: list
    setup_s: float
    window: Window
    #: the driver's counts of the work the window issued
    counts: dict
    #: the reduced device trace (``trace.TraceSummary``), with --trace 1
    trace: object = None


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def run_window(driver, seconds: float, max_items: "int | None" = None) -> Window:
    driver.start_window()
    items = []
    start = time.perf_counter()
    now = start
    while now - start < seconds and (max_items is None or len(items) < max_items):
        t0 = time.perf_counter()
        units, ok = driver.item()
        now = time.perf_counter()
        items.append((t0, now, units, ok))
    return Window(start, now, items)


def measure(driver, seconds: float, trace: bool, trace_items: "int | None" = None) -> tuple:
    """The window, traced or not: (Window, TraceSummary or None).  A traced
    window ends after ``trace_items`` items where the traffic sets it: a
    step that runs thousands of kernels fills the profiler's buffers in
    seconds."""
    if not trace:
        return run_window(driver, seconds), None
    from gpubench import trace as tr

    prof = tr.start_profiler()
    try:
        with tr.window_annotation():
            window = run_window(driver, seconds, trace_items)
    finally:
        prof.stop()
    return window, tr.summarize(prof)


def _sync(devices: list) -> None:
    import torch

    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def execute(cell, seed: int, devices: list, seconds: float, trace: bool,
            t_start: float, base: Path = manifest.HERE) -> dict:
    """Everything of a run after its look for GPUs, on ``devices`` (CPU
    devices in the tests): set-up, window, check, metrics.  Returns the
    result's object."""
    import torch

    on_gpu = devices[0].type == "cuda"
    driver = manifest.driver_class(cell.config["kind"], base)(cell, seed, devices)
    if trace and on_gpu:
        from gpubench import trace as tr

        tr.warm_device_tracing()
    driver.setup()
    _sync(devices)
    setup_s = time.perf_counter() - t_start

    window, summary = measure(driver, seconds, trace and on_gpu, cell.traffic.get("trace_items"))
    counts = driver.window_counts()
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if on_gpu else 0
    driver.free()
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    correct, checks = compare.judge(driver.check(), cell.config["limits"])

    ctx = Context(devices, setup_s, window, counts, summary)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = manifest.metric_reader(m["name"], base)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_gpu else devices[0].type,
              "kind": torch.cuda.get_device_name(devices[0]) if on_gpu else devices[0].type,
              "count": len(devices), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(window.items),
              "failed": sum(not ok for *_, ok in window.items), "metrics": metrics,
              "device": device}
    if summary is not None:
        device["busy_s"] = sum(summary.busy_s.get(d.index, 0.0) for d in devices) / len(devices)
        device["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["counts"] = counts  # the work the window issued, as the harness counted it
    for c in checks.values():
        if not math.isfinite(c["value"]):  # JSON has no inf or nan
            c["value"] = str(c["value"])
    result["checks"] = checks  # last: the numbers compared, each beside its limit
    return result


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = manifest.find_cell(manifest.load_manifest(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA devices, found {have}",
              file=sys.stderr)
        return 2
    try:
        import tpudash_torch  # noqa: F401
    except ImportError as e:
        print(f"gpubench: the program is not importable here: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    result = execute(cell, args.seed, devices, args.seconds, bool(args.trace), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"gpubench: {', '.join(loaded)} loaded in the measuring process", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
