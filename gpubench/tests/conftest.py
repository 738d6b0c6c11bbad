"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
and code files with each configuration shrunk to a size the CPU runs in
seconds, and the cells of ``BENCHMARK.json`` found there."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the shrunk sizes: every width divides over tp 4.  The train cell's
#: limits at this size, on the CPU, are set as the chip's are: sound runs of
#: 8 seeds read at most loss 1.18e-4, gradient norms 3.68e-4, change 6.61e-3
#: (each parameter against its own norm), replicas 0; the fp8 control on 4
#: seeds at least 4.09e-3, 2.38e-2, 4.62e-2.  The probe cell keeps its own
#: limits: they hold at this size (read 3.6e-7 against the control's 1.8e-2;
#: chain 5.0e-4 against 4.0e-2).
TINY = {
    "probe-defaults": {"probe_matmul_size": 256, "probe_matmul_iters": 2, "probe_hbm_mb": 2},
    "workload-defaults": {"model": {"vocab": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
                                    "d_ff": 64, "seq": 16, "batch": 4, "lr": 3e-4},
                          "limits": {"loss_gap": 1e-3, "grad_norm_gap": 3e-3,
                                     "change_norm_gap": 1.5e-2, "replica_gap": 0.0}},
}


@pytest.fixture(scope="session")
def tiny_base(tmp_path_factory) -> Path:
    base = tmp_path_factory.mktemp("gpubench")
    for d in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(BENCH / d, base / d)
    for name, change in TINY.items():
        path = base / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config.update(change)
        path.write_text(json.dumps(config))
    return base


#: the probe cell's entries as a later change would add them to
#: ``BENCHMARK.json``: the cell is out of it while the program's delta timing
#: can serve a rate above its peak (``PERF.md``, Open questions), and its
#: driver, configuration, mix and readers stay here, tested
PROBE_CELL = {
    "configs": [{"name": "probe-defaults",
                 "source": "https://github.com/ontheklaud/k8s-rocm-metrics-dashboard (exporter probe "
                           "defaults: tpudash/sources/probe.py:61-65)",
                 "file": "gpubench/configs/probe-defaults.json", "reduced": [],
                 "why": "the exporter's default source: bf16 GEMM chains on cuBLAS and the "
                        "hand-written hbm_read kernel, delta-timed"}],
    "workloads": [{"name": "probe-defaults.1gpu", "config": "probe-defaults",
                   "traffic": "probe-back-to-back", "chips": 1,
                   "why": "DaemonSet default path: back-to-back probe batches with fetch and encode"}],
    "end_to_end": [
        {"name": "probe_batch_ms", "unit": "ms", "better": "lower", "bound": 0.045,
         "source": "host_clock", "workloads": ["probe-defaults.1gpu"]},
        {"name": "probe_batch_p95_ms", "unit": "ms", "better": "lower", "bound": 0.08,
         "source": "host_clock", "workloads": ["probe-defaults.1gpu"]}],
    "per_layer": [
        {"name": name, "unit": "%", "better": better, "source": "device_trace", "layer": layer,
         "moves": "probe_batch_ms", "workloads": ["probe-defaults.1gpu"]}
        for name, better, layer in (("hbm_read_roofline", "higher", "kernels"),
                                    ("probe_gemm_roofline", "higher", "probes"),
                                    ("device.idle.probe", "lower", "device"))],
}


def with_probe(bench: dict) -> dict:
    return {**bench, **{k: bench[k] + v for k, v in PROBE_CELL.items()}}


@pytest.fixture(scope="session")
def bench_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="session")
def cells_manifest(bench_manifest) -> dict:
    """``BENCHMARK.json`` with the probe cell's entries added."""
    return with_probe(bench_manifest)


@pytest.fixture
def cpu_run(tiny_base, cells_manifest):
    """``cpu_run(cell name, seed)``: a whole run of the shrunk cell on CPU
    devices (as many as the cell's chips), its look for GPUs skipped."""
    import time

    import torch

    from gpubench import manifest
    from gpubench.run import execute

    def run(name: str, seed: int = 2**31 + 7, seconds: float = 0.5) -> dict:
        cell = manifest.find_cell(cells_manifest, name, tiny_base)
        devices = [torch.device("cpu")] * cell.chips
        return execute(cell, seed, devices, seconds, False, time.perf_counter(), tiny_base)

    return run
