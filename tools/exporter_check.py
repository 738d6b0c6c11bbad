#!/usr/bin/env python3
"""The port's exporter under ``source=workload`` over every GPU of one host.

    python3 tools/exporter_check.py [--settle 10] [--timeout 300]

A check and measurement tool, not part of the package: nothing imports it.
It starts ``python -m tpudash_torch.exporter`` with
``TPUDASH_SOURCE=workload`` on a free port (the workload trains over
every GPU, dp × tp as ``mesh_axes_for(n)`` splits n, one CUDA graph a
step), polls ``/metrics`` until every series of the workload source is
there for every chip_id 0..n−1 with steps a second above 0, waits
``--settle`` seconds more (the runner's first sync holds the capture, and
its EMA reads high at first), then reads the utilisation per chip and the
steps a second, sends SIGTERM and waits for exit 0.  Prints the card line,
a line of the readings and one JSON object; fails on a missing series or
chip, a non-finite value or an exporter that dies or outlives SIGTERM.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--settle", type=float, default=10.0)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import mesh_axes_for
    from tpudash_torch.schema import HBM_TOTAL, HBM_USED, TENSORCORE_UTIL
    from tpudash_torch.sources.workload import WORKLOAD_LOSS, WORKLOAD_STEPS_PER_S, WORKLOAD_TFLOPS

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 1:
        print("exporter_check: no GPU", file=sys.stderr)
        return 1
    card = cs.card_line()
    series = (TENSORCORE_UTIL, HBM_USED, HBM_TOTAL, WORKLOAD_LOSS, WORKLOAD_STEPS_PER_S,
              WORKLOAD_TFLOPS)
    port = cs.free_port()
    url = f"http://127.0.0.1:{port}/metrics"
    env = {**os.environ, "TPUDASH_SOURCE": "workload", "TPUDASH_EXPORTER_PORT": str(port)}
    log = ROOT / "chiprun_out" / "exporter_check.log"
    log.parent.mkdir(exist_ok=True)

    def read() -> "dict | None":
        """{series: {chip_id: value}} of one scrape, None while it fails."""
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                text = r.read().decode()
        except (OSError, urllib.error.HTTPError):
            return None
        got: dict = {}
        for m in re.finditer(r'^(tpu_\w+)\{[^}]*chip_id="(\d+)"[^}]*\} (\S+)$', text, re.M):
            got.setdefault(m.group(1), {})[int(m.group(2))] = float(m.group(3))
        return got

    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "tpudash_torch.exporter"], env=env, cwd=ROOT,
                                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        first = None
        while True:
            cs.check(proc.poll() is None, f"the exporter exited {proc.returncode}:\n"
                     f"{log.read_text()[-3000:]}")
            cs.check(time.perf_counter() - t0 < args.timeout,
                     f"no full /metrics within {args.timeout:.0f} s: {read()}")
            got = read()
            whole = got is not None and all(
                sorted(got.get(s, {})) == list(range(n)) for s in series)
            if whole and first is None and min(got[WORKLOAD_STEPS_PER_S].values()) > 0:
                first = time.perf_counter()
                whole_s = first - t0
            if first is not None and whole and time.perf_counter() - first >= args.settle:
                break
            time.sleep(0.5)
        for s in series:
            cs.check(all(map(math.isfinite, got[s].values())), f"{s}: a non-finite value {got[s]}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        cs.check(rc == 0, f"exit {rc} after SIGTERM:\n{log.read_text()[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    util = got[TENSORCORE_UTIL]
    sps = got[WORKLOAD_STEPS_PER_S][0]
    flops = W.flops_per_step(W.WorkloadConfig(**cs.WORKLOAD_DEFAULTS))
    print(f"cards: {card} (x{n})")
    print(f"exporter, source=workload over {n} GPUs (mesh {mesh_axes_for(n)}): every series for "
          f"chip_ids 0..{n - 1} after {whole_s:.1f} s, read {args.settle:.0f} s later: runner EMA "
          f"{1e3 / sps:.3f} ms a step, {flops * sps / 1e12:.2f} TFLOP/s in all; utilisation per "
          f"chip " + ", ".join(f"{i}: {u:.4f} %" for i, u in sorted(util.items()))
          + f"; loss {got[WORKLOAD_LOSS][0]:.4f}; exit 0 after SIGTERM")
    print(json.dumps({"card": card, "gpus": n, "mesh": mesh_axes_for(n), "whole_s": whole_s,
                      "step_ms": 1e3 / sps, "util": util, "loss": got[WORKLOAD_LOSS][0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
