"""A configuration, a traffic mix, a driver and a metric that a later change
adds are found by their names, with no edit to a file of the harness."""

import json
import time

import torch

from gpubench import manifest
from gpubench.run import execute

DRIVER = '''
class Driver:
    def __init__(self, cell, seed, devices):
        self.n = cell.traffic["units"]
    def setup(self):
        pass
    def start_window(self):
        pass
    def item(self):
        return self.n, True
    def window_counts(self):
        return {"made_up": 3}
    def free(self):
        pass
    def check(self):
        return {"dummy_gap": 0.5}
'''


def test_a_new_cell_is_found_by_name(tmp_path):
    for d in ("configs", "traffic", "drivers", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "dummy.json").write_text(json.dumps(
        {"kind": "dummy", "reduced": [], "limits": {"dummy_gap": 1.0}}))
    (tmp_path / "traffic" / "steady.json").write_text(json.dumps({"units": 7}))
    (tmp_path / "drivers" / "dummy.py").write_text(DRIVER)
    (tmp_path / "metrics" / "units.per.s.py").write_text(
        "def read(ctx):\n    return sum(u for _, _, u, _ in ctx.window.items) / ctx.window.seconds\n")
    (tmp_path / "metrics" / "made_up.count.py").write_text(
        "def read(ctx):\n    return ctx.counts['made_up']\n")
    (tmp_path / "metrics" / "silent.py").write_text("def read(ctx):\n    return None\n")
    bench = {
        "workloads": [{"name": "dummy.cell", "config": "dummy", "traffic": "steady", "chips": 1,
                       "why": "a test"}],
        "end_to_end": [{"name": "units.per.s", "unit": "1/s", "better": "higher", "bound": 0.05,
                        "source": "host_clock"}],
        "per_layer": [{"name": "made_up.count", "unit": "n", "better": "lower",
                       "source": "program_counter", "layer": "x", "moves": "units.per.s"},
                      {"name": "silent", "unit": "n", "better": "lower", "source": "program_counter",
                       "layer": "x", "moves": "units.per.s"}],
    }
    cell = manifest.find_cell(bench, "dummy.cell", tmp_path)
    assert cell.traffic == {"units": 7} and cell.config["kind"] == "dummy"
    r = execute(cell, 1, [torch.device("cpu")], 0.05, False, time.perf_counter(), tmp_path)
    assert set(r["metrics"]) == {"units.per.s"} and r["metrics"]["units.per.s"]["value"] > 0
    assert r["correct"] and r["checks"] == {"dummy_gap": {"value": 0.5, "limit": 1.0}}
    # --trace 1: the per-layer metrics; the one that reads nothing is left out
    r = execute(cell, 1, [torch.device("cpu")], 0.05, True, time.perf_counter(), tmp_path)
    assert r["metrics"] == {"made_up.count": {"value": 3, "unit": "n"}}
