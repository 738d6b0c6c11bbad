"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
found as a file of its own."""

import math
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _metrics(m):
    return m["end_to_end"] + m["per_layer"]


@pytest.fixture(params=["BENCHMARK.json", "with the probe cell"])
def either_manifest(request, bench_manifest, cells_manifest):
    """``BENCHMARK.json`` as it is, and with the probe cell's entries added
    back as a later change would add them."""
    return bench_manifest if request.param == "BENCHMARK.json" else cells_manifest


def test_keys_names_and_units(either_manifest):
    m = either_manifest
    assert set(m) == TOP_KEYS
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = [x["name"] for x in m["configs"] + m["workloads"] + _metrics(m)]
    assert all(NAME.match(n) for n in names), names
    for group in (m["configs"], m["workloads"], _metrics(m)):
        assert len({x["name"] for x in group}) == len(group)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/configs/") and (ROOT / c["file"]).is_file()
    for x in _metrics(m):
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher") and x["source"] in SOURCES
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert m["paths"] == ["gpubench"] and m["command"] == ["python3", "gpubench/run.py"]


def test_every_cell_reports_what_its_metrics_need(either_manifest):
    m = either_manifest
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}

    def reports(cell, metric):
        return "workloads" not in metric or cell in metric["workloads"]

    for cell in cells:
        mine = [n for n, x in e2e.items() if reports(cell, x)]
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert any(reports(cell, x) for x in m["per_layer"]), cell
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        assert set(x["workloads"]) <= cells
        for cell in x["workloads"]:
            assert reports(cell, e2e[x["moves"]]), (x["name"], cell)
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25


def test_at_most_one_four_chip_cell(bench_manifest):
    four = [w for w in bench_manifest["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench_manifest["workloads"]) // 4)


def test_a_full_check_fits_its_time_at_24_cells(bench_manifest):
    per_run = bench_manifest["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


def test_every_name_is_a_file(either_manifest):
    import json

    for w in either_manifest["workloads"]:
        config = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "drivers" / f"{config['kind']}.py").is_file()
        assert config["reduced"] == [] and set(config["limits"])
        assert all(math.isfinite(v) and v >= 0 for v in config["limits"].values())
    for x in _metrics(either_manifest):
        assert (BENCH / "metrics" / f"{x['name']}.py").is_file(), x["name"]


def test_files_are_named_from_names(bench_manifest):
    allowed = re.compile(r"^[A-Za-z0-9_./-]+$")
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.name.startswith("."):
            continue
        assert allowed.match(str(p.relative_to(ROOT))), p
