"""What a run reads from its checkout, found by name.

``BENCHMARK.json`` names the cells; each cell's configuration, traffic mix
and metrics are files of their own under this folder:

- ``configs/<config>.json``: the sizes as they run, the configuration's
  ``kind`` and the limits of the numbers that decide ``correct``;
- ``traffic/<traffic>.json``: the parameters of the traffic mix;
- ``drivers/<kind>.py``: the driver of a kind of configuration (its
  ``Driver`` class);
- ``metrics/<metric>.py``: a reader a metric (its ``read(ctx)``), for the
  end-to-end and the per-layer metrics alike.

A later cell, configuration, mix or metric is one more file and one more
entry; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    #: the metrics this cell reports with --trace 0 and with --trace 1
    end_to_end: tuple
    per_layer: tuple


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(manifest: dict, name: str, base: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration and traffic read from their
    files under ``base``; KeyError for a name the manifest lacks."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((base / "configs" / f"{w['config']}.json").read_text()),
        traffic=json.loads((base / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=tuple(m for m in manifest["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in manifest["per_layer"] if _applies(m, name)),
    )


def _load(path: Path, what: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {what} at {path}")
    name = "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(f"gpubench_{what}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_class(kind: str, base: Path = HERE):
    """The ``Driver`` of ``drivers/<kind>.py``."""
    return _load(base / "drivers" / f"{kind}.py", "driver").Driver


def metric_reader(name: str, base: Path = HERE):
    """The ``read(ctx)`` of ``metrics/<name>.py``: the metric's value, or
    None where the run holds nothing to read it from."""
    return _load(base / "metrics" / f"{name}.py", "metric").read
