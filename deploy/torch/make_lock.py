#!/usr/bin/env python
"""Regenerate the PyTorch port's lock from the running environment.

The port (``tpudash_torch``) installs apart from the dashboard: its
exporter image and its CI job install a lock of their own, the exact
``name==version`` closure of the third-party modules that
``tpudash_torch/**/*.py`` imports (found by walking their ASTs), resolved
by whatever this environment installed, with no network and no resolver.
The format is that of ``deploy/make_lock.py``.  The walk differs in one
point: it follows the extras a requirement asks for, because a CUDA build
of torch pulls its runtime libraries in as extras
(``cuda-toolkit[cublas,cudart,...]``), which that walk drops.  The header
adds the torch build and the card, since a torch wheel's local version
(``+cu128``, ``+cpu``) names the index it comes from.

Two locks, one per torch build:

- ``deploy/torch/requirements.lock``: run on a GPU host (torch built for
  CUDA, its ``nvidia-*`` wheels, triton); the image installs it.
- ``deploy/torch/requirements-cpu.lock``: run where torch is built for the
  CPU; the port's CI job installs it.

Usage:  python deploy/torch/make_lock.py [-o PATH]
        (the default PATH is the lock of the running torch build)
"""

from __future__ import annotations

import argparse
import ast
import re
import subprocess
import sys
from importlib import metadata
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2] / "tpudash_torch"
FIRST_PARTY = {"tpudash_torch", "tpudash"}
INDEX = "https://download.pytorch.org/whl/"


_REQ_RE = re.compile(r"^\s*([A-Za-z0-9][A-Za-z0-9._-]*)\s*(?:\[([^\]]*)\])?")
_EXTRA_RE = re.compile(r"""extra\s*==\s*['"]([^'"]+)['"]""")


def canonical(name: str) -> str:
    return re.sub(r"[-_.]+", "-", name).lower()


def requires_of(dist: metadata.Distribution, extras: frozenset) -> list:
    """``(name, extras)`` of each requirement of ``dist`` that applies when
    ``extras`` are asked for.  Other environment markers are accepted: the
    installed set already satisfied them, and what this environment never
    installed is skipped by :func:`closure`."""
    out = []
    for req in dist.requires or []:
        spec, _, marker = req.partition(";")
        gated = _EXTRA_RE.findall(marker)
        if gated and not any(canonical(e) in extras for e in gated):
            continue
        m = _REQ_RE.match(spec)
        if m:
            asked = frozenset(canonical(e) for e in (m.group(2) or "").split(",") if e.strip())
            out.append((canonical(m.group(1)), asked))
    return out


def closure(roots: list[str]) -> dict[str, str]:
    """Installed ``name -> version`` of ``roots`` and everything they need."""
    pins: dict[str, str] = {}
    seen: set = set()
    stack = [(canonical(r), frozenset()) for r in roots]
    while stack:
        name, extras = stack.pop()
        todo = {(name, e) for e in extras} | {(name, None)}
        if todo <= seen:
            continue
        seen |= todo
        try:
            dist = metadata.distribution(name)
        except metadata.PackageNotFoundError:
            continue
        pins[canonical(dist.metadata["Name"])] = dist.version
        stack.extend(requires_of(dist, extras))
    return pins


def imported_modules(package: Path = PACKAGE) -> set[str]:
    """Top-level third-party modules that the package's sources import."""
    mods = set()
    for path in package.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods.update(alias.name.split(".")[0] for alias in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods.add(node.module.split(".")[0])
    return {m for m in mods if m not in sys.stdlib_module_names and m not in FIRST_PARTY}


def roots() -> list[str]:
    """The distributions that provide :func:`imported_modules`."""
    provides = metadata.packages_distributions()
    out = set()
    for mod in imported_modules():
        if mod not in provides:
            raise SystemExit(f"make_lock: no installed distribution provides {mod!r}")
        out.update(provides[mod])
    return sorted(out)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "none"
    return out.splitlines()[0].strip() if out else "none"


def main() -> int:
    import torch

    cpu_build = torch.version.cuda is None
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=str(
        Path(__file__).parent / ("requirements-cpu.lock" if cpu_build else "requirements.lock")))
    args = ap.parse_args()
    root_names = roots()
    pins = closure(root_names)
    root_set = {canonical(r) for r in root_names}
    locals_ = sorted({v.split("+", 1)[1] for v in pins.values() if "+" in v})
    py = ".".join(map(str, sys.version_info[:2]))
    lines = [
        "# tpudash_torch pinned resolution — generated by deploy/torch/make_lock.py",
        f"# python {py}; {len(pins)} packages; roots annotated",
        f"# torch {torch.__version__}, cuda {torch.version.cuda or 'none'}; card: {card_line()}",
        *(f"# index for the +{tag} pins: {INDEX}{tag}" for tag in locals_),
        "# regenerate: python deploy/torch/make_lock.py",
    ]
    for name in sorted(pins):
        tag = "  # root" if name in root_set else ""
        lines.append(f"{name}=={pins[name]}{tag}")
    with open(args.output, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{args.output}: {len(pins)} pins")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
