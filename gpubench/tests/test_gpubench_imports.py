"""Nothing of the benchmark imports JAX or the JAX package, and its
reference imports nothing of the program: top-level module names compared
whole, so that ``tpudash_torch`` is not taken for ``tpudash``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tpudash"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    bad = {str(p.relative_to(BENCH)): sorted(top_level_imports(p) & FORBIDDEN) for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_reference_imports_nothing_of_the_program():
    for p in sorted((BENCH / "reference").rglob("*.py")):
        assert "tpudash_torch" not in top_level_imports(p), p


def test_the_comparison_is_of_whole_names(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import tpudash_torch.ops\nfrom tpudash_torch import schema\nimport jaxtyping\n"
                   "from jax import numpy\n")
    assert top_level_imports(src) == {"tpudash_torch", "jaxtyping", "jax"}
    assert top_level_imports(src) & FORBIDDEN == {"jax"}


def test_a_cpu_run_loads_no_forbidden_module(tiny_base, cells_manifest):
    """A whole run of each shrunk cell on the CPU, in a process of its own
    (the test process may hold what other test files imported)."""
    code = (
        "import json, sys, time\n"
        "from pathlib import Path\n"
        "import torch\n"
        "from gpubench import manifest\n"
        "from gpubench.run import execute, forbidden_modules\n"
        "base = Path(sys.argv[1])\n"
        "m = json.loads(sys.argv[2])\n"
        "for name in ('probe-defaults.1gpu', 'workload-defaults.tp4'):\n"
        "    cell = manifest.find_cell(m, name, base)\n"
        "    execute(cell, 3, [torch.device('cpu')] * cell.chips, 0.2, False, time.perf_counter(), base)\n"
        "print(json.dumps(forbidden_modules()))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tiny_base),
                          json.dumps(cells_manifest)], cwd=BENCH.parent, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
