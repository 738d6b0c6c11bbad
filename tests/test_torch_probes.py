"""The port's probe module and kernels held against the JAX reference on the
CPU.

On the CPU the port's kernel wrappers take their plain PyTorch versions and
the reference's Pallas kernels run in interpret mode, so these tests hold
the arithmetic, the loops and the probe contracts; the CUDA kernels
themselves are checked against the same plain versions on the card by
chip_smoke.py.
"""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import ast
import math
import pathlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpudash.ops import probes as jprobes
from tpudash_torch.ops import kernels
from tpudash_torch.ops import probes as tprobes
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
F32_U = 2.0**-24  # unit roundoff of float32
BF16_U = 2.0**-9  # unit roundoff of bfloat16 (8 significand bits)


def _sum_tol(n_terms: int, mass: np.ndarray) -> np.ndarray:
    """Two f32 sums of the same n terms in different orders: each lies
    within (n-1)·u·Σ|terms| of the exact sum, so they lie within twice that
    of each other."""
    return 2 * n_terms * F32_U * mass


# --- hbm_read ------------------------------------------------------------------

def test_hbm_read_pass_matches_reference_pass():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 512), dtype=np.float32)
    prev = rng.standard_normal((1, 512), dtype=np.float32)
    want = np.asarray(jprobes._hbm_read_once(jnp.asarray(x), jnp.asarray(prev), 64))
    got = kernels.hbm_read_pass(torch.from_numpy(x), torch.from_numpy(prev), 64).numpy()
    mass = np.abs(prev) + np.abs(x).sum(0, keepdims=True)
    assert got.shape == want.shape == (1, 512)
    assert np.all(np.abs(got - want) <= _sum_tol(x.shape[0] + 1, mass))


def test_hbm_read_loop_matches_reference_random():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((256, 512), dtype=np.float32)
    block_rows, repeats = 64, 3
    want = float(jprobes._hbm_read_loop(jnp.asarray(x), block_rows, repeats))
    got = tprobes._hbm_read_loop(torch.from_numpy(x), block_rows, repeats)
    assert got.shape == () and got.dtype == torch.float32
    # the scalar sums repeats × rows terms in each of 8 columns
    mass = repeats * np.abs(x[:, :8]).sum()
    tol = _sum_tol(repeats * x.shape[0] + 8, mass)
    assert abs(float(got) - want) <= tol


@pytest.mark.parametrize("rows,block_rows,repeats", [(256, 64, 3), (128, 128, 44)])
def test_hbm_read_loop_exact_on_ones(rows, block_rows, repeats):
    # every partial sum is an integer below 2^24: exact in any order
    x = np.ones((rows, 256), np.float32)
    want = 8.0 * rows * repeats
    assert float(tprobes._hbm_read_loop(torch.from_numpy(x), block_rows, repeats)) == want
    assert float(jprobes._hbm_read_loop(jnp.asarray(x), block_rows, repeats)) == want


def test_hbm_read_pass_ragged_rows_sum_every_row():
    # rows not a multiple of block_rows: the pass still sums every row
    x = torch.ones((100, 64))
    prev = torch.full((1, 64), 5.0)
    out = kernels.hbm_read_pass(x, prev, 32)
    assert torch.equal(out, torch.full((1, 64), 105.0))


# --- hbm_copy ------------------------------------------------------------------

def test_hbm_copy_loop_matches_reference_exactly():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((128, 256), dtype=np.float32)
    want = float(jprobes._hbm_copy_loop(jnp.asarray(x), 64, 3))
    got = float(tprobes._hbm_copy_loop(torch.from_numpy(x), 3))
    assert got == want  # a copy changes no bit


@pytest.mark.parametrize("repeats", [1, 2, 5])
def test_hbm_copy_loop_ones_is_eight(repeats):
    x = np.ones((64, 128), np.float32)
    assert float(tprobes._hbm_copy_loop(torch.from_numpy(x), repeats)) == 8.0
    assert float(jprobes._hbm_copy_loop(jnp.asarray(x), 64, repeats)) == 8.0


def test_hbm_copy_writes_out_and_matches_plain():
    x = torch.randn(33, 7, generator=torch.Generator().manual_seed(3))
    out = torch.empty_like(x)
    assert kernels.hbm_copy(x, out) is out
    assert torch.equal(out, x)
    fresh = kernels.hbm_copy(x)
    assert torch.equal(fresh, kernels.copy_ref(x))
    assert fresh.data_ptr() != x.data_ptr()


# --- the copy kernel's launch plan ------------------------------------------------

_TILE_FLOATS = kernels.COPY_TILE_BYTES // 4


def _plan_ranges(plan: kernels.CopyPlan) -> list[tuple[int, int]]:
    """The byte ranges the copy kernel moves under ``plan``, CTA by CTA as
    csrc/hbm_copy.cu walks them (CTA b takes items b, b + grid, ...; item
    n_tiles is the short bulk tail), then the float tail."""
    n_items = plan.n_tiles + (plan.tail_bytes > 0)
    ranges = []
    for b in range(plan.grid):
        for item in range(b, n_items, plan.grid):
            size = plan.tile_bytes if item < plan.n_tiles else plan.tail_bytes
            assert size > 0 and size % 16 == 0
            assert item * plan.tile_bytes % 16 == 0
            ranges.append((item * plan.tile_bytes, size))
    body = plan.n_tiles * plan.tile_bytes + plan.tail_bytes
    ranges += [(body + 4 * i, 4) for i in range(plan.tail_floats)]
    return ranges


_GRID_132 = 132 * kernels.COPY_CTAS_PER_SM
#: sizes at the edges of the cut, then a fixed sample spread evenly in log(n)
#: over [1, 4e6]
_PLAN_SIZES = [
    1, 3, 4, 5, _TILE_FLOATS - 100, _TILE_FLOATS, _TILE_FLOATS + 4,
    3 * _TILE_FLOATS + 1, 3 * _TILE_FLOATS + 2, 3 * _TILE_FLOATS + 3,
    _GRID_132 * _TILE_FLOATS, (3 * _GRID_132 + 7) * _TILE_FLOATS, 4_000_000,
]
_rng = random.Random(0)
_PLAN_SIZES += sorted(int(math.exp(_rng.uniform(0.0, math.log(4e6)))) for _ in range(24))


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("n", _PLAN_SIZES)
def test_copy_plan_covers_every_byte_once(sms, n):
    plan = kernels._copy_plan(n, sms)
    assert plan.tile_bytes % 16 == 0 and plan.tail_bytes % 16 == 0
    assert 0 <= plan.tail_bytes < plan.tile_bytes and plan.tail_floats == n % 4
    assert plan.stages >= 2 and plan.smem_bytes <= 232_448
    n_items = plan.n_tiles + (plan.tail_bytes > 0)
    assert 1 <= plan.grid <= sms * kernels.COPY_CTAS_PER_SM
    assert plan.grid <= max(1, n_items)  # no CTA without work
    pos = 0
    for start, size in sorted(_plan_ranges(plan)):
        assert start == pos  # no gap, no byte twice
        pos += size
    assert pos == 4 * n


@pytest.mark.parametrize("args", [(-1, 132), (10, 0), (10, -3)])
def test_copy_plan_refuses_what_the_kernel_cannot_run(args):
    with pytest.raises(ValueError):
        kernels._copy_plan(*args)


# --- wrapper contracts -----------------------------------------------------------

@pytest.mark.parametrize(
    "x,prev,block_rows,exc",
    [
        (torch.ones(8, 16, dtype=torch.float64), torch.zeros(1, 16), 4, TypeError),
        (torch.ones(8, 16), torch.zeros(1, 16, dtype=torch.float16), 4, TypeError),
        (torch.ones(16), torch.zeros(1, 16), 4, ValueError),
        (torch.ones(8, 18), torch.zeros(1, 18), 4, ValueError),  # cols % 4
        (torch.ones(0, 16), torch.zeros(1, 16), 4, ValueError),
        (torch.ones(8, 16), torch.zeros(1, 12), 4, ValueError),
        (torch.ones(16, 8).t(), torch.zeros(1, 16), 4, ValueError),  # strided
        (torch.ones(8, 16), torch.zeros(1, 16), 0, ValueError),
    ],
)
def test_hbm_read_pass_rejects_what_the_kernel_does_not_take(x, prev, block_rows, exc):
    with pytest.raises(exc):
        kernels.hbm_read_pass(x, prev, block_rows)


@pytest.mark.parametrize(
    "x,out,exc",
    [
        (torch.ones(4, 4, dtype=torch.float64), None, TypeError),
        (torch.ones(8, 4).t(), None, ValueError),
        (torch.ones(4, 4), torch.empty(4, 5), ValueError),
        (torch.ones(4, 4), torch.empty(4, 4, dtype=torch.float64), ValueError),
    ],
)
def test_hbm_copy_rejects_what_the_kernel_does_not_take(x, out, exc):
    with pytest.raises(exc):
        kernels.hbm_copy(x, out)


def test_hbm_copy_rejects_overlap():
    buf = torch.zeros(32)
    with pytest.raises(ValueError):
        kernels.hbm_copy(buf[:16], buf[8:24])
    with pytest.raises(ValueError):
        kernels.hbm_copy(buf, buf)


def test_cpu_calls_launch_nothing_and_build_nothing(monkeypatch):
    def no_nvcc(*a, **k):
        raise AssertionError("nvcc must not run for CPU tensors")

    monkeypatch.setattr(kernels.subprocess, "Popen", no_nvcc)
    before = kernels.launch_counts()
    tprobes._hbm_read_loop(torch.ones(64, 32), 16, 2)
    tprobes._hbm_copy_loop(torch.ones(64, 32), 2)
    assert kernels.launch_counts() == before
    assert all(k._fn is None for k in kernels.KERNELS)


def test_reset_launch_counts_zeroes_every_kernel():
    kernels.HBM_READ.launches = 3
    kernels.RMSNORM_BWD.launches = 2
    kernels.MOE_COMBINE_BWD.launches = 5
    kernels.MLA_ROPE_BWD.launches = 7
    kernels.KDA_STATE_BWD.launches = 11
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        "hbm_read": 0, "hbm_copy": 0, "rmsnorm_fwd": 0, "rmsnorm_bwd": 0,
        "moe_gather_fwd": 0, "moe_gather_bwd": 0, "moe_swiglu_fwd": 0, "moe_swiglu_bwd": 0,
        "moe_combine_fwd": 0, "moe_combine_bwd": 0, "mla_rope_fwd": 0, "mla_rope_bwd": 0,
        "kda_pairs_fwd": 0, "kda_pairs_bwd": 0, "kda_state_fwd": 0, "kda_state_bwd": 0}


def test_missing_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


def test_build_uses_sm90a_and_names_library_by_content():
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    for k in kernels.KERNELS:
        assert k.source.is_file()
        path = k.library_path
        assert path.parent == kernels.BUILD_DIR
        assert path.name.startswith(f"lib{k.source.stem}-") and path.suffix == ".so"
        text = k.source.read_text()
        assert k.symbol in text and "tpudash_cuda_error_string" in text


# --- matmul chain --------------------------------------------------------------

def test_matmul_chain_matches_reference():
    size, iters = 256, 2
    rng = np.random.default_rng(4)
    xj = jnp.asarray(rng.standard_normal((size, size), dtype=np.float32), jnp.bfloat16)
    wj = jnp.asarray(
        rng.standard_normal((size, size), dtype=np.float32) * size**-0.5, jnp.bfloat16
    )
    want = float(jprobes._matmul_chain_sum(xj, wj, iters))
    xt, wt = tprobes.inputs_from_numpy(np.asarray(xj), np.asarray(wj), "cpu")
    assert xt.dtype == wt.dtype == torch.bfloat16
    assert np.array_equal(xt.float().numpy(), np.asarray(xj, np.float32))
    got = float(tprobes._matmul_chain_sum(xt, wt, iters))
    # Each product rounds every element to bf16 once, in each framework, from
    # differently ordered f32 sums: per element and product the two differ by
    # at most ~2u of its magnitude, and the differences have random signs,
    # so the scalar sums differ by about 2u·iters·‖chain‖_F.  Four times that
    # still rejects a chain one product short (a difference of order
    # ‖chain‖_F itself).  The sum can be near zero, so the scale is the
    # chain's magnitude, not the sum.
    chain = np.asarray(xj, np.float64)
    for _ in range(iters):
        chain = chain @ np.asarray(wj, np.float64)
    tol = 4 * 2 * BF16_U * iters * np.linalg.norm(chain)
    assert abs(got - want) <= tol
    short = float(tprobes._matmul_chain_sum(xt, wt, iters - 1))
    assert abs(short - want) > tol


def test_matmul_probe_rounds_size_up():
    r = tprobes.matmul_flops_probe(size=100, iters=1, device="cpu")
    assert r.detail == {"size": 256, "iters": 1, "dtype": "bfloat16"}
    assert r.value > 0 and r.elapsed_s > 0


# --- probe contracts -----------------------------------------------------------

@pytest.mark.parametrize(
    "kwargs",
    [
        dict(mb=4, block_rows=256, k1=1, k2=2),  # clamps block_rows to the 128 rows
        dict(mb=1, block_rows=16, k1=1, k2=3, cols=1024),
    ],
)
@pytest.mark.parametrize("probe", ["hbm_bandwidth_probe", "hbm_copy_probe"])
def test_hbm_probe_detail_matches_reference(probe, kwargs):
    want = getattr(jprobes, probe)(**kwargs)
    got = getattr(tprobes, probe)(**kwargs, device="cpu")
    assert got.value > 0 and got.elapsed_s > 0
    detail = dict(got.detail)
    assert detail.pop("backend") == "cpu-reference"
    assert detail == want.detail
    if kwargs.get("block_rows") == 256:
        assert detail["block_rows"] == 128


@pytest.mark.parametrize("probe", ["hbm_bandwidth_probe", "hbm_copy_probe"])
@pytest.mark.parametrize("k1,k2", [(5, 5), (5, 4)])
def test_hbm_probe_rejects_bad_contrast_like_reference(probe, k1, k2):
    with pytest.raises(ValueError, match="k2 must exceed k1"):
        getattr(jprobes, probe)(mb=4, k1=k1, k2=k2)
    with pytest.raises(ValueError, match="k2 must exceed k1"):
        getattr(tprobes, probe)(mb=4, k1=k1, k2=k2, device="cpu")


def test_timers_read_back_and_clamp_like_reference():
    calls = []

    def scalar(v=1.0):
        calls.append(v)
        return torch.tensor(v)

    assert 0.0 <= tprobes._timed_scalar(scalar, 2.0, trials=3) < 1.0
    assert calls == [2.0] * 4  # one warm call, then one per trial
    # a large side no slower than the small one clamps to the guard value
    assert tprobes._delta_time(scalar, scalar) >= tprobes._MIN_DELTA_S
    assert tprobes._MIN_DELTA_S == jprobes._MIN_DELTA_S


def test_memory_stats_and_device_info_on_cpu():
    assert tprobes.hbm_memory_stats("cpu") == jprobes.hbm_memory_stats(jax.local_devices()[0])
    assert tprobes.hbm_memory_stats("cpu") == {"used_bytes": 0.0, "total_bytes": 0.0}
    info = tprobes.device_info("cpu")
    assert info["platform"] == "cpu" and info["num_local_devices"] == 1


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprobes.matmul_flops_probe(size=256, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprobes.hbm_bandwidth_probe(mb=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprobes.hbm_memory_stats()


# --- the port imports no JAX and nothing of the JAX package --------------------

def _port_files():
    return sorted((REPO / "tpudash_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "copy_sweep.py", REPO / "tools" / "ici_check.py",
        REPO / "tools" / "workload_check.py", REPO / "tools" / "graph_threads_check.py",
    ]


def _forbidden_imports(path: pathlib.Path) -> list[str]:
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "tpudash")]
    return bad


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 10 and all(f.is_file() for f in files)
    offenders = {str(f.relative_to(REPO)): _forbidden_imports(f) for f in files}
    assert {f: b for f, b in offenders.items() if b} == {}


def test_import_scan_catches_reference_imports_but_not_the_port(tmp_path):
    probe = tmp_path / "m.py"
    probe.write_text(
        "import tpudash_torch.ops\nfrom tpudash_torch import schema\n"
        "import jax.numpy as jnp\nfrom tpudash.schema import Sample\n"
        "def f():\n    import tpudash\n"
    )
    assert _forbidden_imports(probe) == ["jax.numpy", "tpudash.schema", "tpudash"]
