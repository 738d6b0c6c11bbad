"""Hand-written Hopper kernels of the probes and the model step: loader,
wrappers, plain versions.

Four kernels, from three CUDA C++ sources under ``csrc/``:

- ``hbm_read`` (``csrc/hbm_read.cu``) replaces the Pallas
  ``_hbm_read_kernel``: ``out(1, cols) = prev + Σ_rows x``.
- ``hbm_copy`` (``csrc/hbm_copy.cu``) replaces the Pallas ``_copy_kernel``:
  a copy of the buffer, through a persistent grid of bulk-copy (TMA) rings;
  :func:`_copy_plan` cuts the buffer for it.
- ``rmsnorm_fwd`` and ``rmsnorm_bwd`` (``csrc/rmsnorm.cu``): the model's
  RMSNorm and its gradient, each row read once; :func:`rmsnorm` is the
  autograd function over them and :func:`_norm_plan` their launch.  They
  replace no Pallas kernel: the reference leaves the norm to XLA's fusion.

Build: the first time a kernel is asked for on a CUDA tensor, ``nvcc``
compiles its source for ``sm_90a`` into a shared library with a plain C
interface under ``build/`` beside this file, named by a digest of the source
and flags, and ``ctypes`` loads it.  :func:`build_kernels` starts one
``nvcc`` per source, all at once.  Importing this module compiles nothing.

Each wrapper checks device, dtype, shape, contiguity and alignment and
raises on anything its kernel does not take; allocates outputs and scratch
with ``torch.empty``; launches on the current stream of the tensor's device;
raises if the launch returns a CUDA error; and adds one to its kernel's
``launches``.  The probes' wrappers send a tensor that lies on the CPU to
the plain version; the norm's raise on it, and their caller
(``models/workload.py::_rmsnorm``) sends CPU tensors to :func:`rmsnorm_ref`.
There is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
#: nvcc's output directory, made on first use (listed in .gitignore).
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "kernels are compiled from tpudash_torch/ops/csrc on first use"
    )


class CudaKernel:
    """One ``.cu`` source, compiled by nvcc into a shared library with a
    plain C interface and called through ``ctypes``."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = argtypes
        #: launches since the last :func:`reset_launch_counts`
        self.launches = 0
        #: nvcc's output of the build (``-Xptxas -v``: registers, spills)
        self.build_log = ""
        self._fn = None
        self._error_string = None
        self._count_lock = threading.Lock()

    @property
    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def _start_nvcc(self) -> "tuple[subprocess.Popen, Path] | None":
        if self.library_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp

    def _load(self, job: "tuple[subprocess.Popen, Path] | None") -> None:
        if job is not None:
            proc, tmp = job
            self.build_log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source.name} "
                    f"(exit {proc.returncode}):\n{self.build_log}"
                )
            os.replace(tmp, self.library_path)
        lib = ctypes.CDLL(str(self.library_path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = [*self.argtypes, ctypes.c_int, ctypes.c_void_p]  # + device, stream
        fn.restype = ctypes.c_int
        err = lib.tpudash_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._error_string = err
        self._fn = fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry on ``device``'s current stream; raise on a CUDA
        error, count the launch otherwise."""
        if self._fn is None:
            build_kernels([self])
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = self._fn(*args, device.index, stream)
        if rc != 0:
            msg = self._error_string(rc).decode(errors="replace")
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {rc} ({msg})")
        with self._count_lock:
            self.launches += 1


HBM_READ = CudaKernel(
    "hbm_read", "hbm_read.cu", "tpudash_hbm_read_pass",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3,
)
HBM_COPY = CudaKernel(
    "hbm_copy", "hbm_copy.cu", "tpudash_hbm_copy",
    # src, dst, then a CopyPlan: grid, tile_bytes, stages, n_tiles, tail_bytes, tail_floats
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
)
RMSNORM_FWD = CudaKernel(
    "rmsnorm_fwd", "rmsnorm.cu", "tpudash_rmsnorm_forward",
    # x, scale, y, rows, d, then a NormPlan's vecs, warps, forward_grid
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5,
)
RMSNORM_BWD = CudaKernel(
    "rmsnorm_bwd", "rmsnorm.cu", "tpudash_rmsnorm_backward",
    # x, scale, g, dx, partial, dscale, rows, d, then vecs, warps, backward_grid
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5,
)
KERNELS: tuple[CudaKernel, ...] = (HBM_READ, HBM_COPY, RMSNORM_FWD, RMSNORM_BWD)


def build_kernels(kernels: "list[CudaKernel] | tuple[CudaKernel, ...]" = KERNELS) -> float:
    """Compile (one nvcc per source, all started together) and load every
    kernel not loaded yet; returns the wall seconds it took.  Kernels of one
    source share its library."""
    t0 = time.perf_counter()
    with _BUILD_LOCK:
        todo = [k for k in kernels if k._fn is None]
        jobs: dict = {}
        for k in todo:
            if k.library_path not in jobs:
                jobs[k.library_path] = k._start_nvcc()
        logs: dict = {}
        for k in todo:
            k._load(jobs.pop(k.library_path, None))
            k.build_log = logs.setdefault(k.library_path, k.build_log)
    return time.perf_counter() - t0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        with k._count_lock:
            k.launches = 0


def _check_card_tensor(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, not {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned for float4 access")


# --- hbm_read ----------------------------------------------------------------

#: column tiles of the read kernel's grid: 256 threads × 4 columns each
_READ_COLS_PER_TILE = 1024


def hbm_read_pass_ref(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Plain version of one read pass: ``prev + Σ_rows x``."""
    return prev + x.sum(dim=0, keepdim=True)


def hbm_read_scratch(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """The read kernel's per-chunk column partials, ``(ceil(rows /
    block_rows), cols)`` f32, for reuse across the passes of one loop."""
    n_chunks = -(-x.shape[0] // block_rows)
    return torch.empty((n_chunks, x.shape[1]), dtype=torch.float32, device=x.device)


def hbm_read_pass(
    x: torch.Tensor,
    prev: torch.Tensor,
    block_rows: int = 128,
    scratch: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """One read-streaming pass, ``prev + Σ_rows x`` as a new ``(1, cols)``
    tensor.  ``block_rows`` is the row height of one CUDA block's chunk;
    ``scratch`` (from :func:`hbm_read_scratch`) is allocated when absent."""
    if x.dtype != torch.float32 or prev.dtype != torch.float32:
        raise TypeError(f"hbm_read takes float32, got {x.dtype} and {prev.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, cols), got shape {tuple(x.shape)}")
    rows, cols = x.shape
    if rows < 1 or cols < 4 or cols % 4:
        raise ValueError(f"x needs rows >= 1 and cols a positive multiple of 4, got {rows}x{cols}")
    if tuple(prev.shape) != (1, cols):
        raise ValueError(f"prev must be (1, {cols}), got {tuple(prev.shape)}")
    if prev.device != x.device:
        raise ValueError(f"x on {x.device} but prev on {prev.device}")
    if not (x.is_contiguous() and prev.is_contiguous()):
        raise ValueError("hbm_read takes contiguous tensors")
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if x.device.type == "cpu":
        return hbm_read_pass_ref(x, prev)

    _check_card_tensor(x, "x")
    if rows >= 2**31 or -(-cols // _READ_COLS_PER_TILE) >= 65536:
        raise ValueError(f"x of {rows}x{cols} exceeds the read kernel's grid")
    n_chunks = -(-rows // block_rows)
    if scratch is None:
        scratch = hbm_read_scratch(x, block_rows)
    if (
        tuple(scratch.shape) != (n_chunks, cols)
        or scratch.dtype != torch.float32
        or scratch.device != x.device
        or not scratch.is_contiguous()
    ):
        raise ValueError(f"scratch must be contiguous float32 ({n_chunks}, {cols}) on {x.device}")
    _check_card_tensor(scratch, "scratch")
    out = torch.empty((1, cols), dtype=torch.float32, device=x.device)
    HBM_READ.launch(
        x.device, x.data_ptr(), prev.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        rows, cols, min(block_rows, rows),
    )
    return out


# --- hbm_copy ----------------------------------------------------------------

#: the copy's persistent grid: CTAs per SM, ring stages per CTA, bytes per
#: stage.  csrc/hbm_copy.cu refuses a ring larger than a block may take.
COPY_CTAS_PER_SM = 2
COPY_STAGES = 3
COPY_TILE_BYTES = 32 * 1024


class CopyPlan(NamedTuple):
    """How the copy kernel cuts ``n`` f32 values: ``n_tiles`` tiles of
    ``tile_bytes``, then one bulk item of ``tail_bytes`` (a multiple of 16,
    possibly 0), then ``tail_floats`` (``n % 4``) single floats; ``grid``
    CTAs each run a ring of ``stages`` tiles, CTA ``b`` taking items ``b,
    b + grid, ...``."""

    grid: int
    tile_bytes: int
    stages: int
    n_tiles: int
    tail_bytes: int
    tail_floats: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA: its ring."""
        return self.stages * self.tile_bytes


@functools.lru_cache(maxsize=256)
def _copy_plan(n: int, sms: int) -> CopyPlan:
    """The copy kernel's launch for ``n`` f32 values on a card of ``sms`` SMs."""
    if n < 0 or sms < 1:
        raise ValueError(f"no copy plan for n={n} on {sms} SMs")
    n_tiles, tail_bytes = divmod(n // 4 * 16, COPY_TILE_BYTES)
    items = n_tiles + (tail_bytes > 0)
    grid = max(1, min(sms * COPY_CTAS_PER_SM, items))
    return CopyPlan(grid, COPY_TILE_BYTES, COPY_STAGES, n_tiles, tail_bytes, n % 4)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def copy_ref(x: torch.Tensor, out: "torch.Tensor | None" = None) -> torch.Tensor:
    """Plain version of one copy pass: torch's own copy."""
    if out is None:
        return x.clone()
    return out.copy_(x)


def hbm_copy(x: torch.Tensor, out: "torch.Tensor | None" = None) -> torch.Tensor:
    """Copy ``x`` into ``out`` (allocated when absent) and return it."""
    if x.dtype != torch.float32:
        raise TypeError(f"hbm_copy takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("hbm_copy takes a contiguous tensor")
    if out is not None:
        if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device:
            raise ValueError(
                f"out must match x: {tuple(x.shape)} {x.dtype} on {x.device}, got "
                f"{tuple(out.shape)} {out.dtype} on {out.device}"
            )
        if not out.is_contiguous():
            raise ValueError("hbm_copy writes a contiguous tensor")
        nbytes = x.numel() * 4
        if x.numel() and abs(out.data_ptr() - x.data_ptr()) < nbytes:
            raise ValueError("hbm_copy's source and destination overlap")
    if x.device.type == "cpu":
        return copy_ref(x, out)

    _check_card_tensor(x, "x")
    if out is None:
        out = torch.empty_like(x)
    _check_card_tensor(out, "out")
    if x.numel():
        plan = _copy_plan(x.numel(), _sm_count(x.device.index))
        HBM_COPY.launch(x.device, x.data_ptr(), out.data_ptr(), *plan)
    return out


# --- rmsnorm -------------------------------------------------------------------

#: the widest row the norm kernels take (8 warps × 32 threads × 4 vectors × 8)
NORM_MAX_D = 8192
#: csrc/rmsnorm.cu's block: 8 warps, shared by 8 / warps rows
_NORM_WARPS = 8
#: the backward's fixed grid: two blocks on each of an H100's 132 SMs
_NORM_BACKWARD_BLOCKS = 264
NORM_EPS = 1e-6


class NormPlan(NamedTuple):
    """How the norm kernels cut ``rows`` rows of ``d`` values: a team of
    ``warps`` warps owns a row, each of its threads ``vecs`` 16-byte vectors
    (8 values) of it; ``8 // warps`` teams a block.  The forward runs one
    row a team on ``forward_grid`` blocks; the backward's
    ``backward_grid`` blocks each write one row of partial sums of
    ``dscale``, so its order depends on the shape alone."""

    vecs: int
    warps: int
    forward_grid: int
    backward_grid: int


@functools.lru_cache(maxsize=256)
def _norm_plan(rows: int, d: int) -> NormPlan:
    """The norm kernels' launch for ``rows`` rows of width ``d``."""
    if rows < 1 or d < 8 or d % 8 or d > NORM_MAX_D:
        raise ValueError(f"no norm plan for {rows} rows of width {d}: d must be a multiple "
                         f"of 8 up to {NORM_MAX_D}")
    warps = 1
    while d > warps * 32 * 4 * 8:
        warps *= 2
    vecs = -(-d // (warps * 32 * 8))
    grid = -(-rows // (_NORM_WARPS // warps))
    return NormPlan(vecs, warps, grid, min(grid, _NORM_BACKWARD_BLOCKS))


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: ``bf16((f32(x) · r) · scale)`` with
    ``r = rsqrt(mean(f32(x)²) + 1e-6)``, the reference's expression."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + NORM_EPS)
    return (x32 * rms * scale).to(torch.bfloat16)


def rmsnorm_grads_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor):
    """Plain version of the backward, in the closed form the kernel
    computes, all in f32: ``(dx, dscale)`` with ``dx = r·(g·s − x̂·mean(g·s·x̂))``
    before its rounding to bf16 and ``dscale = Σ_rows g·x̂``, ``x̂ = f32(x)·r``."""
    x32, g32 = x.float(), g.float()
    r = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + NORM_EPS)
    xh = x32 * r
    gs = g32 * scale
    mean = (gs * xh).sum(-1, keepdim=True) / x.shape[-1]
    dx = r * (gs - xh * mean)
    return dx, (g32 * xh).reshape(-1, x.shape[-1]).sum(0)


def _check_norm_args(x: torch.Tensor, scale: torch.Tensor, g: "torch.Tensor | None" = None) -> None:
    tensors = {"x": x, "scale": scale} if g is None else {"x": x, "scale": scale, "g": g}
    if x.dtype != torch.bfloat16 or (g is not None and g.dtype != torch.bfloat16):
        raise TypeError(f"the norm takes bf16 x and g, got {x.dtype}"
                        f"{'' if g is None else f' and {g.dtype}'}")
    if scale.dtype != torch.float32:
        raise TypeError(f"the norm takes an f32 scale, got {scale.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if d < 8 or d % 8 or d > NORM_MAX_D:
        raise ValueError(f"the norm kernels take a last dim that is a multiple of 8 up to "
                         f"{NORM_MAX_D}, got shape {tuple(x.shape)}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale must be ({d},), got {tuple(scale.shape)}")
    if g is not None and g.shape != x.shape:
        raise ValueError(f"g must have x's shape {tuple(x.shape)}, got {tuple(g.shape)}")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("the norm kernels take contiguous tensors")
    if x.device.type != "cuda":
        raise ValueError(f"the norm kernels run on CUDA devices, not {x.device}; "
                         "rmsnorm_ref is their plain version")
    if any(t.device != x.device for t in tensors.values()):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors.values()]}: one device")
    for what, t in tensors.items():
        _check_card_tensor(t, what)


def rmsnorm_forward(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The forward kernel: ``rmsnorm_ref(x, scale)`` over the last dim of a
    contiguous bf16 ``x`` on a GPU, as a new bf16 tensor."""
    _check_norm_args(x, scale)
    y = torch.empty_like(x)
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    if rows:
        plan = _norm_plan(rows, d)
        RMSNORM_FWD.launch(x.device, x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
                           plan.vecs, plan.warps, plan.forward_grid)
    return y


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor,
                     g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels: ``(dx, dscale)`` for the upstream gradient ``g``
    of ``rmsnorm_forward(x, scale)``, dx bf16 and dscale f32, as
    :func:`rmsnorm_grads_ref` computes them (dx rounded once)."""
    _check_norm_args(x, scale, g)
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    dx = torch.empty_like(x)
    if not rows:
        return dx, torch.zeros_like(scale)
    plan = _norm_plan(rows, d)
    partial = torch.empty((plan.backward_grid, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(scale)
    RMSNORM_BWD.launch(x.device, x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
                       partial.data_ptr(), dscale.data_ptr(), rows, d,
                       plan.vecs, plan.warps, plan.backward_grid)
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """The norm on a GPU, forward and backward each a kernel.  It saves x
    and scale only: the backward recomputes r from x."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return rmsnorm_forward(x, scale)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return rmsnorm_backward(x, scale, g.contiguous())


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """:func:`rmsnorm_ref` through the kernels, differentiable in both
    arguments; raises on what the kernels do not take, a CPU tensor
    included."""
    return _RMSNorm.apply(x, scale)
