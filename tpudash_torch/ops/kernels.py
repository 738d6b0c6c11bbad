"""Hand-written Hopper kernels of the probes and the model step: loader,
wrappers, plain versions.

Sixteen kernels, from six CUDA C++ sources under ``csrc/``:

- ``hbm_read`` (``csrc/hbm_read.cu``) replaces the Pallas
  ``_hbm_read_kernel``: ``out(1, cols) = prev + Σ_rows x``.
- ``hbm_copy`` (``csrc/hbm_copy.cu``) replaces the Pallas ``_copy_kernel``:
  a copy of the buffer, through a persistent grid of bulk-copy (TMA) rings;
  :func:`_copy_plan` cuts the buffer for it.
- ``rmsnorm_fwd`` and ``rmsnorm_bwd`` (``csrc/rmsnorm.cu``): the model's
  RMSNorm and its gradient, each row read once; :func:`rmsnorm` is the
  autograd function over them and :func:`_norm_plan` their launch.  They
  replace no Pallas kernel: the reference leaves the norm to XLA's fusion.
- ``moe_gather_fwd``/``_bwd``, ``moe_swiglu_fwd``/``_bwd`` and
  ``moe_combine_fwd``/``_bwd`` (``csrc/moe_dispatch.cu``): the dropless MoE
  dispatch of ``models/deepseek_v2.py`` over the valid rows of its sorted
  buffer only, the count read on the device; :func:`moe_gather`,
  :func:`moe_swiglu` and :func:`moe_combine` are the autograd functions
  over them.  They replace no Pallas kernel either: the reference's MoE is
  a dense one-hot product.
- ``mla_rope_fwd`` and ``mla_rope_bwd`` (``csrc/mla_rope.cu``): MLA's RoPE
  and q/k assembly in ``models/deepseek_v2.py``, from the projections to
  attention's q, k and v and back, each byte once; :func:`mla_qk_rope` is
  the autograd function over them.  They replace no Pallas kernel: the JAX
  package has no MLA and no RoPE.
- ``kda_pairs_fwd``/``_bwd`` and ``kda_state_fwd``/``_bwd``
  (``csrc/kda.cu``): the chunked gated delta rule of Kimi-Linear's KDA
  layers (``models/kimi_linear.py``), the decay-weighted k·kᵀ and q·kᵀ
  blocks of every chunk and the state pass over a sequence's chunks, each
  way; :func:`kda_chunk` is the chunked algorithm around them.  They replace
  no Pallas kernel: the JAX package has no linear attention.

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
The MoE dispatch's autograd functions run their plain versions on CPU
tensors and the kernels on CUDA tensors, whose wrappers raise on anything
else; :func:`mla_qk_rope` alike, where on CPU tensors the plain version is
the model's own chain under autograd.  There is no fallback from the card
to the plain version.
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
import torch.nn.functional as F

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
    # x, scale, y, rows, d, then a NormPlan's vecs, warps, forward_grid, then eps
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float],
)
RMSNORM_BWD = CudaKernel(
    "rmsnorm_bwd", "rmsnorm.cu", "tpudash_rmsnorm_backward",
    # x, scale, g, dx, partial, dscale, rows, d, then vecs, warps, backward_grid, eps
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float],
)
#: the MoE dispatch's kernels (csrc/moe_dispatch.cu); every one ends in the
#: grid, and those over tokens take S, K, cap and d before it
MOE_GATHER_FWD = CudaKernel(
    "moe_gather_fwd", "moe_dispatch.cu", "tpudash_moe_gather_forward",
    # x, pos, n_valid, xs
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5,
)
MOE_GATHER_BWD = CudaKernel(
    "moe_gather_bwd", "moe_dispatch.cu", "tpudash_moe_gather_backward",
    # dxs, pos, n_valid, dx
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5,
)
MOE_SWIGLU_FWD = CudaKernel(
    "moe_swiglu_fwd", "moe_dispatch.cu", "tpudash_moe_swiglu_forward",
    # h, n_valid, act, then cap, f, grid
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3,
)
MOE_SWIGLU_BWD = CudaKernel(
    "moe_swiglu_bwd", "moe_dispatch.cu", "tpudash_moe_swiglu_backward",
    # h, dact, n_valid, dh, then cap, f, grid
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3,
)
MOE_COMBINE_FWD = CudaKernel(
    "moe_combine_fwd", "moe_dispatch.cu", "tpudash_moe_combine_forward",
    # ys, gates, pos, n_valid, y
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5,
)
MOE_COMBINE_BWD = CudaKernel(
    "moe_combine_bwd", "moe_dispatch.cu", "tpudash_moe_combine_backward",
    # dy, ys, gates, pos, n_valid, dys, dgates
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5,
)
#: MLA's RoPE and q/k assembly (csrc/mla_rope.cu); both end in S, T, H, nope,
#: rope, v, r and the grid
MLA_ROPE_FWD = CudaKernel(
    "mla_rope_fwd", "mla_rope.cu", "tpudash_mla_rope_forward",
    # q_raw, kv, kv_a, cos, sin, q, k
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8,
)
MLA_ROPE_BWD = CudaKernel(
    "mla_rope_bwd", "mla_rope.cu", "tpudash_mla_rope_backward",
    # dq, dk, dv, cos, sin, dq_raw, dkv, dkv_a, then the (b, t, h) strides of dq, dk, dv
    [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 8,
)
#: Kimi Delta Attention's chunked passes (csrc/kda.cu): the decay-weighted
#: pair blocks of each chunk and the state pass over a sequence's chunks,
#: each way
KDA_PAIRS_FWD = CudaKernel(
    "kda_pairs_fwd", "kda.cu", "tpudash_kda_pairs_forward",
    # q, k, G, akk, aqk, then the chunks
    [ctypes.c_void_p] * 5 + [ctypes.c_int],
)
KDA_PAIRS_BWD = CudaKernel(
    "kda_pairs_bwd", "kda.cu", "tpudash_kda_pairs_backward",
    # q, k, G, dakk, daqk, dq, dk, dG, then the chunks
    [ctypes.c_void_p] * 8 + [ctypes.c_int],
)
KDA_STATE_FWD = CudaKernel(
    "kda_state_fwd", "kda.cu", "tpudash_kda_state_forward",
    # w, u, kd, gamma, states, v_new, then the heads (B·H) and the chunks a head
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2,
)
KDA_STATE_BWD = CudaKernel(
    "kda_state_bwd", "kda.cu", "tpudash_kda_state_backward",
    # w, kd, gamma, gS, gv, dnext, dv_new, then the heads and the chunks a head
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2,
)
NORM_KERNELS: tuple[CudaKernel, ...] = (RMSNORM_FWD, RMSNORM_BWD)
MOE_KERNELS: tuple[CudaKernel, ...] = (MOE_GATHER_FWD, MOE_GATHER_BWD, MOE_SWIGLU_FWD,
                                       MOE_SWIGLU_BWD, MOE_COMBINE_FWD, MOE_COMBINE_BWD)
MLA_KERNELS: tuple[CudaKernel, ...] = (MLA_ROPE_FWD, MLA_ROPE_BWD)
KDA_KERNELS: tuple[CudaKernel, ...] = (KDA_PAIRS_FWD, KDA_PAIRS_BWD, KDA_STATE_FWD,
                                       KDA_STATE_BWD)
KERNELS: tuple[CudaKernel, ...] = (HBM_READ, HBM_COPY, *NORM_KERNELS, *MOE_KERNELS,
                                   *MLA_KERNELS, *KDA_KERNELS)


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


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = NORM_EPS) -> torch.Tensor:
    """Plain version of the forward: ``bf16((f32(x) · r) · scale)`` with
    ``r = rsqrt(mean(f32(x)²) + eps)``, the reference's expression."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms * scale).to(torch.bfloat16)


def rmsnorm_grads_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      eps: float = NORM_EPS):
    """Plain version of the backward, in the closed form the kernel
    computes, all in f32: ``(dx, dscale)`` with ``dx = r·(g·s − x̂·mean(g·s·x̂))``
    before its rounding to bf16 and ``dscale = Σ_rows g·x̂``, ``x̂ = f32(x)·r``."""
    x32, g32 = x.float(), g.float()
    r = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
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


def rmsnorm_forward(x: torch.Tensor, scale: torch.Tensor, eps: float = NORM_EPS) -> torch.Tensor:
    """The forward kernel: ``rmsnorm_ref(x, scale, eps)`` over the last dim of a
    contiguous bf16 ``x`` on a GPU, as a new bf16 tensor."""
    _check_norm_args(x, scale)
    y = torch.empty_like(x)
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    if rows:
        plan = _norm_plan(rows, d)
        RMSNORM_FWD.launch(x.device, x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
                           plan.vecs, plan.warps, plan.forward_grid, eps)
    return y


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     eps: float = NORM_EPS) -> tuple[torch.Tensor, torch.Tensor]:
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
                       plan.vecs, plan.warps, plan.backward_grid, eps)
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """The norm on a GPU, forward and backward each a kernel.  It saves x
    and scale only: the backward recomputes r from x."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return (*rmsnorm_backward(x, scale, g.contiguous(), ctx.eps), None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = NORM_EPS) -> torch.Tensor:
    """:func:`rmsnorm_ref` through the kernels, differentiable in both
    arguments; raises on what the kernels do not take, a CPU tensor
    included."""
    return _RMSNorm.apply(x, scale, eps)


# --- MoE dispatch ----------------------------------------------------------------
#
# The (token, choice) pairs of a MoE layer sorted by held expert fill the
# first n_valid rows of a buffer of ``cap`` rows; ``pos`` (S, K) int32 is
# the inverse of that sort (the row of token t's choice k), ``n_valid`` a
# one-element int32 tensor on the device (the grouped products' last
# offset).  A choice is valid when its row is below n_valid.  Nothing here
# reads or writes a row from n_valid on: the kernels leave such rows of
# their outputs unwritten, the plain versions fill them with NaN so that a
# read of one shows.

#: the most choices a token may make that the dispatch kernels take
MOE_MAX_TOP_K = 8
#: the dispatch kernels' persistent grid: blocks on each SM
MOE_CTAS_PER_SM = 4


def _valid_count(n_valid: torch.Tensor) -> int:
    return int(n_valid.reshape(-1)[0])


def _choices(pos: torch.Tensor, n: int):
    """(k, rows, mask) for each choice k: the rows of the tokens' choice k
    and which of them are valid."""
    for k in range(pos.shape[1]):
        rows = pos[:, k].long()
        yield k, rows, rows < n


def moe_gather_ref(x: torch.Tensor, pos: torch.Tensor, n_valid: torch.Tensor,
                   cap: int) -> torch.Tensor:
    """Plain version of the gather: ``xs (cap, d)`` with ``xs[pos[t, k]] =
    x[t]`` for each valid choice."""
    n = _valid_count(n_valid)
    xs = x.new_full((cap, x.shape[1]), float("nan"))
    for _, rows, m in _choices(pos, n):
        xs[rows[m]] = x[m]
    return xs


def moe_gather_grad_ref(dxs: torch.Tensor, pos: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather's backward: ``dx (S, d)``, each token's
    valid rows of ``dxs`` added in f32 in k order, rounded once to bf16."""
    n = _valid_count(n_valid)
    acc = torch.zeros((pos.shape[0], dxs.shape[1]), dtype=torch.float32, device=dxs.device)
    for _, rows, m in _choices(pos, n):
        acc[m] += dxs[rows[m]].float()
    return acc.to(torch.bfloat16)


def moe_swiglu_ref(h: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Plain version of the SwiGLU over the valid rows of ``h`` (gate's
    columns, then up's): ``bf16(silu(f32 gate) · f32 up)``."""
    n, f = _valid_count(n_valid), h.shape[1] // 2
    act = h.new_full((h.shape[0], f), float("nan"))
    gate, up = h[:n].float().chunk(2, dim=-1)
    act[:n] = (torch.nn.functional.silu(gate) * up).to(torch.bfloat16)
    return act


def moe_swiglu_grad_ref(h: torch.Tensor, dact: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Plain version of the SwiGLU's backward: ``dh`` (gate's half, then
    up's), autograd's f32 chain of the forward's expression, each half
    rounded once."""
    n, f = _valid_count(n_valid), h.shape[1] // 2
    gate, up = h[:n].float().chunk(2, dim=-1)
    da = dact[:n].float()
    dh = h.new_full(h.shape, float("nan"))
    dh[:n, :f] = torch.ops.aten.silu_backward(da * up, gate).to(torch.bfloat16)
    dh[:n, f:] = (da * torch.nn.functional.silu(gate)).to(torch.bfloat16)
    return dh


def moe_combine_ref(ys: torch.Tensor, gates: torch.Tensor, pos: torch.Tensor,
                    n_valid: torch.Tensor) -> torch.Tensor:
    """Plain version of the combine: ``y (S, d)``, each token's valid rows
    of ``ys`` times their f32 gates, added in f32 in k order, rounded once
    to bf16; a token with no valid choice gets zeros."""
    n = _valid_count(n_valid)
    acc = torch.zeros((pos.shape[0], ys.shape[1]), dtype=torch.float32, device=ys.device)
    for k, rows, m in _choices(pos, n):
        acc[m] += gates[m, k, None] * ys[rows[m]].float()
    return acc.to(torch.bfloat16)


def moe_combine_grad_ref(dy: torch.Tensor, ys: torch.Tensor, gates: torch.Tensor,
                         pos: torch.Tensor, n_valid: torch.Tensor) -> tuple:
    """Plain version of the combine's backward: ``(dys, dgates)``, each
    valid choice's row of dys its token's gradient times the gate, rounded
    once, and its gate's gradient the f32 dot of the two rows (0 for an
    invalid choice)."""
    n = _valid_count(n_valid)
    dy32 = dy.float()
    dys = ys.new_full(ys.shape, float("nan"))
    dgates = torch.zeros(gates.shape, dtype=torch.float32, device=gates.device)
    for k, rows, m in _choices(pos, n):
        dys[rows[m]] = (gates[m, k, None] * dy32[m]).to(torch.bfloat16)
        dgates[m, k] = (dy32[m] * ys[rows[m]].float()).sum(-1)
    return dys, dgates


def _check_moe_args(rows: dict, pos: "torch.Tensor | None", n_valid: torch.Tensor,
                    gates: "torch.Tensor | None" = None) -> None:
    """bf16 ``rows`` tensors (2-D, width a multiple of 8), int32 ``pos`` (S,
    K), f32 ``gates`` (S, K), a one-element int32 ``n_valid``; all
    contiguous, on one CUDA device."""
    tensors = dict(rows)
    for what, t in rows.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the dispatch kernels take bf16 {what}, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] < 8 or t.shape[1] % 8:
            raise ValueError(f"{what} must be 2-D with a width that is a multiple of 8, got "
                             f"{tuple(t.shape)}")
    if pos is not None:
        tensors["pos"] = pos
        if pos.dtype != torch.int32 or pos.dim() != 2:
            raise TypeError(f"pos must be (S, K) int32, got {tuple(pos.shape)} {pos.dtype}")
        if not 1 <= pos.shape[1] <= MOE_MAX_TOP_K or pos.numel() >= 2**31:
            raise ValueError(f"the dispatch kernels take 1 to {MOE_MAX_TOP_K} choices a token and "
                             f"fewer than 2**31 pairs, got pos {tuple(pos.shape)}")
    if gates is not None:
        tensors["gates"] = gates
        if gates.dtype != torch.float32 or gates.shape != pos.shape:
            raise TypeError(f"gates must be f32 of pos's shape {tuple(pos.shape)}, got "
                            f"{tuple(gates.shape)} {gates.dtype}")
    if n_valid.dtype != torch.int32 or n_valid.numel() != 1:
        raise TypeError(f"n_valid must be one int32, got {tuple(n_valid.shape)} {n_valid.dtype}")
    tensors["n_valid"] = n_valid
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("the dispatch kernels take contiguous tensors")
    dev = n_valid.device
    if dev.type != "cuda":
        raise ValueError(f"the dispatch kernels run on CUDA devices, not {dev}; the moe_*_ref "
                         "functions are their plain versions")
    if any(t.device != dev for t in tensors.values()):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors.values()]}: one device")
    for what, t in rows.items():
        _check_card_tensor(t, what)
    if any(t.shape[0] >= 2**31 for t in rows.values()):
        raise ValueError("the dispatch kernels take fewer than 2**31 rows")


def _moe_grid(device: torch.device) -> int:
    return _sm_count(device.index) * MOE_CTAS_PER_SM


def _token_rows(pos: torch.Tensor, what: str, t: torch.Tensor) -> None:
    if t.shape[0] != pos.shape[0]:
        raise ValueError(f"{what} must have a row for each of pos's {pos.shape[0]} tokens, "
                         f"got {tuple(t.shape)}")


def moe_gather_forward(x: torch.Tensor, pos: torch.Tensor, n_valid: torch.Tensor,
                       cap: int) -> torch.Tensor:
    """The gather kernel: :func:`moe_gather_ref`'s valid rows, in a new
    (cap, d) bf16 tensor whose other rows are left unwritten."""
    _check_moe_args({"x": x}, pos, n_valid)
    _token_rows(pos, "x", x)
    if not 0 <= cap < 2**31:
        raise ValueError(f"cap must lie in [0, 2**31), got {cap}")
    xs = torch.empty((cap, x.shape[1]), dtype=x.dtype, device=x.device)
    _check_card_tensor(xs, "xs")
    S, K = pos.shape
    MOE_GATHER_FWD.launch(x.device, x.data_ptr(), pos.data_ptr(), n_valid.data_ptr(),
                          xs.data_ptr(), S, K, cap, x.shape[1], _moe_grid(x.device))
    return xs


def moe_gather_backward(dxs: torch.Tensor, pos: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """The gather's backward kernel: :func:`moe_gather_grad_ref`, every
    token's row written."""
    _check_moe_args({"dxs": dxs}, pos, n_valid)
    S, K = pos.shape
    dx = torch.empty((S, dxs.shape[1]), dtype=dxs.dtype, device=dxs.device)
    MOE_GATHER_BWD.launch(dxs.device, dxs.data_ptr(), pos.data_ptr(), n_valid.data_ptr(),
                          dx.data_ptr(), S, K, dxs.shape[0], dxs.shape[1], _moe_grid(dxs.device))
    return dx


def moe_swiglu_forward(h: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """The SwiGLU kernel: :func:`moe_swiglu_ref`'s valid rows, in a new (cap,
    f) bf16 tensor whose other rows are left unwritten."""
    _check_moe_args({"h": h}, None, n_valid)
    f = h.shape[1] // 2
    if f % 8:
        raise ValueError(f"h's halves must be a multiple of 8 wide, got {tuple(h.shape)}")
    act = torch.empty((h.shape[0], f), dtype=h.dtype, device=h.device)
    MOE_SWIGLU_FWD.launch(h.device, h.data_ptr(), n_valid.data_ptr(), act.data_ptr(),
                          h.shape[0], f, _moe_grid(h.device))
    return act


def moe_swiglu_backward(h: torch.Tensor, dact: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """The SwiGLU's backward kernel: :func:`moe_swiglu_grad_ref`'s valid
    rows, in a new tensor of h's shape whose other rows are left unwritten."""
    _check_moe_args({"h": h, "dact": dact}, None, n_valid)
    f = h.shape[1] // 2
    if f % 8 or tuple(dact.shape) != (h.shape[0], f):
        raise ValueError(f"h {tuple(h.shape)} must have halves a multiple of 8 wide, and dact "
                         f"their shape, got {tuple(dact.shape)}")
    dh = torch.empty_like(h)
    MOE_SWIGLU_BWD.launch(h.device, h.data_ptr(), dact.data_ptr(), n_valid.data_ptr(),
                          dh.data_ptr(), h.shape[0], f, _moe_grid(h.device))
    return dh


def moe_combine_forward(ys: torch.Tensor, gates: torch.Tensor, pos: torch.Tensor,
                        n_valid: torch.Tensor) -> torch.Tensor:
    """The combine kernel: :func:`moe_combine_ref`, every token's row
    written."""
    _check_moe_args({"ys": ys}, pos, n_valid, gates)
    S, K = pos.shape
    y = torch.empty((S, ys.shape[1]), dtype=ys.dtype, device=ys.device)
    MOE_COMBINE_FWD.launch(ys.device, ys.data_ptr(), gates.data_ptr(), pos.data_ptr(),
                           n_valid.data_ptr(), y.data_ptr(), S, K, ys.shape[0], ys.shape[1],
                           _moe_grid(ys.device))
    return y


def moe_combine_backward(dy: torch.Tensor, ys: torch.Tensor, gates: torch.Tensor,
                         pos: torch.Tensor, n_valid: torch.Tensor) -> tuple:
    """The combine's backward kernel: :func:`moe_combine_grad_ref`, dys's
    invalid rows left unwritten."""
    _check_moe_args({"dy": dy, "ys": ys}, pos, n_valid, gates)
    _token_rows(pos, "dy", dy)
    if dy.shape[1] != ys.shape[1]:
        raise ValueError(f"dy {tuple(dy.shape)} and ys {tuple(ys.shape)} differ in width")
    S, K = pos.shape
    dys = torch.empty_like(ys)
    dgates = torch.empty((S, K), dtype=torch.float32, device=ys.device)
    MOE_COMBINE_BWD.launch(ys.device, dy.data_ptr(), ys.data_ptr(), gates.data_ptr(),
                           pos.data_ptr(), n_valid.data_ptr(), dys.data_ptr(), dgates.data_ptr(),
                           S, K, ys.shape[0], ys.shape[1], _moe_grid(ys.device))
    return dys, dgates


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


class _MoEGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pos, n_valid, cap):
        ctx.save_for_backward(pos, n_valid)
        return (moe_gather_ref if _on_cpu(x) else moe_gather_forward)(x, pos, n_valid, cap)

    @staticmethod
    def backward(ctx, dxs):
        pos, n_valid = ctx.saved_tensors
        dxs = dxs.contiguous()
        grad = moe_gather_grad_ref if _on_cpu(dxs) else moe_gather_backward
        return grad(dxs, pos, n_valid), None, None, None


class _MoESwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, n_valid):
        ctx.save_for_backward(h, n_valid)
        return (moe_swiglu_ref if _on_cpu(h) else moe_swiglu_forward)(h, n_valid)

    @staticmethod
    def backward(ctx, dact):
        h, n_valid = ctx.saved_tensors
        grad = moe_swiglu_grad_ref if _on_cpu(h) else moe_swiglu_backward
        return grad(h, dact.contiguous(), n_valid), None


class _MoECombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ys, gates, pos, n_valid):
        ctx.save_for_backward(ys, gates, pos, n_valid)
        return (moe_combine_ref if _on_cpu(ys) else moe_combine_forward)(ys, gates, pos, n_valid)

    @staticmethod
    def backward(ctx, dy):
        ys, gates, pos, n_valid = ctx.saved_tensors
        grad = moe_combine_grad_ref if _on_cpu(ys) else moe_combine_backward
        dys, dgates = grad(dy.contiguous(), ys, gates, pos, n_valid)
        return dys, dgates, None, None


def moe_gather(x: torch.Tensor, pos: torch.Tensor, n_valid: torch.Tensor, cap: int) -> torch.Tensor:
    """The tokens ``x`` (S, d) gathered into the sorted buffer (cap, d),
    differentiable in x: :func:`moe_gather_ref` and its backward on CPU
    tensors, the kernels on CUDA tensors (raising on what they do not take)."""
    return _MoEGather.apply(x, pos, n_valid, cap)


def moe_swiglu(h: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """The SwiGLU of the sorted buffer's gate/up product ``h`` (cap, 2f),
    differentiable in h; plain versions on the CPU, kernels on GPUs."""
    return _MoESwiGLU.apply(h, n_valid)


def moe_combine(ys: torch.Tensor, gates: torch.Tensor, pos: torch.Tensor,
                n_valid: torch.Tensor) -> torch.Tensor:
    """Each token's experts' outputs (rows of ``ys``) times its gates,
    added: (S, d) bf16, differentiable in ys and gates; plain versions on
    the CPU, kernels on GPUs."""
    return _MoECombine.apply(ys, gates, pos, n_valid)


# --- MLA's RoPE and q/k assembly ------------------------------------------------
#
# DeepSeek-V2-Lite's MLA (models/deepseek_v2.py::_mla) projects, per token,
# q_raw (B, T, H, nope + rope), kv (B, T, H, nope + v) and kv_a (B, T, r +
# rope): the latent's r columns, then one rope-wide key shared by the heads.
# The glue before attention: q = [q_raw's nope | RoPE(q_raw's rope)], k =
# [kv's nope | RoPE(kv_a's rope columns) on every head], v = kv's v half;
# cos, sin (T, rope) f32.  Extents come from the shapes: rope from cos, nope
# from q_raw, v from kv, r from kv_a.

#: csrc/mla_rope.cu's persistent grid: blocks on each SM
MLA_CTAS_PER_SM = 8
#: the backward's shared memory: two tokens' heads at the shared key's columns
MLA_MAX_KEY_BYTES = 48 * 1024


def _mla_widths(q_raw: torch.Tensor, kv: torch.Tensor, kv_a: torch.Tensor,
                cos: torch.Tensor) -> tuple:
    """(nope, rope, v, r)."""
    rope = cos.shape[-1]
    nope = q_raw.shape[-1] - rope
    return nope, rope, kv.shape[-1] - nope, kv_a.shape[-1] - rope


def mla_qk_rope_ref(q_raw: torch.Tensor, kv: torch.Tensor, kv_a: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor) -> tuple:
    """Plain version of the forward, and on CPU tensors the model's own
    path: ``(q, k, v)`` by the model's RoPE (``deepseek_v2._rope``, looked
    up at the call, so that a patch of it reaches this path), two cats and
    ``kv.split``, differentiable by autograd."""
    from tpudash_torch.models import deepseek_v2  # the model's RoPE; it imports this module

    B, T, H = q_raw.shape[:3]
    nope, rope, vd, r = _mla_widths(q_raw, kv, kv_a, cos)
    k_nope, v = kv.split([nope, vd], dim=-1)
    q_pe = deepseek_v2._rope(q_raw[..., nope:], cos[:, None], sin[:, None])
    k_pe = deepseek_v2._rope(kv_a[..., r:], cos, sin)
    q = torch.cat([q_raw[..., :nope], q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, T, H, rope)], dim=-1)
    return q, k, v


def _rope_t(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE's transpose, in the kernel's closed form: ``g`` (..., rope) at
    the regrouped positions, f32 products and sums rounded as autograd of
    ``deepseek_v2._rope`` rounds them, un-regrouped, rounded once to bf16."""
    m = g.shape[-1] // 2
    g = g.float()
    lo, hi = g[..., :m], g[..., m:]
    even = lo * cos[..., :m] + hi * sin[..., m:]
    odd = hi * cos[..., m:] - lo * sin[..., :m]
    return torch.stack([even, odd], dim=-1).flatten(-2).to(torch.bfloat16)


def mla_rope_grads_ref(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor, r: int) -> tuple:
    """Plain version of the backward, in the kernel's closed form: ``(dq_raw,
    dkv, dkv_a)`` for the gradients of :func:`mla_qk_rope_ref`'s q, k, v.
    The shared key's gradient adds the heads in f32 in head order and
    rounds to bf16 (where autograd's expand backward rounds), then takes
    RoPE's transpose; dkv_a's latent columns are zero."""
    B, T, H = dq.shape[:3]
    rope = cos.shape[-1]
    nope = dq.shape[-1] - rope
    key = dk[..., 0, nope:].float()
    for h in range(1, H):
        key = key + dk[..., h, nope:].float()
    dq_raw = torch.cat([dq[..., :nope], _rope_t(dq[..., nope:], cos[:, None], sin[:, None])], -1)
    dkv = torch.cat([dk[..., :nope], dv], dim=-1)
    dkv_a = torch.cat([dq.new_zeros((B, T, r)), _rope_t(key.to(torch.bfloat16), cos, sin)], -1)
    return dq_raw, dkv, dkv_a


def _check_mla_tables(cos: torch.Tensor, sin: torch.Tensor, T: int) -> None:
    rope = cos.shape[-1] if cos.dim() else 0
    if rope < 8 or rope % 8:
        raise ValueError(f"the MLA kernels take an even rope width that is a multiple of 8, got "
                         f"cos {tuple(cos.shape)}")
    for what, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (T, rope) or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous f32 ({T}, {rope}), got "
                             f"{tuple(t.shape)} {t.dtype}")


def _check_mla_rows(rows: dict, lead: tuple, widths: dict) -> None:
    """bf16 ``rows`` of shape lead + (width,), and ``widths`` multiples of 8
    (at least 8 but nope's and r's)."""
    for what, t in rows.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the MLA kernels take bf16 {what}, got {t.dtype}")
        if t.dim() != len(lead) + 1 or tuple(t.shape[:-1]) != lead:
            raise ValueError(f"{what} must be {lead} + (width,), got {tuple(t.shape)}")
    for what, w in widths.items():
        if w < (0 if what in ("nope", "r") else 8) or w % 8:
            raise ValueError(f"the MLA kernels take widths that are multiples of 8, got {what} {w}")


def _check_mla_device(tensors: dict) -> torch.device:
    """One CUDA device for all of ``tensors``, each 16-byte aligned."""
    dev = tensors[next(iter(tensors))].device
    if dev.type != "cuda":
        raise ValueError(f"the MLA kernels run on CUDA devices, not {dev}; mla_qk_rope_ref and "
                         "mla_rope_grads_ref are their plain versions")
    if any(t.device != dev for t in tensors.values()):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors.values()]}: one device")
    for what, t in tensors.items():
        _check_card_tensor(t, what)
    return dev


def _mla_grid(S: int, device: torch.device) -> int:
    return max(1, min(S, _sm_count(device.index) * MLA_CTAS_PER_SM))


def mla_rope_forward(q_raw: torch.Tensor, kv: torch.Tensor, kv_a: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor) -> tuple:
    """The forward kernel: :func:`mla_qk_rope_ref`'s q and k, new
    contiguous (B, T, H, nope + rope) bf16 tensors (v is kv's view)."""
    if q_raw.dim() != 4:
        raise ValueError(f"q_raw must be (B, T, H, nope + rope), got {tuple(q_raw.shape)}")
    B, T, H = q_raw.shape[:3]
    nope, rope, vd, r = _mla_widths(q_raw, kv, kv_a, cos)
    _check_mla_tables(cos, sin, T)
    _check_mla_rows({"q_raw": q_raw, "kv": kv}, (B, T, H), {"nope": nope, "v": vd})
    _check_mla_rows({"kv_a": kv_a}, (B, T), {"r": r})
    tensors = {"q_raw": q_raw, "kv": kv, "kv_a": kv_a, "cos": cos, "sin": sin}
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("the MLA forward takes contiguous q_raw, kv, kv_a, cos and sin")
    dev = _check_mla_device(tensors)
    q, k = torch.empty_like(q_raw), torch.empty_like(q_raw)
    S = B * T
    MLA_ROPE_FWD.launch(dev, q_raw.data_ptr(), kv.data_ptr(), kv_a.data_ptr(), cos.data_ptr(),
                        sin.data_ptr(), q.data_ptr(), k.data_ptr(), S, T, H, nope, rope, vd, r,
                        _mla_grid(S, dev))
    return q, k


def _row_strides(t: torch.Tensor, what: str) -> tuple:
    """(b, t, h) element strides of a (B, T, H, width) tensor whose rows
    are contiguous and start on 16 bytes."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"the MLA backward takes {what} with contiguous rows and (b, t, h) "
                         f"strides that are multiples of 8, got strides {t.stride()}")
    return t.stride()[:3]


def mla_rope_backward(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, r: int) -> tuple:
    """The backward kernel: :func:`mla_rope_grads_ref`'s ``(dq_raw, dkv,
    dkv_a)``, new contiguous bf16 tensors, from dq, dk and dv in whatever
    (b, t, h) strides they come, each row contiguous."""
    if dq.dim() != 4:
        raise ValueError(f"dq must be (B, T, H, nope + rope), got {tuple(dq.shape)}")
    B, T, H = dq.shape[:3]
    rope = cos.shape[-1] if cos.dim() else 0
    nope, vd = dq.shape[-1] - rope, dv.shape[-1]
    _check_mla_tables(cos, sin, T)
    _check_mla_rows({"dq": dq, "dk": dk, "dv": dv}, (B, T, H), {"nope": nope, "v": vd, "r": r})
    if dk.shape != dq.shape:
        raise ValueError(f"dk must have dq's shape {tuple(dq.shape)}, got {tuple(dk.shape)}")
    if 4 * H * rope > MLA_MAX_KEY_BYTES:  # two tokens' H · rope bf16 values
        raise ValueError(f"the MLA backward parks two tokens' {H} heads of the shared key in "
                         f"{MLA_MAX_KEY_BYTES} bytes of shared memory: H · rope must be at most "
                         f"{MLA_MAX_KEY_BYTES // 4}, got {H} · {rope}")
    strides = [*_row_strides(dq, "dq"), *_row_strides(dk, "dk"), *_row_strides(dv, "dv")]
    dev = _check_mla_device({"dq": dq, "dk": dk, "dv": dv, "cos": cos, "sin": sin})
    dq_raw = torch.empty((B, T, H, nope + rope), dtype=dq.dtype, device=dev)
    dkv = torch.empty((B, T, H, nope + vd), dtype=dq.dtype, device=dev)
    dkv_a = torch.empty((B, T, r + rope), dtype=dq.dtype, device=dev)
    S = B * T
    MLA_ROPE_BWD.launch(dev, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), cos.data_ptr(),
                        sin.data_ptr(), dq_raw.data_ptr(), dkv.data_ptr(), dkv_a.data_ptr(),
                        *strides, S, T, H, nope, rope, vd, r, _mla_grid(S, dev))
    return dq_raw, dkv, dkv_a


class _MLAQKRope(torch.autograd.Function):
    """The glue as one function, each direction a kernel on GPUs (the plain
    forward and the closed-form backward on CPU tensors).  RoPE is linear:
    it saves cos and sin only; v is kv's view, so that kv's gradient is
    written once, [dk's nope | dv]."""

    @staticmethod
    def forward(ctx, q_raw, kv, kv_a, cos, sin):
        ctx.save_for_backward(cos, sin)
        ctx.latent = kv_a.shape[-1] - cos.shape[-1]
        if _on_cpu(q_raw):
            return mla_qk_rope_ref(q_raw, kv, kv_a, cos, sin)
        q, k = mla_rope_forward(q_raw, kv, kv_a, cos, sin)
        return q, k, kv[..., q_raw.shape[-1] - cos.shape[-1]:]

    @staticmethod
    def backward(ctx, dq, dk, dv):
        cos, sin = ctx.saved_tensors
        grad = mla_rope_grads_ref if _on_cpu(dq) else mla_rope_backward
        return (*grad(dq, dk, dv, cos, sin, ctx.latent), None, None)


def mla_qk_rope(q_raw: torch.Tensor, kv: torch.Tensor, kv_a: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> tuple:
    """MLA's ``(q, k, v)`` (B, T, H, ·) from its projections, differentiable
    in q_raw, kv and kv_a: on CUDA tensors the two kernels (raising on what
    they do not take); on CPU tensors :func:`mla_qk_rope_ref` itself under
    autograd, so that the CPU path is the model's chain, a patch of its
    RoPE included."""
    if _on_cpu(q_raw):
        return mla_qk_rope_ref(q_raw, kv, kv_a, cos, sin)
    return _MLAQKRope.apply(q_raw, kv, kv_a, cos, sin)


# --- Kimi Delta Attention, chunked -------------------------------------------------
#
# The gated delta rule of a KDA layer (models/kimi_linear.py), per head with
# S₀ = 0:  S′ₜ = Diag(αₜ)·Sₜ₋₁,  Sₜ = S′ₜ + βₜ kₜ (vₜ − S′ₜᵀkₜ)ᵀ,  oₜ = scale·Sₜᵀqₜ,
# αₜ = exp(gₜ) per key channel.  By chunks of C positions (the WY form of
# Gated DeltaNet with a decay per channel), with G the cumulative sum of g
# inside the chunk, every exponent a difference G_t − G_s with s ≤ t (or
# G_C − G_s, or G_t alone), never positive:
#
#   Akk[t, s] = Σ_c k_t k_s e^{G_t − G_s}  (s < t),  Aqk[t, s] = Σ_c q_t k_s e^{G_t − G_s}  (s ≤ t)
#   (I + β·Akk)·[w | u] = [β e^{G} k | β v]                 (unit lower triangular)
#   v_new = u − w·S_n,  o = scale·(q e^{G}·S_n + Aqk·v_new)
#   S_{n+1} = e^{G_C}·S_n + (k e^{G_C − G})ᵀ·v_new
#
# Chunked tensors are (B, H, N, C, D) f32, contiguous.  The pair blocks
# (:func:`kda_pairs`) and the state pass (:func:`kda_state`) are the two
# autograd functions with a kernel each way on GPUs; the rest of the
# algorithm is batched PyTorch over every chunk at once (:func:`kda_chunk`).

#: the chunk the KDA kernels take, and the head width (keys and values)
KDA_CHUNK = 64
KDA_HEAD_DIM = 128


def _pair_decays(G: torch.Tensor) -> torch.Tensor:
    """``e^{G_t − G_s}`` (..., t, s, c) for s ≤ t, 0 above the diagonal:
    the exponent is masked before it is taken, so no positive one is."""
    C = G.shape[-2]
    diff = G[..., :, None, :] - G[..., None, :, :]
    lower = torch.ones(C, C, dtype=torch.bool, device=G.device).tril()[:, :, None]
    return torch.where(lower, diff, torch.full_like(diff, float("-inf"))).exp()


def kda_pairs_ref(q: torch.Tensor, k: torch.Tensor, G: torch.Tensor) -> tuple:
    """Plain version of the pair blocks: ``(akk, aqk)`` (B, H, N, C, C) f32,
    ``akk[t, s] = Σ_c k_t k_s e^{G_t − G_s}`` below the diagonal and ``aqk[t,
    s] = Σ_c q_t k_s e^{G_t − G_s}`` on and below it, zeros elsewhere."""
    E = _pair_decays(G)
    C = G.shape[-2]
    strict = torch.ones(C, C, dtype=torch.bool, device=G.device).tril(-1)
    ks = k[..., None, :, :] * E  # k_s e^{G_t − G_s}, (..., t, s, c)
    akk = (k[..., :, None, :] * ks).sum(-1) * strict
    aqk = (q[..., :, None, :] * ks).sum(-1)
    return akk, aqk


def kda_pairs_grads_ref(q: torch.Tensor, k: torch.Tensor, G: torch.Tensor,
                        dakk: torch.Tensor, daqk: torch.Tensor) -> tuple:
    """Plain version of the pair blocks' backward, in the kernel's closed
    form: ``(dq, dk, dG)``.  Only dakk's strict lower triangle and daqk's
    lower triangle are read.  Per channel, with a = dakk, b = daqk and E the
    pair decays: R1 = (a∘E)·k, R2 = (b∘E)·k, Col = (a∘E)ᵀ·k + (b∘E)ᵀ·q;
    dq = R2, dk = R1 + Col, dG = k·R1 + q·R2 − k·Col."""
    C = G.shape[-2]
    a = dakk * torch.ones(C, C, dtype=torch.bool, device=G.device).tril(-1)
    b = daqk * torch.ones(C, C, dtype=torch.bool, device=G.device).tril()
    E = _pair_decays(G)
    aE, bE = a[..., None] * E, b[..., None] * E  # (..., t, s, c)
    r1 = (aE * k[..., None, :, :]).sum(-2)
    r2 = (bE * k[..., None, :, :]).sum(-2)
    col = (aE * k[..., :, None, :] + bE * q[..., :, None, :]).sum(-3)
    return r2, r1 + col, k * r1 + q * r2 - k * col


def kda_state_ref(w: torch.Tensor, u: torch.Tensor, kd: torch.Tensor,
                  gamma: torch.Tensor) -> tuple:
    """Plain version of the state pass: ``(states (B, H, N + 1, Dk, Dv),
    v_new (B, H, N, C, Dv))``, a loop over the chunks: states[n] = S_n (S₀ =
    0), v_new[n] = u_n − w_n·S_n, S_{n+1} = gamma_n·S_n + kd_nᵀ·v_new_n."""
    B, H, N, C, Dk = w.shape
    S = w.new_zeros(B, H, Dk, u.shape[-1])
    states, v_new = [S], []
    for n in range(N):
        x = u[:, :, n] - torch.matmul(w[:, :, n], S)
        S = gamma[:, :, n, :, None] * S + torch.matmul(kd[:, :, n].transpose(-1, -2), x)
        states.append(S)
        v_new.append(x)
    return torch.stack(states, 2), torch.stack(v_new, 2)


def kda_state_reverse_ref(w: torch.Tensor, kd: torch.Tensor, gamma: torch.Tensor,
                          gS: torch.Tensor, gv: torch.Tensor) -> tuple:
    """Plain version of the backward kernel's reverse pass, for the
    gradients ``gS`` (B, H, N + 1, Dk, Dv) of the states and ``gv`` of
    v_new from outside: ``(dnext (B, H, N, Dk, Dv), dv (B, H, N, C, Dv))``,
    dnext[n] the whole gradient of S_{n+1} and dv[n] that of v_new_n:
    from D = gS[N] down, dv_n = gv_n + kd_n·D, dnext[n] = D, D = gamma_n·D +
    gS[n] − w_nᵀ·dv_n."""
    N = w.shape[2]
    D = gS[:, :, N]
    dnext, dv = [None] * N, [None] * N
    for n in range(N - 1, -1, -1):
        x = gv[:, :, n] + torch.matmul(kd[:, :, n], D)
        dnext[n], dv[n] = D, x
        D = gamma[:, :, n, :, None] * D + gS[:, :, n] - torch.matmul(w[:, :, n].transpose(-1, -2), x)
    return torch.stack(dnext, 2), torch.stack(dv, 2)


def kda_state_grads(states: torch.Tensor, v_new: torch.Tensor, dnext: torch.Tensor,
                    dv: torch.Tensor) -> tuple:
    """The state pass's input gradients ``(dw, du, dkd, dgamma)`` from the
    reverse pass's ``dnext`` and ``dv``, batched over every chunk: du = dv,
    dw = −dv·S_nᵀ, dkd = v_new·dnextᵀ, dgamma = Σ_j S_n ∘ dnext."""
    S = states[:, :, :-1]
    dw = -torch.matmul(dv, S.transpose(-1, -2))
    dkd = torch.matmul(v_new, dnext.transpose(-1, -2))
    return dw, dv, dkd, (S * dnext).sum(-1)


def _check_kda(tensors: dict) -> torch.device:
    """``tensors``: name → (tensor, the shape it must have); each contiguous
    f32 on one CUDA device, 16-byte aligned."""
    dev = next(iter(tensors.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"the KDA kernels run on CUDA devices, not {dev}; kda_pairs_ref and "
                         "kda_state_ref are their plain versions")
    for what, (t, shape) in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"the KDA kernels take contiguous f32 tensors on {dev}, got {what} "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} must be {tuple(shape)} (chunk {KDA_CHUNK}, head width "
                             f"{KDA_HEAD_DIM}), got {tuple(t.shape)}")
        _check_card_tensor(t, what)
    return dev


def _kda_lead(x: torch.Tensor) -> tuple:
    if x.dim() != 5 or x.shape[0] * x.shape[1] * x.shape[2] >= 2**31:
        raise ValueError(f"the KDA kernels take (B, H, N, C, D) tensors with fewer than 2**31 "
                         f"chunks, got {tuple(x.shape)}")
    return tuple(x.shape[:3])


def kda_pairs_forward(q: torch.Tensor, k: torch.Tensor, G: torch.Tensor) -> tuple:
    """The pair blocks' kernel: :func:`kda_pairs_ref` as new tensors."""
    B, H, N = _kda_lead(q)
    rows = (B, H, N, KDA_CHUNK, KDA_HEAD_DIM)
    dev = _check_kda({"q": (q, rows), "k": (k, rows), "G": (G, rows)})
    akk = torch.empty((B, H, N, KDA_CHUNK, KDA_CHUNK), dtype=torch.float32, device=dev)
    aqk = torch.empty_like(akk)
    KDA_PAIRS_FWD.launch(dev, q.data_ptr(), k.data_ptr(), G.data_ptr(), akk.data_ptr(),
                         aqk.data_ptr(), B * H * N)
    return akk, aqk


def kda_pairs_backward(q: torch.Tensor, k: torch.Tensor, G: torch.Tensor, dakk: torch.Tensor,
                       daqk: torch.Tensor) -> tuple:
    """The pair blocks' backward kernel: :func:`kda_pairs_grads_ref` as new
    tensors."""
    B, H, N = _kda_lead(q)
    rows = (B, H, N, KDA_CHUNK, KDA_HEAD_DIM)
    pairs = (B, H, N, KDA_CHUNK, KDA_CHUNK)
    dev = _check_kda({"q": (q, rows), "k": (k, rows), "G": (G, rows), "dakk": (dakk, pairs),
                      "daqk": (daqk, pairs)})
    dq, dk, dG = torch.empty_like(q), torch.empty_like(k), torch.empty_like(G)
    KDA_PAIRS_BWD.launch(dev, q.data_ptr(), k.data_ptr(), G.data_ptr(), dakk.data_ptr(),
                         daqk.data_ptr(), dq.data_ptr(), dk.data_ptr(), dG.data_ptr(), B * H * N)
    return dq, dk, dG


def kda_state_forward(w: torch.Tensor, u: torch.Tensor, kd: torch.Tensor,
                      gamma: torch.Tensor) -> tuple:
    """The state pass's kernel: :func:`kda_state_ref` as new tensors."""
    B, H, N = _kda_lead(w)
    C, D = KDA_CHUNK, KDA_HEAD_DIM
    rows = (B, H, N, C, D)
    dev = _check_kda({"w": (w, rows), "u": (u, rows), "kd": (kd, rows),
                      "gamma": (gamma, (B, H, N, D))})
    states = torch.empty((B, H, N + 1, D, D), dtype=torch.float32, device=dev)
    v_new = torch.empty_like(u)
    KDA_STATE_FWD.launch(dev, w.data_ptr(), u.data_ptr(), kd.data_ptr(), gamma.data_ptr(),
                         states.data_ptr(), v_new.data_ptr(), B * H, N)
    return states, v_new


def kda_state_backward(w: torch.Tensor, kd: torch.Tensor, gamma: torch.Tensor, gS: torch.Tensor,
                       gv: torch.Tensor) -> tuple:
    """The state pass's backward kernel: :func:`kda_state_reverse_ref` as new
    tensors."""
    B, H, N = _kda_lead(w)
    C, D = KDA_CHUNK, KDA_HEAD_DIM
    rows = (B, H, N, C, D)
    dev = _check_kda({"w": (w, rows), "kd": (kd, rows), "gamma": (gamma, (B, H, N, D)),
                      "gS": (gS, (B, H, N + 1, D, D)), "gv": (gv, rows)})
    dnext = torch.empty((B, H, N, D, D), dtype=torch.float32, device=dev)
    dv = torch.empty_like(gv)
    KDA_STATE_BWD.launch(dev, w.data_ptr(), kd.data_ptr(), gamma.data_ptr(), gS.data_ptr(),
                         gv.data_ptr(), dnext.data_ptr(), dv.data_ptr(), B * H, N)
    return dnext, dv


class _KDAPairs(torch.autograd.Function):
    """The pair blocks, each direction a kernel on GPUs (the plain forward
    and the closed-form backward on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, G):
        ctx.save_for_backward(q, k, G)
        return (kda_pairs_ref if _on_cpu(q) else kda_pairs_forward)(q, k, G)

    @staticmethod
    def backward(ctx, dakk, daqk):
        q, k, G = ctx.saved_tensors
        grad = kda_pairs_grads_ref if _on_cpu(q) else kda_pairs_backward
        return grad(q, k, G, dakk.contiguous(), daqk.contiguous())


class _KDAState(torch.autograd.Function):
    """The state pass, each direction a kernel on GPUs (the plain loops on
    CPU tensors); the backward's batched products in PyTorch.  It saves the
    states and v_new: the backward reads S_n for dw and dgamma."""

    @staticmethod
    def forward(ctx, w, u, kd, gamma):
        states, v_new = (kda_state_ref if _on_cpu(w) else kda_state_forward)(w, u, kd, gamma)
        ctx.save_for_backward(w, kd, gamma, states, v_new)
        return states, v_new

    @staticmethod
    def backward(ctx, gS, gv):
        w, kd, gamma, states, v_new = ctx.saved_tensors
        reverse = kda_state_reverse_ref if _on_cpu(w) else kda_state_backward
        dnext, dv = reverse(w, kd, gamma, gS.contiguous(), gv.contiguous())
        return kda_state_grads(states, v_new, dnext, dv)


def kda_pairs(q: torch.Tensor, k: torch.Tensor, G: torch.Tensor) -> tuple:
    """``(akk, aqk)`` of chunked q, k and cumulative log-decays G,
    differentiable in all three: kernels on GPUs, plain versions on the CPU."""
    return _KDAPairs.apply(q, k, G)


def kda_state(w: torch.Tensor, u: torch.Tensor, kd: torch.Tensor, gamma: torch.Tensor) -> tuple:
    """``(states, v_new)`` of the state pass, differentiable in its inputs:
    kernels on GPUs, plain loops on the CPU."""
    return _KDAState.apply(w, u, kd, gamma)


def _chunked(x: torch.Tensor, N: int, C: int) -> torch.Tensor:
    """(B, T, H, ...) → (B, H, N, C, ...) contiguous, zeros past T: one copy
    (the padding of the head-major view)."""
    B, T, H = x.shape[:3]
    rest = tuple(x.shape[3:])
    x = x.movedim(2, 1)  # (B, H, T, ...), a view
    pad = [0, 0] * len(rest) + [0, N * C - T]
    return F.pad(x, pad).contiguous().view(B, H, N, C, *rest)


def kda_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
              beta: torch.Tensor, scale: float) -> tuple:
    """The gated delta rule by chunks: ``(o (B, T, H, Dv), final state (B,
    H, Dk, Dv))``, f32, from q and k (L2-normed), v, the log-decays g (B, T,
    H, Dk) and the step sizes beta (B, T, H), all f32.  T is padded with
    zeros to whole chunks (a zero β, k and g leave the state as it is).  On
    GPUs the pair blocks and the state pass are kernels (chunk and widths
    :data:`KDA_CHUNK`, :data:`KDA_HEAD_DIM`); everything else is products
    and elementwise passes over every chunk at once, with no loop over
    chunks.  On the CPU the same chain runs their plain versions."""
    B, T, H, Dk = k.shape
    Dv = v.shape[-1]
    C = KDA_CHUNK
    N = -(-T // C)
    q, k, v, g = (_chunked(x, N, C) for x in (q, k, v, g))
    beta = _chunked(beta, N, C)[..., None]
    G = g.cumsum(-2)
    akk, aqk = kda_pairs(q, k, G)
    decay = G.exp()
    rhs = torch.cat([k * decay * beta, v * beta], -1)
    wu = torch.linalg.solve_triangular(akk * beta, rhs, upper=False, unitriangular=True)
    w, u = wu.split([Dk, Dv], -1)
    last = G[..., -1, :]
    kd = k * (last[..., None, :] - G).exp()
    states, v_new = kda_state(w.contiguous(), u.contiguous(), kd, last.exp().contiguous())
    o = torch.matmul(q * decay, states[:, :, :N]) + torch.matmul(aqk, v_new)
    o = (o * scale).movedim(1, 3).reshape(B, N * C, H, Dv)[:, :T]
    return o, states[:, :, N]
