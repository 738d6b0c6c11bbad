#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpudash_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a host with one H100:

1. prints the card (nvidia-smi name and power limit, torch's device name);
2. builds the probe kernels from tpudash_torch/ops/csrc (one nvcc per
   source, started together) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card, the
   copy kernel exactly at the edges of its launch plan;
4. drives the exporter's main path: TorchProbeSource at the exporter's
   default sizes, then the exporter app serving /metrics and /healthz;
5. drives the probe bench's path: the matmul, read and copy probes at the
   probe bench's arguments;
6. times each kernel at the main path's shapes beside its bound, its plain
   version and one PyTorch call computing the same function, and the host
   time of one wrapper call;
7. prints a {"kernels": [...]} line, and last
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Launch counts are reset just before each path and read just after it.  Any
failed check raises: the script then exits non-zero and prints no result.
It refuses to run without a GPU, and outside a checkout.
"""

from __future__ import annotations

import asyncio
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
#: dense f32 rate outside the tensor cores, TFLOP/s (NVIDIA datasheet), for
#: the operations side of a kernel's bound
F32_PEAK_TFLOPS = {"h100-sxm": 67.0, "h100-pcie": 51.0}
#: a measured bandwidth above this share of the datasheet peak means the
#: traffic hit L2 or work was skipped
MAX_SHARE_OF_PEAK = 1.05
F32_U = 2.0**-24
BF16_U = 2.0**-9


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi printed nothing"


def cuda_ms(fns: dict, n: int = 100, reps: int = 7) -> dict:
    """Median ms per call of each function, by CUDA events around ``n``
    calls; the functions take turns, in reversed order every other round.
    ``n`` is long enough that the ramp at a window's start stays small."""
    import torch

    names = list(fns)
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    times: dict = {name: [] for name in names}
    for rep in range(reps):
        for name in names if rep % 2 == 0 else reversed(names):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / n)
    return {name: statistics.median(t) for name, t in times.items()}


def device_ms(fn, n: int = 20) -> "float | None":
    """Device time per call from torch.profiler: the sum of the CUDA
    kernels and copies ``fn`` ran, without the host's launch gaps between
    them; None when the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    )
    return total_us / n / 1e3 if total_us > 0 else None


def host_us(fn, n: int = 200, reps: int = 5) -> float:
    """Median host µs per call of ``fn`` while the card works through the
    queue: ``n`` calls stay far below the launch queue's depth, so the host
    clock measures the wrapper and the enqueue, not the kernel."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def copy_edge_sizes(plan) -> list[tuple[int, str]]:
    """f32 counts, each with its label, at the edges of the cut that the
    copy kernel's ``plan`` (for a large buffer) makes."""
    t = plan.tile_bytes // 4
    return [
        (t, "one tile"), (t + 4, "one tile + 4 floats"), (t - 100, "less than one tile"),
        (3 * t + 1, "n % 4 == 1"), (3 * t + 2, "n % 4 == 2"), (3 * t + 3, "n % 4 == 3"),
        (1, "one float"), (3, "floats only"),
        ((3 * plan.grid + 7) * t, "whole tiles, not whole rounds of the grid"),
    ]


def main() -> int:
    if not (ROOT / "tpudash_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: no tpudash_torch/ beside {__file__}: run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpudash_torch.config import Config
    from tpudash_torch.exporter.server import WARMUP_TASK, make_app
    from tpudash_torch.ops import kernels, probes
    from tpudash_torch.registry import DEFAULT_GENERATION, resolve_generation_from_device_name
    from tpudash_torch.schema import HBM_BANDWIDTH, HBM_TOTAL, HBM_USED, TENSORCORE_UTIL
    from tpudash_torch.sources.probe import TorchProbeSource

    t_start = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    gen = resolve_generation_from_device_name(kind) or DEFAULT_GENERATION
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: {kind}; "
          f"record {gen.name}: {gen.hbm_gbps} GB/s, {gen.peak_bf16_tflops} TFLOP/s bf16 (datasheet)")

    # -- 2. build --------------------------------------------------------------
    build_s = kernels.build_kernels()
    print(f"build: {build_s:.2f} s for {len(kernels.KERNELS)} kernels (parallel nvcc, sm_90a)")
    for k in kernels.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}")

    # -- 3. each kernel against its plain version on the card -------------------
    gen_rng = torch.Generator(device=dev).manual_seed(SEED)
    x_full, block_rows = probes._hbm_buffer(256, 128, 8192, dev)  # the main path's buffer
    rows, cols = x_full.shape

    def read_check(shape, br, label):
        x = torch.randn(shape, generator=gen_rng, device=dev)
        prev = torch.randn((1, shape[1]), generator=gen_rng, device=dev)
        got = kernels.hbm_read_pass(x, prev, br)
        want = kernels.hbm_read_pass_ref(x, prev)
        torch.cuda.synchronize()
        # the kernel adds each column in a fixed order of depth
        # br + ceil(rows/br) + 1, so it lies within depth·u·mass of the exact
        # sum (mass = |prev| + Σ|x|); torch's reduction is shallower.  Twice
        # the kernel's bound covers both.
        depth = br + -(-shape[0] // br) + 1
        mass = prev.abs() + x.abs().sum(0, keepdim=True)
        err = (got - want).abs()
        tol = 2 * depth * F32_U * mass
        check(bool(torch.isfinite(got).all()), f"hbm_read {label}: non-finite output")
        check(bool((err <= tol).all()),
              f"hbm_read {label}: max err {err.max().item():.3e} above its tolerance")
        print(f"hbm_read vs plain, {label} {tuple(shape)} block_rows={br}: "
              f"max_abs_err {err.max().item():.3e}, max err/tol {(err / tol).max().item():.3f}")
        return err.max().item()

    read_err = read_check((rows, cols), block_rows, "random, main shape")
    read_check((1000, 4100), 128, "random, ragged rows and column tile")
    read_check((5, 12), 128, "random, rows below one chunk")
    prev5 = torch.full((1, cols), 5.0, device=dev)
    ones_out = kernels.hbm_read_pass(x_full, prev5, block_rows)
    check(torch.equal(ones_out, kernels.hbm_read_pass_ref(x_full, prev5)), "hbm_read ones: not exact")
    check(bool((ones_out == rows + 5.0).all()), "hbm_read ones: wrong value")
    loop = probes._hbm_read_loop(x_full, block_rows, 44).item()
    check(loop == 8.0 * rows * 44, f"hbm_read loop on ones: {loop} != {8.0 * rows * 44}")
    print(f"hbm_read vs plain, ones {tuple(x_full.shape)}: exact; 44-pass loop = {loop} exact")

    sms = kernels._sm_count(dev.index)
    plan = kernels._copy_plan(rows * cols, sms)
    print(f"hbm_copy plan at {rows}x{cols} on {sms} SMs: grid {plan.grid} "
          f"({kernels.COPY_CTAS_PER_SM} CTAs per SM), {plan.stages} stages x {plan.tile_bytes} B "
          f"tiles = {plan.smem_bytes} B dynamic shared memory per CTA, {plan.n_tiles} tiles, "
          f"tail {plan.tail_bytes} B + {plan.tail_floats} floats")
    copy_shapes = [((rows, cols), "main shape"), ((999, 4101), "ragged")]
    copy_shapes += [((m,), label) for m, label in copy_edge_sizes(plan)]
    for shape, label in copy_shapes:
        x = torch.randn(shape, generator=gen_rng, device=dev)
        n = x.numel()
        # the destination lies at the start of a larger buffer, whose bytes
        # past n must come through untouched
        guard = torch.full((n + 64,), -7.0, device=dev)
        got = kernels.hbm_copy(x, guard[:n].view(shape))
        check(torch.equal(got, kernels.copy_ref(x)), f"hbm_copy {label} {shape}: not exact")
        check(bool((guard[n:] == -7.0).all()), f"hbm_copy {label} {shape}: wrote past its end")
        p = kernels._copy_plan(n, sms)
        print(f"hbm_copy vs plain, random {shape} ({label}; grid {p.grid}, {p.n_tiles} tiles, "
              f"tail {p.tail_bytes} B + {p.tail_floats} floats): exact, nothing written past n")
    check(probes._hbm_copy_loop(x_full, 5).item() == 8.0, "hbm_copy loop on ones != 8")
    torch.cuda.synchronize()
    print("hbm_copy 5-pass loop on ones = 8.0")
    # the C entry owns the ring's limit: a ring past a block's shared memory
    # is refused before launch, and the wrapper's path raises
    too_big = plan._replace(stages=8, tile_bytes=32 * 1024)
    try:
        kernels.HBM_COPY.launch(dev, x_full.data_ptr(), torch.empty_like(x_full).data_ptr(),
                                *too_big)
    except RuntimeError as e:
        print(f"hbm_copy ring of {too_big.smem_bytes} B: refused ({e})")
    else:
        raise SmokeFailure(f"hbm_copy launched a ring of {too_big.smem_bytes} B")

    # the matmul chain (torch.matmul, no hand kernel) against float64 on the host
    size, iters = 256, 2
    xm = torch.randn((size, size), generator=gen_rng, device=dev).bfloat16()
    wm = (torch.randn((size, size), generator=gen_rng, device=dev) * size**-0.5).bfloat16()
    got_mm = probes._matmul_chain_sum(xm, wm, iters).item()
    chain = xm.double().cpu()
    for _ in range(iters):
        chain = chain @ wm.double().cpu()
    tol_mm = 4 * 2 * BF16_U * iters * chain.norm().item()
    check(abs(got_mm - chain.sum().item()) <= tol_mm,
          f"matmul chain: {got_mm} vs {chain.sum().item()} (tol {tol_mm})")
    print(f"matmul chain vs float64 on the host: {got_mm:.4f} vs {chain.sum().item():.4f}, "
          f"tol {tol_mm:.3f}")
    del xm, wm, chain

    # -- 4. the exporter's main path --------------------------------------------
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    src = TorchProbeSource(Config(source="probe"))
    n_dev = len(src._devices())
    samples = src.fetch()
    fetch_s = time.perf_counter() - t0
    per_batch = (src.hbm_k1 + src.hbm_k2) * 6  # warm + 5 pairs of (k1, k2) loops
    check(kernels.HBM_READ.launches == per_batch * n_dev,
          f"read launches {kernels.HBM_READ.launches} != {per_batch * n_dev}")
    chip0 = {s.metric: s.value for s in samples if s.chip.chip_id == 0}
    check(set(chip0) == {TENSORCORE_UTIL, HBM_USED, HBM_TOTAL, HBM_BANDWIDTH},
          f"series for device 0: {sorted(chip0)}")
    check(all(math.isfinite(v) for v in chip0.values()), f"non-finite sample: {chip0}")
    check(0.0 < chip0[TENSORCORE_UTIL] <= 100.0, f"util {chip0[TENSORCORE_UTIL]}")
    total = torch.cuda.get_device_properties(dev).total_memory
    check(chip0[HBM_TOTAL] == total, f"HBM total {chip0[HBM_TOTAL]} != {total}")
    check(0.0 < chip0[HBM_BANDWIDTH] <= MAX_SHARE_OF_PEAK * gen.hbm_gbps,
          f"read bandwidth {chip0[HBM_BANDWIDTH]} GB/s vs peak {gen.hbm_gbps}")
    print(f"main path: TorchProbeSource.fetch at the exporter defaults "
          f"(matmul {src.matmul_size}/{src.matmul_iters}, {src.hbm_mb} MiB, k1={src.hbm_k1} "
          f"k2={src.hbm_k2}) in {fetch_s:.2f} s; read launches {kernels.HBM_READ.launches} "
          f"= {per_batch} per device")
    print(f"  device 0 [{card}]: util {chip0[TENSORCORE_UTIL]:.4f} % "
          f"({chip0[TENSORCORE_UTIL] * gen.peak_bf16_tflops / 100:.2f} TFLOP/s), "
          f"read {chip0[HBM_BANDWIDTH]:.2f} GB/s "
          f"({100 * chip0[HBM_BANDWIDTH] / gen.hbm_gbps:.2f} % of peak), "
          f"used {chip0[HBM_USED]:.0f} B, total {chip0[HBM_TOTAL]:.0f} B")

    async def serve() -> tuple[str, dict]:
        from aiohttp.test_utils import TestClient, TestServer

        client = TestClient(TestServer(make_app()))
        await client.start_server()
        try:
            await client.app[WARMUP_TASK]
            resp = await client.get("/metrics")
            check(resp.status == 200, f"/metrics status {resp.status}")
            text = await resp.text()
            health = await (await client.get("/healthz")).json()
        finally:
            await client.close()
        return text, health

    text, health = asyncio.run(serve())
    for series in (TENSORCORE_UTIL, HBM_USED, HBM_TOTAL, HBM_BANDWIDTH):
        lines = [ln for ln in text.splitlines() if ln.startswith(series + "{")]
        check(len(lines) == n_dev, f"/metrics: {len(lines)} lines of {series}")
        check(all(math.isfinite(float(ln.rsplit(" ", 1)[1])) for ln in lines),
              f"/metrics: non-finite {series}")
    check(health == {"ok": True, "source": "probe", "error": None}, f"/healthz {health}")
    main_counts = kernels.launch_counts()
    check(main_counts["hbm_read"] == 2 * per_batch * n_dev,
          f"main path read launches {main_counts['hbm_read']}")
    print(f"main path: exporter app served /metrics (200, {len(text.splitlines())} lines) "
          f"and /healthz {health}; launches over the path {main_counts}")

    # -- 5. the probe bench's path ----------------------------------------------
    kernels.reset_launch_counts()
    mm = probes.matmul_flops_probe(size=4096, iters=64, device=dev)
    hbm = probes.hbm_bandwidth_probe(mb=256, k1=10, k2=410, device=dev)
    cp = probes.hbm_copy_probe(mb=256, k1=5, k2=205, device=dev)
    bench_counts = kernels.launch_counts()
    check(hbm.detail["backend"] == cp.detail["backend"] == "cuda", "bench ran off the card")
    check(0 < mm.value <= MAX_SHARE_OF_PEAK * gen.peak_bf16_tflops, f"matmul {mm.value}")
    for label, r in (("read", hbm), ("copy", cp)):
        check(0 < r.value <= MAX_SHARE_OF_PEAK * gen.hbm_gbps,
              f"{label} bandwidth {r.value} GB/s vs peak {gen.hbm_gbps}")
    check(bench_counts == {"hbm_read": (10 + 410) * 6, "hbm_copy": (5 + 205) * 6},
          f"bench launches {bench_counts}")
    print(f"probe bench path [{card}]: matmul 4096/64 {mm.value:.2f} TFLOP/s "
          f"({100 * mm.value / gen.peak_bf16_tflops:.2f} % of peak); read 256 MiB k1=10 k2=410 "
          f"{hbm.value:.2f} GB/s ({100 * hbm.value / gen.hbm_gbps:.2f} %); copy 256 MiB "
          f"k1=5 k2=205 {cp.value:.2f} GB/s ({100 * cp.value / gen.hbm_gbps:.2f} %); "
          f"launches {bench_counts}")

    # -- 6. per-kernel times at the main path's shapes ---------------------------
    x = torch.randn((rows, cols), generator=gen_rng, device=dev)
    prev = torch.randn((1, cols), generator=gen_rng, device=dev)
    scratch = kernels.hbm_read_scratch(x, block_rows)
    dst = torch.empty_like(x)
    read_fns = {
        "kernel": lambda: kernels.hbm_read_pass(x, prev, block_rows, scratch),
        "plain": lambda: kernels.hbm_read_pass_ref(x, prev),
        "library": lambda: x.sum(0, keepdim=True),
    }
    copy_fns = {
        "kernel": lambda: kernels.hbm_copy(x, dst),
        "plain": lambda: kernels.copy_ref(x),
        "library": lambda: dst.copy_(x),
    }
    read_t, copy_t = cuda_ms(read_fns), cuda_ms(copy_fns)
    read_dev = {name: device_ms(fn) for name, fn in read_fns.items()}
    copy_dev = {name: device_ms(fn) for name, fn in copy_fns.items()}
    read_host = {name: host_us(read_fns[name]) for name in ("kernel", "library")}
    copy_host = {name: host_us(copy_fns[name]) for name in ("kernel", "library")}
    f32_peak = F32_PEAK_TFLOPS[gen.name]

    def bound(nbytes: int, ops: int) -> tuple[float, str]:
        t_bytes = nbytes / (gen.hbm_gbps * 1e9) * 1e3
        t_ops = ops / (f32_peak * 1e12) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    read_bound, read_by = bound((rows * cols + 2 * cols) * 4, rows * cols)
    copy_bound, copy_by = bound(2 * rows * cols * 4, 0)
    entries = [
        {"name": "hbm_read", "route": "cuda", "source": "tpudash_torch/ops/csrc/hbm_read.cu",
         "replaces": "tpudash/ops/probes.py:160", "launches": main_counts["hbm_read"],
         "max_abs_err": read_err, "ms": read_t["kernel"], "plain_ms": read_t["plain"],
         "bound_ms": read_bound, "bound_by": read_by, "library_ms": read_t["library"],
         "device_ms": read_dev, "host_us": read_host, "path": "exporter main path"},
        {"name": "hbm_copy", "route": "cuda", "source": "tpudash_torch/ops/csrc/hbm_copy.cu",
         "replaces": "tpudash/ops/probes.py:196", "launches": bench_counts["hbm_copy"],
         "max_abs_err": 0.0, "ms": copy_t["kernel"], "plain_ms": copy_t["plain"],
         "bound_ms": copy_bound, "bound_by": copy_by, "library_ms": copy_t["library"],
         "device_ms": copy_dev, "host_us": copy_host, "path": "probe bench path"},
    ]
    def us(v):
        return "not measured" if v is None else f"{v * 1e3:.2f} us"

    for e in entries:
        dev_t = e["device_ms"]
        print(f"{e['name']} at {rows}x{cols} f32 [{card}]: {e['ms'] * 1e3:.2f} us per pass, "
              f"bound {e['bound_ms'] * 1e3:.2f} us ({e['bound_by']}, "
              f"{100 * e['bound_ms'] / e['ms']:.2f} % of bound), plain {e['plain_ms'] * 1e3:.2f} us, "
              f"library {e['library_ms'] * 1e3:.2f} us; device time (profiler) kernel "
              f"{us(dev_t['kernel'])}, plain {us(dev_t['plain'])}, library {us(dev_t['library'])}")
        ratio_dev = (f"{dev_t['kernel'] / dev_t['library']:.4f}"
                     if dev_t["kernel"] and dev_t["library"] else "not measured")
        print(f"  {e['name']}: kernel / library {e['ms'] / e['library_ms']:.4f} (events), "
              f"{ratio_dev} (profiler); host per call: wrapper {e['host_us']['kernel']:.2f} us, "
              f"library {e['host_us']['library']:.2f} us")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    # -- 7. result ---------------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
