#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpudash_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a host with one H100:

1. prints the card (nvidia-smi name and power limit, torch's device name);
2. builds the probe kernels from tpudash_torch/ops/csrc (one nvcc per
   source, started together) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card, the
   copy kernel exactly at the edges of its launch plan;
3d. holds the norm's kernels (csrc/rmsnorm.cu) against autograd of their
   plain version at the tp step's (16·511, 1024), at every width the port
   runs on the card and at their plan's edges: y and dx within a bf16 ulp
   (dx plus the f32 noise of its cancelling terms), dscale within 1e-5 and
   the same bits twice; the autograd function bitwise its kernels, eager and
   in a CUDA graph; the launches of the first call of the dp 1 × tp 4 step
   over the card named four times (and over every GPU when there are
   several): 33 forward and 17 backward a device a step; their times beside
   the plain chain, F.rms_norm and the bound of their bytes;
3e. holds the MoE dispatch's kernels (csrc/moe_dispatch.cu) against their
   plain versions at the DeepSeek-V2-Lite cell's shapes (S 32,760, top-6 of
   64 with 8 held, d 2048, width 1,408, skewed routing), every row past the
   valid count NaN: gather, combine and their backwards' rows the same bits,
   the SwiGLU within a bf16 ulp, two calls bitwise, no row past the count
   written; the launches of the cell's graphed step (9 a MoE layer, 234 a
   step); each kernel's time with L2 emptied beside the bound of its bytes
   at that valid count and the PyTorch chain it replaced;
3f. holds MLA's RoPE and q/k assembly kernels (csrc/mla_rope.cu) against the
   chain they replaced at the cell's shapes (8 × 4,095 tokens, 16 heads of
   128 + 64, v 128, latent 512) and at two small ones: q and k bitwise; the
   autograd function through SDPA, its backward fed dq, dk and dv as SDPA
   returns them and also token-major and head-major: dq_raw and dkv bitwise
   autograd's, the shared rope key's gradient within a bf16 ulp, two calls
   bitwise; 54 forward and 27 backward launches in the graphed step (315
   with the dispatch's); each kernel's time with L2 emptied beside its
   bytes' bound and the chain's; one eager step under the profiler, its
   cats, copies, f32 products, bf16 adds and fills by kind, over the step
   and under the dsv2.mla spans (tools/dsv2_profile.py gives the same for
   another checkout);
3a. loads the kernels as the exporter image does, with no compiler: a fresh
   process with nvcc off PATH and CUDA_HOME=/nonexistent loads phase 2's
   libraries, launches each kernel once and matches its plain version; the same
   process over a copy with an empty build directory fails "nvcc not found";
3b. runs the image's build stage (deploy/torch/Dockerfile) with no GPU
   visible: a venv of only the distributions deploy/torch/requirements.lock
   names, pip install --no-deps of the stage's COPY sources, then the
   Dockerfile's own build script under python -P; a process with no compiler
   then loads and checks what it built;
3c. runs the DaemonSet's container (deploy/torch/exporter-daemonset.yaml):
   its command and env in that venv on a free port, /healthz 200, /metrics
   200 with every tpu_* series for every GPU, exit 0 within 10 s of SIGTERM
   with nothing of its process group left and the port free;
4. drives the exporter's main path: TorchProbeSource at the exporter's
   default sizes, then the exporter app serving /metrics and /healthz;
5. drives the probe bench's path: the matmul, read and copy probes at the
   probe bench's arguments;
6. drives the inter-GPU probes: a rehearsal over [cuda:0, cuda:0] always
   (its rates are one card's device-to-device copy rates, not an
   interconnect's, held to the memory peak), and the real run over every
   GPU when there are several (held to NVLink's rate each way too);
7. drives the training path at the workload source's full defaults on
   cuda:0: the card's loss against the CPU's on one sequence, the loss at
   init, TorchWorkloadSource training until 3 syncs with falling loss, step
   time, TFLOP/s and peak memory, and the exporter serving the workload;
   then the dp×tp sharded step at the same defaults over [cuda:0, cuda:0]
   (a rehearsal: the mesh's maths on one card, not its placement; like
   every make_*_train_step's step, compiled: one CUDA graph on GPUs) against
   the unsharded step, with TorchWorkloadSource and the exporter emitting
   chip_id 0 and 1; the vocab-parallel loss over the card named 1, 2, 4
   and 8 times (against the plain loss, no f32 tensor of the vocabulary's
   width at tp ≥ 2, graphed bitwise against eager); then ring attention
   at the defaults' shapes over an sp ring of the same two slots against
   its oracle, and one ring train step;
   each of these over every GPU too when there are several;
7d. drives the pipeline paths at the same defaults: GPipe at dp 1 × pp 2
   and dp 2 × pp 2 (M = 4), the 3D step at dp 1 × pp 2 × tp 2 (M = 2), each
   against the unsharded loss and gradients; the MoE at the workload's
   widths at ep 1 and ep 2, its expert FFN against the dense oracle; the
   dry run over the card named 2 and 4 times (one graph captured a path);
   each over every GPU too when there are several;
7e. drives the last modules: the anomaly scorer on every GPU against
   numpy's float32 z-score; the demo (start_demo at the exporter's
   defaults, the dashboard child's first frame, nothing left running after
   close; the exporter half only where the child's packages are absent);
   the exporter's device trace while the workload trains (CUDA kernels and
   the training thread's aten ops, 409 on a second request) and while the
   probe source is scraped (the hbm_read kernels named);
7f. drives the workload's step as one CUDA graph, which the runner replays
   on GPUs: a toy graph of products and peer copies against eager; the
   one-GPU step and the sharded step over [cuda:0, cuda:0] at the workload
   defaults, graphed against eager over 8 steps (losses, parameters and
   gradients; the gradients' storage kept); step time, host issue, ops a
   step, busy share and memory of each, eager and graphed; the exporter's
   utilisation per GPU with the graphed runner (one capture, counted);
   over every GPU too when there are several;
7g. drives every other make_*_train_step's step as one CUDA graph at
   full width on the card named 1–4 times: GPipe at dp 1 × pp 2 and dp 2
   × pp 2 (M 4), the 3D step at dp 1 × pp 2 × tp 2 (M 2), the MoE at ep 1
   and ep 2, the ring step at dp 1 × sp 2, each graphed against its eager
   step as in 7f (one capture, at most 3 host launch calls a step);
8. times each kernel at the main path's shapes beside its bound, its plain
   version and one PyTorch call computing the same function, and the host
   time of one wrapper call;
9. prints a {"kernels": [...]} line, and last
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Launch counts are reset just before each path and read just after it.  Any
failed check raises: the script then exits non-zero and prints no result.
It refuses to run without a GPU, and outside a checkout.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
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
#: the workload source's defaults (tpudash/sources/workload.py:50-57), the
#: widest configuration the repo trains
WORKLOAD_DEFAULTS = dict(vocab=2048, d_model=1024, n_heads=16, n_layers=8, d_ff=4096, seq=512,
                         batch=16)
#: the MoE at the workload's widths, as __graft_entry__.py:160-164 builds its
#: MoE config from the workload config's
MOE_DEFAULTS = dict(vocab=2048, d_model=1024, d_ff=4096, n_experts=8, seq=512, batch=16, top_k=1,
                    capacity_factor=1.25)


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


def ici_phase(devices: list, card: str, gen, label: str) -> None:
    """TorchProbeSource over ``devices`` at probe_ici_mb=16: every ICI
    series present, finite and above 0 for every slot, and both link series
    equal to (tx + rev)·1e9, the reference's behaviour."""
    from tpudash_torch.config import Config
    from tpudash_torch.parallel import collectives
    from tpudash_torch.schema import ICI_LINK_SERIES, ICI_RX, ICI_TX
    from tpudash_torch.sources.probe import TorchProbeSource

    import torch

    from tpudash_torch.ops.probes import _MIN_DELTA_S

    # what the collectives move, on these devices with their streams: slot
    # i holds the number i; k ring steps leave slot i holding i − k·step
    n = len(devices)
    shards = [torch.full((8, 1024), float(i), device=d) for i, d in enumerate(devices)]
    bufs = tuple([torch.empty_like(x) for x in shards] for _ in range(2))
    for k, reverse in ((1, False), (3, False), (3, True)):
        out = collectives._ring(shards, bufs, k, reverse)
        torch.cuda.synchronize()
        step = -1 if reverse else 1
        for i, o in enumerate(out):
            check(bool((o == float((i - k * step) % n)).all()),
                  f"ring k={k} reverse={reverse}: slot {i} holds {o[0, 0].item()}")
    outs = [torch.full((n * 8, 1024), -1.0, device=d) for d in devices]
    collectives._all_gather(shards, outs)
    torch.cuda.synchronize()
    check(all(torch.equal(o.cpu(), torch.cat([x.cpu() for x in shards])) for o in outs),
          "all-gather: a slot does not hold every shard in order")

    results: dict = {}
    probes = {name: getattr(collectives, name) for name in
              ("ppermute_ring_bandwidth_probe", "all_gather_bandwidth_probe")}

    def recording(name):
        def probe(*args, **kwargs):  # keeps each probe's result
            r = probes[name](*args, **kwargs)
            results[(name, r.detail.get("reverse"))] = r
            return r
        return probe

    for name in probes:
        setattr(collectives, name, recording(name))
    try:
        t0 = time.perf_counter()
        src = TorchProbeSource(Config(source="probe", extra={"probe_ici_mb": 16}), devices=devices)
        samples = src.fetch()
        fetch_s = time.perf_counter() - t0
    finally:
        for name, fn in probes.items():
            setattr(collectives, name, fn)
    for key, r in results.items():
        check(r.elapsed_s > _MIN_DELTA_S, f"{key}: the paired delta hit its {_MIN_DELTA_S} s "
              "floor, so the rate is not a measurement")
    rings = {rev: r for (name, rev), r in results.items() if name.startswith("ppermute")}
    xp, xn = ICI_LINK_SERIES["xp"], ICI_LINK_SERIES["xn"]
    tx, rev = rings[False].value, rings[True].value
    for i in range(len(devices)):
        got = {s.metric: s.value for s in samples if s.chip.chip_id == i}
        for m in (ICI_TX, ICI_RX, xp, xn):
            check(m in got and math.isfinite(got[m]) and got[m] > 0, f"slot {i}: {m} = {got.get(m)}")
        check(got[ICI_TX] == tx * 1e9, f"slot {i}: tx {got[ICI_TX]} != {tx * 1e9}")
        check(got[xp] == got[xn] == (tx + rev) * 1e9, f"slot {i}: xp {got[xp]}, xn {got[xn]}, "
              f"(tx + rev)·1e9 = {(tx + rev) * 1e9}")
    rx = results[("all_gather_bandwidth_probe", None)].value
    check(src._cache["ici_rx"] == rx * 1e9, "ici_rx is not the all-gather's rate")
    # distinct GPUs move each shard over NVLink: no rate above a GPU's
    # links each way; one card named twice copies within its memory
    distinct = len(_distinct(devices)) == len(devices)
    link_gbps = gen.ici_links_per_chip * gen.ici_link_gbps
    for what, v in (("ring", tx), ("reverse ring", rev), ("all-gather", rx)):
        check(v <= MAX_SHARE_OF_PEAK * gen.hbm_gbps, f"{what} {v} GB/s above the memory peak")
        check(not distinct or v <= MAX_SHARE_OF_PEAK * link_gbps,
              f"{what} {v} GB/s above {MAX_SHARE_OF_PEAK:.0%} of the {link_gbps} GB/s of a GPU's "
              "links each way")
    print(f"inter-GPU probes over {len(devices)} slots ({label}) [{card}]: fetch {fetch_s:.2f} s; "
          f"ring {tx:.2f} GB/s, reverse ring {rev:.2f} GB/s, all-gather {rx:.2f} GB/s per slot "
          f"(16 MiB shards; paired deltas {', '.join(f'{r.elapsed_s * 1e6:.1f}' for r in results.values())} us); "
          + (f"{100 * tx / link_gbps:.2f} / {100 * rev / link_gbps:.2f} / {100 * rx / link_gbps:.2f} % of "
             f"NVLink's {link_gbps:.0f} GB/s each way, bound {MAX_SHARE_OF_PEAK:.0%} of it; " if distinct
             else f"bound {MAX_SHARE_OF_PEAK:.0%} of the memory peak; ") +
          f"ring and all-gather move the right shards; every ICI series present and > 0 for "
          f"every slot, xp == xn == (tx + rev)·1e9")


def training_phase(dev, card: str, gen) -> None:
    """The workload source's training path at its full defaults on ``dev``."""
    import torch

    from tpudash_torch.config import Config
    from tpudash_torch.exporter.server import WARMUP_TASK, make_app
    from tpudash_torch.models import workload as W
    from tpudash_torch.schema import HBM_TOTAL, HBM_USED, TENSORCORE_UTIL
    from tpudash_torch.sources.workload import (
        WORKLOAD_LOSS,
        WORKLOAD_STEPS_PER_S,
        WORKLOAD_TFLOPS,
        TorchWorkloadSource,
    )

    src = TorchWorkloadSource(Config(source="workload"), device=dev)
    cfg = src.runner.cfg
    check(cfg == W.WorkloadConfig(**WORKLOAD_DEFAULTS), f"workload defaults {cfg}")
    flops = W.flops_per_step(cfg)

    # (a) the card's loss on one sequence against the port's own CPU forward
    # on the same parameters and tokens.  Tolerance as in
    # tests/test_torch_workload.py: 2^-10 of the loss, and 4 bf16 units of
    # the logit scale for the logits (bf16 rounds at the same points on both;
    # only the order of the sums differs).
    gen_t = torch.Generator(device=dev).manual_seed(SEED)
    params = W.init_params(cfg, gen_t)
    print(f"training path: {cfg}; flops_per_step {flops / 1e12:.4f} TFLOP; "
          f"{sum(p.numel() for p in W.leaves(params))} parameters")
    seq = torch.randint(0, cfg.vocab, (1, cfg.seq), generator=gen_t, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits_gpu = W.forward(params, seq[:, :-1], cfg).cpu()
        loss_gpu = W.loss_fn(params, seq, cfg).item()
        cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
                      for k, v in params.items()}
        t1 = time.perf_counter()
        logits_cpu = W.forward(cpu_params, seq[:, :-1].cpu(), cfg)
        loss_cpu = W.loss_fn(cpu_params, seq.cpu(), cfg).item()
        cpu_s = time.perf_counter() - t1
    logit_err = (logits_gpu - logits_cpu).abs().max().item()
    logit_tol = 4 * 2.0**-8 * logits_cpu.abs().max().item()
    loss_tol = 2.0**-10 * loss_cpu
    check(math.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= loss_tol,
          f"loss on the card {loss_gpu} vs the CPU {loss_cpu} (tol {loss_tol})")
    check(logit_err <= logit_tol, f"logits: max err {logit_err} above {logit_tol}")
    print(f"(a) parity, batch 1 x {cfg.seq}: loss card {loss_gpu:.6f} vs CPU {loss_cpu:.6f} "
          f"(|diff| {abs(loss_gpu - loss_cpu):.3e}, tol {loss_tol:.3e}); logits max err "
          f"{logit_err:.3e} (tol {logit_tol:.3e}); CPU forward {cpu_s:.1f} s, whole check "
          f"{time.perf_counter() - t0:.1f} s")

    # (b) loss at init near uniform over the vocabulary.  The bound is the
    # reference's own test's (tests/test_models.py): with unit-RMS features
    # and an unembed of scale d**-0.5 the logits have std ~1, which puts the
    # expected loss at init near ln(vocab) + 0.5 (the reference gives 8.106,
    # ln 2048 + 0.48, at these defaults on the CPU)
    batch = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=gen_t, device=dev)
    with torch.no_grad():
        loss_init = W.loss_fn(params, batch, cfg).item()
    check(abs(loss_init - math.log(cfg.vocab)) < 1.0,
          f"loss at init {loss_init} vs ln {cfg.vocab} = {math.log(cfg.vocab)}")
    print(f"(b) loss at init, batch {cfg.batch}: {loss_init:.4f} (ln {cfg.vocab} = "
          f"{math.log(cfg.vocab):.4f})")
    del params, cpu_params, logits_gpu, logits_cpu

    # (c) the source trains in the background until 3 syncs of 8 steps
    sync = src.runner.steps_per_sync
    t0 = time.perf_counter()
    losses = []
    try:
        src.fetch()  # starts the runner
        deadline = time.monotonic() + 300
        while src.runner.steps < 3 * sync:
            check(time.monotonic() < deadline, f"runner stalled at {src.runner.steps} steps")
            check(src.runner.error is None, f"runner: {src.runner.error}")
            if src.runner.steps and (not losses or losses[-1][0] != src.runner.steps):
                losses.append((src.runner.steps, src.runner.loss))
            time.sleep(0.01)
        samples = {s.metric: s.value for s in src.fetch()}
        m = src.runner.metrics()
        train_s = time.perf_counter() - t0
    finally:
        src.close()
    losses.append((m["steps"], m["loss"]))
    total = torch.cuda.get_device_properties(dev).total_memory
    check(0 < samples[TENSORCORE_UTIL] <= 100, f"util {samples[TENSORCORE_UTIL]}")
    check(samples[HBM_USED] > 0, f"HBM used {samples[HBM_USED]}")
    check(samples[HBM_TOTAL] == total, f"HBM total {samples[HBM_TOTAL]} != {total}")
    check(m["loss"] < loss_init, f"loss did not fall: {loss_init} at init, {m['loss']} at "
          f"step {m['steps']}")
    ema_s = 1.0 / m["steps_per_second"]
    print(f"(c) TorchWorkloadSource trained {m['steps']} steps in {train_s:.1f} s (init and "
          f"the first step's set-up included); loss by sync {[(k, round(v, 4)) for k, v in losses]}, "
          f"fell from {loss_init:.4f} at init")
    print(f"  [{card}]: step time (runner EMA) {ema_s * 1e3:.2f} ms; achieved "
          f"{m['achieved_tflops']:.2f} TFLOP/s ({100 * m['achieved_tflops'] / gen.peak_bf16_tflops:.2f} % "
          f"of {gen.peak_bf16_tflops} TFLOP/s); exported util {samples[TENSORCORE_UTIL]:.4f} %, "
          f"HBM used {samples[HBM_USED]:.0f} B of {samples[HBM_TOTAL]:.0f} B")

    # step time by CUDA events, peak memory and the device's busy share, on
    # a train state of the same defaults built here (the runner's is gone)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    params, opt = W.make_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED))
    for _ in range(2):
        W.train_step(params, opt, batch, cfg)
    n = 10
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        W.train_step(params, opt, batch, cfg)
    issue_ms = (time.perf_counter() - t0) / n * 1e3  # host time to issue a step
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / n
    peak = torch.cuda.max_memory_allocated(dev)
    per_device, top, launches, _, _ = profile_steps(lambda: W.train_step(params, opt, batch, cfg), 3)
    del params, opt
    print(f"  [{card}]: step time (CUDA events, {n} steps) {step_ms:.3f} ms = "
          f"{flops / step_ms / 1e9:.2f} TFLOP/s counted "
          f"({100 * flops / step_ms / 1e9 / gen.peak_bf16_tflops:.2f} % of {gen.peak_bf16_tflops}); "
          f"peak max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB; {peak - base} B above "
          f"the {base} B the script held before the train state)")
    print(f"  host time to issue one step (no readback inside the 10): {issue_ms:.3f} ms")
    if per_device is None:
        print("  device busy share: not measured (the profiler recorded no device time)")
    else:
        dev_ms = sum(per_device.values())
        print(f"  device busy share {100 * dev_ms / step_ms:.2f} % (device time a step over 3 steps, "
              f"profiler, {dev_ms:.3f} ms, over the event-timed step); {launches:.0f} device kernels "
              f"and copies a step; top by device time per step: "
              + "; ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in top[:5]))

    # (d) the exporter serving the workload source
    async def serve() -> str:
        from aiohttp.test_utils import TestClient, TestServer

        client = TestClient(TestServer(make_app(Config(source="workload"))))
        await client.start_server()
        try:
            await client.app[WARMUP_TASK]
            deadline = time.monotonic() + 120
            while True:
                resp = await client.get("/metrics")
                check(resp.status == 200, f"/metrics status {resp.status}")
                text = await resp.text()
                if f"\n{WORKLOAD_LOSS}{{" in text or time.monotonic() > deadline:
                    return text
                await asyncio.sleep(0.05)
        finally:
            await client.close()  # closes the source: the runner stops

    text = asyncio.run(serve())
    for series in (WORKLOAD_LOSS, WORKLOAD_STEPS_PER_S, WORKLOAD_TFLOPS):
        lines = [ln for ln in text.splitlines() if ln.startswith(series + "{")]
        check(len(lines) == 1 and math.isfinite(float(lines[0].rsplit(" ", 1)[1])),
              f"/metrics under TPUDASH_SOURCE=workload: {series} lines {lines}")
    print(f"(d) exporter with source=workload served /metrics (200, {len(text.splitlines())} lines) "
          f"with {WORKLOAD_LOSS}, {WORKLOAD_STEPS_PER_S}, {WORKLOAD_TFLOPS}")


def _ulp_bf16(a):
    """One bf16 ulp of each element of the f32 tensor ``a`` of bf16 values."""
    import torch

    e = torch.floor(torch.log2(a.abs().clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.pow(2.0, e - 7)


def param_rule(got: dict, want: dict, lr: float, context: "dict | None" = None) -> dict:
    """The per-tensor rule of tests/test_torch_workload.py for parameters
    after one AdamW step: no element more than 2·lr plus one ulp from
    ``want``, at most 2 % more than one ulp.  Two corrections that the
    workload's 10^8 parameters need and the tests' small trees happen not
    to: the ulp is that of the larger of the two values (an update of
    opposite sign can carry an element into the next binade, where its
    rounding is twice as coarse), and lr stands for lr·(1 + 2^-6) (AdamW
    forms the first update lr·m/(√v + eps) from bf16 moments, each op
    rounded, so an update can exceed lr by a few bf16 units: 1.0093·lr for
    an element near 1e-4 on an H100 at the workload defaults).  Raises past
    the first part, naming the worst element and its value in each tree of
    ``context`` (name → {label: tensor}); returns each leaf's share above
    one ulp."""
    import torch

    from tpudash_torch.models import workload as W

    want = dict(W.named_leaves(want))
    shares = {}
    for name, g in W.named_leaves(got):
        w = want[name].to(g.device)
        bf16 = w.dtype == torch.bfloat16
        g, w = g.float(), w.float()
        big = torch.maximum(g.abs(), w.abs())
        ulp = _ulp_bf16(big) if bf16 else torch.finfo(torch.float32).eps * big.clamp_min(1e-30)
        err = (g - w).abs()
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        bound = 2 * lr * (1 + 2.0**-6) + ulp
        if not bool((err <= bound).all()):
            i = int(torch.argmax(err - bound))
            at = {"got": g, "want": w, **(context or {}).get(name, {})}
            raise SmokeFailure(
                f"{name}: max err {err.max().item():.3e} above 2·lr·(1 + 2^-6) + ulp; worst element "
                f"{i}: " + ", ".join(f"{k} {t.reshape(-1)[i].item():.6e}" for k, t in at.items()))
        shares[name] = (err > ulp).float().mean().item()
    return shares


GRAD_LIMIT = 2.0**-6  # a sharded gradient's relative distance from the unsharded one


def grad_rel(got: dict, want: dict) -> dict:
    """Per leaf of two flat name → tensor maps, ‖got − want‖ / ‖want‖ in f32."""
    out = {}
    for name, g in got.items():
        w = want[name].float().to(g.device)
        out[name] = ((g.float() - w).norm() / w.norm()).item()
    return out


def gradient_limit_phase(dev, card: str) -> None:
    """Where :data:`GRAD_LIMIT` sits: the sharded gradients at the
    workload defaults at tp 8 (dp 1 × tp 8 over the card named eight
    times) and at dp 2 × tp 2 (named four times), each leaf against the
    unsharded step's, and the same readings with a planted sharding
    fault: the last tp shard's gradient zeroed (tp 8), and the dp sum left
    out, each row keeping its own rows' gradient (dp 2).  The true readings
    must lie under the limit and every planted one above it."""
    import torch

    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import build_mesh

    cfg = W.WorkloadConfig(**WORKLOAD_DEFAULTS)
    gen_t = torch.Generator(device=dev).manual_seed(SEED)
    params, _ = W.make_train_state(cfg, gen_t)
    batch = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=gen_t, device=dev)
    W.loss_fn(params, batch, cfg).backward()
    plain = {name: t.grad for name, t in W.named_leaves(params)}

    def sharded_grads(axes: dict, dp_sum: bool):
        plan = W.shard_plan(build_mesh(axes, [dev] * (axes["dp"] * axes["tp"])), cfg)
        sharded, _ = W.make_sharded_train_step(plan.mesh, cfg)[1](params, None)
        W.sharded_loss_fn(sharded, batch, plan).backward()
        if dp_sum:
            for _, rows in W.named_leaves(sharded):
                for c in range(len(rows[0])):
                    W.sum_replica_grads([row[c] for row in rows])
        return plan, sharded

    def fmt(rel: dict) -> str:
        return ", ".join(f"{n.split('.')[-1]} {v:.2e}" for n, v in rel.items())

    plan, sharded = sharded_grads({"dp": 1, "tp": 8}, True)
    parts = {name: [t.grad for t in rows[0]] for name, rows in W.named_leaves(sharded)}
    tp8 = grad_rel({n: plan.join(n, g) for n, g in parts.items()}, plain)
    zeroed = grad_rel({n: plan.join(n, g[:-1] + [torch.zeros_like(g[-1])])
                       for n, g in parts.items() if W.TP_DIMS[n] is not None}, plain)
    del sharded, parts
    plan, sharded = sharded_grads({"dp": 2, "tp": 2}, False)
    no_sum = grad_rel({n: plan.join(n, [t.grad for t in rows[0]])
                       for n, rows in W.named_leaves(sharded)}, plain)
    for _, rows in W.named_leaves(sharded):
        for c in range(len(rows[0])):
            W.sum_replica_grads([row[c] for row in rows])
    dp2 = grad_rel({n: plan.join(n, [t.grad for t in rows[0]])
                    for n, rows in W.named_leaves(sharded)}, plain)
    del sharded, params, plain
    print(f"gradient limit 2^-6 = {GRAD_LIMIT:.3e} at the workload defaults [{card}]:")
    print(f"  dp 1 × tp 8, true: {fmt(tp8)}")
    print(f"  dp 2 × tp 2, true: {fmt(dp2)}")
    print(f"  planted, last tp shard's gradient zeroed (tp 8): {fmt(zeroed)}")
    print(f"  planted, dp sum left out (dp 2 × tp 2, row 0's own): {fmt(no_sum)}")
    true_max, fault_min = max([*tp8.values(), *dp2.values()]), min([*zeroed.values(), *no_sum.values()])
    check(true_max <= GRAD_LIMIT, f"a true sharded gradient reads {true_max:.3e} above 2^-6")
    check(fault_min > GRAD_LIMIT, f"a planted fault reads {fault_min:.3e}, under 2^-6")
    print(f"  largest true reading {true_max:.3e} ({GRAD_LIMIT / true_max:.2f}x under the limit); "
          f"smallest planted {fault_min:.3e} ({fault_min / GRAD_LIMIT:.1f}x above it)")


def one_step_checks(p0: dict, sharded_after: dict, sharded_grads: dict, plain_after: dict,
                    plain_grads: dict, cfg) -> str:
    """The sharded step's first update against the unsharded step's:

    1. gradients: per leaf, ‖g_sharded − g_plain‖ ≤ 2^-6 ‖g_plain‖ (four
       bf16 units: both backward passes round at the same points, and the
       GPU's products sum in other orders at other widths);
    2. the update: AdamW from the initial parameters ``p0`` with the
       sharded step's gradients, run afresh on the full tree, lands bitwise
       on the gathered parameters;
    3. the per-tensor rule (:func:`param_rule`) against the unsharded
       step's parameters: every element within 2·lr + one ulp (as
       corrected there); at most 2 %
       of a bf16 leaf more than one ulp off.  For the f32 norms that share
       is printed, not held: the first update lr·g/(|g| + eps) of an
       element whose gradient is within a few hundred eps moves by more
       than an f32 ulp for gradient noise at the bf16 level, which 1 and 2
       bound instead."""
    import torch

    from tpudash_torch.models import workload as W

    grads = []
    for name, rel in grad_rel(dict(W.named_leaves(sharded_grads)), plain_grads).items():
        check(rel <= GRAD_LIMIT, f"{name}: gradient off the unsharded step's by {rel:.3e} (> 2^-6)")
        grads.append(f"{name.split('.')[-1]} {rel:.1e}")
    fresh = W._unflatten((n, t.clone().requires_grad_(True)) for n, t in W.named_leaves(p0))
    for name, t in W.named_leaves(fresh):
        t.grad = dict(W.named_leaves(sharded_grads))[name].to(t.device)
    W.make_optimizer(fresh, cfg).step()
    after = dict(W.named_leaves(sharded_after))
    for name, t in W.named_leaves(fresh):
        check(torch.equal(t.detach(), after[name].to(t.device)),
              f"{name}: the sharded update is not AdamW of the sharded gradient")
    start = dict(W.named_leaves(p0))
    context = {n: {"initial": start[n], "grad sharded": g, "grad unsharded": plain_grads[n]}
               for n, g in W.named_leaves(sharded_grads)}
    shares = param_rule(sharded_after, plain_after, cfg.lr, context)
    for name, share in shares.items():
        if dict(W.named_leaves(p0))[name].dtype == torch.bfloat16:
            check(share <= 0.02, f"{name}: {100 * share:.2f} % of elements more than one ulp off")
    return ("gradient rel. diff " + ", ".join(grads) + "; the update is AdamW of the sharded "
            "gradient, bitwise; share more than one ulp off the unsharded step's parameters "
            + ", ".join(f"{n.split('.')[-1]} {100 * v:.3f} %" for n, v in shares.items()))


def _distinct(devices: list) -> list:
    return list(dict.fromkeys(devices))


def sharded_phase(devices: list, card: str, gen, label: str) -> dict:
    """The dp×tp sharded train step at the workload source's full defaults
    over ``devices`` (mesh_axes_for(n)): its loss against the unsharded
    step's on the same parameters and tokens (rtol 1e-4, the reference's
    own bound), its gradients and parameters after one step against the
    unsharded step's (:func:`one_step_checks`), each shard on the device the
    plan names, step time, host issue time, busy share and peak memory per
    device; then TorchWorkloadSource and the exporter over the same devices,
    every series for every chip_id.  Returns the numbers for the record."""
    import torch

    from tpudash_torch.config import Config
    from tpudash_torch.exporter.server import WARMUP_TASK, make_app
    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import build_mesh, mesh_axes_for
    from tpudash_torch.schema import HBM_TOTAL, HBM_USED, TENSORCORE_UTIL
    from tpudash_torch.sources.workload import (
        WORKLOAD_LOSS,
        WORKLOAD_STEPS_PER_S,
        WORKLOAD_TFLOPS,
        TorchWorkloadSource,
    )

    n = len(devices)
    dev = devices[0]
    cfg = W.WorkloadConfig(**WORKLOAD_DEFAULTS)
    flops = W.flops_per_step(cfg)
    mesh = build_mesh(mesh_axes_for(n), devices)
    plan = W.shard_plan(mesh, cfg)
    print(f"sharded step over {n} slots ({label}) [{card}]: mesh {mesh.shape}, "
          f"{'head-aligned' if plan.heads_aligned else 'contiguous'} qkv shards")
    gen_t = torch.Generator(device=dev).manual_seed(SEED)
    params, opt = W.make_train_state(cfg, gen_t)
    batch = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=gen_t, device=dev)
    step, shard_inputs = W.make_sharded_train_step(mesh, cfg)
    sharded, sopt = shard_inputs(params, opt)
    _check_placement(sharded, plan)
    p0 = W._unflatten((name, t.detach().clone()) for name, t in W.named_leaves(params))
    loss_sh = step(sharded, sopt, batch).item()
    loss_un = W.train_step(params, opt, batch, cfg).item()
    rel = abs(loss_sh - loss_un) / loss_un
    check(math.isfinite(loss_sh) and rel <= 1e-4,
          f"sharded loss {loss_sh} vs unsharded {loss_un} (rel {rel:.3e} above 1e-4)")
    groups = check_tp_replicas(sharded, plan, "sharded step")
    print(f"  loss at init: sharded {loss_sh:.6f}, unsharded {loss_un:.6f} (rel {rel:.3e}, "
          f"rtol 1e-4); every shard on the device the plan names, the norms on every device of "
          f"their row; after the step {groups} groups of tp replicas bitwise equal, gradients too")
    grads = W._unflatten((name, plan.join(name, [t.grad for t in rows[0]]))
                         for name, rows in W.named_leaves(sharded))
    summary = one_step_checks(p0, W.gather_params(sharded, plan), grads, params,
                              {name: t.grad for name, t in W.named_leaves(params)}, cfg)
    print(f"  after one step: {summary}")
    del params, opt, p0, grads

    t = step_timings(lambda: step(sharded, sopt, batch), devices, 10)
    check(math.isfinite(t["last"].item()), "sharded loss went non-finite")
    del sharded, sopt
    wall_ms = t["step_ms"]
    print_timings(t, card, 10)
    print(f"  {flops / wall_ms / 1e9:.2f} TFLOP/s counted at the host-clock step time, "
          f"{flops / wall_ms / 1e9 / n:.2f} per slot")

    # TorchWorkloadSource over the same devices: one chip_id per slot
    src = TorchWorkloadSource(Config(source="workload"), devices=devices)
    series = {TENSORCORE_UTIL, HBM_USED, HBM_TOTAL, WORKLOAD_LOSS, WORKLOAD_STEPS_PER_S,
              WORKLOAD_TFLOPS}
    try:
        src.fetch()  # starts the runner
        deadline = time.monotonic() + 300
        while src.runner.steps < 2 * src.runner.steps_per_sync:
            check(time.monotonic() < deadline, f"runner stalled at {src.runner.steps} steps")
            check(src.runner.error is None, f"runner: {src.runner.error}")
            time.sleep(0.01)
        samples = src.fetch()
        m = src.runner.metrics()
    finally:
        src.close()
    by_chip: dict = {}
    for smp in samples:
        by_chip.setdefault(smp.chip.chip_id, {})[smp.metric] = smp.value
    check(set(by_chip) == set(range(n)), f"chip_ids {sorted(by_chip)}")
    for i, got in by_chip.items():
        check(set(got) == series and all(math.isfinite(v) for v in got.values()),
              f"chip {i}: series {sorted(got)}")
        check(0 < got[TENSORCORE_UTIL] <= 100 and got[HBM_USED] > 0, f"chip {i}: {got}")
        check(got[WORKLOAD_TFLOPS] == m["achieved_tflops"] / n, f"chip {i}: per-chip TFLOP/s")
    print(f"  TorchWorkloadSource over {n} slots: {m['steps']} steps, loss {m['loss']:.4f}, "
          f"runner EMA {1e3 / m['steps_per_second']:.2f} ms a step, {m['achieved_tflops']:.2f} "
          f"TFLOP/s in all; chip_ids {sorted(by_chip)} with every series; exported util "
          f"{by_chip[0][TENSORCORE_UTIL]:.4f} % per chip")

    async def serve() -> str:
        from aiohttp.test_utils import TestClient, TestServer

        client = TestClient(TestServer(make_app(Config(source="workload"), devices=devices)))
        await client.start_server()
        try:
            await client.app[WARMUP_TASK]
            deadline = time.monotonic() + 120
            while True:
                resp = await client.get("/metrics")
                check(resp.status == 200, f"/metrics status {resp.status}")
                text = await resp.text()
                if text.count(f"\n{WORKLOAD_LOSS}{{") == n or time.monotonic() > deadline:
                    return text
                await asyncio.sleep(0.05)
        finally:
            await client.close()

    text = asyncio.run(serve())
    for name in series:
        lines = [ln for ln in text.splitlines() if ln.startswith(name + "{")]
        chips = sorted(int(re.search(r'chip_id="(\d+)"', ln).group(1)) for ln in lines)
        check(chips == list(range(n)), f"/metrics over {n} slots: {name} lines {lines}")
    print(f"  exporter over {n} slots served /metrics (200) with every series for chips "
          f"0..{n - 1}")
    return {**t, "loss_rel": rel}


def vocab_wide_tensors(run, vocab: int, dtype=None) -> list:
    """(operation, shape) of every tensor (of ``dtype``, if given) whose
    last dimension is ``vocab`` among the outputs of the operations that
    ``run()`` makes, forward and backward (the backward on the calling
    thread, where the recorder sees it), as a ``TorchDispatchMode`` sees
    them."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    found = []

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            found.extend((str(func), tuple(t.shape)) for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor) and t.dim() and t.shape[-1] == vocab
                         and dtype in (None, t.dtype))
            return out

    with torch.autograd.set_multithreading_enabled(False), Recorder():
        run()
    return found


def vocab_parallel_phase(device_lists: list, card: str) -> None:
    """The dp×tp step's vocab-parallel loss at the workload source's full
    defaults over each of ``device_lists`` (a mesh of ``mesh_axes_for(n)``):
    the loss against the plain ``loss_fn`` of the same parameters (rel
    1e-4); no f32 tensor of the vocabulary's width made by the loss's
    forward and backward at tp ≥ 2 (:func:`vocab_wide_tensors`), and some
    at tp 1, where the one column's ``log_softmax`` is the control; at tp ≥
    2, the compiled step (one capture, counted) against ``.eager`` with its
    backward on one thread over 2 steps from equal states: losses,
    parameters and gradients bitwise."""
    import torch

    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import build_mesh, mesh_axes_for

    cfg = W.WorkloadConfig(**WORKLOAD_DEFAULTS)
    dev = device_lists[0][0]
    g = torch.Generator(device=dev).manual_seed(SEED)
    params = W.init_params(cfg, g)
    batches = [torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=g, device=dev)
               for _ in range(2)]
    with torch.no_grad():
        plain = W.loss_fn(params, batches[0], cfg).item()
    for devices in device_lists:
        t0 = time.perf_counter()
        mesh = build_mesh(mesh_axes_for(len(devices)), devices)
        tp = mesh.shape["tp"]
        plan = W.shard_plan(mesh, cfg)
        sharded = W.shard_params(params, plan)
        for t in W.shard_leaves(sharded):
            t.requires_grad_(True)
        losses = []

        def forward_backward():
            losses.append(W.sharded_loss_fn(sharded, batches[0], plan))
            losses[0].backward()

        wide = vocab_wide_tensors(forward_backward, cfg.vocab, torch.float32)
        loss = losses[0].item()
        rel = abs(loss - plain) / plain
        what = f"vocab-parallel loss over {len(devices)} slots, mesh {mesh.shape}"
        check(math.isfinite(loss) and rel <= 1e-4, f"{what}: {loss} vs plain {plain} (rel {rel:.3e} > 1e-4)")
        check(bool(wide) == (tp == 1), f"{what}: {len(wide)} f32 tensors of the vocabulary's width "
              f"{cfg.vocab}, first {wide[:3]}")
        del sharded, losses
        verdict = f"{len(wide)} f32 tensors {cfg.vocab} wide (the control: one column's log_softmax)"
        if tp > 1:
            step, shard_inputs = W.make_sharded_train_step(mesh, cfg)
            live, eager = shard_inputs(params, None), shard_inputs(params, None)
            with counted_captures() as captures:
                got = [step(*live, t).item() for t in batches]
            with torch.autograd.set_multithreading_enabled(False):
                want = [step.eager(*eager, t).item() for t in batches]
            pairs = list(zip(W.shard_leaves(live[0]), W.shard_leaves(eager[0])))
            check(captures == [1] and got == want and all(
                torch.equal(a, b) and torch.equal(a.grad, b.grad) for a, b in pairs),
                f"{what}: graphed {got} vs eager {want}, {len(captures)} captures; or a parameter "
                "or gradient differs")
            verdict = (f"no f32 tensor {cfg.vocab} wide in its forward and backward; graphed (1 "
                       f"capture) bitwise against eager over 2 steps, losses {got[0]:.6f}, "
                       f"{got[1]:.6f}, every parameter and gradient")
            del step, live, eager, pairs
        gc_cuda(_distinct(devices))
        print(f"{what} [{card}]: {loss:.6f} vs plain loss_fn {plain:.6f} (rel {rel:.3e}, rtol 1e-4); "
              f"{verdict}; {time.perf_counter() - t0:.1f} s")


def ring_phase(devices: list, card: str, label: str) -> None:
    """Ring attention at the workload defaults' shapes (B 16, T 512, 16
    heads, hd 64) over a (dp, sp) mesh of ``devices``, against the unsharded
    oracle on the card (one bf16 unit of the output's scale: both compute in
    f32 from the same bf16 inputs and round once), then one ring train step
    at the full defaults, its loss finite and within 2^-10 of the plain
    step's on the same parameters and tokens."""
    import torch

    from tpudash_torch.models import ring_attention as R
    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import build_mesh, mesh_axes_for

    n = len(devices)
    dev = devices[0]
    sp = mesh_axes_for(n)["tp"]
    mesh = build_mesh({"dp": n // sp, "sp": sp}, devices)
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((16, 512, 16, 64), generator=g, device=dev).bfloat16() for _ in range(3))
    got = R.ring_attention(q, k, v, mesh)
    want = R.reference_attention(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    tol = 2.0**-8 * want.float().abs().max().item()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()) and err <= tol,
          f"ring attention: max err {err:.3e} above {tol:.3e}")
    t = cuda_ms({"ring": lambda: R.ring_attention(q, k, v, mesh),
                 "oracle": lambda: R.reference_attention(q, k, v)}, n=5, reps=3)
    print(f"ring attention over {n} slots ({label}), mesh {mesh.shape} [{card}]: (16, 512, 16, 64) "
          f"bf16, max err vs the oracle {err:.3e} (tol {tol:.3e}); {t['ring']:.3f} ms a call, "
          f"oracle {t['oracle']:.3f} ms (CUDA events on {dev})")
    del q, k, v, got, want

    cfg = W.WorkloadConfig(**WORKLOAD_DEFAULTS)
    params, opt = W.make_train_state(cfg, g.manual_seed(SEED))
    batch = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=g, device=dev)
    with torch.no_grad():
        plain = W.loss_fn(params, batch, cfg).item()
    step, shard_inputs = R.make_ring_train_step(mesh, cfg)
    replicas, ropt = shard_inputs(params, opt)
    del params, opt
    loss = step(replicas, ropt, batch).item()
    check(math.isfinite(loss) and abs(loss - plain) <= 2.0**-10 * plain,
          f"ring step loss {loss} vs plain {plain} (tol {2.0**-10 * plain:.3e})")
    for d in _distinct(devices):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(3):
        step(replicas, ropt, batch)
    for d in _distinct(devices):
        torch.cuda.synchronize(d)
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    same = all(torch.equal(a[0], b.to(a[0].device))
               for a in zip(*(W.leaves(r) for r in replicas)) for b in a[1:])
    check(same, "ring replicas differ after 4 steps")
    print(f"  ring train step at the workload defaults: loss at init {loss:.6f} vs the plain "
          f"step's {plain:.6f} (|diff| {abs(loss - plain):.3e}, tol {2.0**-10 * plain:.3e}); "
          f"{step_ms:.2f} ms a step (host clock, every device synchronised, 3 steps); "
          f"replicas bitwise equal after 4 steps")


def step_timings(run, devices: list, steps: int) -> dict:
    """``steps`` calls of one train step ``run`` over ``devices``, after one
    warm call: ms a step by the host clock with every device synchronised
    and by CUDA events on the current device, the host's time to issue a
    step, the peak memory per distinct device above what it held before,
    the last call's result, and over 2 more calls (profiler) each GPU's
    device time a step and busy share (that time over the host-clock step),
    the device kernels and copies a step and the host's launch calls a
    step."""
    import torch

    distinct = _distinct(devices)
    for d in distinct:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    base = {str(d): torch.cuda.memory_allocated(d) for d in distinct}
    run()
    for d in distinct:
        torch.cuda.synchronize(d)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        last = run()
    issue_ms = (time.perf_counter() - t0) / steps * 1e3
    end.record()
    for d in distinct:
        torch.cuda.synchronize(d)
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    peak = {str(d): torch.cuda.max_memory_allocated(d) - base[str(d)] for d in distinct}
    per_device, top, ops, host_ops, copies_by_gpu = profile_steps(run, 2)
    busy = None if per_device is None else {i: ms / wall_ms for i, ms in per_device.items()}
    copies = {kind: sum(ms for name, ms in top if f"Memcpy {kind}" in name) for kind in COPY_KINDS}
    return {"step_ms": wall_ms, "event_ms": start.elapsed_time(end) / steps, "issue_ms": issue_ms,
            "peak_above_base": peak, "device_ms": per_device, "busy": busy, "copies_ms": copies,
            "copies_ms_by_gpu": copies_by_gpu, "ops": ops, "host_ops": host_ops, "top": top,
            "steps": steps + 3, "last": last}


def print_timings(t: dict, card: str, steps: int) -> None:
    print(f"  [{card}]: step {t['step_ms']:.3f} ms (host clock, every device synchronised, "
          f"{steps} steps), {t['event_ms']:.3f} ms by CUDA events; host issue {t['issue_ms']:.3f} ms "
          f"a step; peak max_memory_allocated above base per device: "
          + "; ".join(f"{d} {b / 2**30:.3f} GiB" for d, b in t["peak_above_base"].items()))
    if t["busy"] is None:
        print("  device busy share: not measured (the profiler recorded no device time)")
    else:
        host = f"{t['host_ops']:.0f}" if t["host_ops"] else "not measured"
        print("  busy share per GPU (device time a step over 2 steps, profiler, over the host-clock "
              "step): " + ", ".join(f"cuda:{i} {100 * b:.2f} % ({t['device_ms'][i]:.3f} ms)"
                                    for i, b in t["busy"].items())
              + f"; {t['ops']:.0f} device kernels and copies a step, {host} host launch calls a step; top: "
              + "; ".join(f"{name[:48]} {ms:.3f} ms" for name, ms in t["top"][:3]))
        print(f"  copies a step, summed over the GPUs (profiler): Memcpy PtoP "
              f"{t['copies_ms']['PtoP']:.3f} ms, Memcpy DtoD {t['copies_ms']['DtoD']:.3f} ms; "
              "Memcpy PtoP per GPU (the stream that ran it): "
              + ", ".join(f"cuda:{i} {ms:.3f}" for i, ms in t["copies_ms_by_gpu"]["PtoP"].items()))


def _check_placement(sharded: dict, plan) -> None:
    """Every part on the device its plan names; a layer norm (``blocks.ln1``,
    ``blocks.ln2``) of a dp×tp or pipeline plan on every device of its dp
    row, as the reference replicates it over tp: no device of a row is
    left to a home's norms."""
    from tpudash_torch.models import workload as W

    per_row = len(plan.mesh.devices) // plan.dp
    for name, rows in W.named_leaves(sharded):
        for r, row in enumerate(rows):
            for i, t in enumerate(row):
                want = plan.part_device(name, r, i)
                check(t.device == want, f"{name}[{r}][{i}] on {t.device}, the plan names {want}")
            if name in ("blocks.ln1", "blocks.ln2"):
                got = [t.device for t in row]
                mine = list(plan.mesh.devices[r * per_row:(r + 1) * per_row])
                check(got == mine, f"{name} of row {r} on {got}, not on every device {mine}")


def check_tp_replicas(sharded: dict, plan, what: str) -> int:
    """After a step: every replica of a leaf that a group of a row shares
    (the parts ``plan.split`` gives as one tensor: a norm over tp, the
    3D step's embed, ln_f and unembed) has its group's first's bits, and so
    has its gradient.  Returns the number of groups held."""
    import torch

    from tpudash_torch.models import workload as W

    groups = 0
    for name, rows in W.named_leaves(sharded):
        split = plan.split(name, plan.join(name, [t.detach() for t in rows[0]]))
        same: dict = {}
        for i, part in enumerate(split):
            same.setdefault(id(part), []).append(i)
        for r, row in enumerate(rows):
            for idx in (v for v in same.values() if len(v) > 1):
                first = row[idx[0]]
                for i in idx[1:]:
                    check(torch.equal(first, row[i].to(first.device))
                          and torch.equal(first.grad, row[i].grad.to(first.device)),
                          f"{what} {name}[{r}][{i}]: a replica or its gradient differs from [{idx[0]}]")
                groups += 1
    return groups


def pipeline_phase(devices: list, card: str, label: str, axes: dict, microbatches: int) -> dict:
    """The GPipe step (axes dp, pp) or the 3D step (dp, pp, tp) at the
    workload source's full defaults over ``devices``: each part on the
    device its plan names; the loss against the unsharded loss on the same
    parameters and tokens (rtol 1e-4, or 5e-3 in 3D: the reference's own
    bounds, tests/test_pipeline.py:49, :100); each leaf's gradient within
    :data:`GRAD_LIMIT` of the unsharded one's (in 3D, of its
    ``convert_params_3d``); dp replicas bitwise equal after a step; step
    time, host issue, busy share and peak memory; the loss lower after 8
    steps on one batch."""
    import torch

    from tpudash_torch.models import pipeline as PL
    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import build_mesh

    dev = devices[0]
    three_d = "tp" in axes
    cfg = W.WorkloadConfig(**WORKLOAD_DEFAULTS)
    mesh = build_mesh(axes, devices)
    plan = PL.pipeline_plan(mesh, cfg)
    what = "3D step" if three_d else "pipeline"
    print(f"{what} over {len(devices)} slots ({label}) [{card}]: mesh {mesh.shape}, M = {microbatches}")
    gen_t = torch.Generator(device=dev).manual_seed(SEED)
    params, _ = W.make_train_state(cfg, gen_t)
    batch = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=gen_t, device=dev)
    make = PL.make_pipeline3d_train_step if three_d else PL.make_pipeline_train_step
    step, shard_inputs = make(mesh, cfg, microbatches)
    sharded, sopt = shard_inputs(PL.convert_params_3d(params) if three_d else params, None)
    _check_placement(sharded, plan)
    loss_pp = step(sharded, sopt, batch).item()
    loss_un = W.loss_fn(params, batch, cfg)
    loss_un.backward()
    loss_un = loss_un.item()
    rtol = 5e-3 if three_d else 1e-4
    rel = abs(loss_pp - loss_un) / loss_un
    check(math.isfinite(loss_pp) and rel <= rtol,
          f"{what} loss {loss_pp} vs unsharded {loss_un} (rel {rel:.3e} above {rtol})")
    plain = W._unflatten((name, t.grad) for name, t in W.named_leaves(params))
    plain = dict(W.named_leaves(PL.convert_params_3d(plain) if three_d else plain))
    got = {name: plan.join(name, [t.grad for t in rows[0]]) for name, rows in W.named_leaves(sharded)}
    rels = grad_rel(got, plain)
    for name, r in rels.items():
        check(r <= GRAD_LIMIT, f"{what} {name}: gradient off the unsharded one's by {r:.3e} (> 2^-6)")
    for name, rows in W.named_leaves(sharded):
        for c, part in enumerate(rows[0]):
            check(all(torch.equal(part, row[c].to(part.device)) for row in rows[1:]),
                  f"{what} {name}[*][{c}]: dp replicas differ after a step")
    groups = check_tp_replicas(sharded, plan, what)
    del params, plain, got
    print(f"  {groups} groups of tp replicas bitwise equal after the step, gradients too")
    print(f"  every part on the device the plan names; loss at init {loss_pp:.6f} vs unsharded "
          f"{loss_un:.6f} (rel {rel:.3e}, rtol {rtol}); gradient rel. diff "
          + ", ".join(f"{n.split('.')[-1]} {v:.1e}" for n, v in rels.items())
          + f" (limit {GRAD_LIMIT:.3e}); dp replicas bitwise equal")
    t = step_timings(lambda: step(sharded, sopt, batch), devices, 4)
    print_timings(t, card, 4)
    done = 1 + t["steps"]
    loss_n = step(sharded, sopt, batch).item()
    check(math.isfinite(loss_n) and loss_n < loss_pp, f"{what} loss {loss_n} after {done} steps, "
          f"{loss_pp} at init")
    print(f"  loss after {done} steps on one batch {loss_n:.6f} (from {loss_pp:.6f})")
    del sharded, sopt
    return {**t, "loss_rel": rel}


def moe_dropped_share(sharded: dict, tokens, plan) -> float:
    """The share of top-k assignments that the capacity drops, over every
    slot's tokens."""
    import torch

    from tpudash_torch.models import moe as MO
    from tpudash_torch.models import workload as W

    cfg, kept, total = plan.cfg, 0.0, 0
    with torch.no_grad():
        for g, t in enumerate(tokens.chunk(plan.ep, 0)):
            p = {name: rows[0][g] for name, rows in sharded.items()}
            x = W._rmsnorm(p["embed"][t[:, :-1].to(plan.device(g))].reshape(-1, cfg.d_model), p["ln"])
            dispatch, _, _ = MO._route(x, p["router"], cfg, MO._capacity(x.shape[0], cfg))
            kept += dispatch.sum().item()
            total += x.shape[0] * cfg.top_k
    return 1.0 - kept / total


def moe_phase(devices: list, card: str, label: str) -> dict:
    """The expert-parallel MoE at the workload's widths over (ep,) =
    ``devices``: the expert FFN over the slots against the dense oracle at
    capacity_factor = n_experts (nothing drops) for top_k 1 and 2 at batch 2,
    within the reference test's rtol 5e-2, atol 2e-2 (tests/test_moe.py:66);
    each part on the device its plan names; the loss at init within 1.0 of
    ln(vocab); the share of assignments dropped at cf 1.25; step time, host
    issue, busy share and peak memory; the loss lower after 8 steps."""
    import dataclasses

    import torch

    from tpudash_torch.models import moe as MO
    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import build_mesh

    dev, G = devices[0], len(devices)
    cfg = MO.MoEConfig(**MOE_DEFAULTS)
    mesh = build_mesh({"ep": G}, devices)
    plan = MO.moe_plan(mesh, cfg)
    print(f"MoE over {G} slots ({label}) [{card}]: {cfg}")
    gen_t = torch.Generator(device=dev).manual_seed(SEED)
    params, opt = MO.make_moe_train_state(cfg, gen_t)
    errs = []
    for k in (1, 2):
        c = dataclasses.replace(cfg, top_k=k, capacity_factor=float(cfg.n_experts))
        x = torch.randn((2 * cfg.seq, cfg.d_model), generator=gen_t, device=dev).bfloat16()
        parts = W.shard_params(params, MO.moe_plan(mesh, c))
        with torch.no_grad():
            ys, _ = MO.moe_ffn([t.to(d) for t, d in zip(x.chunk(G, 0), devices)],
                               [{n: rows[0][g] for n, rows in parts.items()} for g in range(G)], c)
            got = torch.cat([y.to(dev) for y in ys]).float()
            want = MO.dense_moe_reference(x, params, c).float()
        err = (got - want).abs()
        check(bool(torch.isfinite(got).all()) and bool((err <= 2e-2 + 5e-2 * want.abs()).all()),
              f"moe_ffn top_k {k}: max err {err.max().item():.3e} past atol 2e-2 + rtol 5e-2")
        errs.append(f"top_k {k} max err {err.max().item():.3e} (|y| max {want.abs().max().item():.3f})")
        del parts, ys, got, want
    print(f"  moe_ffn vs dense oracle, {2 * cfg.seq} tokens (batch 2), capacity_factor = n_experts: "
          + "; ".join(errs))
    batch = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=gen_t, device=dev)
    step, shard_inputs = MO.make_moe_train_step(mesh, cfg)
    sharded, sopt = shard_inputs(params, opt)
    del params, opt
    _check_placement(sharded, plan)
    dropped = moe_dropped_share(sharded, batch, plan)
    loss0 = step(sharded, sopt, batch).item()
    check(abs(loss0 - math.log(cfg.vocab)) < 1.0, f"MoE loss at init {loss0} vs ln {cfg.vocab}")
    print(f"  every part on the device the plan names; loss at init {loss0:.6f} (ln {cfg.vocab} = "
          f"{math.log(cfg.vocab):.4f}); assignments dropped at cf {cfg.capacity_factor}: "
          f"{100 * dropped:.2f} %")
    t = step_timings(lambda: step(sharded, sopt, batch), devices, 4)
    print_timings(t, card, 4)
    done = 1 + t["steps"]
    loss_n = step(sharded, sopt, batch).item()
    check(math.isfinite(loss_n) and loss_n < loss0, f"MoE loss {loss_n} after {done} steps, {loss0} at init")
    print(f"  loss after {done} steps on one batch {loss_n:.6f} (from {loss0:.6f})")
    del sharded, sopt
    return {**t, "dropped": dropped}


def dryrun_phase(dev, card: str) -> None:
    """``dryrun_multichip`` over the card named 2 and 4 times: every
    parallel step at the tiny configuration, the 3D one at n = 4, each
    captured as one CUDA graph (counted: one a path, as the reference jits
    one program a path) and its loss finite."""
    from tpudash_torch.dryrun import dryrun_multichip

    for n in (2, 4):
        t0 = time.perf_counter()
        with counted_captures() as captures:
            losses = dryrun_multichip(n, [dev] * n)
        want = {"sharded", "ring", "pipeline", "moe"} | ({"3d"} if n % 4 == 0 else set())
        check(set(losses) == want, f"dryrun_multichip({n}) gave {sorted(losses)}")
        check(len(captures) == len(want), f"dryrun_multichip({n}) captured {len(captures)} graphs, "
              f"not one a path ({len(want)})")
        print(f"dryrun_multichip({n}, [{dev}] * {n}) [{card}] in {time.perf_counter() - t0:.1f} s, "
              f"{len(captures)} graphs captured: " + ", ".join(f"{k} {v:.6f}" for k, v in losses.items()))


@contextlib.contextmanager
def counted_captures():
    """Count the CUDA graphs that the body captures: yields a list that
    grows by one at each ``graphed.graph_train_step`` call (the capture of
    every compiled step and of the runner's)."""
    from tpudash_torch.models import graphed

    capture, captures = graphed.graph_train_step, []

    def counting(*args):
        captures.append(1)
        return capture(*args)

    graphed.graph_train_step = counting
    try:
        yield captures
    finally:
        graphed.graph_train_step = capture


def toy_graph_check(devices: list, card: str) -> None:
    """One CUDA graph over ``devices`` (``graphed.graph_train_step``) before
    the model's: a bf16 product on the first device, a peer copy to the next
    and a product there, and so on, a copy back, the loss, its backward and
    an AdamW step; replayed 4 times against the same eager steps from the
    same weights and inputs, the losses and weights bitwise."""
    import torch

    from tpudash_torch.models import graphed
    from tpudash_torch.models import workload as W

    dev = devices[0]
    g = torch.Generator(device=dev).manual_seed(SEED)
    ws = [(torch.randn((1024, 1024), generator=g, device=dev) * 1024**-0.5).bfloat16().to(d)
          for d in devices]
    xs = [torch.randn((512, 1024), generator=g, device=dev).bfloat16() for _ in range(4)]

    def step(params, opt, x):
        opt.zero_grad(set_to_none=True)
        h = x
        for w in params:
            h = torch.matmul(h.to(w.device), w)
        loss = h.to(x.device).float().square().mean()
        loss.backward()
        opt.step()
        return loss.detach()

    def state():
        params = [w.clone().requires_grad_(True) for w in ws]
        return params, W._adamw(params, W.WorkloadConfig())

    eager, live = state(), state()
    replay = graphed.graph_train_step(step, *live, xs[0])
    losses = [(step(*eager, x).item(), replay(x).item()) for x in xs]
    for d in _distinct(devices):
        torch.cuda.synchronize(d)
    check(all(a == b for a, b in losses), f"toy graph over {devices}: losses {losses}")
    check(all(torch.equal(a, b) for a, b in zip(eager[0], live[0])),
          f"toy graph over {devices}: weights differ from eager after 4 steps")
    print(f"toy graph over {len(devices)} slots ({', '.join(str(d) for d in devices)}) [{card}]: "
          f"bf16 1024-wide products passed device to device and back, backward and AdamW as one "
          f"graph; 4 replays equal to eager, losses and weights bitwise")


def _flat_tree(tree, plan, get) -> dict:
    """Name → full tensor of ``get(t)`` over a tree's leaves: the leaves of a
    one-device tree (``plan`` None), of each tree of a tuple of replicas
    (the ring's; name[j] for replica j), or a sharded tree's row 0
    joined."""
    from tpudash_torch.models import workload as W

    if isinstance(tree, tuple):
        return {f"{n}[{j}]": get(t) for j, rep in enumerate(tree) for n, t in W.named_leaves(rep)}
    if plan is None:
        return {n: get(t) for n, t in W.named_leaves(tree)}
    return {n: plan.join(n, [get(t) for t in rows[0]]) for n, rows in W.named_leaves(tree)}


def graphed_vs_eager(what: str, make_state, step, devices: list, plan, card: str, cfg,
                     steps: int = 8) -> dict:
    """A compiled step (``graphed.compiled``: a ``make_*_train_step``'s, or the runner's
    one-device step) against its ``step.eager``, from equal states that
    ``make_state()`` gives and on the same ``steps`` batches of ``cfg``'s
    shape: the compiled step captures one graph (counted) at its first
    call and replays it at every later one; the eager step runs with the
    backward on one thread, the order of operations that the graph
    records, and as PyTorch runs it by default, the backward on a thread a
    device.  Compared: each step's loss, every parameter and gradient after
    the first step and after the last, the gradients' storage over the
    replays, and that each call returns a loss of its own.  Bitwise is
    expected against the first, and against the second on one device;
    where a comparison is not bitwise, the largest differences are printed
    and the graph is held to the bounds that hold a sharded step against the
    unsharded one: each step's loss rel 1e-4, and after one step the
    gradients within 2^-6 (:func:`grad_rel`) and the parameters by
    :func:`param_rule`.  Then step time, host issue, ops and host launch
    calls a step (at most 3 graphed: the tokens' copy, the graph's launch
    and the loss's copy), busy share and memory, eager and graphed."""
    import torch

    dev, distinct = devices[0], _distinct(devices)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    batches = [torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=g, device=dev)
               for _ in range(steps)]
    eager, one_thread, live = make_state(), make_state(), make_state()
    tensors = [p for grp in live[1].param_groups for p in grp["params"]]

    def on_one_thread(t):
        with torch.autograd.set_multithreading_enabled(False):
            return step.eager(*one_thread, t)

    calls = []

    def compiled_call(t):
        calls.append(1)
        return step(*live, t)

    runs = {"graphed": compiled_call, "eager": lambda t: step.eager(*eager, t),
            "one thread": on_one_thread}
    states = {"eager": eager, "one thread": one_thread, "graphed": live}
    losses = {k: [] for k in runs}
    after = {}  # (parameters, gradients) after the first step and after the last

    def snapshot(when):
        for k, (params, _) in states.items():
            after[k, when] = (_flat_tree(params, plan, lambda t: t.detach().clone()),
                              _flat_tree(params, plan, lambda t: t.grad.clone()))

    with counted_captures() as captures:
        ptrs, outs = None, []
        for i, t in enumerate(batches):
            if i == 0:  # the capture (warm-up, undone) and the first replay
                for d in distinct:
                    torch.cuda.synchronize(d)
                    torch.cuda.reset_peak_memory_stats(d)
                base = {str(d): (torch.cuda.memory_allocated(d), torch.cuda.memory_reserved(d))
                        for d in distinct}
                t0 = time.perf_counter()
            for k, run in runs.items():
                out = run(t)
                losses[k].append(out.item())
                if i == 0 and k == "graphed":
                    capture_s = time.perf_counter() - t0
                    mem = {str(d): (torch.cuda.max_memory_allocated(d) - base[str(d)][0],
                                    torch.cuda.memory_reserved(d) - base[str(d)][1]) for d in distinct}
                if k == "graphed":
                    outs.append(out)
            got = [None if p.grad is None else p.grad.data_ptr() for p in tensors]
            check(None not in got and (ptrs is None or got == ptrs),
                  f"{what}: a gradient is missing or moved between replays")
            ptrs = got
            if i == 0:
                snapshot("first")
        snapshot("last")
        check(len({id(o) for o in outs}) == steps and [o.item() for o in outs] == losses["graphed"],
              f"{what}: the calls' losses are not each a tensor of their own")

    def same(k) -> bool:
        return losses[k] == losses["graphed"] and all(
            torch.equal(a[n], b[n]) for when in ("first", "last")
            for a, b in zip(after[k, when], after["graphed", when]) for n in a)

    verdicts, bitwise = [], {k: same(k) for k in ("one thread", "eager")}
    for k in ("one thread", "eager"):
        if bitwise[k]:
            verdicts.append(f"bitwise equal to eager {'with its backward on one thread' if k == 'one thread' else 'as PyTorch runs it (a backward thread a device)'}")
            continue
        loss_rel = max(abs(a - b) / abs(a) for a, b in zip(losses[k], losses["graphed"]))
        (p1, g1), (pg1, gg1) = after[k, "first"], after["graphed", "first"]
        rels = grad_rel(gg1, g1)
        p_end = max((after[k, "last"][0][n].float() - after["graphed", "last"][0][n].float()).abs().max().item()
                    for n in p1)
        print(f"  {what}: graphed and eager ({k}) differ: loss rel up to {loss_rel:.3e} over {steps} steps; "
              f"after one step gradients rel up to {max(rels.values()):.3e}; parameters after {steps} "
              f"steps by up to {p_end:.3e}")
        check(loss_rel <= 1e-4, f"{what}: graphed loss off eager's ({k}) by {loss_rel:.3e} (> 1e-4)")
        for name, r in rels.items():
            check(r <= GRAD_LIMIT, f"{what} {name}: graphed gradient off eager's ({k}) by {r:.3e} (> 2^-6)")
        param_rule(pg1, p1, cfg.lr)
        verdicts.append(f"against eager ({k}): not bitwise, within the bounds (loss rel {loss_rel:.3e} "
                        f"≤ 1e-4 every step; after one step gradients ≤ 2^-6 and param_rule)")
    print(f"  {what} [{card}]: graph captured and replayed once in {capture_s:.2f} s (2 warm-up steps "
          f"undone, the capture, the first step); over {steps} steps: " + "; ".join(verdicts)
          + f"; each .grad kept its storage over the replays; each call's loss a tensor of its own; "
          f"losses {losses['graphed'][0]:.6f} -> {losses['graphed'][-1]:.6f}")
    print(f"  {what}: memory per device, peak allocated above base during warm-up, capture and the "
          f"first step / reserved after it: "
          + "; ".join(f"{d} {a / 2**30:.3f} / {r / 2**30:.3f} GiB" for d, (a, r) in mem.items()))
    del one_thread, after
    out = {}
    with counted_captures() as more:
        for label, run in (("eager", lambda: step.eager(*eager, batches[0])),
                           ("graphed", lambda: compiled_call(batches[0]))):
            t = step_timings(run, devices, 10)
            check(math.isfinite(t["last"].item()), f"{what} {label}: loss went non-finite")
            print(f"  {what}, {label}:")
            print_timings(t, card, 10)
            out[label] = {k: v for k, v in t.items() if k != "last"}
        launch_us = []
        for _ in range(5):  # the host's cost of one call, the queue empty
            for d in distinct:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            compiled_call(batches[0])
            launch_us.append((time.perf_counter() - t0) * 1e6)
    check(captures == [1] and more == [], f"{what}: {len(captures) + len(more)} captures, not 1")
    host_ops = out["graphed"]["host_ops"]
    check(not host_ops or host_ops <= 3, f"{what}: {host_ops} host launch calls a graphed step, not ≤ 3")
    out["launch_us"] = statistics.median(launch_us)
    ratio = out["graphed"]["step_ms"] / out["eager"]["step_ms"]
    print(f"  {what}: 1 capture over {len(calls)} calls; one call (the tokens' copy, the graph's launch, "
          f"the loss's copy) takes {out['launch_us']:.1f} us of host time with every device idle, median "
          f"of 5; the host issue above includes waits for room in the launch queue; graphed / eager step "
          f"time {ratio:.4f}")
    de, dg = dict(out["eager"]["top"]), dict(out["graphed"]["top"])
    if de and dg:
        grew = sorted(set(de) | set(dg), key=lambda k: de.get(k, 0.0) - dg.get(k, 0.0))[:3]
        print(f"  {what}: device time a step that grew most, eager -> graphed: "
              + "; ".join(f"{k[:48]} {de.get(k, 0.0):.3f} -> {dg.get(k, 0.0):.3f} ms" for k in grew))
    out["memory"], out["bitwise"], out["ratio"] = mem, bitwise, ratio
    del eager, live
    return out


def graph_phase(devices: list, card: str, label: str) -> dict:
    """The workload's step as one CUDA graph (``models/graphed.py``), which
    the runner replays on GPUs: the toy graph over the distinct GPUs of
    ``devices``, or over the card named twice where there is one GPU, and
    over the first two of several; at the workload source's full defaults,
    the one-GPU step on the first device and the dp×tp sharded step over
    ``devices``, each graphed against eager (:func:`graphed_vs_eager`); and
    the exporter over ``devices`` with TorchWorkloadSource, whose runner
    captures one graph (counted), serving a utilisation per GPU."""
    import torch

    from tpudash_torch.config import Config
    from tpudash_torch.exporter.server import WARMUP_TASK, make_app
    from tpudash_torch.models import graphed
    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import build_mesh, mesh_axes_for
    from tpudash_torch.schema import TENSORCORE_UTIL
    from tpudash_torch.sources.workload import WORKLOAD_STEPS_PER_S

    n, dev = len(devices), devices[0]
    distinct = _distinct(devices)
    print(f"CUDA graph of the train step over {n} slots ({label}) [{card}]")
    toy_graph_check(distinct if len(distinct) > 1 else [dev, dev], card)
    if len(distinct) > 2:
        toy_graph_check(distinct[:2], card)

    cfg = W.WorkloadConfig(**WORKLOAD_DEFAULTS)

    def one_state():
        return W.make_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED))

    out = {"one": graphed_vs_eager(f"one-GPU step on {dev}", one_state,
                                   graphed.compiled(lambda p, o, t: W.train_step(p, o, t, cfg)),
                                   [dev], None, card, cfg)}
    gc_cuda(distinct)
    mesh = build_mesh(mesh_axes_for(n), devices)
    step, shard_inputs = W.make_sharded_train_step(mesh, cfg)
    out["sharded"] = graphed_vs_eager(
        f"sharded step over {n} slots, mesh {mesh.shape}", lambda: shard_inputs(*one_state()), step,
        devices, W.shard_plan(mesh, cfg), card, cfg)
    gc_cuda(distinct)

    async def serve() -> dict:
        from aiohttp.test_utils import TestClient, TestServer

        client = TestClient(TestServer(make_app(Config(source="workload"), devices=devices)))
        await client.start_server()
        try:
            await client.app[WARMUP_TASK]
            deadline, first = time.monotonic() + 120, None
            while True:
                resp = await client.get("/metrics")
                check(resp.status == 200, f"/metrics status {resp.status}")
                text = await resp.text()
                util = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
                    TENSORCORE_UTIL + r'\{[^}]*chip_id="(\d+)"[^}]*\} (\S+)', text)}
                sps = re.search(WORKLOAD_STEPS_PER_S + r"\{[^}]*\} (\S+)", text)
                if first is None and len(util) == n and sps and float(sps.group(1)) > 0:
                    # the runner's first sync holds the capture, as the
                    # reference's holds jax.jit's compile: 10 s of syncs
                    # leave it a weight of 0.7^15 or less in the EMA
                    first = time.monotonic()
                if first is not None and time.monotonic() - first > 10.0:
                    return {"util": util, "steps_per_s": float(sps.group(1))}
                check(time.monotonic() < deadline, f"/metrics over {n} slots: no utilisation in 120 s")
                await asyncio.sleep(0.1)
        finally:
            await client.close()

    with counted_captures() as captures:
        served = asyncio.run(serve())
    check(captures == [1], f"the runner captured {len(captures)} graphs, not 1")
    check(sorted(served["util"]) == list(range(n)) and all(0 < u <= 100 for u in served["util"].values()),
          f"/metrics utilisation per chip {served['util']}")
    step_ms = 1e3 / served["steps_per_s"]
    print(f"  exporter, source=workload over {n} slots (the runner captured 1 graph): runner EMA "
          f"{step_ms:.2f} ms a step, {W.flops_per_step(cfg) / step_ms / 1e9:.2f} TFLOP/s in all; "
          f"/metrics utilisation per chip: "
          + ", ".join(f"{i}: {u:.4f} %" for i, u in sorted(served["util"].items())))
    return {**out, "served": served}


def path_graph_phase(kind: str, devices: list, axes: dict, card: str, label: str,
                     microbatches: int = 0) -> dict:
    """A ``make_*_train_step``'s step at full width over ``devices`` (a mesh of ``axes``)
    graphed against eager (:func:`graphed_vs_eager`): ``kind`` "pipeline"
    (GPipe over dp, pp, with ``microbatches``), "pipeline3d" (dp, pp, tp),
    "moe" (ep, at :data:`MOE_DEFAULTS`) or "ring" (dp, sp); the others at
    :data:`WORKLOAD_DEFAULTS`."""
    import torch

    from tpudash_torch.models import moe as MO
    from tpudash_torch.models import pipeline as PL
    from tpudash_torch.models import ring_attention as R
    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import build_mesh

    mesh, dev = build_mesh(axes, devices), devices[0]

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED)

    plan = None
    if kind == "moe":
        cfg = MO.MoEConfig(**MOE_DEFAULTS)
        step, shard_inputs = MO.make_moe_train_step(mesh, cfg)
        plan, name = MO.moe_plan(mesh, cfg), "MoE step"

        def make_state():
            return shard_inputs(*MO.make_moe_train_state(cfg, gen()))
    elif kind == "ring":
        cfg = W.WorkloadConfig(**WORKLOAD_DEFAULTS)
        step, shard_inputs = R.make_ring_train_step(mesh, cfg)
        name = "ring step"

        def make_state():
            return shard_inputs(*W.make_train_state(cfg, gen()))
    else:
        cfg = W.WorkloadConfig(**WORKLOAD_DEFAULTS)
        three_d = kind == "pipeline3d"
        make = PL.make_pipeline3d_train_step if three_d else PL.make_pipeline_train_step
        step, shard_inputs = make(mesh, cfg, microbatches)
        plan, name = PL.pipeline_plan(mesh, cfg), f"{'3D' if three_d else 'GPipe'} step, M = {microbatches},"

        def make_state():
            params = W.init_params(cfg, gen())
            return shard_inputs(PL.convert_params_3d(params) if three_d else params, None)
    out = graphed_vs_eager(f"{name} over {len(devices)} slots ({label}), mesh {mesh.shape}", make_state,
                           step, devices, plan, card, cfg)
    gc_cuda(_distinct(devices))
    return out


def gc_cuda(devices: list) -> None:
    """Free what the last check left: garbage first, then the cached blocks."""
    import gc

    import torch

    gc.collect()
    for d in devices:
        torch.cuda.synchronize(d)
    torch.cuda.empty_cache()


def _random_score_inputs(k: int = 64, c: int = 8, seed: int = 7):
    """The anomaly tests' recipe (tests/test_anomaly.py): x, loc and scale
    as float64 [k, c], a NaN x and a NaN loc (a cold cell)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(50.0, 20.0, (k, c))
    loc = rng.normal(50.0, 5.0, (k, c))
    scale = np.abs(rng.normal(3.0, 1.0, (k, c))) + 0.1
    x[0, 0] = np.nan
    loc[1, 1] = np.nan
    return x, loc, scale


def _with_zero_scale(x, loc, scale):
    """One more column whose scale is 0: ±inf, a 0/0 NaN, and the NaNs of
    column 0's x and column 1's loc."""
    import numpy as np

    x = np.hstack([x, x[:, :1]])
    loc = np.hstack([loc, loc[:, 1:2]])
    loc[2, -1] = x[2, -1]  # 0 / 0
    return x, loc, np.hstack([scale, np.zeros((len(x), 1))])


def anomaly_phase(devices: list, card: str) -> None:
    """The port's anomaly scorer on each device of ``devices`` against
    numpy's float32 z-score at 256 and 250 rows: rtol = atol = 1e-6 with NaN
    where numpy has NaN (the reference test's bound), and whether it is
    numpy's in every element; then the host time of one 256 × 12 call, the
    reference test's size, on the first device."""
    import numpy as np

    from tpudash_torch.anomaly import baselines

    def numpy_z(x, loc, scale):
        with np.errstate(invalid="ignore", divide="ignore"):
            return (np.asarray(x, np.float32) - np.asarray(loc, np.float32)) / np.asarray(
                scale, np.float32)

    for device in devices:
        score, backend = baselines.make_scorer(device)
        check(backend == "torch", f"scorer backend {backend}")
        for k in (256, 250):
            x, loc, scale = _with_zero_scale(*_random_score_inputs(k=k, c=12))
            got, want = score(x, loc, scale), numpy_z(x, loc, scale)
            label = f"{k} x 13 on {device}"
            check(got.dtype == np.float32 and got.shape == want.shape,
                  f"anomaly {label}: {got.dtype} {got.shape}")
            with np.errstate(invalid="ignore"):  # inf - inf in the message
                check(bool(np.allclose(got, want, rtol=1e-6, atol=1e-6, equal_nan=True)),
                      f"anomaly {label}: max err {np.nanmax(np.abs(got - want))} above 1e-6")
            check(np.isinf(got[:, -1]).sum() == np.isinf(want[:, -1]).sum() > 0,
                  f"anomaly {label}: the zero-scale column's infinities differ")
            print(f"anomaly scorer {label} [{card}]: within 1e-6 of numpy, equal in every "
                  f"element: {np.array_equal(got, want, equal_nan=True)}")

    def median_us(fn, n: int = 50) -> float:
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(times)

    x, loc, scale = _random_score_inputs(k=256, c=12)
    score, _ = baselines.make_scorer(devices[0])
    score(x, loc, scale)
    print(f"anomaly scorer 256 x 12 on {devices[0]} [{card}]: "
          f"{median_us(lambda: score(x, loc, scale)):.1f} us a call, host clock, median of 50 "
          f"(numpy on the host: {median_us(lambda: numpy_z(x, loc, scale)):.1f} us)")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def binds(port: int) -> bool:
    """Whether a server could bind ``port`` now: with SO_REUSEADDR, as
    servers set it, which passes over TIME_WAIT but not over a listener."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


# -- the exporter as deployed: deploy/torch/{Dockerfile,exporter-daemonset.yaml} --

#: a child that loads the kernels with build_kernels(), launches each once on
#: cuda:0 at the main path's shapes and holds it to its plain version with
#: phase 3's tolerances; argv: rows cols block_rows.  Its first line names the
#: module it imported, before anything can fail.
KERNEL_CHILD = r"""
import json, sys
import torch
from tpudash_torch.ops import kernels
print(json.dumps({"module": kernels.__file__}), flush=True)
try:
    kernels._nvcc()
    nvcc = "reachable"
except RuntimeError:
    nvcc = None
took = kernels.build_kernels()
rows, cols, br = map(int, sys.argv[1:4])
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
x = torch.randn((rows, cols), generator=g, device=dev)
prev = torch.randn((1, cols), generator=g, device=dev)
got = kernels.hbm_read_pass(x, prev, br)
err = (got - kernels.hbm_read_pass_ref(x, prev)).abs()
depth = br + -(-rows // br) + 1
tol = 2 * depth * 2.0**-24 * (prev.abs() + x.abs().sum(0, keepdim=True))
copied = kernels.hbm_copy(x, torch.empty_like(x))
h = torch.randn((16 * 511, 1024), generator=g, device=dev).bfloat16()
scale = torch.ones(1024, device=dev)
y = kernels.rmsnorm_forward(h, scale)
dh, dscale = kernels.rmsnorm_backward(h, scale, h)
y_ref = kernels.rmsnorm_ref(h, scale).float()
ulp = torch.pow(2.0, torch.floor(torch.log2(y_ref.abs().clamp_min(2.0**-126))) - 7)
# the dispatch's six on a small layout: the first half of 64 x 3 rows valid
S, K, d, f = 64, 3, 64, 24
nv, cap = S * K // 2, S * K
pos = torch.randperm(cap, generator=g, device=dev).to(torch.int32).view(S, K)
n_valid = torch.tensor([nv], dtype=torch.int32, device=dev)
xm = torch.randn((S, d), generator=g, device=dev).bfloat16()
gm = torch.rand((S, K), generator=g, device=dev)
xs = kernels.moe_gather_forward(xm, pos, n_valid, cap)
dxm = kernels.moe_gather_backward(xs, pos, n_valid)
hm = torch.randn((cap, 2 * f), generator=g, device=dev).bfloat16()
act = kernels.moe_swiglu_forward(hm, n_valid)
dhm = kernels.moe_swiglu_backward(hm, act, n_valid)
ym = kernels.moe_combine_forward(xs, gm, pos, n_valid)
dys, dgm = kernels.moe_combine_backward(ym, xs, gm, pos, n_valid)
# MLA's two at B 2, T 5, H 4, nope 16, rope 8, v 16, r 32
qr = torch.randn((2, 5, 4, 24), generator=g, device=dev).bfloat16()
kvm = torch.randn((2, 5, 4, 32), generator=g, device=dev).bfloat16()
kva = torch.randn((2, 5, 40), generator=g, device=dev).bfloat16()
cs, sn = torch.rand((5, 8), generator=g, device=dev), torch.rand((5, 8), generator=g, device=dev)
qm, km = kernels.mla_rope_forward(qr, kvm, kva, cs, sn)
grads = kernels.mla_rope_backward(qm, km, kvm[..., 16:], cs, sn, 32)
torch.cuda.synchronize()
mla_ok = (all(torch.equal(a, b) for a, b in zip(
              (qm, km), kernels.mla_qk_rope_ref(qr, kvm, kva, cs, sn)))
          and all(torch.equal(a, b) for a, b in zip(
              grads, kernels.mla_rope_grads_ref(qm, km, kvm[..., 16:], cs, sn, 32))))
# KDA's four on one chunk of one head
qd, kdk = (torch.nn.functional.normalize(torch.randn((1, 1, 1, 64, 128), generator=g, device=dev),
                                         dim=-1) for _ in range(2))
Gd = (-torch.rand((1, 1, 1, 64, 128), generator=g, device=dev)).cumsum(-2)
pairs = kernels.kda_pairs_forward(qd, kdk, Gd)
dpairs = kernels.kda_pairs_backward(qd, kdk, Gd, *pairs)
gam = torch.rand((1, 1, 1, 128), generator=g, device=dev)
st = kernels.kda_state_forward(qd, kdk, Gd.exp(), gam)
dst = kernels.kda_state_backward(qd, Gd.exp(), gam, st[0], st[1])
torch.cuda.synchronize()
kda_ok = all(((a - b).abs().max() <= 1e-4 * b.abs().max()).item() for a, b in zip(
    (*pairs, *dpairs, *st, *dst),
    (*kernels.kda_pairs_ref(qd, kdk, Gd), *kernels.kda_pairs_grads_ref(qd, kdk, Gd, *pairs),
     *kernels.kda_state_ref(qd, kdk, Gd.exp(), gam),
     *kernels.kda_state_reverse_ref(qd, Gd.exp(), gam, st[0], st[1]))))
moe_ok = (torch.equal(xs[:nv], kernels.moe_gather_ref(xm, pos, n_valid, cap)[:nv])
          and torch.equal(dxm, kernels.moe_gather_grad_ref(xs, pos, n_valid))
          and torch.equal(ym, kernels.moe_combine_ref(xs, gm, pos, n_valid))
          and all(bool(torch.isfinite(t[:nv].float()).all()) for t in (act, dhm, dys))
          and bool(torch.isfinite(dgm).all()))
print(json.dumps({
    "nvcc": nvcc, "load_s": took, "libraries": [str(k.library_path) for k in kernels.KERNELS],
    "launches": kernels.launch_counts(), "read_err": err.max().item(),
    "read_ok": bool(torch.isfinite(got).all() and (err <= tol).all()),
    "copy_exact": torch.equal(copied, kernels.copy_ref(x)),
    "norm_ok": bool(((y.float() - y_ref).abs() <= ulp).all() and torch.isfinite(dscale).all()
                    and torch.isfinite(dh.float()).all()),
    "moe_ok": moe_ok, "mla_ok": mla_ok, "kda_ok": kda_ok,
}))
"""


def no_compiler_env(**extra: str) -> dict:
    """This environment with every PATH directory that holds nvcc dropped
    and CUDA_HOME pointed nowhere: kernels._nvcc() looks in PATH, then in
    $CUDA_HOME/bin, and finds nothing.  PYTHONPATH goes too, so a child
    imports the tree it is run over."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep) if d and not (Path(d) / "nvcc").exists())
    env["CUDA_HOME"] = "/nonexistent"
    env.update(extra)
    return env


def run_kernel_child(python: list, cwd: Path, shape: tuple) -> tuple[int, list, str]:
    """KERNEL_CHILD under ``python`` (argv prefix) from ``cwd`` with no
    compiler reachable: (exit code, its JSON lines, its stderr)."""
    r = subprocess.run([*python, "-c", KERNEL_CHILD, *map(str, shape)], cwd=cwd,
                       env=no_compiler_env(), capture_output=True, text=True, timeout=300)
    return r.returncode, [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")], r.stderr


def inside(path: str, tree: Path) -> bool:
    return Path(path).resolve().is_relative_to(tree.resolve())


def check_kernel_child(what: str, rc: int, out: list, err: str, tree: Path) -> dict:
    check(rc == 0 and len(out) == 2, f"{what}: exit {rc}\n{err[-3000:]}")
    got = {**out[0], **out[1]}
    check(inside(got["module"], tree), f"{what}: imported {got['module']}, not {tree}")
    check(got["nvcc"] is None, f"{what}: nvcc was reachable")
    check(all(inside(lib, tree) for lib in got["libraries"]),
          f"{what}: libraries {got['libraries']} outside {tree}")
    from tpudash_torch.ops import kernels

    check(got["launches"] == {k.name: 1 for k in kernels.KERNELS},
          f"{what}: launches {got['launches']}")
    check(got["norm_ok"], f"{what}: the norm's forward off its plain version")
    check(got["moe_ok"], f"{what}: a dispatch kernel off its plain version")
    check(got["mla_ok"], f"{what}: an MLA kernel off its plain version")
    check(got["kda_ok"], f"{what}: a KDA kernel off its plain version")
    check(got["read_ok"], f"{what}: hbm_read max err {got['read_err']:.3e} above its tolerance")
    check(got["copy_exact"], f"{what}: hbm_copy not exact")
    return got


def copy_tree(dst: Path) -> Path:
    """tpudash_torch/ under ``dst`` without its build directory."""
    shutil.copytree(ROOT / "tpudash_torch", dst / "tpudash_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    return dst


def prebuilt_phase(card: str, shape: tuple, tmp: Path) -> None:
    """3a: the runtime image's premise.  A fresh process that cannot reach
    nvcc loads phase 2's libraries, launches each kernel once and matches
    its plain version; the same process over a copy of the package with an
    empty build directory fails for want of nvcc."""
    t0 = time.perf_counter()
    got = check_kernel_child("prebuilt libraries", *run_kernel_child([sys.executable], ROOT, shape),
                             ROOT / "tpudash_torch")
    rc, out, err = run_kernel_child([sys.executable], copy_tree(tmp / "empty_build"), shape)
    check(rc != 0 and "nvcc not found" in err,
          f"negative control: exit {rc} without 'nvcc not found':\n{err[-2000:]}")
    check(bool(out) and inside(out[0]["module"], tmp / "empty_build"),
          f"negative control imported {out[:1]}")
    took = time.perf_counter() - t0
    print(f"3a prebuilt kernels, no compiler [{card}]: a fresh process with nvcc off PATH and "
          f"CUDA_HOME=/nonexistent loaded {len(got['libraries'])} libraries in {got['load_s']:.3f} s, "
          f"launched {got['launches']} on cuda:0 at {shape[0]}x{shape[1]}: read max_abs_err "
          f"{got['read_err']:.3e} within tolerance, copy exact; negative control over an empty "
          f"build directory: exit {rc}, 'nvcc not found'; phase {took:.1f} s")


def dockerfile_build_script() -> tuple[str, list]:
    """The Python the image's build stage runs after ``pip install .``
    (deploy/torch/Dockerfile's ``python -P - <<'EOF'`` block), and the
    sources of the build stage's COPY lines."""
    text = (ROOT / "deploy" / "torch" / "Dockerfile").read_text()
    build = text.split("\nFROM ")[1]
    script = build.split("python -P - <<'EOF'\n", 1)[1].split("\nEOF\n", 1)[0]
    sources = [src for line in build.splitlines() if line.startswith("COPY ")
               for src in line.split()[1:-1]]
    return script, sources


def readelf_needed(lib: str) -> "list[str] | None":
    try:
        out = subprocess.run(["readelf", "-d", lib], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return re.findall(r"\(NEEDED\)\s+Shared library: \[([^\]]+)\]", out)


def lock_pins(path: Path) -> dict:
    pins = {}
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            name, version = line.split("==")
            pins[name] = version
    return pins


def link_distributions(purelib: Path, names: list) -> dict:
    """Symlink every file of each named distribution, as this host installed
    it, into ``purelib``: the venv then holds those distributions and
    nothing else of the host's.  Returns ``{name: version}`` as installed."""
    from importlib import metadata

    versions = {}
    for name in names:
        dist = metadata.distribution(name)
        check(dist.files is not None, f"{name}: no RECORD to link it from")
        versions[name] = dist.version
        for f in dist.files:
            if f.parts[0] == "..":  # scripts and data outside site-packages
                continue
            dst = purelib / f
            if not dst.exists():
                dst.parent.mkdir(parents=True, exist_ok=True)
                dst.symlink_to(Path(dist.locate_file(f)).resolve())
    return versions


def image_build_phase(card: str, shape: tuple, tmp: Path) -> Path:
    """3b: the image's build stage on this host, with no GPU visible.  A
    venv gets the distributions deploy/torch/requirements.lock names, linked
    from this host's install (the lock was generated on such a host), and
    pip; the build stage's COPY sources go to ``src`` and install into the
    venv with ``--no-deps --no-build-isolation``; the Dockerfile's own build
    script runs there under ``python -P`` with CUDA_VISIBLE_DEVICES="".  Then
    a process with no compiler loads what it built, as the runtime stage
    does.  Returns the venv."""
    from tpudash_torch.ops import kernels

    t0 = time.perf_counter()
    script, sources = dockerfile_build_script()
    pins = lock_pins(ROOT / "deploy" / "torch" / "requirements.lock")
    src, venv = tmp / "src", tmp / "venv"
    src.mkdir()
    for name in sources:
        if (ROOT / name).is_dir():
            shutil.copytree(ROOT / name, src / name, ignore=shutil.ignore_patterns("build", "__pycache__"))
        else:
            shutil.copy(ROOT / name, src)
    subprocess.run([sys.executable, "-m", "venv", "--without-pip", str(venv)], check=True, timeout=120)
    py = venv / "bin" / "python"
    purelib = Path(subprocess.run([py, "-c", "import sysconfig; print(sysconfig.get_path('purelib'))"],
                                  capture_output=True, text=True, check=True).stdout.strip())
    installed = link_distributions(purelib, [*pins, "pip"])
    differ = {n: (installed[n], v) for n, v in pins.items() if installed[n] != v}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([py, "-m", "pip", "install", "-q", "--no-deps", "--no-build-isolation", "--no-index",
                    "."], cwd=src, env=env, check=True, timeout=300)
    t_build = time.perf_counter()
    r = subprocess.run([py, "-P", "-"], input=script, cwd=src, env={**env, "CUDA_VISIBLE_DEVICES": ""},
                       capture_output=True, text=True, timeout=600)
    build_s = time.perf_counter() - t_build
    check(r.returncode == 0,
          f"the Dockerfile's build script: exit {r.returncode}\n{r.stdout}{r.stderr[-3000:]}")
    libs = sorted((purelib / "tpudash_torch" / "ops" / "build").glob("*.so"))
    stems = {k.source.stem for k in kernels.KERNELS}
    check(len(libs) == len(stems) and {lib.name.rsplit("-", 1)[0][3:] for lib in libs} == stems,
          f"the build script left {[lib.name for lib in libs]}, not one library of each of {stems}")
    needed = {lib.name: readelf_needed(str(lib)) for lib in libs}
    check(not any("libcuda.so" in n for v in needed.values() if v for n in v),
          f"a kernel library needs the driver at load time: {needed}")
    got = check_kernel_child("the image's libraries", *run_kernel_child([str(py), "-P"], tmp, shape),
                             purelib / "tpudash_torch")
    took = time.perf_counter() - t0
    print(f"3b image build stage, no GPU [{card}]: a venv of the lock's {len(pins)} distributions "
          f"and pip (this host's install; versions that differ from the lock: {differ or 'none'}); "
          f"pip install --no-deps of {' '.join(sources)}, then deploy/torch/Dockerfile's build "
          f"script under python -P with CUDA_VISIBLE_DEVICES='' in {build_s:.1f} s: exit 0, "
          f"{[lib.name for lib in libs]} in site-packages; NEEDED "
          f"{needed if all(needed.values()) else 'not checked (no readelf)'}; a process with no "
          f"compiler loaded them and matched the plain versions (read max_abs_err "
          f"{got['read_err']:.3e}); phase {took:.1f} s")
    return venv


#: seconds the manifest's exporter may take to exit after SIGTERM: well
#: inside Kubernetes' default grace period of 30 s before its SIGKILL
SIGTERM_EXIT_S = 10.0


def manifest_phase(card: str, venv: Path, tmp: Path) -> None:
    """3c: the DaemonSet's container as Kubernetes starts it: its command
    and env from deploy/torch/exporter-daemonset.yaml, resolved in the venv
    of 3b (the lock's distributions only) with no compiler reachable, on a
    free port.  /healthz 200, then /metrics 200 with every tpu_* series for
    every GPU; SIGTERM ends it within SIGTERM_EXIT_S with exit 0, no process
    of its group left, the port free."""
    import signal
    import urllib.error
    import urllib.request

    import torch
    import yaml

    from tpudash_torch.schema import (HBM_BANDWIDTH, HBM_TOTAL, HBM_USED, ICI_LINK_SERIES, ICI_RX,
                                      ICI_TX, TENSORCORE_UTIL)

    t0 = time.perf_counter()
    manifest = yaml.safe_load((ROOT / "deploy" / "torch" / "exporter-daemonset.yaml").read_text())
    (container,) = manifest["spec"]["template"]["spec"]["containers"]
    command = container["command"]
    port = free_port()
    manifest_env = {e["name"]: e["value"] for e in container["env"]}
    env = no_compiler_env(**{**manifest_env, "TPUDASH_EXPORTER_PORT": str(port)})
    env["PATH"] = os.pathsep.join([str(venv / "bin"), env["PATH"]])
    exe = shutil.which(command[0], path=env["PATH"])
    check(exe is not None and Path(exe).parent == venv / "bin", f"{command[0]} resolves to {exe}")
    n_dev = torch.cuda.device_count()
    series = [TENSORCORE_UTIL, HBM_USED, HBM_TOTAL, HBM_BANDWIDTH]
    if n_dev > 1:
        series += [ICI_TX, ICI_RX, ICI_LINK_SERIES["xp"], ICI_LINK_SERIES["xn"]]
    log = tmp / "exporter.log"
    url = f"http://127.0.0.1:{port}"

    def get(path: str, timeout: float) -> tuple[int, str]:
        try:
            with urllib.request.urlopen(url + path, timeout=timeout) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    with open(log, "w") as out:
        proc = subprocess.Popen(command, env=env, cwd=tmp, stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            check(proc.poll() is None, f"the exporter exited {proc.returncode}:\n"
                  f"{log.read_text()[-3000:]}")
            try:
                status, body = get("/healthz", 5)
                break
            except OSError:
                check(time.monotonic() < deadline, "no /healthz within 120 s")
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        check(status == 200 and json.loads(body)["ok"], f"/healthz {status} {body}")
        status, text = get("/metrics", 300)  # waits for the warm-up's probe batch
        metrics_s = time.perf_counter() - t0
        check(status == 200, f"/metrics {status}: {text[:500]}")
        for name in series:
            ids = sorted(int(m) for m in re.findall(rf'^{name}{{[^}}]*chip_id="(\d+)"', text, re.M))
            check(ids == list(range(n_dev)), f"/metrics: {name} for chip_ids {ids}, not 0..{n_dev - 1}")
        exported = sorted({ln.split("{", 1)[0] for ln in text.splitlines() if ln.startswith("tpu_")})
        check(set(exported) == set(series), f"/metrics exports {exported}")
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=SIGTERM_EXIT_S)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"the exporter outlived SIGTERM by {SIGTERM_EXIT_S} s") from None
        exit_s = time.perf_counter() - t_term
        check(rc == 0, f"exit {rc} after SIGTERM:\n{log.read_text()[-3000:]}")
        try:
            os.killpg(proc.pid, 0)
        except ProcessLookupError:
            pass
        else:
            raise SmokeFailure("a process of the exporter's group outlived it")
        check(binds(port), f"port {port} still bound after the exporter exited")
    finally:
        with contextlib.suppress(ProcessLookupError):  # the group is gone when all went well
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    print(f"3c the DaemonSet's exporter [{card}]: {command} with "
          f"{manifest_env} from the manifest, TPUDASH_EXPORTER_PORT={port}, via {exe}, no "
          f"compiler reachable: /healthz 200 after {up_s:.1f} s, /metrics 200 after {metrics_s:.1f} s "
          f"with {len(series)} tpu_* series for each of {n_dev} GPU(s); SIGTERM -> exit 0 in "
          f"{exit_s:.2f} s (bound {SIGTERM_EXIT_S:.0f} s), no process of its group left, port free; "
          f"phase {time.perf_counter() - t0:.1f} s")


def demo_phase(card: str) -> None:
    """``python -m tpudash_torch.demo``'s path: start_demo at the exporter's
    defaults on free ports, the dashboard child's first frame, and nothing
    left running after close.  The child (the reference dashboard, run as
    ``python -m tpudash``) needs pandas, aiohttp and requests; without one,
    only the exporter half runs."""
    import importlib.util
    import os

    import aiohttp
    import torch

    from tpudash_torch import demo
    from tpudash_torch.config import Config
    from tpudash_torch.exporter.server import make_app
    from tpudash_torch.schema import HBM_BANDWIDTH, HBM_TOTAL, HBM_USED, TENSORCORE_UTIL

    port, exporter_port = free_port(), free_port()
    cfg = Config(host="127.0.0.1", port=port, exporter_port=exporter_port)
    exporter_cfg, env = demo.demo_configs(cfg)
    check(exporter_cfg.source == "probe", f"demo source {exporter_cfg.source}")
    check(env["TPUDASH_SCRAPE_URL"] == f"http://127.0.0.1:{exporter_port}/metrics", f"env {env}")
    n_dev = torch.cuda.device_count()
    missing = [m for m in ("pandas", "aiohttp", "requests") if importlib.util.find_spec(m) is None]

    async def metrics(session) -> str:
        async with session.get(f"http://127.0.0.1:{exporter_port}/metrics") as r:
            check(r.status == 200, f"demo exporter /metrics {r.status}")
            text = await r.text()
        for series in (TENSORCORE_UTIL, HBM_USED, HBM_TOTAL, HBM_BANDWIDTH):
            lines = [ln for ln in text.splitlines() if ln.startswith(series + "{")]
            check(len(lines) == n_dev, f"demo /metrics: {len(lines)} lines of {series}")
        return text

    async def exporter_only() -> float:
        from aiohttp import web

        t0 = time.perf_counter()
        runner = web.AppRunner(make_app(exporter_cfg))
        await runner.setup()
        try:
            await web.TCPSite(runner, exporter_cfg.host, exporter_port).start()
            async with aiohttp.ClientSession() as s:
                await metrics(s)
            return time.perf_counter() - t0
        finally:
            await runner.cleanup()

    async def whole() -> tuple:
        # the child runs `python -m tpudash` from this checkout
        os.environ["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p)
        t0 = time.perf_counter()
        d = await demo.start_demo(cfg)
        try:
            started = time.perf_counter() - t0
            async with aiohttp.ClientSession() as s:
                await metrics(s)
                deadline = time.monotonic() + 60
                errors = []  # the frames before the first good one
                while True:
                    async with s.get(f"{d.dashboard_url}/api/frame") as r:
                        check(r.status == 200, f"dashboard /api/frame {r.status}")
                        frame = json.loads(await r.text())
                    if frame["error"] is None or time.monotonic() > deadline:
                        break
                    errors.append(frame["error"])
                    await asyncio.sleep(0.5)
            first_frame = time.perf_counter() - t0
        finally:
            await d.close()
        if errors:
            print(f"  {len(errors)} frame(s) with an error before the first good one; the first: "
                  f"{errors[0][:300]}")
        check(frame["error"] is None, f"dashboard frame error: {frame['error']}")
        check(len(frame["chips"]) == n_dev, f"dashboard shows {len(frame['chips'])} chips, "
              f"not {n_dev}")
        check(d.dashboard.returncode is not None and not os.path.exists(f"/proc/{d.dashboard.pid}"),
              "the dashboard child was not reaped")
        return started, first_frame, len(frame["chips"])

    if missing:
        print(f"demo dashboard child: NOT RUN ({', '.join(missing)} absent on this machine)")
        took = asyncio.run(exporter_only())
        print(f"demo exporter half [{card}]: demo_configs -> probe, scrape URL {env['TPUDASH_SCRAPE_URL']}; "
              f"the exporter on :{exporter_port} served /metrics (200, every tpu_* series for "
              f"{n_dev} GPU(s)) {took:.2f} s after its start")
    else:
        started, first_frame, chips = asyncio.run(whole())
        print(f"demo [{card}]: start_demo up (exporter + dashboard child healthy) in {started:.2f} s; "
              f"time to first frame {first_frame:.2f} s, {chips} chip(s), no error; "
              f"closed, child reaped")
    check(binds(port) and binds(exporter_port), "a demo port is still bound after close")


def _trace_events(trace_dir: str) -> tuple[list, float]:
    import os
    import shutil

    path = os.path.join(trace_dir, "trace.json")
    try:
        size_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            return json.load(f)["traceEvents"], size_mb
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)


def trace_phase(dev, card: str) -> None:
    """``POST /api/profile {"device": true}`` on the port's exporter: with
    the workload training at its defaults on ``dev`` (the trace holds CUDA
    kernels and the ``tpudash-workload`` thread's aten ops; a second request
    meanwhile gets 409), then with the probe source while /metrics is
    scraped (the trace names the hbm_read kernels)."""
    import collections
    import threading

    from aiohttp.test_utils import TestClient, TestServer

    from tpudash_torch.config import Config
    from tpudash_torch.exporter.server import WARMUP_TASK, make_app
    from tpudash_torch.sources.workload import WORKLOAD_LOSS

    async def trace(client, seconds: float, during=None) -> tuple:
        t0 = time.perf_counter()
        task = asyncio.ensure_future(
            client.post("/api/profile", json={"device": True, "seconds": seconds}))
        if during is not None:
            await during()
        resp = await task
        wall = time.perf_counter() - t0
        check(resp.status == 200, f"/api/profile {resp.status}: {await resp.text()}")
        body = await resp.json()
        check(body["mode"] == "device" and body["seconds"] == seconds, f"/api/profile {body}")
        events, size_mb = _trace_events(body["trace_dir"])
        return events, size_mb, wall

    def summary(events) -> str:
        cats = collections.Counter(e.get("cat", e.get("ph")) for e in events)
        return ", ".join(f"{k} {v}" for k, v in cats.most_common())

    async def workload():
        client = TestClient(TestServer(make_app(Config(source="workload"), device=dev)))
        await client.start_server()
        try:
            await client.app[WARMUP_TASK]
            deadline = time.monotonic() + 120
            while f"\n{WORKLOAD_LOSS}{{" not in await (await client.get("/metrics")).text():
                check(time.monotonic() < deadline, "the workload produced no loss in 120 s")
                await asyncio.sleep(0.05)
            tids = {t.native_id for t in threading.enumerate() if t.name == "tpudash-workload"}

            async def second():
                await asyncio.sleep(0.5)
                resp = await client.post("/api/profile", json={"device": True, "seconds": 0.1})
                check(resp.status == 409, f"a second trace meanwhile got {resp.status}, not 409")

            return (*await trace(client, 2.0, second), tids)
        finally:
            await client.close()

    events, size_mb, wall, tids = asyncio.run(workload())
    kernels_ = [e for e in events if e.get("cat") == "kernel"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("tid") in tids
           and e["name"].startswith("aten::")]
    check(len(kernels_) > 0, "the workload trace holds no CUDA kernel")
    check(len(ops) > 0, "the workload trace holds no aten op of the tpudash-workload thread")
    print(f"trace, workload at its defaults on {dev} [{card}]: 2 s window took {wall:.2f} s "
          f"(profiler start included), {size_mb:.1f} MB, {len(events)} events: {summary(events)}; "
          f"{len(kernels_)} CUDA kernels, {len(ops)} aten ops on the tpudash-workload thread; "
          f"a second request meanwhile: 409")

    async def probe():
        # probe_heavy_interval 0: each scrape with no batch in flight starts a
        # probe batch on a background thread, so the window holds one
        cfg = Config(source="probe", extra={"probe_heavy_interval": 0.0})
        client = TestClient(TestServer(make_app(cfg, device=dev)))
        await client.start_server()
        try:
            await client.app[WARMUP_TASK]

            async def scrape():
                for _ in range(3):
                    await asyncio.sleep(0.4)
                    resp = await client.get("/metrics")
                    check(resp.status == 200, f"/metrics during the trace: {resp.status}")

            return await trace(client, 2.0, scrape)
        finally:
            await client.close()

    events, size_mb, wall = asyncio.run(probe())
    names = collections.Counter(e["name"] for e in events if e.get("cat") == "kernel")
    # hbm_read.cu's two kernels
    read = {k: sum(c for n, c in names.items() if k in n)
            for k in ("column_partials", "finish_columns")}
    check(all(read.values()), f"the probe trace names no hbm_read kernel: {names.most_common(8)}")
    print(f"trace, probe source on {dev} with /metrics scraped in the window [{card}]: {wall:.2f} s, "
          f"{size_mb:.1f} MB, {len(events)} events: {summary(events)}; hbm_read kernels {read}")


#: the profiler's names of the copies between GPUs and within one
COPY_KINDS = ("PtoP", "DtoD")
#: the CUDA runtime and driver calls that put work on a stream: a host op
LAUNCH_CALLS = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch|Memcpy\w*Async|Memset\w*Async)")


def start_device_tracing() -> None:
    """One profiler window over one small kernel, which starts the
    profiler's device tracing in this process.  Call it before any graph is
    captured: in a process whose first window came after the capture, a
    graphed step's copies read 0.003 ms a step on an H100 where a process
    that had profiled first read 6.8 ms for the same step, its kernels
    alike."""
    import torch

    profile_steps(lambda: torch.ones(8, device="cuda").add_(1), 1)


def profile_steps(fn, n: int):
    """(device ms per call of each GPU, by index: the CUDA kernels' and
    copies' own time, the GPU-side ranges of annotations such as
    ``Optimizer.step`` left out; the kernels by device ms per call, largest
    first; device kernels and copies per call; host launch calls per call:
    kernel launches, async copies and sets, graph launches; each kind of
    :data:`COPY_KINDS` by device ms per call of each GPU, that of the stream
    that ran it) of ``n`` calls of ``fn`` under torch.profiler; (None, [],
    0, 0, {}) when it records no device time.  A busy share divides the
    device ms by a step time taken without the profiler, whose own host
    cost would stretch a host-bound step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    def on_device(e) -> bool:
        return (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False))

    per_device: dict = {}
    copies: dict = {kind: {} for kind in COPY_KINDS}
    for e in filter(on_device, prof.events()):
        ms = e.self_device_time_total / n / 1e3
        per_device[e.device_index] = per_device.get(e.device_index, 0.0) + ms
        for kind, by_gpu in copies.items():
            if f"Memcpy {kind}" in e.name:
                by_gpu[e.device_index] = by_gpu.get(e.device_index, 0.0) + ms
    if not per_device:
        return None, [], 0, 0, {}
    averages = prof.key_averages()
    events = sorted(filter(on_device, averages), key=lambda e: -e.self_device_time_total)
    return (dict(sorted(per_device.items())), [(e.key, e.self_device_time_total / n / 1e3) for e in events],
            sum(e.count for e in events) / n,
            sum(e.count for e in averages if LAUNCH_CALLS.match(e.key)) / n,
            {kind: {i: by_gpu.get(i, 0.0) for i in sorted(per_device)} for kind, by_gpu in copies.items()})


#: the norm's widths on the card: the workload's defaults (and the MoE's and
#: pipeline's at them), the dry run's, WorkloadConfig's default; then the
#: edges of the kernels' plan (a team of 1, 2, 4 and 8 warps, ragged vectors)
NORM_WIDTHS = (1024, 64, 256)
NORM_EDGE_WIDTHS = (8, 24, 1000, 1032, 2048, 2056, 4104, 8192)
#: the norm's dscale against autograd of the plain forward: max |a − b| over
#: max |b|.  The two add the same f32 terms in other orders.
NORM_DSCALE_RTOL = 1e-5


def trains_norms_only(counts: dict) -> bool:
    """A training path's launches: the norm's kernels, forward and
    backward, and no probe kernel."""
    return (counts["hbm_read"] == counts["hbm_copy"] == 0
            and counts["rmsnorm_fwd"] > 0 and counts["rmsnorm_bwd"] > 0)


def norm_plain_grads(x, scale, g) -> tuple:
    """Autograd of the norm's plain forward: (y, dx, dscale)."""
    import torch

    from tpudash_torch.ops import kernels

    xr = x.detach().clone().requires_grad_(True)
    sr = scale.detach().clone().requires_grad_(True)
    y = kernels.rmsnorm_ref(xr, sr)
    dx, ds = torch.autograd.grad(y, (xr, sr), g)
    return y, dx, ds


def norm_check(x, scale, g, label: str) -> dict:
    """The norm kernels against autograd of the plain forward on (x, scale,
    g): y within one bf16 ulp of the plain value; dx within one ulp plus
    the f32 noise of its two terms, r·g·s and r·x̂·mean, which cancel where
    dx is small (8 f32 units of each, and of mean's sum over the row in any
    order, d·2^-24·Σ|g·s·x̂|/d, once for each of the two computations);
    dscale within NORM_DSCALE_RTOL; a second backward gives the same bits."""
    import torch

    from tpudash_torch.ops import kernels

    y = kernels.rmsnorm_forward(x, scale)
    dx, ds = kernels.rmsnorm_backward(x, scale, g)
    dx2, ds2 = kernels.rmsnorm_backward(x, scale, g)
    y_p, dx_p, ds_p = norm_plain_grads(x, scale, g)
    torch.cuda.synchronize()
    x32, g32 = x.float(), g.float()
    r = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + kernels.NORM_EPS)
    xh = x32 * r
    gs = g32 * scale
    mean = (gs * xh).sum(-1, keepdim=True) / x.shape[-1]
    terms = (gs * xh).abs().sum(-1, keepdim=True)
    noise = F32_U * r * (8 * gs.abs() + xh.abs() * (8 * mean.abs() + 2 * terms))
    y_err = ((y.float() - y_p.float()).abs() / _ulp_bf16(y_p.float())).max().item()
    dx_tol = _ulp_bf16(dx_p.float()) + noise
    dx_err = ((dx.float() - dx_p.float()).abs() / dx_tol).max().item()
    dx_ulps = ((dx.float() - dx_p.float()).abs() / _ulp_bf16(dx_p.float())).max().item()
    ds_err = ((ds - ds_p).abs().max() / ds_p.abs().max()).item()
    check(bool(torch.isfinite(y.float()).all() and torch.isfinite(dx.float()).all()
               and torch.isfinite(ds).all()), f"norm {label}: non-finite output")
    check(y_err <= 1.0, f"norm {label}: y {y_err:.3f} bf16 ulps from the plain version")
    check(dx_err <= 1.0, f"norm {label}: dx {dx_err:.3f} of its tolerance from the plain version")
    check(ds_err <= NORM_DSCALE_RTOL, f"norm {label}: dscale relative error {ds_err:.3e}")
    check(torch.equal(ds, ds2) and torch.equal(dx, dx2), f"norm {label}: two backwards differ")
    return {"y_ulps": y_err, "dx_ulps": dx_ulps, "dx_of_tol": dx_err, "dscale_rel": ds_err}


def norm_counts(devices: list, gen_seed: int = SEED) -> dict:
    """launch_counts() over the first call of the compiled dp 1 × tp n step
    at the workload's defaults on ``devices`` (its two eager warm-up steps
    and its capture), then over one replay; with the expected counts a
    device a step: 4·L + 1 forward (each block's two norms, again in the
    recompute, and ln_f), 2·L + 1 backward."""
    import torch

    from tpudash_torch.models import graphed
    from tpudash_torch.models import workload as W
    from tpudash_torch.ops import kernels
    from tpudash_torch.parallel.mesh import build_mesh

    cfg = W.WorkloadConfig(**WORKLOAD_DEFAULTS)
    n = len(devices)
    mesh = build_mesh({"dp": 1, "tp": n}, devices)
    gen_t = torch.Generator(device=devices[0]).manual_seed(gen_seed)
    params = W.init_params(cfg, gen_t)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=gen_t, device=devices[0])
    step, shard_inputs = W.make_sharded_train_step(mesh, cfg)
    state, opt = shard_inputs(params, None)
    kernels.reset_launch_counts()
    step(state, opt, tokens)
    first = kernels.launch_counts()
    kernels.reset_launch_counts()
    step(state, opt, tokens)
    torch.cuda.synchronize()
    replay = kernels.launch_counts()
    steps = graphed.WARMUP_STEPS + 1
    want = {"rmsnorm_fwd": 4 * cfg.n_layers + 1, "rmsnorm_bwd": 2 * cfg.n_layers + 1}
    got = {k: first[k] / (steps * n) for k in want}
    check(got == want, f"norm launches a device a step over the first call {got}, want {want} "
          f"(counts {first} over {steps} steps on {n} devices)")
    check(all(v == 0 for v in replay.values()), f"a replay launched from the host: {replay}")
    del state, opt, step
    return {"per_device_step": got, "first_call": first, "replay": replay, "devices": n}


def norm_phase(devices: list, card: str, gen, label: str, timing: bool = True) -> dict:
    """The norm kernels on ``devices[0]`` against autograd of the plain
    forward at the tp step's (16·511, 1024), at every other width the port
    runs on the card and at the plan's edges; the autograd function
    against the wrappers and, captured in a CUDA graph, against eager; the
    launches of one capture of the dp 1 × tp n step over ``devices``; with
    ``timing``, each kernel's time beside the plain chain, the library's
    ``torch.nn.functional.rms_norm`` (a yardstick: the port never calls it)
    and the bound of the bytes it must move."""
    import torch
    import torch.nn.functional as F

    from tpudash_torch.ops import kernels

    dev = devices[0]
    rng = torch.Generator(device=dev).manual_seed(SEED + 16)

    def inputs(rows: int, d: int, scale_ones: bool = False) -> tuple:
        x = torch.randn((rows, d), generator=rng, device=dev).bfloat16()
        s = (torch.ones(d, device=dev) if scale_ones
             else 1 + 0.1 * torch.randn(d, generator=rng, device=dev))
        g = torch.randn((rows, d), generator=rng, device=dev).bfloat16()
        return x, s, g

    rows = 16 * 511
    results = {}
    for d in NORM_WIDTHS:
        results[f"{rows}x{d}"] = norm_check(*inputs(rows, d), f"({rows}, {d})")
    results[f"{rows}x1024 ones"] = norm_check(*inputs(rows, 1024, True), f"({rows}, 1024) ones")
    for r, d in [(1, 1024), (7, 1024), (3000, 1024)] + [(1000, d) for d in NORM_EDGE_WIDTHS]:
        results[f"{r}x{d}"] = norm_check(*inputs(r, d), f"({r}, {d})")
    # the autograd function on a 3-D x, against the wrappers, eager and graphed
    x, s, g = inputs(rows, 1024)
    x3, g3 = x.view(16, 511, 1024), g.view(16, 511, 1024)
    xr, sr = x3.clone().requires_grad_(True), s.clone().requires_grad_(True)
    y = kernels.rmsnorm(xr, sr)
    y.backward(g3)
    want_y = kernels.rmsnorm_forward(x3, s)
    want_dx, want_ds = kernels.rmsnorm_backward(x3, s, g3)
    check(torch.equal(y, want_y) and torch.equal(xr.grad, want_dx) and torch.equal(sr.grad, want_ds),
          "norm: the autograd function differs from its kernels")
    del xr, sr, y
    # captured as a whole network is: fresh leaves, warmed up on a side
    # stream, then one capture of forward and backward
    xg, sg = x3.clone().requires_grad_(True), s.clone().requires_grad_(True)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            torch.autograd.grad(kernels.rmsnorm(xg, sg), (xg, sg), g3)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg = kernels.rmsnorm(xg, sg)
        dxg, dsg = torch.autograd.grad(yg, (xg, sg), g3)
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(yg, want_y) and torch.equal(dxg, want_dx) and torch.equal(dsg, want_ds),
          "norm: the graphed function differs from eager")
    del graph, xg, sg, yg, dxg, dsg
    worst = {k: max(v[k] for v in results.values())
             for k in ("y_ulps", "dx_ulps", "dx_of_tol", "dscale_rel")}
    print(f"norm kernels vs autograd of the plain forward ({label}) [{card}]: "
          f"{len(results)} shapes, widths {sorted({int(k.split('x')[1].split()[0]) for k in results})}; "
          f"worst y {worst['y_ulps']:.3f} ulp, dx {worst['dx_ulps']:.3f} ulp "
          f"({worst['dx_of_tol']:.3f} of its tolerance), dscale rel {worst['dscale_rel']:.3e}; "
          "two backwards bitwise equal; the autograd function bitwise its kernels, eager and graphed")
    out = {"checks": results, "worst": worst}
    # a launch on another GPU leaves the caller's current device as it was
    # (the kernels' library runs its own CUDA runtime on the same context)
    for other in dict.fromkeys(devices):
        with torch.cuda.device(dev):
            xo = torch.ones((16, 64), device=other, dtype=torch.bfloat16)
            so = torch.ones(64, device=other)
            kernels.rmsnorm_backward(xo, so, kernels.rmsnorm_forward(xo, so))
            check(torch.cuda.current_device() == dev.index,
                  f"norm on {other} left the current device at {torch.cuda.current_device()}")
    out["counts"] = counts = norm_counts(devices)
    print(f"norm launches over the first call of the dp 1 x tp {counts['devices']} step ({label}): "
          f"{counts['first_call']}, a device a step {counts['per_device_step']}; a replay "
          f"{counts['replay']}")
    if not timing:
        return out
    d = 1024
    x, s, g = inputs(rows, d)
    s16 = s.bfloat16()
    xp, sp = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    yp = kernels.rmsnorm_ref(xp, sp)
    xl, sl = x.clone().requires_grad_(True), s16.clone().requires_grad_(True)
    yl = F.rms_norm(xl, (d,), sl, kernels.NORM_EPS)
    fns = {
        "forward": {"kernel": lambda: kernels.rmsnorm_forward(x, s),
                    "plain": lambda: kernels.rmsnorm_ref(x, s),
                    "library": lambda: F.rms_norm(x, (d,), s16, kernels.NORM_EPS)},
        "backward": {"kernel": lambda: kernels.rmsnorm_backward(x, s, g),
                     "plain": lambda: torch.autograd.grad(yp, (xp, sp), g, retain_graph=True),
                     "library": lambda: torch.autograd.grad(yl, (xl, sl), g, retain_graph=True)},
    }
    hbm = gen.hbm_gbps * 1e9
    nbytes = {"forward": 2 * 2 * rows * d + 4 * d, "backward": 3 * 2 * rows * d + 2 * 4 * d}
    # L2 (50 MB) emptied of x and g before each call by a read of 256 MiB
    flush = torch.ones(64 * 2**20, device=dev)
    flush_ms = graph_ms(lambda: flush.sum(), dev)
    out["timing"] = {"shape": [rows, d]}
    for side, f in fns.items():
        kernel = f["kernel"]
        t = {f"{k}_device": device_ms(fn) for k, fn in f.items()}
        t.update({f"{k}_events": v for k, v in cuda_ms(dict(f)).items()})
        t["kernel_graph"] = graph_ms(kernel, dev)
        t["kernel_cold"] = graph_ms(lambda kernel=kernel: (flush.sum(), kernel()), dev) - flush_ms
        t["bound_ms"] = nbytes[side] / hbm * 1e3
        out["timing"][side] = t
        print(f"norm {side} at ({rows}, {d}) bf16 [{card}]: kernel {t['kernel_graph'] * 1e3:.2f} us "
              f"a call in a CUDA graph, {t['kernel_cold'] * 1e3:.2f} us with L2 emptied before each "
              f"(bound {t['bound_ms'] * 1e3:.2f} us of bytes: {100 * t['bound_ms'] / t['kernel_cold']:.2f} "
              f"% of it cold); device time (profiler): kernel {t['kernel_device'] * 1e3:.2f} us, plain "
              f"{t['plain_device'] * 1e3:.2f} us, library (F.rms_norm, bf16 scale) "
              f"{t['library_device'] * 1e3:.2f} us; events a call (host-paced): kernel "
              f"{t['kernel_events'] * 1e3:.2f}, plain {t['plain_events'] * 1e3:.2f}, library "
              f"{t['library_events'] * 1e3:.2f} us")
    return out


#: the DeepSeek-V2-Lite cell's MoE dispatch: 8 sequences of 4,095 positions,
#: top-6 of 64 routed experts with 8 held, d 2048, expert width 1,408
MOE_DISPATCH_SHAPE = dict(S=8 * 4095, top_k=6, n_experts=64, held=8, d=2048, f=1408)
#: the dispatch kernels' launches a MoE layer a train step: gather, SwiGLU
#: and combine forward, again in the recompute, and their three backwards
MOE_LAUNCHES_A_LAYER = 9
#: the gates' gradient against the plain version: |a − b| over Σ|terms|
#: (two orders of the same f32 dot product of width d)
MOE_DGATE_RTOL = 2.0**-18


def moe_dispatch_layout(dev, seed: int, shape: "dict | None" = None) -> dict:
    """The cell's routing on ``dev``: softmax of N(0, 1) router logits with
    expert e's raised by 0.1·ln(E / (r + 1)), r its rank (skewed, as the
    cell's Zipf tokens skew it), the top-6 by ``moe._top_k``, the first 8
    experts held; their ranks spread evenly over the E, so that they take
    about their share of the choices, 8/64 in the cell, unevenly among
    them; with ``dispatch_layout``'s pos, offsets and valid count."""
    import torch

    from tpudash_torch.models import deepseek_v2 as D
    from tpudash_torch.models import moe

    sh = dict(MOE_DISPATCH_SHAPE, **(shape or {}))
    S, K, E, n = sh["S"], sh["top_k"], sh["n_experts"], sh["held"]
    rng = torch.Generator(device=dev).manual_seed(seed)
    e = torch.arange(E, device=dev)
    rank = (e * n) % E + e * n // E
    bias = 0.1 * torch.log(E / (rank + 1).float())
    logits = torch.randn((S, E), generator=rng, device=dev) + bias
    gates, experts = moe._top_k(torch.softmax(logits, -1), K)
    slot_of = torch.full((E,), n, dtype=torch.int64, device=dev)
    slot_of[:n] = torch.arange(n, device=dev)
    counts, offs, n_valid, pos = D.dispatch_layout(experts, slot_of, n)
    nv = int(n_valid.item())
    return dict(sh, gates=gates.contiguous(), experts=experts, slot_of=slot_of, counts=counts,
                offs=offs, n_valid=n_valid, pos=pos, nv=nv, cap=S * min(K, n),
                tokens=int((pos < nv).any(1).sum().item()), rng=rng)


def moe_dispatch_bytes(lay: dict) -> dict:
    """Each dispatch kernel's bytes at the layout's valid count: every
    input read once and every output written once, rows of d or f bf16
    values, pos and the gates 4 bytes a choice."""
    S, K, d, f, nv, nt = (lay[k] for k in ("S", "top_k", "d", "f", "nv", "tokens"))
    idx = 4 * S * K + 4
    return {"moe_gather_fwd": 2 * d * (nt + nv) + idx,
            "moe_gather_bwd": 2 * d * (nv + S) + idx,
            "moe_swiglu_fwd": 6 * f * nv + 4,
            "moe_swiglu_bwd": 10 * f * nv + 4,
            "moe_combine_fwd": 2 * d * (nv + S) + idx + 4 * S * K,
            "moe_combine_bwd": 2 * d * (nt + 2 * nv) + idx + 8 * S * K}


def moe_dispatch_checks(lay: dict, dev) -> dict:
    """Each dispatch kernel against its plain version on inputs whose rows
    past the valid count hold NaN: the gather, its backward, the combine and
    dys the same bits, the SwiGLU and its backward within a bf16 ulp (plus,
    for the gate's gradient, the f32 noise of 1 + g·(1 − s) where it
    cancels), the gates' gradient within MOE_DGATE_RTOL of Σ|terms|; a
    second call the same bits; and no row from the valid count on written
    (each output pre-filled and launched into directly)."""
    import torch

    from tpudash_torch.ops import kernels as K

    S, d, f, nv, cap = lay["S"], lay["d"], lay["f"], lay["nv"], lay["cap"]
    pos, n_valid, gates, rng = lay["pos"], lay["n_valid"], lay["gates"], lay["rng"]

    def rand(rows: int, cols: int, nan_from: "int | None" = None):
        t = torch.randn((rows, cols), generator=rng, device=dev).bfloat16()
        if nan_from is not None:
            t[nan_from:] = float("nan")
        return t

    def same_twice(what: str, fn):
        a, b = fn(), fn()
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        torch.cuda.synchronize()
        check(all(torch.equal(u[:nv] if u.shape[0] == cap else u, v[:nv] if v.shape[0] == cap else v)
                  for u, v in zip(a, b)), f"{what}: two calls differ")
        return a if len(a) > 1 else a[0]

    out = {}
    x = rand(S, d)
    xs = same_twice("moe_gather_fwd", lambda: K.moe_gather_forward(x, pos, n_valid, cap))
    check(torch.equal(xs[:nv], K.moe_gather_ref(x, pos, n_valid, cap)[:nv]),
          "moe_gather_fwd: differs from its plain version")
    dxs = rand(cap, d, nv)
    dx = same_twice("moe_gather_bwd", lambda: K.moe_gather_backward(dxs, pos, n_valid))
    check(torch.equal(dx, K.moe_gather_grad_ref(dxs, pos, n_valid)),
          "moe_gather_bwd: differs from its plain version")
    h = rand(cap, 2 * f, nv)
    act = same_twice("moe_swiglu_fwd", lambda: K.moe_swiglu_forward(h, n_valid))
    act_p = K.moe_swiglu_ref(h, n_valid)
    ulps = ((act[:nv].float() - act_p[:nv].float()).abs() / _ulp_bf16(act_p[:nv].float()))
    out["swiglu_fwd_ulps"] = ulps.max().item()
    out["swiglu_fwd_bitwise_share"] = (ulps == 0).float().mean().item()
    check(out["swiglu_fwd_ulps"] <= 1.0, f"moe_swiglu_fwd: {out['swiglu_fwd_ulps']} ulps")
    dact = rand(cap, f, nv)
    dh = same_twice("moe_swiglu_bwd", lambda: K.moe_swiglu_backward(h, dact, n_valid))
    dh_p = K.moe_swiglu_grad_ref(h, dact, n_valid)
    g32, u32, a32 = h[:nv, :f].float(), h[:nv, f:].float(), dact[:nv].float()
    s = torch.sigmoid(g32)
    noise = torch.cat([8 * F32_U * (a32 * u32 * s).abs() * (1 + g32.abs()),
                       torch.zeros_like(g32)], -1)
    err = (dh[:nv].float() - dh_p[:nv].float()).abs()
    out["swiglu_bwd_ulps"] = (err / _ulp_bf16(dh_p[:nv].float())).max().item()
    out["swiglu_bwd_of_tol"] = (err / (_ulp_bf16(dh_p[:nv].float()) + noise)).max().item()
    check(out["swiglu_bwd_of_tol"] <= 1.0,
          f"moe_swiglu_bwd: {out['swiglu_bwd_of_tol']} of its tolerance")
    ys = rand(cap, d, nv)
    y = same_twice("moe_combine_fwd", lambda: K.moe_combine_forward(ys, gates, pos, n_valid))
    check(torch.equal(y, K.moe_combine_ref(ys, gates, pos, n_valid)),
          "moe_combine_fwd: differs from its plain version")
    dy = rand(S, d)
    dys, dg = same_twice("moe_combine_bwd",
                         lambda: K.moe_combine_backward(dy, ys, gates, pos, n_valid))
    dys_p, dg_p = K.moe_combine_grad_ref(dy, ys, gates, pos, n_valid)
    check(torch.equal(dys[:nv], dys_p[:nv]), "moe_combine_bwd: dys differs from its plain version")
    held = pos < nv
    mass = torch.zeros_like(dg_p)
    mass[held] = (dy.float()[held.nonzero()[:, 0]] * ys[pos[held].long()].float()).abs().sum(-1)
    out["dgates_of_mass"] = ((dg - dg_p).abs() / mass.clamp_min(1e-30)).max().item()
    check(bool(((dg - dg_p).abs() <= MOE_DGATE_RTOL * mass).all()),
          f"moe_combine_bwd: dgates {out['dgates_of_mass']:.3e} of Σ|terms|")
    check(bool((dg[~held] == 0).all()), "moe_combine_bwd: an invalid choice's dgates is not 0")
    for what, t in (("xs", xs), ("dx", dx), ("act", act), ("dh", dh), ("y", y), ("dys", dys),
                    ("dgates", dg)):
        check(bool(torch.isfinite(t[:nv] if t.shape[0] == cap else t).all()),
              f"moe dispatch: non-finite {what}")
    # nothing written from the valid count on: each buffer output pre-filled
    grid = K._moe_grid(dev)
    sentinel = -7.0

    def untouched(what: str, out_t, launch) -> None:
        out_t.fill_(sentinel)
        launch(out_t)
        torch.cuda.synchronize()
        check(bool((out_t[nv:] == sentinel).all()), f"{what} wrote a row past the valid count")

    buf = torch.empty((cap, d), dtype=torch.bfloat16, device=dev)
    untouched("moe_gather_fwd", buf, lambda o: K.MOE_GATHER_FWD.launch(
        dev, x.data_ptr(), pos.data_ptr(), n_valid.data_ptr(), o.data_ptr(), S, lay["top_k"],
        cap, d, grid))
    untouched("moe_combine_bwd", buf, lambda o: K.MOE_COMBINE_BWD.launch(
        dev, dy.data_ptr(), ys.data_ptr(), gates.data_ptr(), pos.data_ptr(), n_valid.data_ptr(),
        o.data_ptr(), torch.empty_like(gates).data_ptr(), S, lay["top_k"], cap, d, grid))
    half = torch.empty((cap, f), dtype=torch.bfloat16, device=dev)
    untouched("moe_swiglu_fwd", half, lambda o: K.MOE_SWIGLU_FWD.launch(
        dev, h.data_ptr(), n_valid.data_ptr(), o.data_ptr(), cap, f, grid))
    whole = torch.empty((cap, 2 * f), dtype=torch.bfloat16, device=dev)
    untouched("moe_swiglu_bwd", whole, lambda o: K.MOE_SWIGLU_BWD.launch(
        dev, h.data_ptr(), dact.data_ptr(), n_valid.data_ptr(), o.data_ptr(), cap, f, grid))
    out["tensors"] = dict(x=x, dxs=dxs, h=h, dact=dact, ys=ys, dy=dy)
    return out


def dsv2_step_launches(dev, steps: int = 4) -> dict:
    """launch_counts() over the first call of the DeepSeek-V2-Lite step at
    the cell's defaults (its two eager warm-up steps and its capture), and
    over replays; the dispatch kernels MOE_LAUNCHES_A_LAYER times a MoE
    layer a step and MLA's MLA_LAUNCHES_A_LAYER times a layer, none from a
    replay; with the replayed step's time (CUDA events over ``steps``
    steps) and the pool's peak."""
    import torch

    from tpudash_torch.models import deepseek_v2 as D
    from tpudash_torch.models import graphed
    from tpudash_torch.ops import kernels as K

    cfg = D.DeepseekV2Config()
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 18)
    params, opt = D.make_train_state(cfg, gen_t)
    counters = D.routing_counters(cfg, dev)
    step = D.make_train_step(cfg, dev, counters)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=gen_t, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    loss0 = step(params, opt, tokens).item()
    first = K.launch_counts()
    K.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        loss = step(params, opt, tokens)
    end.record()
    end.synchronize()
    replay = K.launch_counts()
    n_moe = cfg.n_layers - cfg.first_k_dense
    counted = graphed.WARMUP_STEPS + 1
    per_step = {k.name: first[k.name] / counted for k in (*K.MOE_KERNELS, *K.MLA_KERNELS)}
    moe = sum(per_step[k.name] for k in K.MOE_KERNELS)
    check(moe == MOE_LAUNCHES_A_LAYER * n_moe,
          f"dispatch launches a step {per_step} (sum {moe}), want {MOE_LAUNCHES_A_LAYER * n_moe}")
    want_mla = {name: n * cfg.n_layers for name, n in MLA_LAUNCHES_A_LAYER.items()}
    check({k.name: per_step[k.name] for k in K.MLA_KERNELS} == want_mla,
          f"MLA launches a step {per_step}, want {want_mla}")
    total = sum(per_step.values())
    check(all(v == 0 for v in replay.values()), f"a replay launched from the host: {replay}")
    check(math.isfinite(loss0) and math.isfinite(loss.item()), "the step's loss is not finite")
    routed = counters[:-1].sum().item() / counters[-1].item()
    out = {"per_step": per_step, "per_step_total": total, "first_call": first, "replay": replay,
           "step_ms": start.elapsed_time(end) / steps, "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "loss0": loss0, "valid_row_share": routed / D.dispatch_rows(cfg)}
    del params, opt, step, counters
    gc_cuda([dev])
    return out


def moe_dispatch_phase(dev, card: str, gen, timing: bool = True) -> dict:
    """The dispatch kernels at the DeepSeek-V2-Lite cell's shapes
    (MOE_DISPATCH_SHAPE, skewed routing): each against its plain version
    (moe_dispatch_checks), the launches of one graphed step at the cell's
    defaults (dsv2_step_launches); with ``timing``, each kernel's time with
    L2 emptied before each call, beside the bound of its bytes at this
    valid count and the PyTorch chain it replaced (the padded buffer, the
    f32 SwiGLU, the f32 index_add into a dropped row), timed alike."""
    import torch
    import torch.nn.functional as F

    from tpudash_torch.models import deepseek_v2 as D
    from tpudash_torch.ops import kernels as K

    lay = moe_dispatch_layout(dev, SEED + 17)
    S, K_, d, f, nv, cap = (lay[k] for k in ("S", "top_k", "d", "f", "nv", "cap"))
    out = {"n_valid": nv, "cap": cap, "tokens": lay["tokens"], "valid_share": nv / cap,
           "expert_tokens": lay["counts"].tolist()}
    checks = moe_dispatch_checks(lay, dev)
    tensors = checks.pop("tensors")
    out["checks"] = checks
    print(f"moe dispatch kernels vs plain at S {S}, top-{K_} of {lay['n_experts']}, {lay['held']} "
          f"held, d {d}, f {f} [{card}]: {nv} valid rows of {cap} ({100 * nv / cap:.2f} %), "
          f"{lay['tokens']} tokens with a held choice, experts {out['expert_tokens']}; gather, "
          f"its backward, combine and dys bitwise; SwiGLU {checks['swiglu_fwd_ulps']:.3f} ulp "
          f"({100 * checks['swiglu_fwd_bitwise_share']:.2f} % bitwise), its backward "
          f"{checks['swiglu_bwd_ulps']:.3f} ulp ({checks['swiglu_bwd_of_tol']:.3f} of its "
          f"tolerance), dgates {checks['dgates_of_mass']:.3e} of Σ|terms|; two calls bitwise; "
          "no row past the valid count written")
    out["step"] = st = dsv2_step_launches(dev)
    print(f"dispatch and MLA launches over the first call of the DeepSeek-V2-Lite step (2 warm-up "
          f"steps + capture) [{card}]: a step {st['per_step']} = {st['per_step_total']}; a replay "
          f"{st['replay']}; graphed step {st['step_ms']:.2f} ms, peak {st['peak_bytes'] / 1e9:.2f} "
          f"GB, valid-row share {st['valid_row_share']:.4f}")
    if not timing:
        return out
    t = tensors
    pos, n_valid, gates = lay["pos"], lay["n_valid"], lay["gates"]
    order = torch.sort(lay["slot_of"][lay["experts"]].reshape(-1), stable=True).indices[:cap]
    valid = torch.arange(cap, device=dev) < lay["offs"][-1]
    rows = torch.where(valid, order // K_, S)
    xr = t["x"].clone().requires_grad_(True)
    xs_chain = F.embedding(rows, F.pad(xr, (0, 0, 0, 1)))
    hr = t["h"].clone().requires_grad_(True)
    act_chain = D._swiglu(hr)
    ysr = t["ys"].clone().requires_grad_(True)
    gr = gates.clone().requires_grad_(True)

    def combine_chain(ys_, g_):
        g = torch.where(valid, g_.reshape(-1).gather(0, order), 0.0)
        y = torch.zeros(S + 1, d, dtype=torch.float32, device=dev)
        return y.index_add(0, rows, ys_.float() * g[:, None])[:S].to(torch.bfloat16)

    y_chain = combine_chain(ysr, gr)
    fns = {
        "moe_gather_fwd": (lambda: K.moe_gather_forward(t["x"], pos, n_valid, cap),
                           lambda: F.embedding(rows, F.pad(t["x"], (0, 0, 0, 1)))),
        "moe_gather_bwd": (lambda: K.moe_gather_backward(t["dxs"], pos, n_valid),
                           lambda: torch.autograd.grad(xs_chain, (xr,), t["dxs"],
                                                       retain_graph=True)),
        "moe_swiglu_fwd": (lambda: K.moe_swiglu_forward(t["h"], n_valid),
                           lambda: D._swiglu(t["h"])),
        "moe_swiglu_bwd": (lambda: K.moe_swiglu_backward(t["h"], t["dact"], n_valid),
                           lambda: torch.autograd.grad(act_chain, (hr,), t["dact"],
                                                       retain_graph=True)),
        "moe_combine_fwd": (lambda: K.moe_combine_forward(t["ys"], gates, pos, n_valid),
                            lambda: combine_chain(t["ys"], gates)),
        "moe_combine_bwd": (lambda: K.moe_combine_backward(t["dy"], t["ys"], gates, pos, n_valid),
                            lambda: torch.autograd.grad(y_chain, (ysr, gr), t["dy"],
                                                        retain_graph=True)),
    }
    hbm = gen.hbm_gbps * 1e9
    nbytes = moe_dispatch_bytes(lay)
    flush = torch.ones(64 * 2**20, device=dev)
    flush_ms = graph_ms(lambda: flush.sum(), dev)
    # the chains by CUDA events around calls (each is milliseconds of device
    # work, so the host stays ahead; a backward's autograd cannot be
    # captured apart from its forward)
    flush_events = cuda_ms({"flush": lambda: flush.sum()}, n=4, reps=5)["flush"]
    out["timing"] = {}
    for name, (kernel, chain) in fns.items():
        tm = {"kernel_graph": graph_ms(kernel, dev, n=10, reps=7),
              "kernel_cold": graph_ms(lambda kernel=kernel: (flush.sum(), kernel()), dev, n=10,
                                      reps=7) - flush_ms,
              "chain_cold": cuda_ms({"c": lambda chain=chain: (flush.sum(), chain())}, n=4,
                                    reps=5)["c"] - flush_events,
              "bound_ms": nbytes[name] / hbm * 1e3, "bytes": nbytes[name]}
        out["timing"][name] = tm
        print(f"{name} at the cell's shapes [{card}]: {tm['kernel_cold'] * 1e3:.2f} us with L2 "
              f"emptied before each call ({tm['kernel_graph'] * 1e3:.2f} us warm), bound "
              f"{tm['bound_ms'] * 1e3:.2f} us ({nbytes[name] / 1e6:.1f} MB at {nv} valid rows: "
              f"{100 * tm['bound_ms'] / tm['kernel_cold']:.2f} % of it); the PyTorch chain it "
              f"replaced {tm['chain_cold'] * 1e3:.2f} us")
    del xs_chain, act_chain, y_chain, flush
    gc_cuda([dev])
    return out


#: MLA at the DeepSeek-V2-Lite cell's shapes: 8 sequences of 4,095
#: positions (the step's input) against the cell's cos table of 4,096, the
#: published widths
MLA_SHAPE = dict(B=8, T=4095, table=4096, H=16, nope=128, rope=64, v=128, r=512)
#: and at the CPU tests' widths (rope 8: one rope unit a head) and with no
#: nope part, a head row all rope
MLA_EDGE_SHAPES = (dict(B=2, T=33, table=40, H=4, nope=16, rope=8, v=16, r=32),
                   dict(B=3, T=7, table=7, H=3, nope=0, rope=16, v=8, r=0))
#: MLA's kernel launches a layer a train step: the forward, again in the
#: recompute, and the backward
MLA_LAUNCHES_A_LAYER = {"mla_rope_fwd": 2, "mla_rope_bwd": 1}
#: the device kernels the chain of PyTorch ops that the MLA kernels replaced
#: ran, by kind (patterns of the kernel names in the cell's trace): its cats,
#: its copies (the casts and the regrouping), its f32 products, bf16 adds
#: (autograd's merges) and fills (the zero-filled slices)
GLUE_KINDS = {"cat": r"CatArrayBatchedCopy", "copy": r"copy_kernel",
              "f32_mul": r"MulFunctor<float>", "bf16_add": r"CUDAFunctor_add<c10::BFloat16>",
              "fill": r"FillFunctor"}


def mla_inputs(dev, sh: dict, seed: int) -> dict:
    """q_raw, kv, kv_a (N(0, 1), bf16) and the cell's cos/sin tables (YaRN
    at the published settings, rope wide) for ``sh``'s first T positions."""
    import dataclasses

    import torch

    from tpudash_torch.models import deepseek_v2 as D

    g = torch.Generator(device=dev).manual_seed(seed)
    B, T, H = sh["B"], sh["T"], sh["H"]

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    cfg = dataclasses.replace(D.DeepseekV2Config(), qk_rope_head_dim=sh["rope"])
    cos, sin = D.rope_tables(cfg, sh["table"], dev)
    return dict(q_raw=rand(B, T, H, sh["nope"] + sh["rope"]),
                kv=rand(B, T, H, sh["nope"] + sh["v"]), kv_a=rand(B, T, sh["r"] + sh["rope"]),
                cos=cos[:T], sin=sin[:T], g=g)


def mla_bytes(sh: dict) -> dict:
    """Each MLA kernel's bytes: every input read once, every output written
    once (bf16 rows, the f32 tables once)."""
    S, H, nope, rope, vd, r = (sh[k] for k in ("B", "H", "nope", "rope", "v", "r"))
    S *= sh["T"]
    qw, tables = nope + rope, 2 * 4 * sh["T"] * rope
    return {"mla_rope_fwd": 2 * S * (H * qw + H * nope + rope) + 2 * 2 * S * H * qw + tables,
            "mla_rope_bwd": 2 * S * H * (2 * qw + vd)
                            + 2 * S * (H * qw + H * (nope + vd) + r + rope) + tables}


def mla_checks(dev, sh: dict, seed: int, card: str) -> dict:
    """The MLA kernels against the chain they replaced (mla_qk_rope_ref, and
    autograd of it) at ``sh``: q and k the same bits; the autograd function
    through SDPA on the card, its backward given dq, dk and dv in the
    strides SDPA's backward returns them, then each also token-major and
    head-major contiguous: dq_raw and dkv the same bits as autograd's,
    dkv_a's latent columns zero and its rope columns within a bf16 ulp
    (the heads' sum in another order), and all three the same bits as the
    closed form (mla_rope_grads_ref); two calls the same bits."""
    import torch

    from tpudash_torch.models import deepseek_v2 as D
    from tpudash_torch.ops import kernels as K

    x = mla_inputs(dev, sh, seed)
    q_raw, kv, kv_a, cos, sin = (x[k] for k in ("q_raw", "kv", "kv_a", "cos", "sin"))
    label = f"B {sh['B']}, T {sh['T']} of {sh['table']}, H {sh['H']}, nope {sh['nope']}, " \
            f"rope {sh['rope']}, v {sh['v']}, r {sh['r']}"
    q, k = K.mla_rope_forward(q_raw, kv, kv_a, cos, sin)
    q2, k2 = K.mla_rope_forward(q_raw, kv, kv_a, cos, sin)
    q_p, k_p, _ = K.mla_qk_rope_ref(q_raw, kv, kv_a, cos, sin)
    torch.cuda.synchronize()
    check(torch.equal(q, q2) and torch.equal(k, k2), f"mla_rope_fwd {label}: two calls differ")
    check(torch.equal(q, q_p) and torch.equal(k, k_p),
          f"mla_rope_fwd {label}: differs from the chain")
    # the function through SDPA, its backward's inputs kept as SDPA gave them
    seen = {}
    backward = K.mla_rope_backward

    def keep(dq, dk, dv, *rest):
        seen.update(dq=dq, dk=dk, dv=dv)
        return backward(dq, dk, dv, *rest)

    leaves = [t.clone().requires_grad_(True) for t in (q_raw, kv, kv_a)]
    qf, kf, vf = K.mla_qk_rope(*leaves, cos, sin)
    check(vf.data_ptr() == leaves[1].data_ptr() + 2 * sh["nope"], "v is not kv's view")
    o = D._attention_core(qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2), 0.1)
    K.mla_rope_backward = keep
    try:
        o.backward(torch.randn(o.shape, generator=x["g"], device=dev).bfloat16())
    finally:
        K.mla_rope_backward = backward
    dq, dk, dv = seen["dq"], seen["dk"], seen["dv"]
    chain_leaves = [t.clone().requires_grad_(True) for t in (q_raw, kv, kv_a)]
    want = torch.autograd.grad(K.mla_qk_rope_ref(*chain_leaves, cos, sin), chain_leaves,
                               (dq, dk, dv))
    closed = K.mla_rope_grads_ref(dq, dk, dv, cos, sin, sh["r"])
    out = {"sdpa_strides": {n: t.stride() for n, t in seen.items()}, "ulps": 0.0}
    layouts = {"SDPA's": (dq, dk, dv),
               "token-major": tuple(t.contiguous() for t in (dq, dk, dv)),
               "head-major": tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                                   for t in (dq, dk, dv))}
    got = {name: K.mla_rope_backward(*g, cos, sin, sh["r"]) for name, g in layouts.items()}
    again = K.mla_rope_backward(dq, dk, dv, cos, sin, sh["r"])
    torch.cuda.synchronize()
    through = tuple(t.grad for t in leaves)
    for name, (dq_raw, dkv, dkv_a) in {**got, "the function's": through}.items():
        check(torch.equal(dq_raw, want[0]) and torch.equal(dkv, want[1]),
              f"mla_rope_bwd {label}, {name} strides: dq_raw or dkv differs from autograd's")
        check(bool((dkv_a[..., :sh["r"]] == 0).all()) and torch.equal(dkv_a[..., :sh["r"]],
                                                                     want[2][..., :sh["r"]]),
              f"mla_rope_bwd {label}, {name}: dkv_a's latent columns are not zero")
        a, b = dkv_a[..., sh["r"]:].float(), want[2][..., sh["r"]:].float()
        ulps = ((a - b).abs() / _ulp_bf16(b)).max().item()
        out["ulps"] = max(out["ulps"], ulps)
        check(ulps <= 1.0, f"mla_rope_bwd {label}, {name}: the rope key's gradient {ulps} ulps off")
        check(all(torch.equal(u, v) for u, v in zip((dq_raw, dkv, dkv_a), closed)),
              f"mla_rope_bwd {label}, {name}: differs from the closed form")
    check(all(torch.equal(u, v) for u, v in zip(again, got["SDPA's"])),
          f"mla_rope_bwd {label}: two calls differ")
    key = want[2][..., sh["r"]:]
    out["key_bitwise_share"] = (got["SDPA's"][2][..., sh["r"]:] == key).float().mean().item()
    print(f"mla kernels vs the chain at {label} [{card}]: q, k bitwise; the function through SDPA "
          f"(dq, dk, dv strides {out['sdpa_strides']}), token-major and head-major: dq_raw, dkv "
          f"bitwise autograd's, dkv_a latent zero, its rope key {out['ulps']:.3f} ulp "
          f"({100 * out['key_bitwise_share']:.2f} % bitwise), all bitwise the closed form; two "
          "calls bitwise")
    out["tensors"] = dict(x, dq=dq, dk=dk, dv=dv)
    return out


def dsv2_eager_profile(dev, card: str) -> dict:
    """One eager train step of DeepSeek-V2-Lite at the cell's defaults,
    after one to warm up, under torch.profiler: device ms by kernel, the
    sums of GLUE_KINDS over the step and over the ops under ``dsv2.mla``
    spans (forward and recompute; a backward op has no span), the step's
    device ms and kernels.  Runs either tree's package (tools/dsv2_profile.py
    --tree)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpudash_torch.models import deepseek_v2 as D
    from tpudash_torch.ops import kernels as K

    K.build_kernels(tuple(k for k in K.KERNELS if k.name.startswith(("rmsnorm", "moe", "mla"))))
    cfg = D.DeepseekV2Config()
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 20)
    params, opt = D.make_train_state(cfg, gen_t)
    consts, counters = D.Constants(cfg, dev), D.routing_counters(cfg, dev)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=gen_t, device=dev)
    D.train_step(params, opt, tokens, cfg, consts, counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        D.train_step(params, opt, tokens, cfg, consts, counters)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name, under = {}, {kind: 0.0 for kind in GLUE_KINDS}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        in_mla, p = False, e
        while p is not None and not in_mla:
            in_mla, p = p.name == "dsv2.mla", p.cpu_parent
        for kern in e.kernels:
            ms = kern.duration / 1e3
            by_name[kern.name] = by_name.get(kern.name, 0.0) + ms
            if in_mla:
                for kind, pat in GLUE_KINDS.items():
                    if re.search(pat, kern.name):
                        under[kind] += ms
    kinds = {kind: sum(ms for n, ms in by_name.items() if re.search(pat, n))
             for kind, pat in GLUE_KINDS.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    out = {"card": card, "device_ms": sum(by_name.values()), "wall_s": wall,
           "kinds_ms": kinds, "under_mla_ms": under, "top": top[:30],
           "mla_kernels": {n: ms for n, ms in by_name.items() if "mla_rope" in n}}
    del params, opt, consts, counters
    gc_cuda([dev])
    return out


def mla_rope_phase(dev, card: str, gen, step: "dict | None" = None, timing: bool = True) -> dict:
    """3f: the MLA kernels against the chain they replaced (mla_checks) at
    the cell's shapes and at MLA_EDGE_SHAPES; the launches of one graphed
    step (``step``, dsv2_step_launches' result, run here when None); with
    ``timing``, each kernel's time with L2 emptied beside the bound of its
    bytes and the chain's time, and one eager profiled step
    (dsv2_eager_profile)."""
    import torch

    from tpudash_torch.ops import kernels as K

    out = {"checks": mla_checks(dev, MLA_SHAPE, SEED + 20, card)}
    tensors = out["checks"].pop("tensors")
    for i, sh in enumerate(MLA_EDGE_SHAPES):
        mla_checks(dev, sh, SEED + 21 + i, card).pop("tensors")
    st = out["step"] = step if step is not None else dsv2_step_launches(dev)
    mla = {k.name: st["per_step"][k.name] for k in K.MLA_KERNELS}
    print(f"MLA launches a graphed DeepSeek-V2-Lite step [{card}]: {mla}; with the dispatch's, "
          f"{st['per_step_total']:.0f} a step; none from a replay")
    if not timing:
        return out
    t = tensors
    q_raw, kv, kv_a, cos, sin = (t[k] for k in ("q_raw", "kv", "kv_a", "cos", "sin"))
    dq, dk, dv, r = t["dq"], t["dk"], t["dv"], MLA_SHAPE["r"]
    leaves = [u.clone().requires_grad_(True) for u in (q_raw, kv, kv_a)]
    chain_out = K.mla_qk_rope_ref(*leaves, cos, sin)
    fns = {"mla_rope_fwd": (lambda: K.mla_rope_forward(q_raw, kv, kv_a, cos, sin),
                            lambda: K.mla_qk_rope_ref(q_raw, kv, kv_a, cos, sin)),
           "mla_rope_bwd": (lambda: K.mla_rope_backward(dq, dk, dv, cos, sin, r),
                            lambda: torch.autograd.grad(chain_out, leaves, (dq, dk, dv),
                                                        retain_graph=True))}
    hbm = gen.hbm_gbps * 1e9
    nbytes = mla_bytes(MLA_SHAPE)
    flush = torch.ones(64 * 2**20, device=dev)
    flush_ms = graph_ms(lambda: flush.sum(), dev)
    flush_events = cuda_ms({"flush": lambda: flush.sum()}, n=4, reps=5)["flush"]
    out["timing"] = {}
    for name, (kernel, chain) in fns.items():
        tm = {"kernel_graph": graph_ms(kernel, dev, n=10, reps=7),
              "kernel_cold": graph_ms(lambda kernel=kernel: (flush.sum(), kernel()), dev, n=10,
                                      reps=7) - flush_ms,
              "chain_cold": cuda_ms({"c": lambda chain=chain: (flush.sum(), chain())}, n=4,
                                    reps=5)["c"] - flush_events,
              "bound_ms": nbytes[name] / hbm * 1e3, "bytes": nbytes[name]}
        out["timing"][name] = tm
        print(f"{name} at the cell's shapes [{card}]: {tm['kernel_cold'] * 1e3:.2f} us with L2 "
              f"emptied before each call ({tm['kernel_graph'] * 1e3:.2f} us warm), bound "
              f"{tm['bound_ms'] * 1e3:.2f} us ({nbytes[name] / 1e6:.1f} MB: "
              f"{100 * tm['bound_ms'] / tm['kernel_cold']:.2f} % of it); the PyTorch chain it "
              f"replaced {tm['chain_cold'] * 1e3:.2f} us")
    del chain_out, leaves, flush, tensors
    gc_cuda([dev])
    prof = out["profile"] = dsv2_eager_profile(dev, card)
    def ms(d: dict) -> str:
        return json.dumps({k: round(v, 2) for k, v in d.items()})

    print(f"one eager DeepSeek-V2-Lite step under the profiler [{card}]: device "
          f"{prof['device_ms']:.1f} ms; by kind over the step {ms(prof['kinds_ms'])}, under "
          f"dsv2.mla {ms(prof['under_mla_ms'])}; the MLA kernels {ms(prof['mla_kernels'])} ms")
    return out


#: Kimi-Linear's KDA at the cell's shapes (4 sequences of 8,191 positions, 32
#: heads of 128) and at two small ones (one whole chunk; ragged chunks)
KDA_SHAPE = dict(B=4, T=8191, H=32)
KDA_EDGE_SHAPES = (dict(B=1, T=64, H=1), dict(B=2, T=100, H=3))
#: the chunks of the cell's shape whose pair blocks are checked against the
#: plain version on the card (the plain one forms a (C, C, D) tensor a chunk)
KDA_PAIR_CHECK_CHUNKS = 8
#: the KDA kernels' launches a KDA layer a train step: the forward, again in
#: the recompute, and the backward
KDA_LAUNCHES_A_LAYER = {"kda_pairs_fwd": 2, "kda_state_fwd": 2, "kda_pairs_bwd": 1,
                        "kda_state_bwd": 1}
#: the kernels against their plain versions on the card, max |a − b| over
#: max |b|: the same f32 terms summed in other orders (128 channels, or 64
#: positions, a sum), and the state pass's over 128 chunks in sequence
KDA_KERNEL_RTOL = 2.0**-16
#: the whole chunked rule on the card against the plain chain on the host,
#: the same: more sums in other orders, and the triangular solve's own
KDA_CHAIN_RTOL = 2.0**-14


def kda_inputs(dev, sh: dict, seed: int, grad: bool = False) -> dict:
    """q, k (L2-normed), v, g and beta f32 (B, T, H, ·) as the model makes
    them at init: g = −exp(A_log)·softplus(f + dt_bias) with A_log = log U(1,
    16), dt_bias the inverse softplus of exp U(ln 0.001, ln 0.1) and f ~
    N(0, 0.5²); beta = sigmoid(N(0, 1))."""
    import torch

    from tpudash_torch.models import kimi_linear as KL

    g = torch.Generator(device=dev).manual_seed(seed)
    B, T, H, D = sh["B"], sh["T"], sh["H"], 128

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    a_log = KL.init_leaf("A_log", (H,), 0.02, g)
    dt_bias = KL.init_leaf("dt_bias", (H * D,), 0.02, g).view(H, D)
    x = dict(q=KL._l2norm(rand(B, T, H, D)), k=KL._l2norm(rand(B, T, H, D)), v=rand(B, T, H, D),
             g=-a_log.exp()[:, None] * torch.nn.functional.softplus(0.5 * rand(B, T, H, D) + dt_bias),
             beta=torch.sigmoid(rand(B, T, H)))
    if grad:
        x = {n: t.requires_grad_(True) for n, t in x.items()}
    return x


def kda_call_bytes(sh: dict, backward: bool) -> int:
    """The least bytes of one KDA call at ``sh`` (gpubench/flops_kimi_linear.py's
    count): q, k, v, the decay's and β's pre-activations in and o out in bf16,
    each once; backward also o's gradient in and the inputs' gradients out."""
    wide, narrow = sh["B"] * sh["T"] * sh["H"] * 128, sh["B"] * sh["T"] * sh["H"]
    fwd = 2 * (5 * wide + narrow)
    return fwd + 2 * (4 * wide + narrow) if backward else fwd


def _kda_pieces(x: dict) -> dict:
    """The kernels' inputs as kernels.kda_chunk makes them."""
    import torch

    from tpudash_torch.ops import kernels as K

    C = K.KDA_CHUNK
    B, T, H, Dk = x["k"].shape
    N = -(-T // C)
    q, k, v, g = (K._chunked(x[n].detach(), N, C) for n in ("q", "k", "v", "g"))
    beta = K._chunked(x["beta"].detach(), N, C)[..., None]
    G = g.cumsum(-2)
    decay = G.exp()
    last = G[..., -1, :]
    w = torch.empty_like(q)
    u = torch.empty_like(v)
    for n in range(N):  # the solve a chunk at a time: its plain form, no batch of 10^4
        a = K.kda_pairs_ref(q[:, :, n:n + 1], k[:, :, n:n + 1], G[:, :, n:n + 1])[0]
        rhs = torch.cat([k[:, :, n:n + 1] * decay[:, :, n:n + 1] * beta[:, :, n:n + 1],
                         v[:, :, n:n + 1] * beta[:, :, n:n + 1]], -1)
        wu = torch.linalg.solve_triangular(a * beta[:, :, n:n + 1], rhs, upper=False,
                                           unitriangular=True)
        w[:, :, n:n + 1], u[:, :, n:n + 1] = wu.split([Dk, v.shape[-1]], -1)
    kd = (k * (last[..., None, :] - G).exp()).contiguous()
    return dict(q=q, k=k, G=G, w=w, u=u, kd=kd, gamma=last.exp().contiguous())


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def kda_checks(dev, sh: dict, seed: int, card: str, pair_chunks: "int | None" = None) -> dict:
    """Each KDA kernel against its plain version on the card at ``sh`` (the
    pair blocks on the first ``pair_chunks`` chunks of each head), max |a −
    b| over max |b| within KDA_KERNEL_RTOL; two calls the same bits."""
    import torch

    from tpudash_torch.ops import kernels as K

    x = kda_inputs(dev, sh, seed)
    pc = _kda_pieces(x)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    label = f"B {sh['B']}, T {sh['T']}, H {sh['H']}"
    out = {}
    sl = slice(None, pair_chunks)
    q, k, G = (pc[n][:, :, sl].contiguous() for n in ("q", "k", "G"))
    got = K.kda_pairs_forward(q, k, G)
    again = K.kda_pairs_forward(q, k, G)
    want = K.kda_pairs_ref(q, k, G)
    out["pairs_fwd"] = max(_rel(a, b) for a, b in zip(got, want))
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"kda_pairs_fwd {label}: two calls differ")
    check(all(torch.equal(a, a.tril(d)) for a, d in zip(got, (-1, 0))),
          f"kda_pairs_fwd {label}: a value above its diagonal")
    da = torch.randn(got[0].shape, generator=g, device=dev)
    db = torch.randn(got[0].shape, generator=g, device=dev)
    gotb = K.kda_pairs_backward(q, k, G, da, db)
    wantb = K.kda_pairs_grads_ref(q, k, G, da, db)
    out["pairs_bwd"] = max(_rel(a, b) for a, b in zip(gotb, wantb))
    check(all(torch.equal(a, b) for a, b in zip(gotb, K.kda_pairs_backward(q, k, G, da, db))),
          f"kda_pairs_bwd {label}: two calls differ")
    del got, again, want, gotb, wantb, q, k, G, da, db
    w, u, kd, gamma = (pc[n] for n in ("w", "u", "kd", "gamma"))
    got = K.kda_state_forward(w, u, kd, gamma)
    want = K.kda_state_ref(w, u, kd, gamma)
    out["state_fwd"] = max(_rel(a, b) for a, b in zip(got, want))
    check(all(torch.equal(a, b) for a, b in zip(got, K.kda_state_forward(w, u, kd, gamma))),
          f"kda_state_fwd {label}: two calls differ")
    gS = torch.randn(got[0].shape, generator=g, device=dev)
    gv = torch.randn(got[1].shape, generator=g, device=dev)
    gotb = K.kda_state_backward(w, kd, gamma, gS, gv)
    wantb = K.kda_state_reverse_ref(w, kd, gamma, gS, gv)
    out["state_bwd"] = max(_rel(a, b) for a, b in zip(gotb, wantb))
    torch.cuda.synchronize()
    for name in ("pairs_fwd", "pairs_bwd", "state_fwd", "state_bwd"):
        check(out[name] <= KDA_KERNEL_RTOL,
              f"kda_{name} {label}: {out[name]:.3e} of the plain version's largest value")
    print(f"kda kernels vs their plain versions at {label} [{card}] (pairs over "
          f"{pair_chunks or 'every'} chunk(s) a head): max |diff| / max |plain| "
          + ", ".join(f"{n} {v:.3e}" for n, v in out.items()) + "; two calls bitwise")
    return out


def kda_chain_check(dev, sh: dict, seed: int, card: str) -> dict:
    """kernels.kda_chunk on the card (the kernels) against the same chain on
    the host in f32 (the plain versions): the output, the final state and
    every input's gradient, max |a − b| over max |b| within KDA_CHAIN_RTOL."""
    import torch

    from tpudash_torch.ops import kernels as K

    x = kda_inputs(dev, sh, seed, grad=True)
    host = {n: t.detach().cpu().requires_grad_(True) for n, t in x.items()}
    names = ("q", "k", "v", "g", "beta")
    outs = K.kda_chunk(*(x[n] for n in names), 128**-0.5)
    outs_h = K.kda_chunk(*(host[n] for n in names), 128**-0.5)
    g = torch.Generator().manual_seed(seed + 2)
    cot = [torch.randn(o.shape, generator=g) for o in outs_h]
    grads = torch.autograd.grad(outs, [x[n] for n in names], [c.to(dev) for c in cot])
    grads_h = torch.autograd.grad(outs_h, [host[n] for n in names], cot)
    rel = {"o": _rel(outs[0].cpu(), outs_h[0]), "state": _rel(outs[1].cpu(), outs_h[1]),
           **{f"d{n}": _rel(a.cpu(), b) for n, a, b in zip(names, grads, grads_h)}}
    label = f"B {sh['B']}, T {sh['T']}, H {sh['H']}"
    for n, v in rel.items():
        check(v <= KDA_CHAIN_RTOL, f"kda_chunk {label}: {n} {v:.3e} off the host's chain")
    print(f"kda_chunk on the card vs the plain chain on the host at {label} [{card}]: max |diff| / "
          "max |host| " + ", ".join(f"{n} {v:.3e}" for n, v in rel.items()))
    return rel


def kimi_step_launches(dev, steps: int = 2) -> dict:
    """launch_counts() over the first call of the Kimi-Linear step at the
    cell's defaults (its eager warm-up steps and its capture) and over
    replays: KDA's kernels KDA_LAUNCHES_A_LAYER times a KDA layer a step,
    MLA's MLA_LAUNCHES_A_LAYER times an MLA layer, the dispatch's
    MOE_LAUNCHES_A_LAYER times a MoE layer, none from a replay; with the
    replayed step's time (CUDA events over ``steps`` steps) and the peak."""
    import torch

    from tpudash_torch.models import graphed
    from tpudash_torch.models import kimi_linear as KL
    from tpudash_torch.ops import kernels as K

    cfg = KL.KimiLinearConfig()
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 30)
    params, opt = KL.make_train_state(cfg, gen_t)
    counters = KL.routing_counters(cfg, dev)
    step = KL.make_train_step(cfg, dev, counters)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=gen_t, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    loss0 = step(params, opt, tokens).item()
    first_s = time.perf_counter() - t0
    first = K.launch_counts()
    K.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        loss = step(params, opt, tokens)
    end.record()
    end.synchronize()
    replay = K.launch_counts()
    counted = graphed.WARMUP_STEPS + 1
    per_step = {n: c / counted for n, c in first.items() if c}
    n_kda = sum(cfg.is_kda(i) for i in range(cfg.n_layers))
    want = {**{n: c * n_kda for n, c in KDA_LAUNCHES_A_LAYER.items()},
            **{n: c * (cfg.n_layers - n_kda) for n, c in MLA_LAUNCHES_A_LAYER.items()}}
    check({n: per_step.get(n, 0) for n in want} == want,
          f"Kimi-Linear launches a step {per_step}, want {want}")
    moe = sum(per_step.get(k.name, 0) for k in K.MOE_KERNELS)
    check(moe == MOE_LAUNCHES_A_LAYER * (cfg.n_layers - cfg.first_k_dense),
          f"dispatch launches a Kimi-Linear step {moe}")
    check(all(v == 0 for v in replay.values()), f"a replay launched from the host: {replay}")
    check(math.isfinite(loss0) and math.isfinite(loss.item()), "the step's loss is not finite")
    out = {"per_step": per_step, "first_call": first, "replay": replay, "first_call_s": first_s,
           "step_ms": start.elapsed_time(end) / steps,
           "peak_bytes": torch.cuda.max_memory_allocated(dev), "loss0": loss0}
    del params, opt, step, counters
    gc_cuda([dev])
    return out


def kda_phase(dev, card: str, gen, timing: bool = True) -> dict:
    """3g: the KDA kernels against their plain versions (kda_checks) at the
    cell's shapes and at KDA_EDGE_SHAPES, the chunked rule on the card
    against the host's chain (kda_chain_check); the launches, step time and
    peak of one graphed Kimi-Linear step (kimi_step_launches); with
    ``timing``, each kernel's time with L2 emptied and warm, and a call's
    kernels against the least time of a call (kda_call_bytes over the HBM
    rate)."""
    import torch

    from tpudash_torch.ops import kernels as K

    out = {"checks": kda_checks(dev, KDA_SHAPE, SEED + 30, card, KDA_PAIR_CHECK_CHUNKS)}
    gc_cuda([dev])
    for i, sh in enumerate(KDA_EDGE_SHAPES):
        kda_checks(dev, sh, SEED + 31 + i, card)
    out["chain"] = kda_chain_check(dev, dict(B=1, T=300, H=2), SEED + 34, card)
    gc_cuda([dev])
    st = out["step"] = kimi_step_launches(dev)
    kda = {k.name: st["per_step"].get(k.name, 0) for k in K.KDA_KERNELS}
    print(f"Kimi-Linear graphed step at the cell's defaults [{card}]: KDA launches a step {kda}; "
          f"all {sum(st['per_step'].values()):.0f} launches a step "
          f"{json.dumps(st['per_step'])}; none from a replay; first call (two eager warm-up steps "
          f"and the capture) {st['first_call_s']:.1f} s; {st['step_ms']:.1f} ms a replayed step; "
          f"peak {st['peak_bytes'] / 1e9:.2f} GB")
    if not timing:
        return out
    x = kda_inputs(dev, KDA_SHAPE, SEED + 35)
    pc = _kda_pieces(x)
    q, k, G, w, u, kd, gamma = (pc[n] for n in ("q", "k", "G", "w", "u", "kd", "gamma"))
    g = torch.Generator(device=dev).manual_seed(SEED + 36)
    akk, _ = K.kda_pairs_forward(q, k, G)
    da, db = torch.randn(akk.shape, generator=g, device=dev), torch.randn(akk.shape, generator=g, device=dev)
    states, v_new = K.kda_state_forward(w, u, kd, gamma)
    gS = torch.randn(states.shape, generator=g, device=dev)
    gv = torch.randn(v_new.shape, generator=g, device=dev)
    del akk, states, v_new
    fns = {"kda_pairs_fwd": lambda: K.kda_pairs_forward(q, k, G),
           "kda_state_fwd": lambda: K.kda_state_forward(w, u, kd, gamma),
           "kda_pairs_bwd": lambda: K.kda_pairs_backward(q, k, G, da, db),
           "kda_state_bwd": lambda: K.kda_state_backward(w, kd, gamma, gS, gv)}
    hbm = gen.hbm_gbps * 1e9
    flush = torch.ones(64 * 2**20, device=dev)
    flush_ms = graph_ms(lambda: flush.sum(), dev)
    out["timing"] = {}
    for name, fn in fns.items():
        tm = {"kernel_graph": graph_ms(fn, dev, n=3, reps=5),
              "kernel_cold": graph_ms(lambda fn=fn: (flush.sum(), fn()), dev, n=3, reps=5) - flush_ms}
        out["timing"][name] = tm
        gc_cuda([dev])
    for side, backward in (("fwd", False), ("bwd", True)):
        call = sum(out["timing"][f"kda_{n}_{side}"]["kernel_cold"] for n in ("pairs", "state"))
        bound = kda_call_bytes(KDA_SHAPE, backward) / hbm * 1e3
        for n in ("pairs", "state"):
            out["timing"][f"kda_{n}_{side}"].update(bound_ms=bound, call_ms=call)
        print(f"kda_pairs_{side} + kda_state_{side} at the cell's shapes [{card}]: "
              f"{out['timing'][f'kda_pairs_{side}']['kernel_cold']:.3f} + "
              f"{out['timing'][f'kda_state_{side}']['kernel_cold']:.3f} ms with L2 emptied before "
              f"each call ({out['timing'][f'kda_pairs_{side}']['kernel_graph']:.3f} + "
              f"{out['timing'][f'kda_state_{side}']['kernel_graph']:.3f} ms warm); a call's bound "
              f"{bound:.4f} ms ({kda_call_bytes(KDA_SHAPE, backward) / 1e6:.1f} MB): "
              f"{100 * bound / call:.2f} % of it")
    del flush, q, k, G, w, u, kd, gamma, da, db, gS, gv, pc, x
    gc_cuda([dev])
    return out


def graph_ms(fn, dev, n: int = 20, reps: int = 9) -> float:
    """Median ms a call of ``fn`` with ``n`` calls captured in one CUDA graph
    and replayed: device time without the host's launch cost."""
    import torch

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


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
    for path in dict.fromkeys(k.library_path for k in kernels.KERNELS):
        names = [k.name for k in kernels.KERNELS if k.library_path == path]
        log = next(k.build_log for k in kernels.KERNELS if k.library_path == path)
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
        print(f"  {'/'.join(names)}: {len(regs)} entry functions, at most "
              f"{max(regs, default=0)} registers a thread, {spills} bytes spilled")

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

    start_device_tracing()  # before the first capture (3f profiles a step)

    # -- 3d. the norm kernels, and their launches in one capture of the tp 4 step --
    norm = norm_phase([dev] * 4, card, gen, "one card; the tp 4 step over the card named four times")

    # -- 3e. the MoE dispatch kernels at the DeepSeek-V2-Lite cell's shapes ---------
    moe_dispatch = moe_dispatch_phase(dev, card, gen)

    # -- 3f. MLA's RoPE and q/k assembly kernels at the cell's shapes ----------------
    mla = mla_rope_phase(dev, card, gen, step=moe_dispatch["step"])

    # -- 3g. Kimi-Linear's KDA kernels, and the Kimi-Linear step -----------------------
    kda = kda_phase(dev, card, gen)

    # -- 3a-3c. the exporter as deployed: prebuilt kernels with no compiler, the
    # image's build stage with no GPU, the DaemonSet's command --------------------
    with tempfile.TemporaryDirectory(prefix="tpudash-deploy-") as tmp:
        prebuilt_phase(card, (rows, cols, block_rows), Path(tmp))
        venv = image_build_phase(card, (rows, cols, block_rows), Path(tmp))
        manifest_phase(card, venv, Path(tmp))

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
    check(bench_counts == {"hbm_read": (10 + 410) * 6, "hbm_copy": (5 + 205) * 6,
                           **{k.name: 0 for k in (*kernels.NORM_KERNELS, *kernels.MOE_KERNELS,
                                                  *kernels.MLA_KERNELS, *kernels.KDA_KERNELS)}},
          f"bench launches {bench_counts}")
    print(f"probe bench path [{card}]: matmul 4096/64 {mm.value:.2f} TFLOP/s "
          f"({100 * mm.value / gen.peak_bf16_tflops:.2f} % of peak); read 256 MiB k1=10 k2=410 "
          f"{hbm.value:.2f} GB/s ({100 * hbm.value / gen.hbm_gbps:.2f} %); copy 256 MiB "
          f"k1=5 k2=205 {cp.value:.2f} GB/s ({100 * cp.value / gen.hbm_gbps:.2f} %); "
          f"launches {bench_counts}")

    # -- 6. the inter-GPU probes -------------------------------------------------
    kernels.reset_launch_counts()
    ici_phase([dev, dev], card, gen, "rehearsal on one card: device-to-device copy "
              "rates of cuda:0 to cuda:0, not an interconnect rate")
    n_gpus = torch.cuda.device_count()
    if n_gpus > 1:
        ici_phase([torch.device("cuda", i) for i in range(n_gpus)], card, gen,
                  f"peer copies between {n_gpus} distinct GPUs")
    else:
        print("inter-GPU probes over distinct GPUs: NOT RUN (this machine has 1 GPU); "
              "only the one-card rehearsal ran")
    ici_counts = kernels.launch_counts()
    print(f"inter-GPU probe path: launches {ici_counts} (the per-device probes of each slot)")

    # -- 7. the training path ------------------------------------------------------
    kernels.reset_launch_counts()
    training_phase(dev, card, gen)
    train_counts = kernels.launch_counts()
    check(trains_norms_only(train_counts), f"training path launches {train_counts}")
    print(f"training path: launches {train_counts} (no probe kernel; the norm's kernels)")

    # -- 7b. the dp×tp sharded step, its source and exporter ------------------------
    every_gpu = [torch.device("cuda", i) for i in range(n_gpus)]
    kernels.reset_launch_counts()
    sharded_phase([dev, dev], card, gen, "rehearsal on one card named twice: the maths of "
                  "the mesh, not its placement")
    if n_gpus > 1:
        sharded_phase(every_gpu, card, gen, f"{n_gpus} distinct GPUs")
    else:
        print("sharded step over distinct GPUs: NOT RUN (this machine has 1 GPU); only the "
              "one-card rehearsal ran")
    if n_gpus > 1:
        norm_phase(every_gpu, card, gen, f"{n_gpus} distinct GPUs", timing=False)
    vocab_parallel_phase([[dev] * n for n in (1, 2, 4, 8)], card)
    gradient_limit_phase(dev, card)
    sharded_counts = kernels.launch_counts()
    check(trains_norms_only(sharded_counts), f"sharded path launches {sharded_counts}")
    print(f"sharded path: launches {sharded_counts}")

    # -- 7c. ring attention over an sp ring and its train step -------------------------
    kernels.reset_launch_counts()
    ring_phase([dev, dev], card, "rehearsal on one card named twice")
    if n_gpus > 1:
        ring_phase(every_gpu, card, f"{n_gpus} distinct GPUs")
    else:
        print("ring attention over distinct GPUs: NOT RUN (this machine has 1 GPU)")
    ring_counts = kernels.launch_counts()
    check(trains_norms_only(ring_counts), f"ring path launches {ring_counts}")
    print(f"ring path: launches {ring_counts}")

    # -- 7d. the pipeline, 3D and MoE steps and the dry run --------------------------
    new_counts = {}

    def counted(path: str, run, reads: bool = False, trains: bool = True) -> None:
        """Run a path between a reset and a read of the launch counts: the
        copy kernel launches on none of these paths, the read kernel on
        those that run the probe source (``reads``) only, the norm's on
        those that train (``trains``)."""
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run()
        took = time.perf_counter() - t0
        c = new_counts[path] = kernels.launch_counts()
        norms = c["rmsnorm_fwd"] > 0 and c["rmsnorm_bwd"] > 0
        kda = sum(c[k.name] for k in kernels.KDA_KERNELS)
        check(c["hbm_copy"] == 0 and (c["hbm_read"] > 0) == reads and (not trains or norms)
              and kda == 0, f"{path} path launches {c}")
        print(f"{path} path: launches {c}; {took:.1f} s")

    def pipelines() -> None:
        pipeline_phase([dev] * 2, card, "rehearsal on one card named twice", {"dp": 1, "pp": 2}, 4)
        pipeline_phase([dev] * 4, card, "rehearsal on one card named four times",
                       {"dp": 2, "pp": 2}, 4)
        if n_gpus > 1:
            pipeline_phase(every_gpu, card, f"{n_gpus} distinct GPUs", {"dp": 1, "pp": n_gpus}, 4)

    def pipelines3d() -> None:
        pipeline_phase([dev] * 4, card, "rehearsal on one card named four times",
                       {"dp": 1, "pp": 2, "tp": 2}, 2)
        if n_gpus % 4 == 0:
            pipeline_phase(every_gpu, card, f"{n_gpus} distinct GPUs",
                           {"dp": n_gpus // 4, "pp": 2, "tp": 2}, 2)

    def moes() -> None:
        moe_phase([dev], card, "one card")
        moe_phase([dev] * 2, card, "rehearsal on one card named twice")
        if n_gpus > 1:
            moe_phase(every_gpu, card, f"{n_gpus} distinct GPUs")

    counted("pipeline", pipelines)
    counted("pipeline3d", pipelines3d)
    counted("moe", moes)
    counted("dryrun", lambda: dryrun_phase(dev, card))
    if n_gpus == 1:
        print("pipeline, 3D and MoE over distinct GPUs: NOT RUN (this machine has 1 GPU); only the "
              "one-card rehearsals ran")

    # -- 7e. the anomaly scorer, the demo and the device trace ------------------------
    counted("anomaly", lambda: anomaly_phase(every_gpu, card), trains=False)
    counted("demo", lambda: demo_phase(card), reads=True, trains=False)
    counted("trace", lambda: trace_phase(dev, card), reads=True)

    # -- 7f. the train step as one CUDA graph -------------------------------------------
    def graphs() -> None:
        graph_phase([dev, dev], card, "rehearsal on one card named twice")
        if n_gpus > 1:
            graph_phase(every_gpu, card, f"{n_gpus} distinct GPUs")

    counted("graph", graphs)

    # -- 7g. every other make_*_train_step's step as one CUDA graph, against eager ------
    def path_graphs() -> None:
        for kind, n, axes, m in (("pipeline", 2, {"dp": 1, "pp": 2}, 4),
                                 ("pipeline", 4, {"dp": 2, "pp": 2}, 4),
                                 ("pipeline3d", 4, {"dp": 1, "pp": 2, "tp": 2}, 2),
                                 ("moe", 1, {"ep": 1}, 0),
                                 ("moe", 2, {"ep": 2}, 0),
                                 ("ring", 2, {"dp": 1, "sp": 2}, 0)):
            path_graph_phase(kind, [dev] * n, axes, card,
                             "one card" if n == 1 else f"one card named {n} times", m)
        print("these steps' graphs over distinct GPUs: tools/workload_check.py --phases "
              "ring,pipeline,pipeline3d,moe")

    counted("path graphs", path_graphs)

    # -- 8. per-kernel times at the main path's shapes ---------------------------
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
         "device_ms": read_dev, "host_us": read_host, "path": "exporter main path",
         "launches_by_path": {"exporter": main_counts["hbm_read"], "bench": bench_counts["hbm_read"],
                              "inter_gpu": ici_counts["hbm_read"], "training": train_counts["hbm_read"],
                              "sharded": sharded_counts["hbm_read"], "ring": ring_counts["hbm_read"],
                              **{path: c["hbm_read"] for path, c in new_counts.items()}}},
        {"name": "hbm_copy", "route": "cuda", "source": "tpudash_torch/ops/csrc/hbm_copy.cu",
         "replaces": "tpudash/ops/probes.py:196", "launches": bench_counts["hbm_copy"],
         "max_abs_err": 0.0, "ms": copy_t["kernel"], "plain_ms": copy_t["plain"],
         "bound_ms": copy_bound, "bound_by": copy_by, "library_ms": copy_t["library"],
         "device_ms": copy_dev, "host_us": copy_host, "path": "probe bench path",
         "launches_by_path": {"exporter": main_counts["hbm_copy"], "bench": bench_counts["hbm_copy"],
                              "inter_gpu": ici_counts["hbm_copy"], "training": train_counts["hbm_copy"],
                              "sharded": sharded_counts["hbm_copy"], "ring": ring_counts["hbm_copy"],
                              **{path: c["hbm_copy"] for path, c in new_counts.items()}}},
    ]
    paths = {"exporter": main_counts, "bench": bench_counts, "inter_gpu": ici_counts,
             "training": train_counts, "sharded": sharded_counts, "ring": ring_counts, **new_counts}
    for name, side in (("rmsnorm_fwd", "forward"), ("rmsnorm_bwd", "backward")):
        t = norm["timing"][side]
        entries.append({
            "name": name, "route": "cuda", "source": "tpudash_torch/ops/csrc/rmsnorm.cu",
            "replaces": "none (tpudash/models/workload.py:97 _rmsnorm, XLA-fused)",
            "launches": norm["counts"]["first_call"][name],
            "max_abs_err": None, "worst": norm["worst"], "ms": t["kernel_cold"],
            "graph_ms": t["kernel_graph"], "device_ms_hot": t["kernel_device"],
            "plain_ms": t["plain_device"], "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t["library_device"],
            "path": f"tp {norm['counts']['devices']} train step, {side}",
            "shape": norm["timing"]["shape"],
            "per_device_step": norm["counts"]["per_device_step"][name],
            "launches_by_path": {path: c[name] for path, c in paths.items()}})

    for name, t in moe_dispatch["timing"].items():
        entries.append({
            "name": name, "route": "cuda", "source": "tpudash_torch/ops/csrc/moe_dispatch.cu",
            "replaces": "none (models/deepseek_v2.py::_held_experts's padded dispatch; the "
                        "reference's MoE is a one-hot product)",
            "launches": moe_dispatch["step"]["first_call"][name], "max_abs_err": None,
            "worst": moe_dispatch["checks"], "ms": t["kernel_cold"], "graph_ms": t["kernel_graph"],
            "chain_ms": t["chain_cold"], "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "path": "DeepSeek-V2-Lite train step", "n_valid": moe_dispatch["n_valid"],
            "cap": moe_dispatch["cap"], "per_step": moe_dispatch["step"]["per_step"][name],
            "launches_by_path": {path: c[name] for path, c in paths.items()}})

    def us(v):
        return "not measured" if v is None else f"{v * 1e3:.2f} us"

    for name, t in mla["timing"].items():
        entries.append({
            "name": name, "route": "cuda", "source": "tpudash_torch/ops/csrc/mla_rope.cu",
            "replaces": "none (models/deepseek_v2.py::_mla's RoPE, cats and split, and their "
                        "autograd; the JAX package has no MLA or RoPE)",
            "launches": mla["step"]["first_call"][name], "max_abs_err": None,
            "worst": {"key_ulps": mla["checks"]["ulps"]}, "ms": t["kernel_cold"],
            "graph_ms": t["kernel_graph"], "chain_ms": t["chain_cold"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "path": "DeepSeek-V2-Lite train step",
            "per_step": mla["step"]["per_step"][name],
            "launches_by_path": {path: c[name] for path, c in paths.items()}})

    for name, t in kda["timing"].items():
        entries.append({
            "name": name, "route": "cuda", "source": "tpudash_torch/ops/csrc/kda.cu",
            "replaces": "none (the JAX package has no linear attention; models/kimi_linear.py's "
                        "chunked gated delta rule, kernels.kda_chunk)",
            "launches": kda["step"]["first_call"][name], "max_abs_err": None,
            "worst": kda["checks"], "ms": t["kernel_cold"], "graph_ms": t["kernel_graph"],
            "chain_ms": None, "bound_ms": t["bound_ms"], "call_ms": t["call_ms"],
            "bound_by": "bytes (a call's, both kernels)", "path": "Kimi-Linear train step",
            "per_step": kda["step"]["per_step"].get(name, 0),
            "launches_by_path": {path: c[name] for path, c in paths.items()}})

    for e in entries:
        if "chain_ms" in e:  # printed by moe_dispatch_phase, mla_rope_phase and kda_phase
            continue
        if "device_ms" not in e:
            print(f"{e['name']} at {e['shape']} bf16 [{card}]: {e['ms'] * 1e3:.2f} us with L2 "
                  f"emptied ({e['graph_ms'] * 1e3:.2f} us warm), bound {e['bound_ms'] * 1e3:.2f} us "
                  f"(bytes, {100 * e['bound_ms'] / e['ms']:.2f} % of bound), device time: plain "
                  f"{e['plain_ms'] * 1e3:.2f} us, library {e['library_ms'] * 1e3:.2f} us; launches by "
                  f"path {e['launches_by_path']}")
            continue
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

    # -- 9. result ---------------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
