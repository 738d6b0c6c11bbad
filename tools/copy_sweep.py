#!/usr/bin/env python3
"""The copy kernel's design choices, each measured beside ``dst.copy_(src)`` on one GPU.

    python3 tools/copy_sweep.py [--mb 256] [--json PATH]

A measurement tool, not part of the package: nothing imports it.  It
compares the kernel of ``tpudash_torch/ops/csrc/hbm_copy.cu`` with

- other launch plans of the same kernel: CTAs per SM and ring shapes (the
  kernel takes any plan; ``kernels._copy_plan`` commits one);
- source variants made from the same file by text substitution, each built
  into its own library: ``contiguous`` (each CTA copies one contiguous run
  of tiles instead of every grid-th tile), ``no_hint`` (no L2
  ``evict_first`` hint on the bulk loads and stores), ``lag2`` (loads run
  stages - 2 ahead behind ``wait_group.read 2``), ``rounds`` (each CTA
  fills its whole ring, then drains it);
- two diagnostics that move one side only, beside ``x.sum()`` and
  ``dst.fill_(1)``: ``loads_only`` (the ring's bulk loads, no stores) and
  ``stores_only`` (its bulk stores, no loads).

Every copying variant is first held to exact equality with its input, and
to leaving the bytes past its output alone, at the buffer size and at the
edges of its plan.  Then all of them and ``copy_`` are timed by CUDA
events, 100 back-to-back calls per window, in turns, median of 7 windows,
beside the bound of the bytes they move at the H100 SXM5's datasheet
3.35 TB/s.  Needs a GPU.  A variant whose text to replace is no longer in
the kernel's source is an error: update the substitution with the kernel.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tpudash_torch.ops import kernels  # noqa: E402

_INTERLEAVED = """\
  first = b;
  step = g;
  count = b < n_items ? (n_items - 1 - b) / g + 1 : 0;
"""
_CONTIGUOUS = """\
  const long long per = (n_items + g - 1) / g;
  first = b * per;
  step = 1;
  count = first < n_items ? (n_items - first < per ? n_items - first : per) : 0;
"""
_LOAD = """\
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
"""
_LOAD_NO_HINT = """\
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
"""
_STORE = """\
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
               ::"l"(dst), "r"(src), "r"(bytes), "l"(policy)
               : "memory");
"""
_STORE_NO_HINT = """\
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
"""
_NOTHING = "  (void)dst; (void)src; (void)bytes; (void)policy;\n"
_ARRIVE_TX = '"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"'
_RING = """\
  const long long ahead = count < stages - 1 ? count : stages - 1;
  for (long long k = 0; k < ahead; ++k) load(k, static_cast<int>(k));
  int s = 0;
  uint32_t parity = 0;
  for (long long k = 0; k < count; ++k) {
    bar_wait(bar0 + 8u * s, parity);
    const long long item = first + k * step;
    bulk_store(dst + item * tile_bytes, ring0 + static_cast<uint32_t>(s) * tile_bytes,
               item < n_tiles ? tile_bytes : tail_bytes, policy);
    if (k + stages - 1 < count) {
      // the stage item k - 1 was stored from takes item k + stages - 1
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(k + stages - 1, s == 0 ? stages - 1 : s - 1);
    }
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
  }
"""
#: whole rounds: fill every stage, then drain every stage, then wait until
#: the stores have read the ring before the next round's loads
_ROUNDS = """\
  uint32_t parity = 0;
  for (long long k0 = 0; k0 < count; k0 += stages) {
    const int m = count - k0 < stages ? static_cast<int>(count - k0) : stages;
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    for (int s = 0; s < m; ++s) load(k0 + s, s);
    for (int s = 0; s < m; ++s) {
      bar_wait(bar0 + 8u * s, parity);
      const long long item = first + (k0 + s) * step;
      bulk_store(dst + item * tile_bytes, ring0 + static_cast<uint32_t>(s) * tile_bytes,
                 item < n_tiles ? tile_bytes : tail_bytes, policy);
    }
    parity ^= 1;
  }
"""
#: loads run stages - 2 ahead, so two stores may still read their stages
_LAG2 = [
    ("count < stages - 1 ? count : stages - 1", "count < stages - 2 ? count : stages - 2"),
    ("if (k + stages - 1 < count) {", "if (k + stages - 2 < count) {"),
    ("cp.async.bulk.wait_group.read 1;", "cp.async.bulk.wait_group.read 2;"),
    ("load(k + stages - 1, s == 0 ? stages - 1 : s - 1);",
     "load(k + stages - 2, (s + stages - 2) % stages);"),
]

#: source variants that copy; each is held to exactness before it is timed
_EDITS = {
    "contiguous": [(_INTERLEAVED, _CONTIGUOUS)],
    "no_hint": [(_LOAD, _LOAD_NO_HINT), (_STORE, _STORE_NO_HINT)],
    "lag2": _LAG2,
    "rounds": [(_RING, _ROUNDS)],
}
#: diagnostics that move one side only: bulk loads into the ring with no
#: stores, and bulk stores from the ring with no loads
_DIAGNOSTICS = {
    "loads_only": [(_STORE, _NOTHING)],
    "stores_only": [(_LOAD, _NOTHING),
                    (_ARRIVE_TX, '"mbarrier.arrive.shared::cta.b64 _, [%0]; // %1"')],
}

#: (CTAs per SM, stages, tile KiB), the committed plan first; the CTAs of one
#: SM fit its 228 KB of shared memory together
COMMITTED = (kernels.COPY_CTAS_PER_SM, kernels.COPY_STAGES, kernels.COPY_TILE_BYTES // 1024)
PLANS = [COMMITTED, (1, 4, 32), (1, 2, 64), (1, 8, 16), (4, 3, 16)]


def plan_for(n: int, sms: int, ctas_per_sm: int, stages: int, tile_kib: int) -> kernels.CopyPlan:
    """``kernels._copy_plan``'s cut of ``n`` floats at another grid and ring."""
    tile = tile_kib * 1024
    n_tiles, tail = divmod(n // 4 * 16, tile)
    grid = max(1, min(sms * ctas_per_sm, n_tiles + (tail > 0)))
    return kernels.CopyPlan(grid, tile, stages, n_tiles, tail, n % 4)


def variant_kernels(out_dir: Path) -> dict[str, kernels.CudaKernel]:
    """Each source variant written under ``out_dir``, as its own kernel."""
    text = kernels.HBM_COPY.source.read_text()
    made = {}
    for name, edits in {**_EDITS, **_DIAGNOSTICS}.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: the text to replace is not in hbm_copy.cu "
                                   f"once:\n{old}")
            src = src.replace(old, new)
        path = out_dir / f"hbm_copy_{name}.cu"
        path.write_text(src)
        made[name] = kernels.CudaKernel(name, str(path), kernels.HBM_COPY.symbol,
                                        kernels.HBM_COPY.argtypes)
    return made


def exact_copy(launch, n: int, dev: torch.device) -> bool:
    """``launch(src, dst, n)`` copies ``n`` random floats exactly and writes
    nothing past them."""
    x = torch.randn(n, device=dev)
    guard = torch.full((n + 64,), -7.0, device=dev)
    launch(x, guard[:n], n)
    torch.cuda.synchronize()
    return torch.equal(guard[:n], x) and bool((guard[n:] == -7.0).all())


def time_in_turns(fns: dict, n: int = 100, reps: int = 7) -> dict[str, float]:
    """Median ms per call by CUDA events around ``n`` calls; the functions
    take turns, in reversed order every other round."""
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


def sweep(args, out_dir: Path) -> int:
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()[:1]
    print(f"card: {card[0] if card else 'nvidia-smi printed nothing'}")
    sms = kernels._sm_count(0)
    n = args.mb * 1024 * 1024 // 4
    if plan_for(n, sms, *COMMITTED) != kernels._copy_plan(n, sms):
        raise RuntimeError("plan_for no longer cuts as kernels._copy_plan does")
    variants = variant_kernels(out_dir)
    build_s = kernels.build_kernels([kernels.HBM_COPY, *variants.values()])
    print(f"build: {build_s:.2f} s for {1 + len(variants)} libraries; {sms} SMs")
    for k in (kernels.HBM_COPY, *variants.values()):
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}")

    configs = {f"kernel c={c} {s}x{t}KiB": (kernels.HBM_COPY, (c, s, t)) for c, s, t in PLANS}
    for name, k in variants.items():
        configs[name] = (k, COMMITTED)
    for label, (k, shape) in configs.items():
        if k.name in _DIAGNOSTICS:
            continue
        plan = plan_for(n, sms, *shape)
        t = plan.tile_bytes // 4
        edges = [t, t + 4, t - 100, 3 * t + 1, 3 * t + 2, 3 * t + 3, 1, 3,
                 (3 * plan.grid + 7) * t]
        bad = [m for m in [n, *edges] if not exact_copy(
            lambda x, out, m, k=k, shape=shape: k.launch(
                dev, x.data_ptr(), out.data_ptr(), *plan_for(m, sms, *shape)), m, dev)]
        if bad:
            print(f"copy_sweep: {label} is not an exact copy at n={bad}", file=sys.stderr)
            return 1
    print(f"every copying variant is exact at {n} floats and at its plan's edge sizes")

    x = torch.randn(n, device=dev)
    dst = torch.empty_like(x)
    fns = {"copy_": lambda: dst.copy_(x), "x.sum() (reads only)": lambda: x.sum(),
           "dst.fill_(1) (writes only)": lambda: dst.fill_(1.0)}
    for label, (k, shape) in configs.items():
        plan = plan_for(n, sms, *shape)
        fns[label] = lambda k=k, plan=plan: k.launch(dev, x.data_ptr(), dst.data_ptr(), *plan)
    ms = time_in_turns(fns)
    copy_bound_ms = 2 * n * 4 / 3.35e12 * 1e3
    rows = []
    for label, t in ms.items():
        bound_ms = copy_bound_ms / 2 if "only" in label else copy_bound_ms
        rows.append({"variant": label, "us": t * 1e3, "bound_us": bound_ms * 1e3,
                     "share_of_bound": bound_ms / t, "ratio_to_copy_": t / ms["copy_"]})
        print(f"{label:28s} {t * 1e3:9.2f} us  {100 * bound_ms / t:6.2f} % of its "
              f"{bound_ms * 1e3:.2f} us bound  {t / ms['copy_']:.4f} x copy_")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "n": n, "rows": rows}, f, indent=1)
    return 0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=int, default=256, help="buffer size, MiB")
    ap.add_argument("--json", help="write the results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("copy_sweep: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="copy_sweep-") as tmp:
        return sweep(args, Path(tmp))


if __name__ == "__main__":
    sys.exit(main())
