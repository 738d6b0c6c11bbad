#!/usr/bin/env python3
"""The multi-GPU train steps of one checkout's ``tpudash_torch``, measured
alike, so that two checkouts compare in one run.

    python3 tools/step_compare.py --tree DIR [--paths sharded,ring,pipeline3d,moe]
        [--one-card N] [--steps 8] [--out FILE]

A measurement tool, not part of the package: nothing imports it.  The
package comes from ``--tree`` (a checkout, e.g. an unpacked ``git archive``
of another commit); the measuring code (``chip_smoke.step_timings``) and
the sizes (``chip_smoke.WORKLOAD_DEFAULTS``, ``MOE_DEFAULTS``) from this
one.  For each path, at full width over every GPU (or over cuda:0 named
``--one-card`` times), from a seeded state:

- the compiled step (one CUDA graph on GPUs) over ``--steps`` seeded
  batches: each loss, exactly (``float.hex``), and the graph's pool peak
  per device (allocated above the base during the warm-up, the capture
  and the first step);
- ``step_timings`` of the graphed step and of its ``.eager`` step (as
  PyTorch runs it, a backward thread a device) from a second state: step
  ms by the host clock, busy share and device ms per GPU, ``Memcpy PtoP``
  and ``Memcpy DtoD`` ms a step summed over the GPUs (``copies_ms``) and
  per GPU, that of the stream that ran the copy (``copies_ms_by_gpu``),
  host launch calls a step, peak memory above base.

Paths and their meshes, n the number of slots: ``sharded`` dp×tp as
``mesh_axes_for(n)`` splits n; ``ring`` dp×sp the same way; ``pipeline3d``
dp n/4 × pp 2 × tp 2 (M 2); ``pipeline`` dp n/2 × pp 2 (M 4); ``moe`` ep n.
Prints one JSON object a path and, with ``--out``, writes them all there.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PATHS = ("sharded", "ring", "pipeline3d", "pipeline", "moe")


def build(kind: str, devices: list, cs):
    """(step, make_state, cfg, axes) of ``kind`` over ``devices``."""
    import torch

    from tpudash_torch.models import moe as MO
    from tpudash_torch.models import pipeline as PL
    from tpudash_torch.models import ring_attention as R
    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import build_mesh, mesh_axes_for

    n, dev = len(devices), devices[0]

    def gen():
        return torch.Generator(device=dev).manual_seed(cs.SEED)

    if kind == "moe":
        cfg, axes = MO.MoEConfig(**cs.MOE_DEFAULTS), {"ep": n}
        step, shard_inputs = MO.make_moe_train_step(build_mesh(axes, devices), cfg)
        return step, lambda: shard_inputs(*MO.make_moe_train_state(cfg, gen())), cfg, axes
    cfg = W.WorkloadConfig(**cs.WORKLOAD_DEFAULTS)
    tp = mesh_axes_for(n)["tp"]
    if kind in ("sharded", "ring"):
        axes = {"dp": n // tp, "tp": tp} if kind == "sharded" else {"dp": n // tp, "sp": tp}
        make = W.make_sharded_train_step if kind == "sharded" else R.make_ring_train_step
        step, shard_inputs = make(build_mesh(axes, devices), cfg)
        return step, lambda: shard_inputs(*W.make_train_state(cfg, gen())), cfg, axes
    three_d = kind == "pipeline3d"
    axes = {"dp": n // 4, "pp": 2, "tp": 2} if three_d else {"dp": n // 2, "pp": 2}
    make = PL.make_pipeline3d_train_step if three_d else PL.make_pipeline_train_step
    step, shard_inputs = make(build_mesh(axes, devices), cfg, 2 if three_d else 4)

    def make_state():
        params = W.init_params(cfg, gen())
        return shard_inputs(PL.convert_params_3d(params) if three_d else params, None)

    return step, make_state, cfg, axes


def measure(kind: str, devices: list, steps: int, cs) -> dict:
    import torch

    step, make_state, cfg, axes = build(kind, devices, cs)
    dev, distinct = devices[0], list(dict.fromkeys(devices))
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    batches = [torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=g, device=dev)
               for _ in range(steps)]
    state = make_state()
    for d in distinct:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    base = {str(d): torch.cuda.memory_allocated(d) for d in distinct}
    t0 = time.perf_counter()
    losses = [step(*state, batches[0]).item()]
    capture_s = time.perf_counter() - t0
    pool = {str(d): torch.cuda.max_memory_allocated(d) - base[str(d)] for d in distinct}
    losses += [step(*state, t).item() for t in batches[1:]]
    out = {"path": kind, "axes": axes, "slots": [str(d) for d in devices],
           "losses": [x.hex() for x in losses], "loss_first_last": [losses[0], losses[-1]],
           "capture_s": capture_s, "pool_peak_gib": {d: b / 2**30 for d, b in pool.items()}}
    out["graphed"] = timings(cs.step_timings(lambda: step(*state, batches[0]), devices, 10))
    del state
    cs.gc_cuda(distinct)
    eager = make_state()
    out["eager"] = timings(cs.step_timings(lambda: step.eager(*eager, batches[0]), devices, 10))
    del eager
    cs.gc_cuda(distinct)
    return out


def timings(t: dict) -> dict:
    keep = ("step_ms", "event_ms", "issue_ms", "device_ms", "busy", "copies_ms", "copies_ms_by_gpu",
            "ops", "host_ops")
    return {**{k: t[k] for k in keep}, "top": t["top"][:16],
            "peak_above_base_gib": {d: b / 2**30 for d, b in t["peak_above_base"].items()}}


def main(argv: list) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="the checkout whose tpudash_torch is measured")
    ap.add_argument("--paths", default="sharded,ring,pipeline3d,moe", help=f"of {', '.join(PATHS)}")
    ap.add_argument("--one-card", type=int, default=0, help="cuda:0 named this many times")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        ap.error(f"unknown path in {paths}")
    tree = Path(args.tree).resolve()
    if not (tree / "tpudash_torch").is_dir():
        ap.error(f"no tpudash_torch in {tree}")
    sys.path.insert(0, str(tree))  # the package measured
    import importlib.util

    import torch

    import tpudash_torch

    # the measuring code of this checkout, whatever chip_smoke.py the tree has
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("step_compare: no GPU", file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    devices = ([torch.device("cuda", 0)] * args.one_card if args.one_card
               else [torch.device("cuda", i) for i in range(n)])
    cs.start_device_tracing()  # before the first capture
    card = cs.card_line()
    print(f"step_compare: tpudash_torch from {Path(tpudash_torch.__file__).parent}; {card} (x{n}); "
          f"torch {torch.__version__}")
    results = []
    for kind in paths:
        r = {"tree": str(tree), "card": card, **measure(kind, devices, args.steps, cs)}
        print(json.dumps(r))
        results.append(r)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
