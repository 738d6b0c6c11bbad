#!/usr/bin/env python3
"""Whether autograd's per-device worker threads can take part in the
capture of one CUDA graph over several GPUs.

    python3 tools/graph_threads_check.py

A check tool, not part of the package: nothing imports it.
``graph_train_step`` (``tpudash_torch/models/graphed.py``) runs its warm-up
and its capture with autograd's multithreading off, so that the backward
runs on the capturing thread.  This tool captures the dp×tp sharded step
at the workload source's defaults over every GPU of the host as
``graph_train_step`` does, and then with autograd's worker threads on
(the backward on a thread a device, as PyTorch runs it by default), in
each capture error mode ("global", "thread_local", "relaxed").  Each case
runs in a process of its own, since a failed capture may leave its
process unfit for the next.  For each it prints whether the capture
succeeded, the error where it did not, and where it did, whether 4
replays equal the same 4 steps run eagerly with the backward threaded as
in the capture.  It fails on a host with fewer than two GPUs, and when
the case that ``graph_train_step`` runs does not capture or does not
replay the eager steps bitwise.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASES = ("shipped", "threads:global", "threads:thread_local", "threads:relaxed")


def run_case(case: str) -> int:
    """One case in this process; prints one line starting with ``case``."""
    import contextlib

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tpudash_torch.models import graphed
    from tpudash_torch.models import workload as W
    from tpudash_torch.parallel.mesh import build_mesh, mesh_axes_for

    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    cfg = W.WorkloadConfig(**chip_smoke.WORKLOAD_DEFAULTS)
    mesh = build_mesh(mesh_axes_for(len(devices)), devices)
    step, shard_inputs = W.make_sharded_train_step(mesh, cfg)
    step = step.eager  # captured here by hand, in each case's mode

    def state():
        gen = torch.Generator(device=devices[0]).manual_seed(0)
        return shard_inputs(*W.make_train_state(cfg, gen))

    g = torch.Generator(device=devices[0]).manual_seed(1)
    batches = [torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), generator=g, device=devices[0])
               for _ in range(4)]
    eager, live = state(), state()
    if case != "shipped":
        graphed.CAPTURE_ERROR_MODE = case.split(":")[1]
        # autograd's worker threads stay on through the warm-up and the capture
        graphed.torch.autograd.set_multithreading_enabled = lambda mode: contextlib.nullcontext()
    try:
        replay = graphed.graph_train_step(step, *live, batches[0])
        got = [replay(t).item() for t in batches]
    except Exception as e:  # noqa: BLE001 — the error is the finding
        print(f"{case}: capture FAILED: {type(e).__name__}: {str(e).splitlines()[0][:300]}")
        return 3
    # eager in the capture's order: on one thread, or (the switch is a no-op
    # in the other cases) on a thread a device
    with torch.autograd.set_multithreading_enabled(False):
        want = [step(*eager, t).item() for t in batches]
    for d in devices:
        torch.cuda.synchronize(d)
    same = got == want and all(torch.equal(a, b) for a, b in zip(W.shard_leaves(eager[0]),
                                                                  W.shard_leaves(live[0])))
    print(f"{case}: captured; 4 replays {'bitwise equal to' if same else 'DIFFER from'} the same "
          f"eager steps with the backward in the capture's threading (losses {got} vs {want})")
    return 0 if same else 4


def main(argv: list) -> int:
    if argv:
        return run_case(argv[0])
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"graph_threads_check: {n} GPU(s); the check needs two or more", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    print(f"cards: {chip_smoke.card_line()} (x{n}); torch {torch.__version__}; the sharded step at "
          f"the workload defaults over {n} GPUs, one process a case")
    rcs = {}
    for case in CASES:
        try:
            done = subprocess.run([sys.executable, __file__, case], capture_output=True, text=True,
                                  timeout=300)
        except subprocess.TimeoutExpired:  # run() has killed the child
            print(f"{case}: no result in 300 s")
            rcs[case] = None
            continue
        lines = [ln for ln in done.stdout.splitlines() if ln.startswith(case + ":")]
        print(lines[-1] if lines else f"{case}: exit {done.returncode}, no result; stderr tail: "
              f"{done.stderr.strip().splitlines()[-1:]}")
        rcs[case] = done.returncode
    return 0 if rcs["shipped"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
