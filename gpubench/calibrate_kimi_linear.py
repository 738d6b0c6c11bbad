"""The readings that the Kimi-Linear cells' limits are set from, in one
process (``calibrate_deepseek_v2.py``'s, for the ``kimi_linear_train`` kind).

    python3 gpubench/calibrate_kimi_linear.py --workload kimi-linear-ep16.1gpu \
        --seeds 1,2,... [--control-seeds 1,2] [--fault-seeds 1,2] [--faults a,b]

For each of ``--seeds``, the numbers that decide ``correct`` as a sound run
of the program gives them (the lower readings); for each of
``--control-seeds``, as the reference one precision down (fp8 products)
gives them in the program's place, and as the reference fed half of each
batch gives them (the upper readings); for each of ``--fault-seeds``, as
each planted fault of the program (:data:`FAULTS`, or those ``--faults``
names by their index, :data:`SCAN_BF16` after them) gives them.  One JSON
object a reading on standard output, with ``by_leaf`` as
``calibrate_deepseek_v2.by_leaf`` gives it.  Not
run by the benchmark's own runs; the limits in the configuration were set
from its output (``PERF.md`` gives the readings).

Each fault is planted where the card's step runs: in the model module's
functions that the step looks up at each call, or in ``kernels.kda_chunk``
and the functions it calls, through which the KDA layers reach the kernels.
The scan in bf16 replaces the kernels' f32 state pass by a loop over the
chunks that rounds the carried state at each, and rounds the pair blocks.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gpubench import manifest  # noqa: E402
from gpubench.calibrate import _free  # noqa: E402
from gpubench.calibrate_deepseek_v2 import by_leaf  # noqa: E402

#: the planted faults of the program's model, each a mistake that a port of
#: the architecture could make
FAULTS = ("decay a head's mean", "beta fixed at 1", "short convolution left out",
          "q/k L2 norm left out", "output gate left out", "top-k gates not renormalised")
#: the program's chunked rule one precision below the f32 that the
#: configuration states for it; ``--faults`` names it by the index after
#: :data:`FAULTS`.  Not one of them: at the CPU tests' seq of 80 (two chunks)
#: it reads as a sound run does
SCAN_BF16 = "scan in bf16"


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _state_bf16(w, u, kd, gamma) -> tuple:
    """``kernels.kda_state_ref``'s loop over the chunks with its inputs, the
    state it carries from chunk to chunk and v_new each rounded to bf16."""
    w, u, kd = (_bf16(x) for x in (w, u, kd))
    S = w.new_zeros(*w.shape[:2], w.shape[-1], u.shape[-1])
    states, v_new = [S], []
    for n in range(w.shape[2]):
        x = _bf16(u[:, :, n] - torch.matmul(w[:, :, n], S))
        S = _bf16(gamma[:, :, n, :, None] * S + torch.matmul(kd[:, :, n].transpose(-1, -2), x))
        states.append(S)
        v_new.append(x)
    return torch.stack(states, 2), torch.stack(v_new, 2)


@contextlib.contextmanager
def planted(kind: str):
    """The program's ``models/kimi_linear.py`` (or the chunked rule it
    calls) with the fault ``kind``."""
    import torch.nn.functional as F

    from tpudash_torch.models import kimi_linear as K
    from tpudash_torch.ops import kernels

    if kind == SCAN_BF16:  # the state, the pair blocks, w, u and v_new in bf16, not f32
        pairs = kernels.kda_pairs
        patches = {"kda_pairs": lambda q, k, G: tuple(_bf16(a) for a in pairs(q, k, G)),
                   "kda_state": _state_bf16}
        module = kernels
    elif kind in ("decay a head's mean", "beta fixed at 1"):
        module, orig = kernels, kernels.kda_chunk

        def broken(q, k, v, g, beta, scale):
            if kind == "beta fixed at 1":
                beta = torch.ones_like(beta)
            else:  # Gated DeltaNet's scalar decay: one a head
                g = g.mean(-1, keepdim=True).expand_as(g).contiguous()
            return orig(q, k, v, g, beta, scale)
        patches = {"kda_chunk": broken}
    else:
        module = K
        name = {"short convolution left out": "_short_conv", "q/k L2 norm left out": "_l2norm",
                "output gate left out": "_gated_norm",
                "top-k gates not renormalised": "_route"}[kind]
        orig = getattr(K, name)
        if kind == "short convolution left out":
            def broken(x, filters):
                return F.silu(x.float())
        elif kind == "q/k L2 norm left out":
            def broken(x):
                return x
        elif kind == "output gate left out":
            def broken(o, gate, scale, eps):
                return orig(o, torch.full_like(gate, 30.0), scale, eps)  # sigmoid(30) = 1 in f32
        else:
            def broken(x, router, cfg):
                scores = torch.sigmoid(torch.matmul(x.float(), router))
                gates, experts = K.moe._top_k(scores, cfg.top_k)
                return gates * cfg.routed_scaling_factor, experts
        patches = {name: broken}
    origs = {name: getattr(module, name) for name in patches}
    for name, broken in patches.items():
        setattr(module, name, broken)
    try:
        yield
    finally:
        for name, orig in origs.items():
            setattr(module, name, orig)


def readings(cell, devices, seeds, control_seeds, fault_seeds, out, faults=FAULTS,
             base=manifest.HERE) -> None:
    driver_cls = manifest.driver_class(cell.config["kind"], base)
    B = cell.traffic["batch"]

    def program(what: str, seed: int, fault: "str | None" = None) -> None:
        d = driver_cls(cell, seed, devices)
        with planted(fault) if fault else contextlib.nullcontext():
            d.setup()
        d.free()
        _free()
        want = d.reference()
        out(what, seed, d.numbers(d.readings, want), by_leaf(d.readings, want))
        del d
        _free()

    for seed in seeds:
        program("program", seed)
    for seed in control_seeds:
        d = driver_cls(cell, seed, devices)
        d.pool = d.tokens()
        want = d.reference()
        fp8 = d.reference("fp8")
        out("control fp8", seed, d.numbers(fp8, want), by_leaf(fp8, want))
        del fp8
        half = d.reference(rows=slice(0, B // 2))
        out("fault half batch", seed, d.numbers(half, want), by_leaf(half, want))
        del d, want, half
        _free()
    for seed in fault_seeds:
        for fault in faults:
            program(f"fault {fault}", seed, fault)


def main(argv: list) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default=[], type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--control-seeds", default=[], type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--fault-seeds", default=[], type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--faults", default=None,
                    type=lambda s: [(*FAULTS, SCAN_BF16)[int(x)] for x in s.split(",")])
    args = ap.parse_args(argv)

    cell = manifest.find_cell(manifest.load_manifest(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {cell.name} needs {cell.chips} CUDA devices", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]

    def out(what: str, seed: int, numbers: dict, leaves: dict) -> None:
        print(json.dumps({"cell": cell.name, "what": what, "seed": seed, "numbers": numbers,
                          "by_leaf": leaves}), flush=True)

    readings(cell, devices, args.seeds, args.control_seeds, args.fault_seeds, out,
             args.faults or FAULTS)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
