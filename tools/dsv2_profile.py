#!/usr/bin/env python3
"""One eager DeepSeek-V2-Lite train step of one checkout's ``tpudash_torch``
under torch.profiler, so that two checkouts compare in one run.

    python3 tools/dsv2_profile.py --tree DIR [--out FILE]

A measurement tool, not part of the package: nothing imports it.  The
package comes from ``--tree`` (a checkout, e.g. an unpacked ``git archive``
of another commit); the measuring code (``chip_smoke.dsv2_eager_profile``)
from this one.  At the cell's defaults on cuda:0, after one step to warm up:
the step's device ms by kernel, and the device ms of the kinds of
``chip_smoke.GLUE_KINDS`` (cats, copies, f32 products, bf16 adds, fills)
over the step and under the ``dsv2.mla`` spans.  Prints one JSON object and,
with ``--out``, writes it there.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="the checkout whose tpudash_torch is measured")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
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
        print("dsv2_profile: no GPU", file=sys.stderr)
        return 1
    cs.start_device_tracing()
    card = cs.card_line()
    print(f"dsv2_profile: tpudash_torch from {Path(tpudash_torch.__file__).parent}; {card}; "
          f"torch {torch.__version__}")
    r = {"tree": str(tree), **cs.dsv2_eager_profile(torch.device("cuda", 0), card)}
    print(json.dumps(r))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(r, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
