"""The numbers that decide ``correct``, and the judgement against their
limits.  Every number is a gap between what the program produced and what
the reference worked out; a run is correct when each is finite and at most
its limit (``configs/<name>.json``, ``limits``)."""

from __future__ import annotations

import math
import statistics


def loss_gap(program: list, reference: list) -> float:
    """The largest relative gap of a step's loss."""
    if len(program) != len(reference):
        return math.inf
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def norm_gaps(program: dict, reference: dict, names) -> dict:
    """Each named parameter's gap between the program's norm and the
    reference's, against the reference's norm of that parameter; inf for a
    name the program lacks."""
    return {n: abs(program[n] - reference[n]) / reference[n] if n in program else math.inf
            for n in names}


def norm_gap(program: dict, reference: dict, names) -> float:
    """The worst of :func:`norm_gaps`.  ``names`` are those that
    :func:`moved` keeps, so that no reference norm is nought to rounding."""
    return max(norm_gaps(program, reference, names).values())


def moved(ref_grad_norms: dict, share: float = 1e-3) -> list:
    """The parameters whose reference gradient is not nought to rounding:
    at least ``share`` of the median parameter's.  The others move under
    AdamW by round-off alone: neither their gradient nor their change is
    compared."""
    median = statistics.median(ref_grad_norms.values())
    return [n for n, g in ref_grad_norms.items() if g >= share * median]


def sum_gap(program: float, ref_sum: float, ref_rss: float) -> float:
    """A sum of many elements against the reference's, in units of the
    root sum of squares of the reference's elements (the size of such a sum
    of random signs)."""
    return abs(program - ref_sum) / ref_rss


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number beside its limit, ``checks`` in the
    limits' order.  A number without a limit, or a limit without a number,
    is a fault of the harness and raises."""
    if set(numbers) != set(limits):
        raise KeyError(f"numbers {sorted(numbers)} against limits {sorted(limits)}")
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
