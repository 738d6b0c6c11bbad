"""Arithmetic over every item of a measured window."""

from __future__ import annotations

import math


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) of every value, by linear
    interpolation between the closest ranks (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
