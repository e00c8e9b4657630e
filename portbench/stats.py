"""Order statistics of the benchmark's samples."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, interpolating
    linearly between the order statistics that bracket it (numpy's
    default, ``statistics.quantiles(method="inclusive")``)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values) -> float:
    xs = list(values)
    if not xs:
        raise ValueError("mean of no values")
    return sum(xs) / len(xs)
