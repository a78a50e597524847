"""The statistics of the end-to-end metrics, over every sample."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of all the values, by linear
    interpolation between the closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window_rate_ms(window_s: float, n: int) -> float:
    """The window's milliseconds over the n frames completed in it."""
    if n < 1:
        raise ValueError("no frame completed in the window")
    return window_s * 1e3 / n


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (statistics.quantiles, n=4, its default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
