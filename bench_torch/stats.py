"""Percentiles over all requests, rates over a whole window, spreads,
Poisson arrivals."""

from __future__ import annotations

import math
import random
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, linear between the
    closest ranks (numpy's default rule).  Infinite values (failed
    requests) sort last."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """Interquartile distance as a share of the median, with the quartiles
    of ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def spread_without_farthest(values: Sequence[float]) -> float:
    """``spread`` after leaving out the value farthest from the median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def poisson_gaps(rate_per_s: float, n: int, seed: int) -> list[float]:
    """``n`` inter-arrival gaps of a Poisson process at ``rate_per_s``:
    the exponential distribution's quantiles at ``(i + 0.5) / n``, in the
    seed's order, so that every seed offers the same gaps."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate_per_s for i in range(n)]
    random.Random(seed).shuffle(gaps)
    return gaps
