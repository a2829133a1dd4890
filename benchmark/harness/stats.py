"""Statistics over every sample of a window: no chunk or batch medians."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank p-th percentile of all values (a failed sample is
    +inf, and so lies above every percentile it can reach)."""
    if not values:
        raise ValueError("no samples")
    xs = sorted(values)
    rank = max(math.ceil(p / 100.0 * len(xs)), 1)
    return xs[rank - 1]


def rate(count: int, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("an empty window")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile as a share of
    the median, as `statistics.quantiles(values, n=4)` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
