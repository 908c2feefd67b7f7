"""Order statistics of a run's samples."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest sample with at
    least q% of the samples at or below it."""
    if not values:
        raise ValueError("percentile of no samples")
    s = sorted(values)
    return s[max(int(math.ceil(q / 100.0 * len(s))) - 1, 0)]


def spread(values: Sequence[float]) -> float:
    """The quartiles' distance as a share of the median
    (statistics.quantiles, exclusive method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
