"""Latency and spread arithmetic of the benchmark (the yardstick).

Written for the harness, not imported from the program: a later change to
the program may change its own latency windows, never this arithmetic.
Every request of a window is kept; a percentile is taken over all of them.
"""

from __future__ import annotations

import math
import statistics


def nearest_rank(values, q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) by nearest rank: the
    ``ceil(q / 100 * n)``-th smallest value.  ``inf`` entries (requests that
    failed or were refused) sort last, as misses of every limit."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, with Python's ``statistics.quantiles(n=4)``
    (the exclusive method), the spread a bound is set from."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("inf")
