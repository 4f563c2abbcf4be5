"""The end-to-end arithmetic: a rate over the whole window, and a tail
percentile over every request."""

from __future__ import annotations

import math


def rate(completed: int, window_s: float) -> float:
    """Requests completed over the window's whole length, per second."""
    return completed / window_s


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest observed value
    with at least ``q`` percent of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def p95(values) -> float:
    return percentile(values, 95.0)
