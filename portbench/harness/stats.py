"""Reductions of a window's case timings."""

from __future__ import annotations


def rate(count: int, seconds: float) -> float:
    """Cases completed per second of the window."""
    return count / seconds


def p95(values) -> float:
    """The 95th percentile of every value, linear between the two nearest
    ranks (numpy's default method)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = 0.95 * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

