"""The statistics the metrics are made of: percentiles over all requests,
rates over all the window's work and time, busy time as a union of
intervals."""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0..100) of all values, linear between the two
    nearest ranks (numpy's default)."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work a second over a whole window."""
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return count / seconds


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Overlapping or touching (start, end) intervals merged, in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: list[tuple[float, float]], lo: float,
            hi: float) -> float:
    """Time within [lo, hi] that the union of the intervals covers."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union(intervals))


def gaps(intervals: list[tuple[float, float]], lo: float,
         hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def idle_share(intervals: list[tuple[float, float]], lo: float,
               hi: float) -> float:
    """The share of [lo, hi] with no interval running."""
    return 1.0 - covered(intervals, lo, hi) / (hi - lo)
