"""Arithmetic of the benchmark's readings: percentiles, frame times, the
union of time intervals and the idle gaps between them. Pure functions of
plain numbers, tested on synthetic timestamps."""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default, type 7). Raises on no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def intervals_between(arrivals: Sequence[float], start: float):
    """Intervals between consecutive arrivals, the first from ``start``."""
    out, prev = [], start
    for a in arrivals:
        out.append(a - prev)
        prev = a
    return out


def frame_ms(window_ms: float, arrivals_ms: Sequence[float]) -> float:
    """The window's length over the frames that arrived in it."""
    n = sum(1 for a in arrivals_ms if a <= window_ms)
    if n == 0:
        raise ValueError("no frame arrived in the window")
    return window_ms / n


def union_length(intervals: Iterable[tuple]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def clip(intervals: Iterable[tuple], lo: float, hi: float):
    """The intervals cut to [lo, hi); empty ones dropped."""
    out = []
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e))
    return out


def gaps(intervals: Iterable[tuple], lo: float, hi: float):
    """The idle stretches of [lo, hi) that no interval covers, in time
    order, as (start, end)."""
    out, t = [], lo
    for s, e in sorted(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
