"""The arithmetic of the metrics: rates over a window, percentiles over
every sample, the union of device intervals and the idle gaps between
them.  Pure Python, so that the tests hold it on synthetic timelines."""

from __future__ import annotations

import math
import statistics


def rate(work: float, window_s: float) -> float:
    """All the work over the whole window."""
    if window_s <= 0:
        raise ValueError("a window has a positive length")
    return work / window_s


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float:
    return statistics.median(values)


def union(intervals):
    """Merge ``(start, end)`` intervals -> sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals) -> float:
    """Seconds in which at least one interval is open."""
    return sum(e - s for s, e in union(intervals))


def idle_pct(intervals, window_s: float) -> float:
    """100 x (1 - the busy union over the window)."""
    return 100.0 * (1.0 - busy(intervals) / window_s)


def idle_gaps(intervals, start: float, end: float):
    """The gaps in ``[start, end]`` where no interval is open."""
    gaps, t = [], start
    for s, e in union(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(s, e) for s, e in gaps if e > s]


def label_gaps(gaps, spans, top: int = 10):
    """Idle seconds summed by what the host was doing: the innermost
    ``(name, start, end)`` span holding a gap's midpoint names it
    (``host:other`` where none does) -> the ``top`` names by seconds."""
    by = {}
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside \
            else "host:other"
        by[name] = by.get(name, 0.0) + (e - s)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def top_ops(ops, top: int = 10):
    """``(name, start, end)`` device operations -> the ``top`` names by
    summed seconds."""
    by = {}
    for name, s, e in ops:
        by[name] = by.get(name, 0.0) + (e - s)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]
