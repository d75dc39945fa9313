"""The window's arithmetic: rates over whole items, a percentile over all
requests, and the device's busy time from its intervals."""
from __future__ import annotations

import math


def rate(work: float, t_start: float, t_last_done: float) -> float:
    """Work of the completed items over the time from the window's start
    to the last completion."""
    span = t_last_done - t_start
    if span <= 0:
        raise ValueError(f"rate: no time passed ({t_start} -> {t_last_done})")
    return work / span


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value: the smallest
    value with at least q% of all values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[k - 1]


def union_length(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` (start, end) clipped to
    [lo, hi]."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle stretches (start, end) in [lo, hi] between ``intervals``."""
    out = []
    t = lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
