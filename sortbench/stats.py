"""Arithmetic the metric readers share: percentiles, unions of intervals,
the LSD floor and the spread of a set of runs."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between the two closest ranks
    (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merged(intervals, lo: float, hi: float) -> list:
    """``intervals`` (start, end) clipped to ``[lo, hi]`` and merged where
    they overlap, in order."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` that at least one interval covers."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def lsd_floor_bytes(n: int, key_bytes: int, value_bytes: int,
                    window_bits: int, digit_bits: int = 8) -> int:
    """Bytes of an LSD radix sort's passes over ``n`` keys: one pass per
    digit of the window, each reading and writing every key's and
    payload's bytes once."""
    passes = -(-window_bits // digit_bits)
    return passes * 2 * n * (key_bytes + value_bytes)


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
