"""Rate and tail arithmetic over the units of work of one window.

A unit is one call the window makes (a served batch, a train step, a
``predict`` call), recorded as (start, end, work) on the host clock in
seconds. Every end-to-end number is taken over all units and all the
time of the window: no median of chunks.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

Unit = Tuple[float, float, float]          # (start s, end s, work)


def rate(units: Sequence[Unit], start: float) -> float:
    """Work completed per second from ``start`` (the window's start) to
    the end of the last unit."""
    if not units:
        raise ValueError("no unit completed in the window")
    end = max(u[1] for u in units)
    if end <= start:
        raise ValueError("the window has no length")
    return sum(u[2] for u in units) / (end - start)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) by linear interpolation
    between closest ranks (numpy's default, 'linear')."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies(units: Sequence[Unit]):
    return [u[1] - u[0] for u in units]

