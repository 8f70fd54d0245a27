"""Reading the traced run's Chrome traces (``torch.profiler``'s export).

The traced run profiles two stretches of the window (``window.py``).
From the ``busy`` stretch, which records device activity alone:

* busy time: the union of the device's kernel, copy and set intervals
  (the method of ``chip_smoke.trace_busy_share``, copied), over the
  stretch's length on the host clock.

From the ``spans`` stretch, inside one harness span, ``portbench.window``,
and read from that span's interval:

* the device time of a harness span: the durations of the device
  operations whose launch (the CUDA API call with the same
  ``correlation``) lies inside a span of that name on the launching
  thread, whatever kernels ran;
* the longest device operations by name, and the idle gaps of the device
  by the innermost harness span the host's main thread was in.

Times in the trace are microseconds; what this module returns is seconds.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "portbench."
NAME_CHARS = 160                  # a kernel's name in the breakdown
WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CATS = ("user_annotation",)


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` ((a, b) pairs) clipped to
    [lo, hi]."""
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= lo or a >= hi:
            continue
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out


class Trace:
    """The events of one exported trace that the readers use."""

    def __init__(self, events: List[dict]):
        self.device = []           # (start, end, name, correlation)
        self.launches = {}         # correlation -> (ts, tid)
        self.spans = []            # (start, end, name, tid)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat")
            ts, dur = float(e["ts"]), float(e["dur"])
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", "?"),
                                    args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                self.launches[args["correlation"]] = (ts, e.get("tid"))
            elif cat in SPAN_CATS and str(e.get("name", "")).startswith(
                    PREFIX):
                self.spans.append((ts, ts + dur, e["name"], e.get("tid")))
        self.spans.sort()

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as fh:
            return cls(json.load(fh)["traceEvents"])

    def window(self) -> Optional[Tuple[float, float, object]]:
        """(start, end, tid) of the traced window's span."""
        for a, b, name, tid in self.spans:
            if name == WINDOW:
                return a, b, tid
        return None

    def _in_window(self, lo, hi):
        return [d for d in self.device if d[1] > lo and d[0] < hi]

    def busy_us(self, lo: float, hi: float) -> float:
        return union_length([(a, b) for a, b, _, _ in self.device], lo, hi)

    def device_count(self, lo: float, hi: float) -> int:
        """Device operations (kernels, copies, sets) that start in
        [lo, hi]."""
        return sum(1 for a, _, _, _ in self.device if lo <= a < hi)

    def span_device_us(self, name: str, lo: float, hi: float
                       ) -> Tuple[float, int]:
        """(device µs, launches) of the operations launched inside spans
        ``name`` that start in [lo, hi]."""
        by_tid = defaultdict(list)
        for a, b, n, tid in self.spans:
            if n == name and lo <= a < hi:
                by_tid[tid].append((a, b))
        if not by_tid:
            return 0.0, 0
        starts = {tid: [a for a, _ in v] for tid, v in by_tid.items()}
        total, count = 0.0, 0
        for a, b, _, corr in self.device:
            launch = self.launches.get(corr)
            if launch is None or launch[1] not in by_tid:
                continue
            ts, tid = launch
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and by_tid[tid][i][1] >= ts:
                total += b - a
                count += 1
        return total, count

    def span_count(self, name: str, lo: float, hi: float) -> int:
        return sum(1 for a, _, n, _ in self.spans if n == name and
                   lo <= a < hi)

    def top_device_ops(self, lo: float, hi: float, n: int = 10):
        """[[name, seconds], ...]: device time by operation name in the
        window, largest first."""
        acc = defaultdict(float)
        for a, b, name, _ in self._in_window(lo, hi):
            acc[name[:NAME_CHARS]] += (min(b, hi) - max(a, lo)) / 1e6
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, lo: float, hi: float, tid, n: int = 10):
        """[[span, seconds], ...]: the device's idle time in the window by
        the innermost harness span the host's thread ``tid`` was in when
        each gap began, largest first."""
        segments = self._innermost(tid, lo, hi)
        starts = [s[0] for s in segments]
        acc = defaultdict(float)
        for a, b in gaps([(x, y) for x, y, _, _ in self.device], lo, hi):
            i = bisect.bisect_right(starts, a) - 1
            name = segments[i][2] if i >= 0 else WINDOW
            acc[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def _innermost(self, tid, lo, hi):
        """(start, end, name) segments of [lo, hi]: the innermost harness
        span of thread ``tid`` over each stretch."""
        points = sorted({lo, hi} | {t for a, b, _, s in self.spans
                                    if s == tid for t in (a, b)
                                    if lo <= t <= hi})
        mine = [(a, b, name) for a, b, name, s in self.spans
                if s == tid and b >= lo and a <= hi]
        out = []
        for x, y in zip(points, points[1:]):
            mid = (x + y) / 2
            # the innermost: the latest start, then the earliest end
            inner = [(a, -b, name) for a, b, name in mine if a <= mid < b]
            out.append((x, y, max(inner)[2] if inner else WINDOW))
        return out


def busy(trace: Trace, window_s: float) -> Dict:
    """busy_s and window_s of the busy stretch: the union of every device
    interval its trace holds (the device was idle at both ends, which
    were synchronised), and the stretch's length."""
    busy_us = union_length([(a, b) for a, b, _, _ in trace.device],
                           float("-inf"), float("inf"))
    if busy_us <= 0:
        raise ValueError("no device operation ran in the traced window")
    return {"busy_s": busy_us / 1e6, "window_s": window_s}


def summary(trace: Trace) -> Dict:
    """busy_s, window_s and the breakdown of the spans stretch."""
    win = trace.window()
    if win is None:
        raise ValueError("the trace holds no portbench.window span")
    lo, hi, tid = win
    busy = trace.busy_us(lo, hi)
    if busy <= 0:
        raise ValueError("no device operation ran in the traced window")
    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
            "lo": lo, "hi": hi, "tid": tid,
            "breakdown": {"device_ops": trace.top_device_ops(lo, hi),
                          "idle_gaps": trace.idle_by_span(lo, hi, tid)}}
