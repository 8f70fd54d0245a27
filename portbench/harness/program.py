"""The program's own spans, read from the spans stretch's trace.

The port marks its layers' parts as ``record_function`` spans named
``bsed.<layer>.<part>`` (``bsed_tpu_torch/utils/profiling.span``): the
serving forward's five parts, the train step's six phases and
``predict``'s build, read, resample, forward, filter and decode. Nested in
the harness's unit span, they lie on the profiler's own timeline, on the
clock of the device activity it traced. ``of(ctx)`` parses them once a
run, from the main thread (the one that ran ``portbench.window``) inside
the window, and gives for each span name:

* ``host_us``: self time, the spans' durations less those of their
  ``bsed.`` children;
* ``launches``: the CUDA API calls, from any thread, that started a
  device operation while that span was the innermost ``bsed.`` span open
  on the main thread. Backward's kernels
  are launched from autograd's device thread while the main thread waits
  in ``bsed.train.backward``, so launches are put down to spans by time,
  not by thread;
* ``device_us``: the durations of the device operations those launches
  started;
* ``total_us`` and ``count``: the spans' whole durations and number.

The metric files divide them by the traced units (``units``, as
``readers.launches_per_unit`` counts them). ``of`` also writes the table,
with each span's three longest device operations, and the device's idle
over the window by the innermost ``bsed.`` span the main thread was in
when each gap began (the harness's innermost span where it was in none),
to standard error; no metric reads the idle table.
"""
from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from portbench.harness.trace import NAME_CHARS, PREFIX as HARNESS, WINDOW
from portbench.harness.trace import gaps

PREFIX = "bsed."


def _open_spans(events, tid, lo: float, hi: float
                ) -> List[Tuple[float, float, str]]:
    """(start, end, name) of the ``bsed.`` user annotations of thread
    ``tid`` that start in [lo, hi], by start."""
    out = []
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("tid") == tid
                and str(e.get("name", "")).startswith(PREFIX)):
            a = float(e["ts"])
            if lo <= a < hi:
                out.append((a, a + float(e["dur"]), e["name"]))
    return sorted(out, key=lambda s: (s[0], -s[1]))


def innermost(spans: List[Tuple[float, float, str]]
              ) -> Tuple[List[Tuple[float, float, str]], Dict[str, float]]:
    """(segments, self µs by name) of nested spans sorted by (start,
    −end): each segment is a stretch over which one span is the innermost
    open. A child that ends past its parent (the exporter rounds) is cut
    at the parent's end."""
    segs, self_us = [], defaultdict(float)
    stack: List[Tuple[float, float, str]] = []
    cursor = None

    def pop_until(t):
        nonlocal cursor
        while stack and stack[-1][1] <= t:
            a, b, name = stack.pop()
            if b > cursor:
                segs.append((cursor, b, name))
            cursor = b

    for a, b, name in spans:
        pop_until(a)
        if stack:
            b = min(b, stack[-1][1])
            if a > cursor:
                segs.append((cursor, a, stack[-1][2]))
            self_us[stack[-1][2]] -= b - a
        stack.append((a, b, name))
        self_us[name] += b - a
        cursor = a
    pop_until(float("inf"))
    return segs, dict(self_us)


def _find(segs, starts, t) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < segs[i][1]:
        return segs[i][2]
    return None


class ProgramSpans:
    """The ``bsed.`` spans of one traced run (see the module)."""

    def __init__(self, trace, events, tid, lo: float, hi: float,
                 unit_name: str):
        spans = _open_spans(events, tid, lo, hi)
        self.units = trace.span_count(HARNESS + unit_name, lo, hi)
        self.count: Dict[str, int] = defaultdict(int)
        self.total_us: Dict[str, float] = defaultdict(float)
        for a, b, name in spans:
            self.count[name] += 1
            self.total_us[name] += b - a
        segs, self.host_us = innermost(spans)
        starts = [s[0] for s in segs]
        started = defaultdict(set)
        self.device_us: Dict[str, float] = defaultdict(float)
        ops = defaultdict(lambda: defaultdict(float))
        for a, b, op, corr in trace.device:
            launch = trace.launches.get(corr)
            if launch is None:
                continue
            name = _find(segs, starts, launch[0])
            if name is not None:
                started[name].add(corr)
                self.device_us[name] += b - a
                ops[name][op[:NAME_CHARS]] += b - a
        # each span's three longest device operations by name, µs
        self.top_ops = {n: sorted(v.items(), key=lambda kv: -kv[1])[:3]
                        for n, v in ops.items()}
        self.launches = {k: len(v) for k, v in started.items()}
        self.idle = self._idle(trace, segs, starts, tid, lo, hi)

    @staticmethod
    def _idle(trace, segs, starts, tid, lo, hi) -> List[List]:
        """[[span, s], ...]: the device's idle in [lo, hi] by the innermost
        ``bsed.`` span of the main thread when each gap began, else the
        innermost harness span, largest first."""
        harness = sorted(((a, b, n) for a, b, n, t in trace.spans
                          if t == tid), key=lambda s: (s[0], -s[1]))
        h_segs, _ = innermost(harness)
        h_starts = [s[0] for s in h_segs]
        acc = defaultdict(float)
        for a, b in gaps([(x, y) for x, y, _, _ in trace.device], lo, hi):
            name = (_find(segs, starts, a) or _find(h_segs, h_starts, a)
                    or WINDOW)
            acc[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])]

    def per_unit(self, table: Dict, name: str, scale: float = 1.0
                 ) -> Optional[float]:
        """``table[name]`` a traced unit × ``scale``; None where the span
        never ran in the traced units."""
        if not self.units or not self.count.get(name):
            return None
        return table.get(name, 0) * scale / self.units

    def rows(self) -> Dict[str, Dict]:
        """Every span's numbers a unit: count, host ms, launches, device
        ms, and its three longest device operations' ms."""
        return {n: {"count": self.count[n] / self.units,
                    "host_ms": self.per_unit(self.host_us, n, 1e-3),
                    "launches": self.per_unit(self.launches, n),
                    "device_ms": self.per_unit(self.device_us, n, 1e-3),
                    "top_ops": [[op, us / 1e3 / self.units] for op, us in
                                self.top_ops.get(n, [])]}
                for n in sorted(self.count)} if self.units else {}


def of(ctx) -> ProgramSpans:
    """The run's ``ProgramSpans``, parsed once and kept on ``ctx``."""
    found = getattr(ctx, "program_spans", None)
    if found is None:
        with open(ctx.window.trace_path) as fh:
            events = json.load(fh)["traceEvents"]
        found = ProgramSpans(ctx.trace, events, ctx.summary["tid"], ctx.lo,
                             ctx.hi, ctx.runner.unit_name)
        del events
        ctx.program_spans = found
        harness = sorted({n for _, _, n, _ in ctx.trace.spans} - {WINDOW})
        print("portbench: program spans a unit " + json.dumps({
            "units": found.units, "spans": found.rows(),
            "harness_device_ms": {
                n: ctx.trace.span_device_us(n, ctx.lo, ctx.hi)[0] / 1e3
                / max(found.units, 1) for n in harness}}),
            file=sys.stderr, flush=True)
        print("portbench: idle by program span "
              + json.dumps(found.idle), file=sys.stderr, flush=True)
    return found


def host_ms(span: str) -> Callable:
    """Reader: the span's self time on the host, ms a traced unit."""
    return lambda ctx: of(ctx).per_unit(of(ctx).host_us, span, 1e-3)


def launches(span: str) -> Callable:
    """Reader: the launches put down to the span, a traced unit."""
    return lambda ctx: of(ctx).per_unit(of(ctx).launches, span)


def device_ms(span: str) -> Callable:
    """Reader: the device time of the operations launched in the span, ms
    a traced unit."""
    return lambda ctx: of(ctx).per_unit(of(ctx).device_us, span, 1e-3)


def share(span: str) -> Callable:
    """Reader: the spans' whole durations over the traced units' (the
    harness's unit spans), %."""
    def read(ctx) -> Optional[float]:
        p = of(ctx)
        unit = HARNESS + ctx.runner.unit_name
        wall = sum(b - a for a, b, n, t in ctx.trace.spans
                   if n == unit and t == ctx.summary["tid"]
                   and ctx.lo <= a < ctx.hi)
        if not p.count.get(span) or wall <= 0:
            return None
        return 100.0 * p.total_us[span] / wall
    return read
