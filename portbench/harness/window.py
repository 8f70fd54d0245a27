"""The measured window: a closed loop of units of work until the deadline.

Each unit is timed on the host clock from its call to its return; a unit
that returns before the device has finished (a train step) is closed by
``runner.drain()``, the ``torch.cuda.synchronize()`` that ends the
window. In the traced run the profiler covers two stretches of the
window, one after the other, from the first unit that starts after
``TRACE_AFTER`` of the window, each for ``traced`` units or until the
deadline, with the device synchronised at both ends of each:

* ``busy``: device activity alone (no host operators, no harness spans),
  so that the profiler's own host cost stays small; the device's busy
  time is read from its trace over the stretch's length on the host
  clock;
* ``spans``: host operators and device activity, with a harness span
  around each unit, its parts and the kernel entries, inside
  ``portbench.window``; the rooflines, launch counts and the breakdown
  are read from it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

from portbench.harness.trace import PREFIX, WINDOW


TRACE_AFTER = 0.3         # the traced stretches start past this share
STRETCHES = ("busy", "spans")


class Window:
    def __init__(self, units, start: float, end: float,
                 traces: Dict[str, str], busy_window_s: Optional[float],
                 stretches: Dict[str, Tuple[int, int]]):
        self.units = units                  # [(start, end, work)]
        self.start, self.end = start, end
        self.traces = traces                # stretch -> exported trace
        self.busy_window_s = busy_window_s  # the busy stretch, host clock
        self.stretches = stretches          # stretch -> (first, end) unit

    @property
    def trace_path(self) -> Optional[str]:
        return self.traces.get("spans")


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(device, host: bool):
    """Device activity, and with ``host`` the host's operators; on a
    device without a trace of its own (the CPU), the host's."""
    from torch.profiler import ProfilerActivity, profile
    activities = []
    if host or device.type != "cuda":
        activities.append(ProfilerActivity.CPU)
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def warm_profiler(device) -> None:
    """Start and stop both profilers once on a trivial op: the first start
    in a process initialises CUPTI, which takes seconds, and belongs in
    set-up, not in a traced stretch."""
    import torch
    for host in (False, True):
        with _profiler(device, host):
            (torch.ones(8, device=device) * 2).sum().item()


def span(runner, name: str):
    """A harness span inside a unit: a ``record_function`` while the
    spans stretch is profiled, nothing otherwise."""
    if getattr(runner, "tracing", False):
        from torch.profiler import record_function
        return record_function(PREFIX + name)
    return contextlib.nullcontext()


class _Stretch:
    """One profiled stretch of the window."""

    def __init__(self, name: str, runner, spans, first: int):
        from torch.profiler import record_function
        self.name, self.runner, self.spans = name, runner, spans
        self.first, self.done = first, 0
        _sync(runner.device)
        self.prof = _profiler(runner.device, host=name == "spans")
        self.prof.start()
        self.win = None
        if name == "spans":
            self.win = record_function(WINDOW)
            self.win.__enter__()
            if spans is not None:
                spans.recording = True
            runner.tracing = True
        self.t0 = time.perf_counter()

    def unit_context(self, unit_span: str):
        from torch.profiler import record_function
        if self.win is not None:
            return record_function(unit_span)
        return contextlib.nullcontext()

    def stop(self, trace_dir: str) -> Tuple[str, float]:
        _sync(self.runner.device)
        length = time.perf_counter() - self.t0
        if self.win is not None:
            self.win.__exit__(None, None, None)
            self.runner.tracing = False
            if self.spans is not None:
                self.spans.recording = False
        self.prof.stop()
        path = os.path.join(trace_dir, f"{self.name}.pt.trace.json")
        self.prof.export_chrome_trace(path)
        return path, length


def run(runner, seconds: float, trace_dir: Optional[str] = None,
        traced: int = 0, spans=None) -> Window:
    """Run ``runner.unit(k)`` for k = 0, 1, ... until ``seconds`` have
    passed; ``trace_dir`` set: profile the two stretches of ``traced``
    units each (the traced run), with ``spans`` (a ``KernelSpans``)
    recording the kernel entries' work in the second."""
    unit_span = PREFIX + runner.unit_name
    units: List = []
    todo = list(STRETCHES) if trace_dir else []
    cur: Optional[_Stretch] = None
    traces: Dict[str, str] = {}
    ranges: Dict[str, Tuple[int, int]] = {}
    busy_window_s = None

    def close(k):
        nonlocal cur, busy_window_s
        path, length = cur.stop(trace_dir)
        traces[cur.name] = path
        ranges[cur.name] = (cur.first, k)
        if cur.name == "busy":
            busy_window_s = length
        cur = None

    start = time.perf_counter()
    deadline = start + seconds
    k = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        if (cur is None and todo
                and t0 >= start + TRACE_AFTER * seconds):
            cur = _Stretch(todo.pop(0), runner, spans, k)
            t0 = time.perf_counter()
        ctx = (cur.unit_context(unit_span) if cur is not None
               else contextlib.nullcontext())
        with ctx:
            w = runner.unit(k)
        t1 = time.perf_counter()
        units.append((t0, t1, w))
        k += 1
        if cur is not None:
            cur.done += 1
            if cur.done >= traced or t1 >= deadline:
                close(k)
    end = runner.drain()
    if cur is not None:
        close(k)
    if not units:
        raise RuntimeError("no unit of work started in the window")
    last = units[-1]
    units[-1] = (last[0], max(last[1], end), last[2])
    return Window(units, start, units[-1][1], traces, busy_window_s, ranges)
