"""What a per-layer metric reads, and the reading rules the metric files
share. Each ``portbench/metrics/<name>.py`` defines ``read(ctx)``, which
returns the metric's value, or None where the traced run holds nothing
for it (the harness then leaves the metric out of the line). A metric
that reads a kernel entry's span also defines ``spans(config)``: the
entries to wrap, as ``(module, attribute, span, work_of)`` tuples
(``spans.py``), which the harness wraps before set-up."""
from __future__ import annotations

import importlib.util
import os
from typing import Callable, Optional

from portbench.harness import work as W


class Context:
    """A traced run as the readers see it: the spans stretch's ``trace``
    (``trace.Trace``) and ``summary`` (``trace.summary``), the busy
    stretch's ``busy`` (``trace.busy``), ``spans`` (the kernel-entry
    spans' recorded work), ``runner``, ``window`` and the configuration
    file ``config``."""

    def __init__(self, trace, summary, busy, spans, runner, window,
                 config):
        self.trace, self.summary, self.spans = trace, summary, spans
        self.busy = busy
        self.runner, self.window, self.config = runner, window, config

    @property
    def lo(self):
        return self.summary["lo"]

    @property
    def hi(self):
        return self.summary["hi"]


def load(root: str, name: str):
    """The module ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def idle_share(ctx: Context) -> Optional[float]:
    """% of the busy stretch in which no operation ran on the device."""
    b = ctx.busy
    return 100.0 * (1.0 - b["busy_s"] / b["window_s"])


def mfu(ctx: Context) -> Optional[float]:
    """% of the peak of the configuration's precision for the runner's
    kind: the model FLOPs of the window's units that no profiler slowed
    (all but the first and the traced stretches') over their time on the
    host clock."""
    win = ctx.window
    profiled = {i for a, b in win.stretches.values() for i in range(a, b)}
    units = [u for i, u in enumerate(win.units) if i and i not in profiled]
    if not units:
        return None
    precision = ctx.config["precision"][ctx.runner.kind]
    peak = float(ctx.config["mfu_peak_flops"][precision])
    flops = len(units) * ctx.runner.flops_per_unit()
    return 100.0 * flops / sum(b - a for a, b, _ in units) / peak


def roofline(span: str) -> Callable:
    """The reader of a kernel entry's roofline share: the least time its
    calls' work allows (``work.bound_s``) over the device time of the
    operations launched inside its spans, in %."""
    def read(ctx: Context) -> Optional[float]:
        calls = ctx.spans.calls.get(span, []) if ctx.spans else []
        device_us, launches = ctx.trace.span_device_us(span, ctx.lo, ctx.hi)
        if not calls or device_us <= 0:
            return None
        least = sum(W.bound_s(b, ops) for b, ops in calls)
        return 100.0 * least / (device_us / 1e6)
    return read


def launches_per_unit(ctx: Context) -> Optional[float]:
    """Device operations (kernels, copies, sets) a traced unit."""
    units = ctx.trace.span_count("portbench." + ctx.runner.unit_name,
                                 ctx.lo, ctx.hi)
    if units == 0:
        return None
    return ctx.trace.device_count(ctx.lo, ctx.hi) / units
