"""One run of one cell: find its configuration, traffic mix, runner,
limits and metrics by name, set up, run the window, read the metrics,
check the outputs against the reference, and build the result line.

A mix names its runner, ``portbench/runners/<runner>.py``, whose
``Runner`` does the cell's set-up, units of work and check; a per-layer
metric is ``portbench/metrics/<metric>.py`` (``readers.py``)."""
from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench.harness import guard

class Run:
    """What a runner is given: the cell's configuration and mix, the seed,
    the device, and the test hooks (``fault`` breaks the timed path, ``control`` puts
    the reference at a lower precision in the program's place)."""

    def __init__(self, config, mix, seed, device, fault=None,
                 control=None):
        self.config, self.mix, self.seed = config, mix, seed
        self.device, self.fault, self.control = device, fault, control

    def seeds(self, n: int) -> List[int]:
        """``n`` independent 63-bit seeds from the run's seed."""
        return [int(v) for v in np.random.SeedSequence(self.seed)
                .generate_state(n, dtype=np.uint64) >> np.uint64(1)]


def _load(root, rel):
    with open(os.path.join(root, rel)) as fh:
        return json.load(fh)


def find(root: str, workload: str):
    """(bench, cell, configuration file, mix, limits) of ``workload``."""
    bench = _load(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _load(root, entry["file"])
    mix = _load(root, os.path.join("portbench", "traffic",
                                   cell["traffic"] + ".json"))
    limits = _load(root, os.path.join("portbench", "limits",
                                      workload + ".json"))["limits"]
    return bench, cell, config, mix, limits


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def runner_module(name: str):
    """``portbench/runners/<name>.py``: its ``Runner`` and its ``FAULTS``
    (breakages of the timed path that its check has to catch)."""
    import importlib
    return importlib.import_module(f"portbench.runners.{name}")


def _host_times() -> Dict[str, float]:
    """The process's CPU seconds and context switches so far."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": r.ru_utime, "sys_s": r.ru_stime,
            "voluntary_switches": r.ru_nvcsw,
            "involuntary_switches": r.ru_nivcsw}


def _unit_seconds(win, first: int, end: int) -> Optional[float]:
    us = [b - a for a, b, _ in win.units[first:end]]
    return sum(us) / len(us) if us else None


def execute(root: str, workload: str, seed: int, seconds: float,
            trace: bool, *, device: str = "cuda", require_card: bool = True,
            fault: Optional[Callable] = None, control=None,
            overrides: Optional[Callable] = None,
            t_start: Optional[float] = None, log=None,
            detail: Optional[Dict] = None) -> Dict:
    """Run the cell; returns the result line's object. ``overrides``
    (tests) edits (config, mix) before the run; ``detail``, a dict, gains
    what the runner's check noted beside its numbers (the readings)."""
    import torch
    from portbench.harness import device as D
    from portbench.harness import readers, spans as SP, window as Wn
    from portbench.harness import trace as T

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    t_start = D.process_start() if t_start is None else t_start
    bench, cell, config, mix, limits = find(root, workload)
    if overrides is not None:
        config, mix = overrides(config, mix)
    if require_card:
        D.require(cell["chips"])
    dev = torch.device(device)
    run = Run(config, mix, seed, dev, fault, control)
    runner = runner_module(mix["runner"]).Runner(run)
    log("portbench: flags in force " + json.dumps(D.flags()))
    spans = None
    readers_of = {}
    if trace:
        spans = SP.KernelSpans()
        for m in bench["per_layer"]:
            if _applies(m, workload):
                mod = readers.load(root, m["name"])
                readers_of[m["name"]] = mod.read
                for entry in getattr(mod, "spans", lambda c: [])(config):
                    spans.wrap(*entry)
    try:
        runner.setup()
        if trace:
            Wn.warm_profiler(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start
        host0 = _host_times()
        with tempfile.TemporaryDirectory(prefix="portbench-") as tdir:
            win = Wn.run(runner, seconds, trace_dir=tdir if trace else None,
                         traced=mix["traced"], spans=spans)
            host = {k: v - host0[k] for k, v in _host_times().items()}
            host["window_s"] = win.end - win.start
            log("portbench: host over the window " + json.dumps(host))
            result = {"correct": False, "attempted": len(win.units),
                      "failed": 0, "metrics": {}}
            if trace:
                if "busy" in win.traces:
                    busy = T.busy(T.Trace.load(win.traces["busy"]),
                                  win.busy_window_s)
                if set(win.traces) != set(Wn.STRETCHES):
                    raise RuntimeError("a traced stretch never started")
                tr = T.Trace.load(win.trace_path)
                summ = T.summary(tr)
                first = min(a for a, _ in win.stretches.values())
                log("portbench: seconds a unit, unprofiled / device "
                    "activity profiled / spans profiled " + json.dumps([
                        _unit_seconds(win, 1, first),
                        _unit_seconds(win, *win.stretches["busy"]),
                        _unit_seconds(win, *win.stretches["spans"])]))
                ctx = readers.Context(tr, summ, busy, spans, runner, win,
                                      config)
                for m in bench["per_layer"]:
                    if not _applies(m, workload):
                        continue
                    v = readers_of[m["name"]](ctx)
                    if v is not None:
                        result["metrics"][m["name"]] = {
                            "value": float(v), "unit": m["unit"]}
        if not trace:
            e2e = runner.end_to_end(win)
            e2e["setup_s"] = setup_s
            for m in bench["end_to_end"]:
                if _applies(m, workload):
                    result["metrics"][m["name"]] = {
                        "value": float(e2e[m["name"]]), "unit": m["unit"]}
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        runner.release()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers, failed = runner.check(limits)
        if detail is not None:
            detail.update(getattr(runner, "detail", {}))
    finally:
        if spans is not None:
            spans.restore()
        close = getattr(runner, "close", None)
        if close is not None:
            close()
    dev_info = (D.info(cell["chips"]) if dev.type == "cuda" else
                {"platform": "cpu", "kind": "cpu", "count": 1})
    dev_info["memory_peak_bytes"] = int(peak)
    if trace:
        dev_info["busy_s"] = busy["busy_s"]
        dev_info["window_s"] = busy["window_s"]
        result["breakdown"] = summ["breakdown"]
    result["device"] = dev_info
    result["failed"] = int(failed)
    result["correct"] = all(math.isfinite(v) and v <= limits[k]
                            for k, v in numbers) and failed == 0
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers}
    return result


def emit(result: Dict) -> int:
    """Print the checks as the last lines of standard error and the
    result as the last line of standard output; refuse to print where a
    forbidden package is loaded."""
    found = guard.loaded()
    if found:
        print(f"portbench: {', '.join(found)} loaded in the benchmark "
              f"process; no result", file=sys.stderr, flush=True)
        return 5
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
