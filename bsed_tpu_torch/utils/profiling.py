"""Tracing / profiling hooks.

Port of ``bsed_tpu/utils/profiling.py``. The reference's observability is
a wall-clock line per epoch (reference src/main_baseline.py:190,596-597).
Here: ``torch.profiler`` traces (Chrome trace JSON, viewable in Perfetto
or TensorBoard) plus lightweight step timers.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host + device trace into ``log_dir``:
    ``with trace('stored_data/run/trace'): ...`` writes
    ``<log_dir>/trace_<pid>_<ns>.pt.trace.json`` when the block ends. The
    device is traced when a CUDA device is present."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Blocking step timer with simple percentile summaries. Once CUDA is
    in use it synchronises the card on entry and exit, so a step's time
    includes its device work."""

    def __init__(self):
        self.times = []
        self._t0 = None

    @staticmethod
    def _sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        import numpy as np
        a = np.asarray(self.times)
        return {"mean_s": float(a.mean()),
                "p50_s": float(np.percentile(a, 50)),
                "p90_s": float(np.percentile(a, 90)),
                "max_s": float(a.max()),
                "steps": len(a)}


def plot_grad_flow(metrics: Dict[str, float], path: str) -> bool:
    """Render the reference's gradient-flow diagnostic
    (reference src/main_baseline.py:108-123): average |grad| per non-bias
    parameter, bar-free line plot saved as a PNG. Consumes the
    ``grad_abs/<param>`` entries that ``make_train_step(grad_flow=True)``
    adds to its metrics dict. Returns False when matplotlib is absent."""
    items = sorted((k[len("grad_abs/"):], float(v))
                   for k, v in metrics.items() if k.startswith("grad_abs/"))
    if not items:
        return False
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    layers = [k for k, _ in items]
    ave_grads = [v for _, v in items]
    fig, ax = plt.subplots(figsize=(max(6, len(layers) * 0.3), 4))
    ax.plot(ave_grads, alpha=0.3, color="b")
    ax.hlines(0, 0, len(ave_grads) + 1, linewidth=1, color="k")
    ax.set_xticks(range(len(layers)))
    ax.set_xticklabels(layers, rotation="vertical", fontsize=5)
    ax.set_xlim(0, len(ave_grads))
    ax.set_xlabel("Layers")
    ax.set_ylabel("average gradient")
    ax.set_title("Gradient flow")
    ax.grid(True)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True
