"""Tracing / profiling hooks.

Port of ``bsed_tpu/utils/profiling.py``. The reference's observability is
a wall-clock line per epoch (reference src/main_baseline.py:190,596-597).
Here: ``torch.profiler`` traces (Chrome trace JSON, viewable in Perfetto
or TensorBoard), and ``span``, the named regions the port marks on them:
the serving forward's parts (``bsed.serve.mel``, ``stem``, ``cnn``,
``bigru``, ``head``; with a BEATs encoder ``fbank``, ``beats`` and
``fuse``; with HTS-AT ``htsat``, bn0 through its final LayerNorm), the
train step's phases (``bsed.train.inputs``,
``teacher``, ``student``, ``backward``, ``optimizer``, ``ema``) and
``predict``'s (``bsed.predict.build``, ``read``, ``resample``, ``forward``,
``filter``, ``decode``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "bsed."        # every span of the port is named bsed.<layer>.<part>
_NULL = contextlib.nullcontext()


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


def span(name: str, seconds: Optional[Dict[str, float]] = None,
         key: Optional[str] = None):
    """The port's span: ``with span('serve.mel'): ...`` marks a region
    ``bsed.serve.mel`` on the running ``torch.profiler`` profile's
    timeline (a ``record_function``, on the clock of the device activity
    it traces). With no profiler running it checks one flag and returns a
    shared null context. With ``seconds`` and ``key`` it also adds the
    region's wall seconds to ``seconds[key]``, profiled or not."""
    if seconds is not None:
        return _timed(name, seconds, key)
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def _timed(name: str, seconds: Dict[str, float], key: str):
    with span(name):
        t0 = time.perf_counter()
        yield
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0


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
