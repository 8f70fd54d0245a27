"""Rate, tail and trace arithmetic on synthetic samples and a synthetic
trace; the kernels' work and the model FLOPs at known shapes."""
from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.harness import stats as S
from portbench.harness import trace as T
from portbench.harness import work as W
from portbench.harness.readers import Context, idle_share, launches_per_unit
from portbench.harness.readers import roofline


def test_rate_is_all_work_over_all_time():
    units = [(0.0, 1.0, 10.0), (1.0, 2.0, 10.0), (2.0, 5.0, 10.0)]
    assert S.rate(units, 0.0) == pytest.approx(6.0)
    # a stall inside the window counts: the window runs to the last end
    assert S.rate(units, -1.0) == pytest.approx(5.0)
    with pytest.raises(ValueError):
        S.rate([], 0.0)


def test_p95_is_over_every_unit():
    lat = [0.001 * (i + 1) for i in range(100)]
    assert S.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    lat[-1] = 1.0                  # one stalled batch moves only the max
    assert S.percentile(lat, 95) == pytest.approx(0.09505)
    lat[-10:] = [1.0] * 10         # ten do move the 95th percentile
    assert S.percentile(lat, 95) == pytest.approx(1.0)
    assert S.latencies([(1.0, 1.5, 3.0)]) == [0.5]


def _trace_events():
    """A window of 1000 µs on thread 1 with two units; unit 2 stalls the
    host for 400 µs before it launches; a kernel-entry span launches one
    kernel on thread 1, and a backward span on thread 2 another."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 0, "dur": 1000, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.step",
           "ts": 0, "dur": 300, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.step",
           "ts": 300, "dur": 700, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.k2_stem",
           "ts": 10, "dur": 20, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.k3",
           "ts": 750, "dur": 30, "tid": 2}]
    launches = [(1, 15, 1), (2, 40, 1), (3, 760, 2), (4, 710, 1)]
    for corr, ts, tid in launches:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": ts, "dur": 5, "tid": tid,
                   "args": {"correlation": corr}})
    kernels = [(1, 20, 100), (2, 100, 200), (3, 800, 100), (4, 720, 50)]
    for corr, ts, dur in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                   "ts": ts, "dur": dur, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 950,
               "dur": 10, "args": {}})
    return ev


def test_trace_busy_idle_and_gaps(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _trace_events()}))
    tr = T.Trace.load(str(path))
    s = T.summary(tr)
    # kernels 20-120, 100-300 overlap: 280; 720-770, 800-900, 950-960
    assert s["busy_s"] == pytest.approx((280 + 50 + 100 + 10) / 1e6)
    assert s["window_s"] == pytest.approx(1e-3)
    # the stall: 300-720 idle in unit 2, plus 0-20 in unit 1 and the gaps
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["portbench.step"] == pytest.approx(
        (20 + 420 + 30 + 50 + 40) / 1e6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["k2"] == pytest.approx(200e-6)
    # device time of a span: the operations launched inside it, on the
    # launching thread
    assert tr.span_device_us("portbench.k2_stem", 0, 1000) == (100.0, 1)
    assert tr.span_device_us("portbench.k3", 0, 1000) == (100.0, 1)
    assert tr.span_device_us("portbench.k4", 0, 1000) == (0.0, 0)

    class D:
        unit_name, kind = "step", "train"

    class Spans:
        calls = {"portbench.k2_stem": [(3.35e12 * 50e-6, {})]}

    # the busy stretch: every device interval of its trace over its
    # length on the host clock
    busy = T.busy(tr, 2e-3)
    assert busy == {"busy_s": pytest.approx(440e-6), "window_s": 2e-3}
    ctx = Context(tr, s, busy, Spans(), D(), None, {})
    assert idle_share(ctx) == pytest.approx(100 * (1 - 440 / 2000))
    assert launches_per_unit(ctx) == pytest.approx(5 / 2)
    # 50 µs of bytes at the card's rate over 100 µs of device time
    assert roofline("portbench.k2_stem")(ctx) == pytest.approx(50.0)
    assert roofline("portbench.k4_gru")(ctx) is None


def test_mfu_reads_the_units_no_profiler_slowed():
    from portbench.harness.readers import mfu

    class Win:
        # unit 0 and the stretches' units (2, 3) are left out
        units = [(0.0, 5.0, 1.0), (5.0, 6.0, 1.0), (6.0, 9.0, 1.0),
                 (9.0, 12.0, 1.0), (12.0, 13.0, 1.0)]
        stretches = {"busy": (2, 3), "spans": (3, 4)}

    class D:
        kind = "train"

        def flops_per_unit(self):
            return 5.0

    cfg = {"precision": {"train": "bfloat16"},
           "mfu_peak_flops": {"bfloat16": 50.0}}
    ctx = Context(None, None, None, None, D(), Win(), cfg)
    assert mfu(ctx) == pytest.approx(100 * 2 * 5.0 / 2.0 / 50.0)


def test_busy_stretch_without_device_work_is_refused():
    with pytest.raises(ValueError, match="no device operation"):
        T.busy(T.Trace([]), 1.0)


def test_window_profiles_two_stretches_in_turn(tmp_path):
    """The traced window profiles the busy stretch, then the spans
    stretch, each for ``traced`` units after ``TRACE_AFTER`` of the
    window, and only the second inside harness spans."""
    import torch
    from portbench.harness import window as Wn

    class R:
        unit_name, device = "step", torch.device("cpu")
        seen = []

        def unit(self, k):
            self.seen.append(getattr(self, "tracing", False))
            (torch.ones(64) * 2).sum()
            return 1.0

        def drain(self):
            import time
            return time.perf_counter()

    r = R()
    Wn.warm_profiler(r.device)
    win = Wn.run(r, 2.0, trace_dir=str(tmp_path), traced=3)
    (b0, b1), (s0, s1) = win.stretches["busy"], win.stretches["spans"]
    assert b1 - b0 == 3 and s0 == b1 and s1 - s0 == 3
    assert win.busy_window_s > 0
    assert r.seen[b0:b1] == [False] * 3 and r.seen[s0:s1] == [True] * 3
    spans = T.Trace.load(win.traces["spans"]).span_count(
        "portbench.step", float("-inf"), float("inf"))
    assert spans == 3
    assert T.Trace.load(win.traces["busy"]).span_count(
        "portbench.step", float("-inf"), float("inf")) == 0


def test_kernel_work_at_known_shapes():
    b, o = W.k1_mel((2, 1000), (2, 5, 4), 16, 9, 12)
    assert b == (2000 + 40) * 4
    assert o == {"float32": 10 * (2.5 * 16 * 4 + 27 + 24)}
    b, o = W.k2_stem((1, 2, 3, 128), (1, 1, 3, 64), (128, 128),
                     "bfloat16", train=False)
    rows = 6
    assert o["bfloat16"] == rows * 128 * 128 * 2
    assert o["float32"] == rows * 128 * 8 + 192 * 3
    assert b == (rows * 128 + 192 + 128 * 128) * 2 + 3 * 512
    b, o = W.k2_stem((1, 2, 3, 128), (1, 1, 3, 64), (128, 128),
                     "bfloat16", train=True)
    assert b == rows * 128 * 3 + 192 * 2 + 128 * 128 * 2 + 3 * 512
    b, o = W.k3_stem_bwd((1, 1, 3, 64), (1, 2, 3, 128), (128, 128),
                         "bfloat16")
    assert o["bfloat16"] == 4 * rows * 128 * 128 * 2
    b, o = W.k4_gru((2, 4, 10, 384), (2, 4, 10, 128), (2, 128, 384),
                    (2, 384), "float32")
    assert o == {"float32": 2 * 4 * 10 * 128 * 384 * 2
                 + 2 * 4 * 10 * 128 * 16}
    assert b == (2 * 4 * 10 * 384 + 2 * 4 * 10 * 128 + 2 * 128 * 384) * 4 \
        + 2 * 384 * 4
    assert W.bound_s(3.35e12, {}) == pytest.approx(1.0)
    assert W.bound_s(0.0, {"bfloat16": 989e12, "float32": 67e12}) == \
        pytest.approx(2.0)


def _model(**kw):
    m = {"n_in_channel": 1, "nclass": 2, "activation": "glu",
         "nb_filters": [2, 4], "pooling": [[2, 2], [1, 2]],
         "kernel_size": 3, "n_rnn_cell": 3, "n_layers_rnn": 1,
         "use_fpn": False}
    m.update(kw)
    return m


def test_model_flops_at_known_shapes():
    cfg = {"audio": {"sr": 100, "max_len_seconds": 1.0, "hop_size": 10,
                     "n_mels": 8, "n_window": 16, "mel_f_min": 0.0,
                     "mel_f_max": 50.0},
           "model": _model()}
    f = W.forward_flops(cfg, with_mel=False)
    t = 11                                 # 1 + 100 // 10 frames
    conv = 2 * 9 * 1 * 2 * t * 8 + 2 * 2 * 2 * t * 8 \
        + 2 * 9 * 2 * 4 * 5 * 4 + 2 * 4 * 4 * 5 * 4
    assert f["cnn"] == conv
    assert f["rnn"] == 2 * (2 * 5 * 4 * 9 + 2 * 5 * 3 * 9)
    assert f["head"] == 2 * 2 * 5 * 6 * 2
    step = W.train_step_flops(cfg, 3, 6)
    per = sum(f.values())
    assert step == 3 * per + 6 * (3 * per - 2 * 9 * 1 * 2 * t * 8)
