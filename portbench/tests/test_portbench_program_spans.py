"""The reader of the program's own spans (``harness/program.py``): on a
hand-built Chrome trace, and on a real CPU profile of two tiny MT+ISP
train steps."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.harness import program as P
from portbench.harness import trace as T
from portbench.harness.readers import Context, load
from portbench.tests.tiny_cells import ROOT

PHASES = ("inputs", "teacher", "student", "backward", "optimizer", "ema")
NEW = ([f"serve.{p}_device_ms" for p in ("mel", "stem", "cnn", "bigru",
                                          "head")]
       + [f"train.{p}_{k}" for k in ("host_ms", "launches") for p in PHASES]
       + ["predict.resample_share", "predict.build_share"])


def _x(name, ts, dur, tid, cat="user_annotation", **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if args:
        e["args"] = args
    return e


def _events():
    """Two units of 1000 µs on thread 1. In each, ``inputs`` then
    ``backward``; in the first, ``read`` with ``resample`` inside. Thread
    2, autograd's, launches during the main thread's backward and has a
    ``bsed.`` span of its own that the reader ignores."""
    ev = [_x("portbench.window", 0, 2000, 1),
          _x("portbench.step", 0, 1000, 1),
          _x("portbench.step", 1000, 1000, 1),
          _x("bsed.train.inputs", 10, 90, 1),
          _x("bsed.train.backward", 100, 500, 1),
          _x("bsed.predict.read", 650, 250, 1),
          _x("bsed.predict.resample", 700, 150, 1),
          _x("bsed.train.inputs", 1010, 90, 1),
          _x("bsed.train.backward", 1100, 500, 1),
          _x("bsed.train.student", 300, 10, 2)]
    # (correlation, launch ts, launching thread, kernel start, duration)
    for corr, ts, tid, k0, dur in [(1, 20, 1, 25, 30), (2, 300, 2, 310, 100),
                                   (3, 1200, 2, 1210, 50),
                                   (4, 620, 1, 630, 10), (5, 750, 1, 760, 10)]:
        ev.append(_x("cudaLaunchKernel", ts, 3, tid, "cuda_runtime",
                     correlation=corr))
        ev.append(_x(f"k{corr}", k0, dur, 7, "kernel", correlation=corr))
    # a runtime call that started no device work
    ev.append(_x("cudaStreamSynchronize", 400, 5, 1, "cuda_runtime",
                 correlation=6))
    return ev


def _context(path, unit_name="step", summary=None):
    tr = T.Trace.load(str(path))
    if summary is None:
        lo, hi, tid = tr.window()
        summary = {"lo": lo, "hi": hi, "tid": tid}
    return Context(tr, summary, None, None,
                   SimpleNamespace(unit_name=unit_name),
                   SimpleNamespace(trace_path=str(path)), {})


@pytest.fixture
def ctx(tmp_path):
    path = tmp_path / "spans.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    return _context(path)


def test_launch_from_another_thread_counts_under_the_main_threads_span(ctx):
    # corr 2 and 3 on thread 2 in the two backwards, a unit: 1
    assert P.launches("bsed.train.backward")(ctx) == pytest.approx(1.0)
    assert P.launches("bsed.train.inputs")(ctx) == pytest.approx(0.5)
    # thread 2's own bsed. span takes nothing; corr 4 lies in no span
    assert "bsed.train.student" not in P.of(ctx).count
    assert sum(P.of(ctx).launches.values()) == 4


def test_self_time_subtracts_a_bsed_child(ctx):
    assert P.host_ms("bsed.predict.read")(ctx) == pytest.approx(
        (250 - 150) / 2 / 1e3)
    assert P.host_ms("bsed.predict.resample")(ctx) == pytest.approx(
        150 / 2 / 1e3)
    assert P.host_ms("bsed.train.backward")(ctx) == pytest.approx(0.5)
    # the share reads the whole span over the units' wall time
    assert P.share("bsed.predict.resample")(ctx) == pytest.approx(
        100 * 150 / 2000)
    assert P.share("bsed.predict.read")(ctx) == pytest.approx(
        100 * 250 / 2000)


def test_device_ms_follow_the_correlation_ids(ctx):
    assert P.device_ms("bsed.train.backward")(ctx) == pytest.approx(
        (100 + 50) / 2 / 1e3)
    assert P.device_ms("bsed.train.inputs")(ctx) == pytest.approx(
        30 / 2 / 1e3)
    assert P.device_ms("bsed.predict.resample")(ctx) == pytest.approx(
        10 / 2 / 1e3)
    assert P.device_ms("bsed.predict.read")(ctx) == 0.0


def test_values_are_per_traced_unit_and_none_where_the_span_never_ran(ctx):
    assert P.of(ctx).units == 2
    assert P.of(ctx) is P.of(ctx)          # parsed once a run
    for reader in (P.device_ms, P.host_ms, P.launches, P.share):
        assert reader("bsed.serve.mel")(ctx) is None
    # one unit traced: the same totals read twice as large
    lo, hi, tid = ctx.trace.window()
    one = _context(ctx.window.trace_path,
                   summary={"lo": lo, "hi": 1000, "tid": tid})
    assert P.of(one).units == 1
    assert P.host_ms("bsed.train.backward")(one) == pytest.approx(0.5)
    assert P.launches("bsed.train.backward")(one) == pytest.approx(1.0)


def test_idle_by_the_innermost_program_span(ctx):
    idle = dict(P.of(ctx).idle)
    # gaps begin at 55 (inputs, to 310), 410 and 1260 (backward, to 630
    # and 2000), 770 (resample, to 1210); at 0 and 640, in no bsed. span,
    # they go to the harness's innermost
    assert idle["bsed.train.inputs"] == pytest.approx(255e-6)
    assert idle["bsed.train.backward"] == pytest.approx((220 + 740) * 1e-6)
    assert idle["bsed.predict.resample"] == pytest.approx(440e-6)
    assert idle["portbench.step"] == pytest.approx((25 + 120) * 1e-6)


def test_nested_spans_give_innermost_segments():
    segs, self_us = P.innermost([(0, 10, "a"), (2, 4, "b"), (3, 4, "c"),
                                 (6, 11, "d")])
    # d ends past its parent a: cut at 10
    assert segs == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"),
                    (6, 10, "d")]
    assert self_us == {"a": 4, "b": 1, "c": 1, "d": 4}


def test_a_real_cpu_profile_of_two_tiny_train_steps(tmp_path):
    """Two tiny MT+ISP steps of the port under a CPU profile, each in a
    hand-placed ``portbench.step`` span: every phase reads a host time
    above 0 a step. The CPU has no device operations, so launches and
    device time are left to the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bsed_tpu_torch.config import AudioConfig, get_config
    from bsed_tpu_torch.train import steps

    cfg = get_config("baseline_mt_isp")
    cfg = cfg.replace(
        audio=AudioConfig(sr=3200, hop_size=160, max_len_seconds=1.0,
                          n_mels=16),
        model=dataclasses.replace(
            cfg.model, dropout=0.0, nb_filters=(16, 32, 64, 16),
            pooling=((2, 2), (2, 2), (1, 2), (1, 2)), n_rnn_cell=16),
        train=dataclasses.replace(cfg.train, batch_size=4))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        modules = steps.build_modules(cfg, device="cpu")
        state = steps.create_train_state(cfg, modules, 0)
        step = steps.make_train_step(modules)
        rng = np.random.default_rng(3)
        t_in, f, c = cfg.audio.max_frames, cfg.audio.n_mels, cfg.nclass
        batch = {"syn": np.abs(rng.standard_normal((4, t_in, f))),
                 "syn_strong": rng.random((4, cfg.n_frames, c)) > 0.9,
                 "real": np.abs(rng.standard_normal((4, t_in, f))),
                 "real_weak": rng.random((4, c)) > 0.7}
        batch = {k: torch.from_numpy(np.asarray(v, np.float32))
                 for k, v in batch.items()}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("portbench.window"):
                for _ in range(2):
                    with record_function("portbench.step"):
                        step(state, batch, 1, 30.0)
    finally:
        torch.set_num_threads(n)
    path = tmp_path / "spans.pt.trace.json"
    prof.export_chrome_trace(str(path))
    ctx = _context(path)
    spans = P.of(ctx)
    assert spans.units == 2
    for p in PHASES:
        name = f"bsed.train.{p}"
        assert spans.count[name] == 2, name
        assert load(ROOT, f"train.{p}_host_ms").read(ctx) > 0, name
        assert load(ROOT, f"train.{p}_launches").read(ctx) == 0, name


def test_the_new_metrics_import_nothing_blocked():
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "from portbench.harness import guard; guard.install()\n"
            "from portbench.harness.readers import load\n"
            f"for m in {NEW!r}: load({ROOT!r}, m)\n"
            "print(guard.loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    names = {m["name"]: m for m in bench["per_layer"]}
    for m in NEW:
        assert names[m]["source"] == "program_span"
