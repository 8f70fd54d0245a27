"""The port's spans (``utils/profiling.span``) on the CPU: the null context
when no profiler runs, and the spans a profiled serving forward, MT+ISP
train step and ``predict`` call emit, read from the profile's exported
Chrome trace. Tiny sizes: 2 s clips of 16 mel bins, four narrow blocks."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.utils import profiling
from bsed_tpu_torch.utils.weights import init_params

SERVE = ["bsed.serve.mel", "bsed.serve.stem", "bsed.serve.cnn",
         "bsed.serve.bigru", "bsed.serve.head"]
PHASES = ["bsed.train.inputs", "bsed.train.teacher", "bsed.train.student",
          "bsed.train.backward", "bsed.train.optimizer", "bsed.train.ema"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(preset="baseline"):
    cfg = get_config(preset)
    cfg = cfg.replace(audio=AudioConfig(sr=3200, hop_size=160,
                                        max_len_seconds=2.0, n_mels=16))
    return cfg.replace(model=dataclasses.replace(
        cfg.model, dropout=0.0, nb_filters=(16, 32, 64, 32),
        pooling=((2, 2), (2, 2), (1, 2), (1, 2)), n_rnn_cell=32))


def profiled_spans(fn, tmp_path):
    """(result of ``fn()``, [(start µs, end µs, name)] of the ``bsed.``
    spans it emitted under a CPU profile, in order of start)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(profiling.PREFIX))
    return out, spans


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch,
                                                            tmp_path):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b")
    seconds = {}
    with profiling.span("a", seconds, "a"):
        with profiling.span("b"):
            torch.ones(4).sum()
    assert seconds["a"] > 0
    # a whole forward and a predict call enter none either
    from bsed_tpu_torch.predict import predict_recordings
    from bsed_tpu_torch.serve import make_fast_forward
    cfg = tiny_cfg()
    params, stats = init_params(cfg, 3)
    forward = make_fast_forward(cfg, params, stats, device="cpu")
    forward(np.zeros((2, cfg.audio.n_samples), np.float32))
    path = str(tmp_path / "r.wav")
    wavfile.write(path, 4800, np.zeros(4800 * 3, np.int16))
    out = predict_recordings(cfg, params, stats, [path], device="cpu")
    assert sorted(out["seconds"]) == ["decode", "filter", "forward", "read"]


def test_serving_forward_emits_its_five_parts_in_order(tmp_path):
    from bsed_tpu_torch.serve import make_fast_forward
    cfg = tiny_cfg()
    params, stats = init_params(cfg, 3)
    forward = make_fast_forward(cfg, params, stats, device="cpu")
    audio = np.random.default_rng(0).standard_normal(
        (2, cfg.audio.n_samples)).astype(np.float32) * 0.1
    (strong, weak), spans = profiled_spans(lambda: forward(audio), tmp_path)
    assert [n for _, _, n in spans] == SERVE
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= b[0]            # one after the other, none nested
    assert strong.shape == (2, cfg.n_frames, cfg.nclass)


def test_mt_isp_train_step_emits_its_six_phases_in_order(tmp_path):
    from bsed_tpu_torch.train import steps
    cfg = tiny_cfg("baseline_mt_isp")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=4))
    modules = steps.build_modules(cfg, device="cpu")
    state = steps.create_train_state(cfg, modules, 0)
    step = steps.make_train_step(modules)
    rng = np.random.default_rng(1)
    t_in, f, c = cfg.audio.max_frames, cfg.audio.n_mels, cfg.nclass
    batch = {"syn": np.abs(rng.standard_normal((4, t_in, f))),
             "syn_strong": rng.random((4, cfg.n_frames, c)) > 0.9,
             "real": np.abs(rng.standard_normal((4, t_in, f))),
             "real_weak": rng.random((4, c)) > 0.7}
    batch = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in batch.items()}
    metrics, spans = profiled_spans(
        lambda: step(state, batch, 1, 30.0), tmp_path)
    assert [n for _, _, n in spans] == PHASES
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= b[0]
    assert np.isfinite(float(metrics["loss"])) and state.step == 1


def test_predict_spans_read_resample_and_build(tmp_path):
    from bsed_tpu_torch.predict import predict_recordings
    cfg = tiny_cfg()
    params, stats = init_params(cfg, 3)
    rng = np.random.default_rng(2)
    paths = []
    for sr in (48000, cfg.audio.sr):
        path = str(tmp_path / f"rec_{sr}.wav")
        wavfile.write(path, sr, (rng.standard_normal(int(3.5 * sr)) * 3000
                                 ).astype(np.int16))
        paths.append(path)
    out, spans = profiled_spans(lambda: predict_recordings(
        cfg, params, stats, paths, device="cpu"),
        tmp_path)
    by = {}
    for s in spans:
        by.setdefault(s[2], []).append(s)
    assert len(by["bsed.predict.build"]) == 1
    assert len(by["bsed.predict.forward"]) == 2
    assert len(by["bsed.predict.filter"]) == 2
    assert len(by["bsed.predict.decode"]) == 2
    # the serving parts nest in the forwards
    for s in by["bsed.serve.mel"]:
        assert any(inside(s, f) for f in by["bsed.predict.forward"])
    read_48k, read_own = sorted(by["bsed.predict.read"])
    (resample,) = by["bsed.predict.resample"]
    assert inside(resample, read_48k) and not inside(resample, read_own)
    seconds = out["seconds"]
    assert sorted(seconds) == ["decode", "filter", "forward", "read"]
    # read still times the read and the resample together
    assert seconds["read"] >= (resample[1] - resample[0]) / 1e6
    assert seconds["read"] <= sum(b - a for a, b, _ in
                                  by["bsed.predict.read"]) / 1e6
    assert len(out["rows"]) >= 0 and out["audio_seconds"] == \
        pytest.approx(7.0)
