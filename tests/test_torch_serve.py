"""Slice 1 as a whole: the port's make_fast_forward (raw audio → frame and
clip posteriors) against bsed_tpu.serve.make_fast_forward on the same
flax-layout weights and numpy audio, float32, device='cpu'.

The small geometry is test_folded_stem.py's (sr 3200, hop 160, 2 s):
folded, standard and fused-epilogue branches (the JAX epilogue kernel in
interpret mode, the port's on its plain version). One case runs the parity
geometry at 1 s so the mel kernel's plain path runs end to end. Gate 1e-4
on strong and weak; the JAX side runs at float32 matmul precision
(conftest.py's note on XLA:CPU's bf16 conv fastpath)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.serve import make_fast_forward as j_make_fast_forward
from bsed_tpu.serve import predict_long_recording as j_predict_long
from bsed_tpu.train.steps import build_modules

from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.serve import make_fast_forward, predict_long_recording
from bsed_tpu_torch.utils.weights import init_params

SMALL = dict(sr=3200, hop_size=160, max_len_seconds=2.0)


def _pair(audio_kw, seed=0, activation="glu"):
    jcfg = j_get_config("baseline").replace(audio=JAudioConfig(**audio_kw))
    cfg = get_config("baseline").replace(audio=AudioConfig(**audio_kw))
    if activation != "glu":
        jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model,
                                                      activation=activation))
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    activation=activation))
    params, stats = init_params(cfg, seed)
    # widen the heads' N(0, 0.01) init so posteriors move away from 0.5
    # and the gate sees encoder differences
    for head in params["predictor"].values():
        head["kernel"] *= 30.0
    return jcfg, cfg, params, stats


def _jax_forward(jcfg, params, stats, **kw):
    fwd = jax.jit(j_make_fast_forward(jcfg, build_modules(jcfg), params,
                                      stats, **kw))

    def run(audio):
        with jax.default_matmul_precision("float32"):
            return fwd(audio)
    return run


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("kw", [
    {},                                   # folded stem (the default)
    {"use_folded_stem": False},           # standard CRNN branch
    {"use_fused_epilogue": True},         # folded + fused epilogue (K2)
])
def test_fast_forward_matches_jax(kw):
    jcfg, cfg, params, stats = _pair(SMALL)
    audio = np.random.default_rng(11).standard_normal(
        (3, cfg.audio.n_samples)).astype(np.float32)
    want = _jax_forward(jcfg, params, stats, **kw)(audio)
    got = make_fast_forward(cfg, params, stats, device="cpu", **kw)(audio)
    assert got[0].shape == (3, cfg.n_frames, 20) and got[1].shape == (3, 20)
    _close(got, want)


def test_parity_geometry_block_kernel_path():
    """10 s geometry cut to 1 s: the port's mel kernel path (its plain
    version on the CPU) end to end against the JAX dense front end."""
    jcfg, cfg, params, stats = _pair(dict(max_len_seconds=1.0), seed=1)
    audio = np.random.default_rng(3).standard_normal(
        (2, cfg.audio.n_samples)).astype(np.float32) * 0.1
    want = _jax_forward(jcfg, params, stats)(audio)
    got = make_fast_forward(cfg, params, stats, device="cpu",
                            precision="high",
                            mel_algorithm="block_kernel")(audio)
    assert got[0].shape == (2, 31, 20)
    _close(got, want)


def test_predict_long_recording_matches_jax():
    jcfg, cfg, params, stats = _pair(SMALL, seed=2)
    rec = np.random.default_rng(5).standard_normal(17700).astype(np.float32)
    want, w_sec = j_predict_long(_jax_forward(jcfg, params, stats), rec,
                                 jcfg, batch_size=3, hop_seconds=1.0)
    got, sec = predict_long_recording(
        make_fast_forward(cfg, params, stats, device="cpu"), rec, cfg,
        batch_size=3, hop_seconds=1.0)
    assert sec == w_sec and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg, params, stats = _pair(SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fast_forward(cfg, params, stats)          # device="cuda"


@pytest.mark.parametrize("kw", [{}, {"use_folded_stem": False},
                                {"use_fused_stem": True}])
def test_serving_runs_the_hoisted_bigru(monkeypatch, kw):
    """Folded, standard and fused-stem branches run the BiGRU in
    bsed_tpu's hoisted form (K4's recurrence, its plain version on the
    CPU): with nn.GRU's forward made to raise, each still serves."""
    def refuse(*args, **kwargs):
        raise AssertionError("serving reached nn.GRU")
    monkeypatch.setattr(torch.nn.GRU, "forward", refuse)
    _, cfg, params, stats = _pair(SMALL, seed=7)
    audio = np.random.default_rng(8).standard_normal(
        (2, cfg.audio.n_samples)).astype(np.float32)
    strong, weak = make_fast_forward(cfg, params, stats, device="cpu",
                                     **kw)(audio)
    assert strong.shape == (2, cfg.n_frames, 20)
    assert torch.isfinite(strong).all() and torch.isfinite(weak).all()


def test_fused_stem_with_cg_falls_through_to_standard():
    """The fused stem exists only for GLU: with context gating
    ``use_fused_stem=True`` runs the standard CRNN branch, as in JAX."""
    jcfg, cfg, params, stats = _pair(SMALL, seed=4, activation="cg")
    audio = np.random.default_rng(6).standard_normal(
        (2, cfg.audio.n_samples)).astype(np.float32)
    want = _jax_forward(jcfg, params, stats, use_fused_stem=True)(audio)
    got = make_fast_forward(cfg, params, stats, device="cpu",
                            use_fused_stem=True)(audio)
    _close(got, want)
    std = make_fast_forward(cfg, params, stats, device="cpu",
                            use_folded_stem=False)(audio)
    for g, s in zip(got, std):
        torch.testing.assert_close(g, s, rtol=0, atol=0)
