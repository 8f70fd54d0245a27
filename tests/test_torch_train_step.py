"""One flagship train step of the port (bsed_tpu_torch/train/steps.py) against
``bsed_tpu.train.steps.make_train_step`` on the CPU: preset
``baseline_mt_isp`` on 2 s clips at 3.2 kHz, float32, the folded train
stem with the fused epilogue (JAX runs its Pallas K2/K3 in interpret mode,
the port their plain versions), dropout 0 and no teacher noise, so the
only random draws are the ISP shifts, which both sides take from the same
replay (as tests/test_reference_train_parity.py feeds them). The JAX train
state is carried into the port with utils/weights.py.

Gates after one step at epoch 30 (lr and cost at their maxima): every
metric rel 1e-4; the gradients through Adam's first moment (mu = 0.1·g
after one step) at atol 3e-4 / rtol 1e-4 on mu/0.1, the gate of
tests/test_folded_stem.py; the EMA params at 1e-5; BatchNorm running stats
of student and teacher at 1e-5 absolute plus 1e-4 relative; the step count.

Two allowances, both measured and both those of
tests/test_reference_train_parity.py: (1) elements whose gradient is
cancellation noise (|g| < 1e-6: conv biases feeding BatchNorm, the
attention-softmax bias) take an Adam step of arbitrary sign on either side,
so their EMA params get the Adam step bound 1.1·lr on top; (2) block 0's
batch variance (~30) is a float32 mean over ~1e5 squared dB-scale
activations, whose reduction order alone moves it by ~2e-5 relative between
XLA and PyTorch, hence the relative term on the statistics."""
import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsed_tpu.train.steps as j_steps
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config

import bsed_tpu_torch.train.steps as steps
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.utils import weights

BS = 4
EPOCH = 30.0


def _shifts():
    """One step's ISP draws in the reference's order (time then freq)."""
    rr = random.Random(2023)
    t = [rr.randint(-64, 64) for _ in range(BS)]
    f = [rr.randint(-4, 4) for _ in range(BS)]
    return [s * 4 for s in t], t, f


def _override(cfg, audio_cls, fused_streams):
    cfg = cfg.replace(audio=audio_cls(sr=3200, hop_size=160,
                                      max_len_seconds=2.0, noise_snr=None))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, folded_train_stem=True,
                                  fused_stem_epilogue=True, dropout=0.0),
        train=dataclasses.replace(cfg.train, fused_streams=fused_streams))


def _batch(cfg):
    rng = np.random.default_rng(5)
    t_in, f = cfg.audio.max_frames, cfg.audio.n_mels
    strong = (rng.random((BS, cfg.n_frames, cfg.nclass)) > 0.9)
    return {
        "syn": np.abs(rng.standard_normal((BS, t_in, f))).astype(np.float32),
        "syn_strong": strong.astype(np.float32),
        "real": np.abs(rng.standard_normal((BS, t_in, f))).astype(
            np.float32),
        "real_weak": (rng.random((BS, cfg.nclass)) > 0.7).astype(
            np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_step(fused_streams):
    """(trees before, trees after, metrics, cfg) of one JAX step, built
    once per configuration in this file."""
    cfg = _override(j_get_config("baseline_mt_isp"), JAudioConfig,
                    fused_streams)
    modules = j_steps.build_modules(cfg)
    state = jax.jit(lambda k: j_steps.create_train_state(cfg, modules, k))(
        jax.random.key(3))
    before = weights.trees_from_jax_state(state)
    t_sh, p_sh, f_sh = _shifts()
    orig = j_steps.sample_isp_shifts
    j_steps.sample_isp_shifts = lambda *a, **k: (
        jnp.asarray(t_sh, jnp.int32), jnp.asarray(p_sh, jnp.int32),
        jnp.asarray(f_sh, jnp.int32))
    try:
        with jax.default_matmul_precision("float32"):
            step = j_steps.make_train_step(modules)
            batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
            new, metrics = step(state, batch, jax.random.key(1),
                                jnp.asarray(EPOCH, jnp.float32))
            after = weights.trees_from_jax_state(new)
    finally:
        j_steps.sample_isp_shifts = orig
    return before, after, {k: float(v) for k, v in metrics.items()}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _assert_trees(got, want, what, atol, rtol=0.0, grads=None,
                  noise_bound=0.0):
    """|Δ| ≤ atol + rtol·|want| per element, plus ``noise_bound`` where
    the gradient tree ``grads`` is below 1e-6 (see the module docstring)."""
    want_l = dict(_leaves(want))
    got_l = dict(_leaves(got))
    assert got_l.keys() == want_l.keys(), what
    g_l = dict(_leaves(grads)) if grads is not None else {}
    for path, v in want_l.items():
        bound = atol + rtol * np.abs(v)
        if path in g_l:
            bound = bound + np.where(np.abs(g_l[path]) < 1e-6, noise_bound,
                                     0.0)
        delta = np.abs(got_l[path] - v)
        assert (delta <= bound).all(), (
            f"{what} {path}: |Δ| {float(delta.max())}, "
            f"excess {float((delta - bound).max())}")


@pytest.mark.parametrize("fused_streams", [True, False])
def test_train_step_matches_jax(fused_streams, monkeypatch):
    before, after, j_metrics = _jax_step(fused_streams)
    cfg = _override(get_config("baseline_mt_isp"), AudioConfig,
                    fused_streams)
    t_sh, p_sh, f_sh = _shifts()
    monkeypatch.setattr(steps, "sample_isp_shifts", lambda *a, **k: tuple(
        torch.tensor(s) for s in (t_sh, p_sh, f_sh)))
    modules = steps.build_modules(cfg, device="cpu")
    state = steps.load_train_state(modules, before)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    metrics = steps.make_train_step(modules)(state, batch, 1, EPOCH)
    got = weights.export_train_state(state)

    assert got["step"] == after["step"] == 1
    assert metrics.keys() == j_metrics.keys()
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4,
                                   err_msg=k)
    assert got["count"] == after["count"] == 1
    grads = jax.tree.map(lambda m: m / 0.1, after["mu"])
    _assert_trees(jax.tree.map(lambda m: m / 0.1, got["mu"]), grads,
                  "gradient (mu/0.1)", atol=3e-4, rtol=1e-4)
    _assert_trees(got["ema_params"], after["ema_params"], "EMA params",
                  atol=1e-5, grads=grads,
                  noise_bound=1.1 * j_metrics["lr"])
    for key in ("batch_stats", "ema_batch_stats"):
        _assert_trees(got[key], after[key], key, atol=1e-5, rtol=1e-4)
