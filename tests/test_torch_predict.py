"""The port's ``predict`` (bsed_tpu_torch/predict.py and the CLI's
``predict``) against ``bsed_tpu``'s ``cmd_predict`` on the CPU.

One reference-format checkpoint, written by the port's
``export_torch_checkpoint`` from seeded weights at the ``--tiny-audio``
geometry (2 s clips at 3.2 kHz; the predictor's dense kernel scaled by
``SCALE`` so the frame posteriors spread over 0.3-0.65 rather than
hugging 0.5), serves two recordings longer than two clips: an int16
stereo WAV at 4.41 kHz (resampled on read) and a raw-audio ``.npy``. Both
CLIs run ``predict --precision highest`` with ``--torch-checkpoint``:
``bsed_tpu.cli.main`` in-process on one device (the port has no mesh, so
the JAX side takes its single-device branch, ``auto_data_mesh`` → None),
under ``jax.default_matmul_precision("float32")``, and the port's with
``--device cpu``. Gates: each recording's frame posteriors from
``predict_long_recording`` within 1e-4 of JAX's; no posterior within 1e-4
of the threshold (a near-tie would let float noise flip a frame, so the
test names it and fails); then the two TSVs byte-equal.
"""
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import bsed_tpu.cli as j_cli
import bsed_tpu.parallel.mesh as j_mesh
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.eval.test_model import load_torch_checkpoint as j_load
from bsed_tpu.serve import make_fast_forward as j_make_fast_forward
from bsed_tpu.serve import predict_long_recording as j_predict_long
from bsed_tpu.train.steps import build_modules as j_build_modules
from bsed_tpu.utils.audio import read_audio as j_read_audio

from bsed_tpu_torch import cli
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.eval.test_model import export_torch_checkpoint
from bsed_tpu_torch.predict import predict_recordings, write_event_tsv
from bsed_tpu_torch.utils.device import TF32_BY_PRECISION, float32_precision
from bsed_tpu_torch.utils.weights import init_params

TINY = dict(sr=3200, hop_size=160, max_len_seconds=2.0)
SCALE = 30.0
THRESHOLD = 0.45
GATE = 1e-4
WAV_SR = 4410

# (extra CLI flags, hop_seconds, batch_size): the fixed median window; the
# class-wise windows; overlapping windows (1.5 s hop on 2 s clips) in
# batches of 3, the last one ragged and padded
CASES = {
    "fixed": ([], None, 32),
    "learned_post": (["--learned-post"], None, 32),
    "hop": (["--hop-seconds", "1.5", "--batch-size", "3"], 1.5, 3),
}


@pytest.fixture(scope="module")
def cfg():
    return get_config("baseline").replace(audio=AudioConfig(**TINY))


@pytest.fixture(scope="module")
def fixture(cfg, tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    params, stats = init_params(cfg, 5)
    params["predictor"]["dense"]["kernel"] = (
        params["predictor"]["dense"]["kernel"] * SCALE)
    ckpt = export_torch_checkpoint(cfg, params, stats,
                                   str(root / "model.pt"))
    rng = np.random.default_rng(7)
    wav = str(root / "field.wav")
    wavfile.write(wav, WAV_SR, (rng.standard_normal(
        (int(5.3 * WAV_SR), 2)) * 3000).astype(np.int16))
    npy = str(root / "raw.npy")
    np.save(npy, (rng.standard_normal(int(4.1 * cfg.audio.sr)) * 0.1
                  ).astype(np.float32))
    return {"root": root, "ckpt": ckpt, "params": params, "stats": stats,
            "audio": [wav, npy]}


@pytest.fixture(scope="module")
def jax_forward(fixture):
    """bsed_tpu's jitted forward at 'highest' on the checkpoint, as its
    CLI builds it on one device."""
    jcfg = j_get_config("baseline").replace(audio=JAudioConfig(**TINY))
    params, stats = j_load(fixture["ckpt"], jcfg)
    with jax.default_matmul_precision("float32"):
        forward = jax.jit(j_make_fast_forward(
            jcfg, j_build_modules(jcfg), params, stats, precision="highest"))
    return jcfg, forward


def _jax_posteriors(jax_forward, paths, hop_seconds, batch_size):
    jcfg, forward = jax_forward
    out = []
    with jax.default_matmul_precision("float32"):
        for path in paths:
            audio = (np.load(path).astype(np.float32) if path.endswith(".npy")
                     else j_read_audio(path, jcfg.audio.sr)[0])
            strong, _ = j_predict_long(forward, audio, jcfg,
                                       batch_size=batch_size,
                                       hop_seconds=hop_seconds)
            out.append(np.asarray(strong))
    return out


def _assert_no_near_ties(posteriors, paths, cfg):
    for path, p in zip(paths, posteriors):
        near = np.argwhere(np.abs(p - THRESHOLD) < GATE)
        assert not len(near), (
            f"{os.path.basename(path)}: frame {near[0][0]}, class "
            f"{cfg.bird_list[near[0][1]]} has posterior "
            f"{p[tuple(near[0])]:.7f}, within {GATE} of the threshold "
            f"{THRESHOLD}: the TSV comparison would hang on float noise")


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_matches_bsed_tpu(case, cfg, fixture, jax_forward,
                                  monkeypatch):
    flags, hop, batch = CASES[case]
    paths = fixture["audio"]
    ours = predict_recordings(cfg, fixture["params"], fixture["stats"],
                              paths, device="cpu", precision="highest",
                              threshold=THRESHOLD, hop_seconds=hop,
                              batch_size=batch, keep_posteriors=True,
                              learned_post="--learned-post" in flags)
    theirs = _jax_posteriors(jax_forward, paths, hop, batch)
    for path, a, b in zip(paths, ours["posteriors"], theirs):
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=GATE, rtol=0, err_msg=path)
    _assert_no_near_ties(theirs, paths, cfg)
    # 3 windows a recording; with a 1.5 s hop the WAV has 4, the last
    # batch of 3 padded from 1
    assert ours["batches"] == ([[3, 3], [3]] if hop else [[3], [3]])
    assert ours["tf32"] == {"matmul_tf32": False, "cudnn_tf32": False}

    root = fixture["root"]
    common = ["predict", "--tiny-audio", "--preset", "baseline",
              "--torch-checkpoint", fixture["ckpt"], "--audio", *paths,
              "--precision", "highest", "--threshold", str(THRESHOLD),
              *flags]
    j_tsv, t_tsv = str(root / f"jax_{case}.tsv"), str(root / f"port_{case}.tsv")
    monkeypatch.setattr(j_mesh, "auto_data_mesh", lambda *a, **k: None)
    with jax.default_matmul_precision("float32"):
        j_cli.main([*common, "--out-tsv", j_tsv])
    out = cli.main([*common, "--out-tsv", t_tsv, "--device", "cpu"])
    with open(j_tsv, "rb") as fh:
        want = fh.read()
    with open(t_tsv, "rb") as fh:
        got = fh.read()
    assert got == want
    assert len(out["rows"]) > 0 and want.count(b"\n") == len(out["rows"]) + 1


def test_empty_result_is_the_header_alone(tmp_path):
    """No events: the header line alone, as pandas writes an empty frame;
    times as "%.3f"."""
    import pandas as pd

    cols = ["filename", "event_label", "onset", "offset"]
    rows = [("a.wav", "EATO", 0.0, 1.0 / 3.0), ("b.npy", "WOTH", 2.0005,
                                                  12.3456789)]
    for name, data in (("empty", []), ("rows", rows)):
        want, got = tmp_path / f"{name}_pd.tsv", tmp_path / f"{name}.tsv"
        pd.DataFrame(data, columns=cols).to_csv(want, sep="\t", index=False,
                                                float_format="%.3f")
        write_event_tsv(data, str(got))
        assert got.read_bytes() == want.read_bytes(), name


def test_float32_precision_sets_and_restores_tf32():
    """'highest' and 'high' run with TF32 off, 'fast' with it on; the
    caller's settings come back after the block, also after an error."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    try:
        for start in (False, True):
            matmul.allow_tf32 = cudnn.allow_tf32 = start
            for precision, tf32 in TF32_BY_PRECISION.items():
                with float32_precision(precision) as seen:
                    assert seen == {"matmul_tf32": tf32, "cudnn_tf32": tf32}
                    assert matmul.allow_tf32 is tf32
                    assert cudnn.allow_tf32 is tf32
                assert (matmul.allow_tf32, cudnn.allow_tf32) == (start, start)
            with pytest.raises(ValueError):
                with float32_precision("highest"):
                    raise ValueError
            assert (matmul.allow_tf32, cudnn.allow_tf32) == (start, start)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
    assert TF32_BY_PRECISION == {"highest": False, "high": False,
                                 "fast": True}


def test_predict_without_a_card_refuses(fixture, tmp_path):
    """``predict`` runs on the card by default and never falls back to
    the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["predict", "--tiny-audio", "--preset", "baseline",
                  "--torch-checkpoint", fixture["ckpt"], "--audio",
                  fixture["audio"][1], "--out-tsv", str(tmp_path / "e.tsv")])
