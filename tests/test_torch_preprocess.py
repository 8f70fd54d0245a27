"""The port's audio IO and ``preprocess`` (bsed_tpu_torch/utils/audio.py,
data/preprocess.py, the CLI's ``preprocess``) against ``bsed_tpu``'s on
the CPU.

``read_wav`` bit for bit on int16, uint8, float32 and stereo WAVs, with
and without resampling (44.1 → 32 kHz is 320/441); ``segment_audio``,
``wav_duration_s``, ``read_audio``; the duration TSV byte-equal. Then an
ENA-layout root (two "Recording" domains and one other, WAVs with Raven
selection tables: events across segment boundaries, close pairs that
merge, short ones that drop, a species off the bird list, and one
recording without annotations) through both packages' preprocess and
split: the same dump names and shapes, log-mel within the front end's
1e-3 dB gate (``tests/test_torch_mel.py``; the JAX side under
``jax.default_matmul_precision("float32")``), annotation files with the
same columns and labels and times within 1e-12, and the same names in
each split directory.
"""
import csv
import os
import shutil

import jax
import numpy as np
import pytest
from scipy.io import wavfile

import bsed_tpu.cli as j_cli
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.data import preprocess as j_pre
from bsed_tpu.utils import audio as j_audio

from bsed_tpu_torch import cli
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.data import preprocess as pre
from bsed_tpu_torch.ops.mel import amplitude_to_db
from bsed_tpu_torch.utils import audio

from tests.test_torch_mel import assert_db_close

SMALL = dict(sr=3200, hop_size=160, max_len_seconds=2.0)
RAVEN = ["Selection", "View", "Channel", "Begin Time (s)", "End Time (s)",
         "Low Freq (Hz)", "High Freq (Hz)", "Species"]


def _write_wav(path, sr, seconds, dtype, channels, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((int(seconds * sr), channels)) * 0.2
    if dtype == "int16":
        data = (x * 32767).astype(np.int16)
    elif dtype == "uint8":
        data = np.clip(x * 127 + 128, 0, 255).astype(np.uint8)
    else:
        data = x.astype(np.float32)
    wavfile.write(path, sr, data[:, 0] if channels == 1 else data)
    return path


@pytest.mark.parametrize("dtype", ["int16", "uint8", "float32"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rates", [(3200, 3200), (4410, 3200),
                                   (44100, 32000), (8000, 3200)])
def test_read_wav_is_bsed_tpus(tmp_path, dtype, channels, rates):
    src_sr, target = rates
    path = _write_wav(str(tmp_path / "x.wav"), src_sr, 0.37, dtype,
                      channels, seed=channels)
    got = pre.read_wav(path, target)
    want = j_pre.read_wav(path, target)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got_a, sr = audio.read_audio(path, target)
    np.testing.assert_array_equal(got_a, j_audio.read_audio(path, target)[0])
    assert sr == target
    if dtype == "float32":     # the wave module reads PCM only, both sides
        import wave
        for fn in (audio.wav_duration_s, j_audio.wav_duration_s):
            with pytest.raises(wave.Error):
                fn(path)
    else:
        assert audio.wav_duration_s(path) == j_audio.wav_duration_s(path)


def test_resample_fraction_is_320_over_441():
    from fractions import Fraction
    frac = Fraction(32000, 44100).limit_denominator(1000)
    assert (frac.numerator, frac.denominator) == (320, 441)


def test_segment_audio_and_durations_tsv(tmp_path):
    x = np.arange(23, dtype=np.float32)
    for seg in (1, 5, 23, 24):
        np.testing.assert_array_equal(pre.segment_audio(x, seg),
                                      j_pre.segment_audio(x, seg))
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i, (sr, s) in enumerate(((3200, 1.0), (4410, 0.33), (8000, 2.5))):
        _write_wav(str(wavs / f"r{i}.wav"), sr, s, "int16", 1, i)
    rows = audio.generate_tsv_wav_durations(str(wavs), str(tmp_path / "a.tsv"))
    df = j_audio.generate_tsv_wav_durations(str(wavs), str(tmp_path / "b.tsv"))
    assert rows == list(df.itertuples(index=False, name=None))
    assert (tmp_path / "a.tsv").read_bytes() == \
        (tmp_path / "b.tsv").read_bytes()


def test_mp3_to_wav_is_gated():
    with pytest.raises(NotImplementedError, match="mp3"):
        audio.mp3_to_wav("a.mp3", "a.wav")


def _raven(path, rows):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t", lineterminator="\n")
        w.writerow(RAVEN)
        for i, (a, b, sp) in enumerate(rows):
            w.writerow([i + 1, "Spectrogram 1", 1, a, b, 1000.0, 4000.0, sp])


def _ena_root(root, sr, seg_s):
    """Two Recording domains (+ one the preprocess skips) of int16 WAVs at
    ``sr``; events in units of the segment length ``seg_s``."""
    s = seg_s
    layout = {
        "Recording_1": {
            "r1_a": (2.6, [(0.1 * s, 0.5 * s, "EATO"),
                           (0.55 * s, 0.6 * s, "EATO"),   # merges (< .15 s)
                           (0.8 * s, 1.3 * s, "WOTH"),    # crosses 1·s
                           (1.4 * s, 1.4 * s + 0.1, "BCCH"),  # too short
                           (1.5 * s, 1.9 * s, "NOPE"),    # not a bird
                           (2.0 * s + 0.3, 2.4 * s, "AMRE")]),
            "r1_b": (1.2, None),                          # no annotation
        },
        "Recording_2": {"r2_a": (3.1, [(0.2 * s, 2.7 * s, "OVEN"),
                                       (1.0 * s, 1.1 * s, "OVEN")])},
        "Other": {"o_a": (1.5, [(0.1 * s, 0.4 * s, "EATO")])},
    }
    for d, recs in layout.items():
        os.makedirs(os.path.join(root, "wav", d), exist_ok=True)
        os.makedirs(os.path.join(root, "annotation", d), exist_ok=True)
        for i, (stem, (segs, events)) in enumerate(sorted(recs.items())):
            _write_wav(os.path.join(root, "wav", d, stem + ".wav"), sr,
                       segs * seg_s, "int16", 2 if i else 1,
                       sum(map(ord, stem)))
            if events is not None:
                _raven(os.path.join(root, "annotation", d,
                                    stem + ".Table.1.selections.txt"),
                       events)
    return root


def _read_txt(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh, delimiter="\t"))
    return rows[0], rows[1:]


def _assert_same_dumps(ours, theirs, names):
    for name in names:
        got = np.load(os.path.join(ours, "wav", name + ".npy"))
        want = np.load(os.path.join(theirs, "wav", name + ".npy"))
        assert got.shape == want.shape and got.dtype == want.dtype
        assert_db_close(amplitude_to_db(_t(got[None])).numpy(),
                        amplitude_to_db(_t(want[None])).numpy(), name)
        h_got, r_got = _read_txt(os.path.join(ours, "annotation",
                                              name + ".txt"))
        h_want, r_want = _read_txt(os.path.join(theirs, "annotation",
                                                name + ".txt"))
        assert h_got == h_want == ["onset", "offset", "event_label"]
        assert [r[2] for r in r_got] == [r[2] for r in r_want], name
        np.testing.assert_allclose(
            np.array([r[:2] for r in r_got], float).reshape(-1, 2),
            np.array([r[:2] for r in r_want], float).reshape(-1, 2),
            rtol=0, atol=1e-12, err_msg=name)


def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _listing(root, sub):
    out = {}
    for kind in ("wav", "annotation"):
        d = os.path.join(root, sub, kind)
        out[kind] = sorted(os.listdir(d)) if os.path.isdir(d) else None
    return out


@pytest.fixture(scope="module")
def small_roots(tmp_path_factory):
    """The same ENA root preprocessed and split by each package at the
    small geometry (2 s segments at 3.2 kHz)."""
    cfg = get_config("baseline").replace(audio=AudioConfig(**SMALL))
    jcfg = j_get_config("baseline").replace(audio=JAudioConfig(**SMALL))
    base = tmp_path_factory.mktemp("ena")
    ours = _ena_root(str(base / "ours"), 4410, 2.0)
    theirs = str(base / "theirs")
    shutil.copytree(ours, theirs)
    seconds = {}
    names = pre.ena_data_preprocess(ours, cfg, device="cpu",
                                    seconds=seconds)
    pre.data_split(ours, cfg)
    with jax.default_matmul_precision("float32"):
        j_names = j_pre.ena_data_preprocess(theirs, jcfg)
    j_pre.data_split(theirs, jcfg)
    return {"cfg": cfg, "ours": ours, "theirs": theirs, "names": names,
            "j_names": j_names, "seconds": seconds}


def test_preprocess_dumps_match(small_roots):
    r = small_roots
    cfg = r["cfg"]
    assert r["names"] == r["j_names"]
    assert "o_a_0" not in r["names"] and "r1_b_0" in r["names"]
    assert len(r["names"]) == 2 + 1 + 3
    sub = cfg.data.feature_subdir
    assert _listing(r["ours"], sub) == _listing(r["theirs"], sub)
    shape = np.load(os.path.join(r["ours"], sub, "wav",
                                 r["names"][0] + ".npy")).shape
    assert shape == (cfg.audio.max_frames, cfg.audio.n_mels)
    _assert_same_dumps(os.path.join(r["ours"], sub),
                       os.path.join(r["theirs"], sub), r["names"])
    assert set(r["seconds"]) == {"read", "annotations", "mel", "write"}


def test_preprocess_annotations_are_segmented(small_roots):
    """The events reach their segments as bsed_tpu puts them: merged,
    split at boundaries, short and off-list ones dropped, and the
    recording without a table gets header-only files."""
    r = small_roots
    d = os.path.join(r["ours"], r["cfg"].data.feature_subdir, "annotation")
    header, rows = _read_txt(os.path.join(d, "r1_a_0.txt"))
    assert [x[2] for x in rows] == ["EATO", "WOTH"]
    assert float(rows[0][1]) == pytest.approx(1.2)
    assert [x[2] for x in _read_txt(os.path.join(d, "r1_a_1.txt"))[1]] == \
        ["WOTH"]
    assert _read_txt(os.path.join(d, "r1_b_0.txt"))[1] == []
    with open(os.path.join(d, "r1_b_0.txt"), "rb") as fh:
        assert fh.read() == b"onset\toffset\tevent_label\n"


def test_data_split_matches(small_roots):
    r = small_roots
    data = r["cfg"].data
    for sub in (data.train_weak_subdir, data.train_unlabeled_subdir,
                data.val_subdir):
        assert _listing(r["ours"], sub) == _listing(r["theirs"], sub), sub
    n = sum(len(_listing(r["ours"], s)["wav"]) for s in
            (data.train_weak_subdir, data.train_unlabeled_subdir,
             data.val_subdir))
    assert n == len(r["names"])


def test_preprocess_cli_matches_at_full_geometry(tmp_path):
    """Both CLIs' ``preprocess`` on one 21 s recording at 32 kHz (two
    10 s dumps of 1255 × 128), the port's with ``--device cpu``."""
    cfg = get_config("baseline")
    ours = str(tmp_path / "ours")
    os.makedirs(os.path.join(ours, "wav", "Recording_1"))
    os.makedirs(os.path.join(ours, "annotation", "Recording_1"))
    _write_wav(os.path.join(ours, "wav", "Recording_1", "field.wav"), 44100,
               21.0, "int16", 2, 3)
    _raven(os.path.join(ours, "annotation", "Recording_1", "field.txt"),
           [(2.0, 3.5, "EATO"), (9.5, 12.0, "WOTH"), (14.0, 19.0, "BCCH")])
    theirs = str(tmp_path / "theirs")
    shutil.copytree(ours, theirs)
    assert cli.main(["preprocess", "--dataset-root", ours,
                     "--device", "cpu"]) == ["field_0", "field_1"]
    with jax.default_matmul_precision("float32"):
        j_cli.main(["preprocess", "--dataset-root", theirs])
    sub = cfg.data.feature_subdir
    assert _listing(ours, sub) == _listing(theirs, sub)
    _assert_same_dumps(os.path.join(ours, sub), os.path.join(theirs, sub),
                       ["field_0", "field_1"])
    assert np.load(os.path.join(ours, sub, "wav", "field_0.npy")).shape == \
        (1255, 128)
    for s in (cfg.data.train_weak_subdir, cfg.data.train_unlabeled_subdir,
              cfg.data.val_subdir):
        assert _listing(ours, s) == _listing(theirs, s)
