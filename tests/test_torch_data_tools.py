"""The port's data tools against ``bsed_tpu``'s on the CPU: ``synthesize``
(data/synthesizer.py), ``analyze`` (data/analysis.py) and ``visualize``
(eval/visualize.py), as libraries and through both CLIs.

synthesize: the two-class co-occurrence JSON of
``tests/test_aux_components.py``, synthetic chirps (no foreground
directory) and 2 s soundscapes, then a case with foreground and
background WAV directories: every WAV, per-clip txt and ``output.tsv``
byte-equal (one ``np.random.default_rng(seed)`` consumed in the same
order), ``syn_preprocess`` dumps within the front end's 1e-3 dB gate
(the JAX side under ``jax.default_matmul_precision("float32")``),
``polyphony`` and ``mix_pairs`` equal. analyze: the CSVs with
``bsed_tpu``'s header and labels, counts equal and floats within 1e-12;
``export_event_audio`` and ``mix_audio_files`` byte-equal. visualize:
t-SNE, PCA/ICA and the SVM probe equal to ``bsed_tpu``'s on the same
arrays, and the CLI's ``.npy`` outputs equal.
"""
import csv
import json
import os
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
from scipy.io import wavfile

import bsed_tpu.cli as j_cli
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.data import analysis as j_an
from bsed_tpu.data import synthesizer as j_syn
from bsed_tpu.eval import visualize as j_viz

from bsed_tpu_torch import cli
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.data import analysis as an
from bsed_tpu_torch.data import synthesizer as syn
from bsed_tpu_torch.eval import visualize as viz

from tests.test_torch_preprocess import (_assert_same_dumps, _ena_root,
                                         _write_wav)

SMALL = dict(sr=3200, hop_size=160, max_len_seconds=2.0)
CO = {
    "EATO": {"proba": 0.6, "co-occurences": {
        "max_events": 3, "mean_events": 2,
        "classes": ["WOTH"], "probas": [1.0]}},
    "WOTH": {"proba": 0.4, "co-occurences": {
        "max_events": 2, "mean_events": 1,
        "classes": ["EATO"], "probas": [1.0]}},
}


def _files(d):
    return {f: Path(d, f).read_bytes() for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f))}


@pytest.fixture(scope="module")
def co_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("co") / "co.json")
    with open(path, "w") as fh:
        json.dump(CO, fh)
    return path


def _small():
    return (get_config("baseline").replace(audio=AudioConfig(**SMALL)),
            j_get_config("baseline").replace(audio=JAudioConfig(**SMALL)))


@pytest.mark.parametrize("pools", ["synthetic", "wav_dirs"])
def test_generate_dataset_is_byte_equal(tmp_path, co_path, pools):
    cfg, jcfg = _small()
    fg = bg = None
    if pools == "wav_dirs":
        fg, bg = str(tmp_path / "fg"), str(tmp_path / "bg")
        for k, c in enumerate(("EATO", "WOTH")):
            os.makedirs(os.path.join(fg, c))
            for i in range(2):
                _write_wav(os.path.join(fg, c, f"{c}_{i}.wav"), 4410,
                           0.4 + 0.3 * i, "int16", 1, 10 * k + i)
        os.makedirs(bg)
        _write_wav(os.path.join(bg, "bed_long.wav"), 3200, 3.0, "int16", 2, 5)
        _write_wav(os.path.join(bg, "bed_short.wav"), 3200, 0.7, "int16", 1, 6)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    sc = syn.SoundscapeConfig(sr=cfg.audio.sr, duration=2.0)
    jsc = j_syn.SoundscapeConfig(sr=cfg.audio.sr, duration=2.0)
    table = syn.generate_dataset(ours, co_path, 6, cfg, fg_dir=fg,
                                 bg_dir=bg, seed=3, sc=sc)
    df = j_syn.generate_dataset(theirs, co_path, 6, jcfg, fg_dir=fg,
                                bg_dir=bg, seed=3, sc=jsc)
    got, want = _files(ours), _files(theirs)
    assert sorted(got) == sorted(want)
    assert len([f for f in got if f.endswith(".wav")]) == 6
    for name in want:
        assert got[name] == want[name], name
    assert table.rows() == [(r.event_label, r.onset, r.offset, r.filename)
                            for r in df.itertuples()]


def test_syn_preprocess_dumps(tmp_path, co_path):
    cfg, jcfg = _small()
    gen = str(tmp_path / "gen")
    syn.generate_dataset(gen, co_path, 5, cfg, seed=0,
                         sc=syn.SoundscapeConfig(sr=cfg.audio.sr,
                                                 duration=2.0))
    names = syn.syn_preprocess(gen, str(tmp_path / "ours"), cfg,
                               device="cpu")
    with jax.default_matmul_precision("float32"):
        j_names = j_syn.syn_preprocess(gen, str(tmp_path / "theirs"), jcfg)
    assert names == j_names and len(names) == 5
    _assert_same_dumps(str(tmp_path / "ours"), str(tmp_path / "theirs"),
                       names)
    assert np.load(str(tmp_path / "ours" / "wav" / (names[0] + ".npy"))
                   ).shape == (cfg.audio.max_frames, cfg.audio.n_mels)


def test_synthesize_cli_matches(tmp_path, co_path):
    """Both CLIs' ``synthesize --features-out`` at the preset's 10 s,
    32 kHz soundscapes; the port's on ``--device cpu``."""
    args = ["synthesize", "--co-occur", co_path, "--n-soundscapes", "3",
            "--seed", "11"]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    table = cli.main([*args, "--out", str(ours / "gen"), "--features-out",
                      str(ours / "feat"), "--device", "cpu"])
    with jax.default_matmul_precision("float32"):
        j_cli.main([*args, "--out", str(theirs / "gen"), "--features-out",
                    str(theirs / "feat")])
    assert _files(str(ours / "gen")) == _files(str(theirs / "gen"))
    names = [f"soundscape_{i:05d}" for i in range(3)]
    _assert_same_dumps(str(ours / "feat"), str(theirs / "feat"), names)
    assert np.load(str(ours / "feat" / "wav" / "soundscape_00000.npy")
                   ).shape == (1255, 128)
    assert len(table) == _files(str(ours / "gen"))["output.tsv"].count(
        b"\n") - 1


def test_polyphony_mix_pairs_and_nips4b_pool(tmp_path):
    rng = np.random.default_rng(4)
    for n in (0, 1, 3, 8):
        ev = [("EATO", float(a), float(a + d)) for a, d in
              zip(rng.uniform(0, 5, n), rng.uniform(0.1, 3, n))]
        assert syn.polyphony(ev) == j_syn.polyphony(ev)
    a = rng.standard_normal(100).astype(np.float32)
    b = rng.standard_normal(80).astype(np.float32)
    for w in (0.5, 0.3):
        np.testing.assert_array_equal(syn.mix_pairs(a, b, w),
                                      j_syn.mix_pairs(a, b, w))
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    for name in ("a.wav", "b.wav", "c.wav"):
        (audio_dir / name).write_bytes(b"RIFF")
    ann = tmp_path / "nips4b.csv"
    ann.write_text("NIPS4B labels\nfile list\nFilename,Empty,Bird\n"
                   "a.wav,1,0\nb.wav,0,1\nc.wav,1.0,0\nmissing.wav,1,0\n")
    got = syn.build_background_pool_from_nips4b(str(ann), str(audio_dir),
                                                str(tmp_path / "ours"))
    want = j_syn.build_background_pool_from_nips4b(
        str(ann), str(audio_dir), str(tmp_path / "theirs"))
    assert got == want == ["a.wav", "c.wav"]
    assert sorted(os.listdir(tmp_path / "ours")) == ["a.wav", "c.wav"]


def _annotation_dir(d):
    os.makedirs(d, exist_ok=True)
    clips = {
        "clip_0": [(0.0, 0.5, "EATO"), (1.0, 2.0, "WOTH"),
                   (1.2, 1.9, "EATO"), (3.0, 3.3, "NOPE")],
        "clip_1": [(0.0, 1.0, "EATO")],
        "clip_2": [],
        "clip_3": [(0.1, 0.2 + 1e-9, "BCCH"), (2.5, 9.75, "WOTH"),
                   (0.3, 0.7, "AMCR")],
    }
    for name, rows in clips.items():
        pd.DataFrame(rows, columns=["onset", "offset", "event_label"]
                     ).to_csv(os.path.join(d, name + ".txt"), sep="\t",
                              index=False)
    return d


def _read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def test_analyze_matches(tmp_path):
    cfg = get_config("baseline")
    ann = _annotation_dir(str(tmp_path / "annotation"))
    events = an.collect_annotations(ann, cfg.bird_list)
    j_events = j_an.collect_annotations(ann, cfg.bird_list)
    assert sorted(zip(events.filename, events.event_label, events.onset,
                      events.offset)) == \
        sorted(zip(j_events.filename, j_events.event_label, j_events.onset,
                   j_events.offset))
    assert len(events) == len(j_events) == 8
    mat = an.cooccurrence_matrix(events, cfg.bird_list,
                                 str(tmp_path / "ours.csv"))
    j_mat = j_an.cooccurrence_matrix(j_events, cfg.bird_list,
                                     str(tmp_path / "theirs.csv"))
    np.testing.assert_array_equal(mat, j_mat.to_numpy())
    assert (tmp_path / "ours.csv").read_bytes() == \
        (tmp_path / "theirs.csv").read_bytes()
    rows = an.duration_stats(events, cfg.bird_list,
                             str(tmp_path / "ours_d.csv"))
    j_df = j_an.duration_stats(j_events, cfg.bird_list,
                               str(tmp_path / "theirs_d.csv"))
    assert [r["event_label"] for r in rows] == list(j_df.event_label)
    _assert_stats_csv(str(tmp_path / "ours_d.csv"),
                      str(tmp_path / "theirs_d.csv"))
    empty = an.collect_annotations(str(tmp_path / "nothing"), cfg.bird_list)
    assert len(empty) == 0
    assert an.cooccurrence_matrix(empty, cfg.bird_list).sum() == 0


def _assert_stats_csv(ours, theirs):
    got, want = _read_csv(ours), _read_csv(theirs)
    assert got[0] == want[0] == ["event_label", "count", "total_s",
                                 "mean_s", "min_s", "max_s"]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose(np.array([r[2:] for r in got[1:]], float),
                               np.array([r[2:] for r in want[1:]], float),
                               rtol=0, atol=1e-12)


def test_analyze_cli_matches(tmp_path):
    ann = _annotation_dir(str(tmp_path / "annotation"))
    cli.main(["analyze", "--annotation-dir", ann, "--out-dir",
              str(tmp_path / "ours")])
    j_cli.main(["analyze", "--annotation-dir", ann, "--out-dir",
                str(tmp_path / "theirs")])
    assert (tmp_path / "ours" / "occurence_analysis.csv").read_bytes() == \
        (tmp_path / "theirs" / "occurence_analysis.csv").read_bytes()
    _assert_stats_csv(str(tmp_path / "ours" / "dataset_time_analysis.csv"),
                      str(tmp_path / "theirs" / "dataset_time_analysis.csv"))


def test_export_event_audio_and_mix(tmp_path):
    cfg, jcfg = _small()
    root = _ena_root(str(tmp_path / "ena"), 4410, 2.0)
    n = an.export_event_audio(root, str(tmp_path / "ours"), cfg, pad_s=0.1)
    j_n = j_an.export_event_audio(root, str(tmp_path / "theirs"), jcfg,
                                  pad_s=0.1)
    assert n == j_n > 0
    for label in sorted(os.listdir(tmp_path / "theirs")):
        assert _files(str(tmp_path / "ours" / label)) == \
            _files(str(tmp_path / "theirs" / label)), label
    sr = 32000
    a = (np.sin(np.linspace(0, 100, sr)) * 0.5).astype(np.float32)
    b = np.ones(sr // 2, dtype=np.float32) * 0.25
    pa, pb = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    wavfile.write(pa, sr, a)
    wavfile.write(pb, sr, b)
    out = an.mix_audio_files([pa, pb], str(tmp_path / "mix.wav"), sr=sr)
    j_out = j_an.mix_audio_files([pa, pb], str(tmp_path / "j_mix.wav"),
                                 sr=sr)
    assert Path(out).read_bytes() == Path(j_out).read_bytes()
    got_sr, mix = wavfile.read(out)
    assert got_sr == sr and len(mix) == sr
    np.testing.assert_allclose(mix[:sr // 2], 0.5 * (a[:sr // 2] + b),
                               atol=1e-5)


def _embeddings(seed, n, shift):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4, 6)) + shift).astype(np.float32)


@pytest.fixture
def one_thread():
    """scikit-learn's OpenMP and BLAS on one thread, so two runs of the
    same estimator sum in the same order."""
    from threadpoolctl import threadpool_limits
    with threadpool_limits(limits=1):
        yield


def test_visualize_probes_match(tmp_path, one_thread):
    syn_emb, real_emb = _embeddings(0, 7, 0.0), _embeddings(1, 6, 1.5)
    pts, y, sil = viz.tsne_domain_audit(syn_emb, real_emb, perplexity=3,
                                        plot_path=str(tmp_path / "a.png"))
    j_pts, j_y, j_sil = j_viz.tsne_domain_audit(syn_emb, real_emb,
                                                perplexity=3)
    np.testing.assert_array_equal(pts, j_pts)
    np.testing.assert_array_equal(y, j_y)
    assert sil == j_sil
    assert (tmp_path / "a.png").stat().st_size > 0
    for method in ("pca", "ica"):
        np.testing.assert_array_equal(
            viz.project_embeddings(syn_emb, method),
            j_viz.project_embeddings(syn_emb, method))
    with pytest.raises(ValueError):
        viz.project_embeddings(syn_emb, "umap")
    assert viz.svm_domain_accuracy(syn_emb, real_emb, folds=3) == \
        j_viz.svm_domain_accuracy(syn_emb, real_emb, folds=3)


def _feature_dir(d, emb, per_batch=4):
    os.makedirs(d)
    for i in range(0, len(emb), per_batch):
        np.save(os.path.join(d, f"{i // per_batch}.npy"),
                emb[i:i + per_batch])
    return d


def test_visualize_cli_matches(tmp_path, monkeypatch, one_thread):
    syn_dir = _feature_dir(str(tmp_path / "syn"), _embeddings(2, 9, 0.0))
    real_dir = _feature_dir(str(tmp_path / "real"), _embeddings(3, 8, 2.0))
    args = ["visualize", "--syn-features", syn_dir, "--real-features",
            real_dir]
    res = cli.main([*args, "--out-dir", str(tmp_path / "ours")])
    j_cli.main([*args, "--out-dir", str(tmp_path / "theirs")])
    for name in ("tsne_points.npy", "tsne_domains.npy"):
        np.testing.assert_array_equal(
            np.load(tmp_path / "ours" / name),
            np.load(tmp_path / "theirs" / name))
    assert set(res) == {"silhouette", "svm_domain_accuracy", "out_dir"}
    # where scikit-learn is missing the CLI exits naming it
    import importlib.util
    real_find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda n, *a: None if n == "sklearn"
                        else real_find(n, *a))
    with pytest.raises(SystemExit) as exc:
        cli.main([*args, "--out-dir", str(tmp_path / "none")])
    assert "scikit-learn" in exc.value.code and "sklearn" in exc.value.code
