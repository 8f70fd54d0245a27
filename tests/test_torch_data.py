"""The port's data layer against bsed_tpu's on the same seed-made inputs:
label codec, annotation cleanup, transforms, scalers, prefetch, the
feature datasets (pandas-free TSV reading), SyntheticDataSource
(bit-identical), and the loaders (EvalLoader, ThreeStreamLoader in both
layouts, host and resident, gather_batch). The JAX side runs on the CPU;
the port's resident path is exercised with CPU tensors here and on the
card in tests/test_torch_cuda.py."""
import dataclasses
import os

import numpy as np
import pandas as pd
import pytest
import torch

from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import BIRD_LIST as J_BIRD_LIST
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.data import annotations as j_ann
from bsed_tpu.data import codec as j_codec
from bsed_tpu.data import datasets as j_ds
from bsed_tpu.data import pipeline as j_pipe
from bsed_tpu.utils import scaler as j_scaler

from bsed_tpu_torch.config import BIRD_LIST, AudioConfig, get_config
from bsed_tpu_torch.data import annotations as ann
from bsed_tpu_torch.data import codec
from bsed_tpu_torch.data import datasets as ds
from bsed_tpu_torch.data import pipeline as pipe
from bsed_tpu_torch.data.prefetch import prefetch
from bsed_tpu_torch.utils import scaler
from bsed_tpu_torch.utils.tables import EventTable

SMALL = dict(sr=3200, hop_size=160, max_len_seconds=2.0)


def _cfgs(**audio):
    kw = dict(SMALL, **audio)
    return (j_get_config("baseline").replace(audio=JAudioConfig(**kw)),
            get_config("baseline").replace(audio=AudioConfig(**kw)))


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, want):
    got, want = _host(got), _host(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# codec and annotations: tests/test_codec.py's assertions on the copies


def test_bird_list_is_bsed_tpus():
    assert list(BIRD_LIST) == list(J_BIRD_LIST)


def test_encode_weak_comma_split_and_empty_sentinel():
    enc = codec.ManyHotEncoder(BIRD_LIST, n_frames=313)
    y = enc.encode_weak(["EATO,WOTH", "BAWW"])
    assert y.sum() == 3
    assert enc.decode_weak(y) == ["EATO", "WOTH", "BAWW"]
    assert (enc.encode_weak("empty") == -1).all()
    jenc = j_codec.ManyHotEncoder(J_BIRD_LIST, n_frames=313)
    for labels in (["EATO,WOTH", "BAWW"], "empty", "EATO", [None, "OVEN"]):
        _same(enc.encode_weak(labels), jenc.encode_weak(labels))


@pytest.mark.parametrize("events", [
    [("EATO", 1.0, 2.0)],
    [("EATO", 0.0, 10.0), ("WOTH", 3.3, 3.31), ("BAWW", 9.99, 10.0)],
    [],
])
def test_encode_strong_and_table_form(events):
    enc = codec.ManyHotEncoder(BIRD_LIST, n_frames=313)
    jenc = j_codec.ManyHotEncoder(J_BIRD_LIST, n_frames=313)
    _same(enc.encode_strong(events), jenc.encode_strong(events))
    table = EventTable.from_rows(events, ("event_label", "onset", "offset"))
    frame = pd.DataFrame(events, columns=["event_label", "onset", "offset"])
    _same(enc.encode_strong_df(table), jenc.encode_strong_df(frame))
    y = enc.encode_strong(events)
    assert enc.decode_strong(y) == jenc.decode_strong(y)
    assert enc.seconds_to_frame(1.0) == 31 and enc.seconds_to_frame(2.0) == 62


def test_codec_state_roundtrip_and_regions():
    enc = codec.ManyHotEncoder(BIRD_LIST, n_frames=100, sr=16000)
    again = codec.ManyHotEncoder.load_state_dict(enc.state_dict())
    assert again.state_dict() == enc.state_dict()
    assert enc.state_dict() == j_codec.ManyHotEncoder(
        J_BIRD_LIST, n_frames=100, sr=16000).state_dict()
    rng = np.random.default_rng(0)
    for a in ([1, 1, 0, 1], [0, 0], [1], [],
              (rng.random(57) > 0.5).astype(int)):
        _same(codec.find_contiguous_regions(np.array(a)),
              j_codec.find_contiguous_regions(np.array(a)))


ANN_CASES = {
    "merge": ("merge_close_events",
              ([("EATO", 0.0, 1.0), ("EATO", 1.1, 2.0), ("EATO", 2.05, 3.0),
                ("WOTH", 1.05, 1.5), ("EATO", 5.0, 6.0)],), {"gap": 0.15}),
    "drop_short": ("drop_short_events",
                   ([("EATO", 0.0, 0.2), ("EATO", 0.0, 0.201)],),
                   {"min_dur": 0.2}),
    "split": ("split_at_boundary",
              ([("EATO", 9.0, 11.0), ("WOTH", 2.0, 3.0)], 10.0), {}),
    "union": ("union_same_label_overlaps",
              ([("EATO", 0.0, 2.0), ("EATO", 1.5, 4.0), ("EATO", 4.0, 5.0),
                ("EATO", 7.0, 8.0), ("WOTH", 1.0, 3.0)],), {}),
    "segment": ("segment_annotations",
                ([("EATO", 9.5, 10.5), ("WOTH", 15.0, 16.0),
                  ("A", 3.0, 10.0), ("A", 3.0, 12.0)], 2), {}),
    "split_seed": ("seeded_split", ([f"clip_{i}" for i in range(64)],),
                   {"seed": 1215}),
}


@pytest.mark.parametrize("case", sorted(ANN_CASES))
def test_annotation_transforms_match(case):
    name, args, kw = ANN_CASES[case]
    assert getattr(ann, name)(*args, **kw) == getattr(j_ann, name)(*args,
                                                                   **kw)


def test_annotation_pinned_values():
    merged = ann.merge_close_events(ANN_CASES["merge"][1][0], gap=0.15)
    assert ("EATO", 0.0, 3.0) in merged and len(merged) == 3
    assert ann.drop_short_events([("EATO", 0.0, 0.2), ("EATO", 0.0, 0.201)],
                                 0.2) == [("EATO", 0.0, 0.201)]
    segs = ann.segment_annotations([("A", 3.0, 10.0)], n_segments=2)
    assert segs[0] == [] and segs[1] == []
    w, u, v = ann.seeded_split([f"clip_{i}" for i in range(64)], seed=1215)
    assert len(v) == 32 and len(w) == 8 and len(u) == 24


def test_clean_annotations_and_events_to_frame():
    rows = {"event_label": ["EATO", "EATO", "WOTH"],
            "onset": [0.0, 1.05, 0.0], "offset": [1.0, 2.0, 0.1]}
    table = EventTable(rows["event_label"], rows["onset"], rows["offset"])
    got = ann.clean_annotations(table)
    assert got == j_ann.clean_annotations(pd.DataFrame(rows))
    assert ("EATO", 0.0, 2.0) in got and all(l != "WOTH" for l, *_ in got)
    events = [("EATO", 0.0, 1.0), ("WOTH", 2.5, 3.0)]
    for fname in ("", "clip"):
        t = ann.events_to_frame(events, fname)
        want = j_ann.events_to_frame(events, fname)
        assert t.columns == list(want.columns)
        for c in want.columns:
            assert list(t[c]) == list(want[c])


def test_load_raven_annotations(tmp_path):
    path = tmp_path / "sel.txt"
    path.write_text(
        "Selection\tView\tBegin Time (s)\tEnd Time (s)\tSpecies\n"
        "1\tSpectrogram 1\t0.5\t1.25\tEATO\n"
        "2\tSpectrogram 1\t2\t3\tXXXX\n"
        "3\tSpectrogram 1\t4.125\t5.5\tWOTH\n")
    got = ann.load_raven_annotations(str(path), BIRD_LIST)
    want = j_ann.load_raven_annotations(str(path), J_BIRD_LIST)
    assert got.filename is None and len(got) == len(want) == 2
    for c in ("onset", "offset", "event_label"):
        assert list(got[c]) == list(want[c])


# ---------------------------------------------------------------------------
# transforms, scalers, prefetch: tests/test_transforms_misc.py's assertions


def test_transform_pipeline_matches():
    from bsed_tpu.data import transforms as j_tf
    from bsed_tpu_torch.data import transforms as tf

    rng = np.random.default_rng(0)
    data = np.abs(rng.standard_normal((37, 16))).astype(np.float32)
    label = np.zeros((9, 4), np.float32)
    (clean, noisy), out_label = tf.get_transforms(
        40, noise_snr=30.0, rng=np.random.default_rng(1))((data, label))
    (jc, jn), _ = j_tf.get_transforms(
        40, noise_snr=30.0, rng=np.random.default_rng(1))((data, label))
    assert clean.shape == (40, 16) and not np.allclose(clean, noisy)
    assert clean.min() >= clean.max() - 80 - 1e-4
    _same(clean, jc)
    _same(noisy, jn)
    _same(out_label, label)
    x, _ = tf.MinMaxNormalization()((data, label))
    assert x.min() == pytest.approx(0) and x.max() == pytest.approx(1)
    mix = rng.standard_normal((3, 5, 4))
    for how in ("max", "mean"):
        _same(tf.CombineChannels(how)((mix, None))[0],
              j_tf.CombineChannels(how)((mix, None))[0])


def test_scalers_match(tmp_path):
    rng = np.random.default_rng(0)
    items = [(rng.standard_normal((20, 4)).astype(np.float32) * 3 + 1,)
             for _ in range(5)]
    s, js = scaler.Scaler(), j_scaler.Scaler()
    s.calculate_scaler(items)
    js.calculate_scaler(items)
    _same(s.mean_, js.mean_)
    _same(s.std_, js.std_)
    _same(s.normalize(items[0][0]), js.normalize(items[0][0]))
    assert abs(np.concatenate([s.normalize(i[0]) for i in items]).mean()) \
        < 0.2
    for mode in ("standard", "max", "min-max"):
        _same(scaler.ScalerPerAudio(mode).normalize(items[0][0]),
              j_scaler.ScalerPerAudio(mode).normalize(items[0][0]))
    path = str(tmp_path / "scaler.json")
    s.save(path)
    again = j_scaler.Scaler().load(path)         # the JSON is bsed_tpu's
    np.testing.assert_allclose(again.mean_, s.mean_)
    np.testing.assert_allclose(again.std_, s.std_)


def test_fit_log_mel_stats_matches():
    """Per-bin log-mel statistics over a union of datasets (one with
    as_arrays, one item by item); the logs come from two libraries'
    log10, so the gate is 1e-5 relative."""
    _, cfg = _cfgs()
    jcfg, _ = _cfgs()
    a = ds.SyntheticDataSource(cfg, n_items=5, seed=1)
    ja = j_ds.SyntheticDataSource(jcfg, n_items=5, seed=1)

    class Items:
        def __init__(self, inner):
            self.inner = inner

        def __len__(self):
            return len(self.inner)

        def __getitem__(self, i):
            return self.inner[i]

    got = scaler.fit_log_mel_stats([a, None, Items(a)], chunk=2)
    want = j_scaler.fit_log_mel_stats([ja, None, Items(ja)], chunk=2)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5)


def test_prefetch_order_exceptions_and_bound():
    import time

    assert list(prefetch(iter(range(100)), depth=3)) == list(range(100))
    assert list(prefetch(iter([]), depth=2)) == []

    def boom():
        yield 1
        raise ValueError("producer failed")
    it = prefetch(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        list(it)

    produced = []

    def tracked():
        for i in range(50):
            produced.append(i)
            yield i
    it = prefetch(tracked(), depth=2)
    next(it)
    time.sleep(0.2)
    assert len(produced) <= 1 + 2 + 1


# ---------------------------------------------------------------------------
# datasets


@pytest.mark.parametrize("weak_only", [False, True])
def test_synthetic_source_bit_identical(weak_only):
    jcfg, cfg = _cfgs()
    src = ds.SyntheticDataSource(cfg, n_items=6, seed=3, weak_only=weak_only,
                                 event_rate=0.2, signal_boost=3.0)
    jsrc = j_ds.SyntheticDataSource(jcfg, n_items=6, seed=3,
                                    weak_only=weak_only, event_rate=0.2,
                                    signal_boost=3.0)
    for i in range(len(src)):
        assert src.events(i) == jsrc.events(i)
        (f, t, n), (jf, jt, jn) = src[i], jsrc[i]
        _same(f, jf)
        _same(t, jt)
        assert n == jn
    for a, b in zip(src.as_arrays(), jsrc.as_arrays()):
        _same(a, b)


def test_pad_or_trunc_matches():
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    for n in (3, 5, 8):
        _same(ds.pad_or_trunc(x, n), j_ds.pad_or_trunc(x, n))


def _feature_dir(root, cfg, rng):
    """A tiny preprocessed dump: wav/*.npy linear mel of ragged lengths and
    annotation/*.txt event tables, as bsed_tpu's preprocessing writes
    them."""
    os.makedirs(root / "wav")
    os.makedirs(root / "annotation")
    t, f = cfg.audio.max_frames, cfg.audio.n_mels
    rows = {"a": [("EATO", 0.25, 1.0), ("WOTH", 1.5, 1.9)],
            "b": [],
            "c": [("BAWW", 0.0, 2.0), ("XXXX", 0.3, 0.4)]}
    for k, (name, events) in enumerate(rows.items()):
        np.save(root / "wav" / f"{name}.npy",
                np.abs(rng.standard_normal((t - 3 + 4 * k, f))))
        pd.DataFrame([e for e in events if e[0] != "XXXX"],
                     columns=["event_label", "onset", "offset"]).to_csv(
            root / "annotation" / f"{name}.txt", sep="\t", index=False)
    with open(root / "annotation" / "c.txt", "a") as fh:
        fh.write("XXXX\t0.3\t0.4\n")      # a label outside the bird list
    return rows


def test_npy_feature_dataset_matches(tmp_path):
    jcfg, cfg = _cfgs()
    _feature_dir(tmp_path, cfg, np.random.default_rng(0))
    enc = codec.ManyHotEncoder(list(BIRD_LIST) + ["XXXX"],
                               n_frames=cfg.n_frames, sr=cfg.audio.sr,
                               hop_size=cfg.audio.hop_size)
    jenc = j_codec.ManyHotEncoder(list(J_BIRD_LIST) + ["XXXX"],
                                  n_frames=jcfg.n_frames, sr=jcfg.audio.sr,
                                  hop_size=jcfg.audio.hop_size)
    d = ds.NpyFeatureDataset(str(tmp_path), enc, cfg)
    jd = j_ds.NpyFeatureDataset(str(tmp_path), jenc, jcfg)
    assert len(d) == len(jd) == 3
    for i in range(3):
        assert d.events(i) == jd.events(i)
        for a, b in zip(d[i][:2], jd[i][:2]):
            _same(a, b)
    for a, b in zip(d.as_arrays(), jd.as_arrays()):
        _same(a, b)


def test_pseudo_labeled_dataset_matches(tmp_path):
    jcfg, cfg = _cfgs()
    _feature_dir(tmp_path, cfg, np.random.default_rng(1))
    tsv = tmp_path / "pl.tsv"
    pd.DataFrame({"filename": [str(tmp_path / "wav" / "a.npy"), "c.npy"],
                  "event_labels": ["EATO,WOTH", ""]}).to_csv(
        tsv, sep="\t", index=False)
    enc = codec.ManyHotEncoder(BIRD_LIST)
    jenc = j_codec.ManyHotEncoder(J_BIRD_LIST)
    for path in (str(tsv), str(tmp_path / "missing.tsv")):
        d = ds.PseudoLabeledDataset(str(tmp_path), path, enc, cfg)
        jd = j_ds.PseudoLabeledDataset(str(tmp_path), path, jenc, jcfg)
        for i in range(3):
            for a, b in zip(d[i][:2], jd[i][:2]):
                _same(a, b)
        for a, b in zip(d.as_arrays(), jd.as_arrays()):
            _same(a, b)
    assert d[0][1].sum() == 0 and ds.PseudoLabeledDataset(
        str(tmp_path), str(tsv), enc, cfg)[0][1].sum() == 2


def test_concat_dataset_matches():
    jcfg, cfg = _cfgs()
    parts = [ds.SyntheticDataSource(cfg, n_items=n, seed=s)
             for n, s in ((3, 1), (4, 2))]
    jparts = [j_ds.SyntheticDataSource(jcfg, n_items=n, seed=s)
              for n, s in ((3, 1), (4, 2))]
    c, jc = ds.ConcatDataset(parts), j_ds.ConcatDataset(jparts)
    assert len(c) == len(jc) == 7
    for i in range(7):
        _same(c[i][0], jc[i][0])
    for a, b in zip(c.cluster_indices, jc.cluster_indices):
        _same(a, b)


# ---------------------------------------------------------------------------
# loaders


class NoArrays:
    """A dataset without ``as_arrays`` (the loaders' item-by-item path)."""

    def __init__(self, inner):
        self._i = inner

    def __len__(self):
        return len(self._i)

    def __getitem__(self, i):
        return self._i[i]

    def filename(self, i):
        return self._i.filename(i)

    def events(self, i):
        return self._i.events(i)


def _sources(cfg, module, weak_only_unlab, items=(10, 6, 6)):
    syn = module.SyntheticDataSource(cfg, n_items=items[0], seed=1)
    weak = module.SyntheticDataSource(cfg, n_items=items[1], seed=2)
    unlab = module.SyntheticDataSource(cfg, n_items=items[2], seed=3,
                                       weak_only=weak_only_unlab)
    return syn, weak, unlab


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])


LOADER_CASES = {
    "syn_only": dict(streams="syn"),
    "three": dict(streams="all"),
    "three_weak_unlab": dict(streams="all", weak_only_unlab=True),
    "origin": dict(streams="all", layout="origin"),
    "origin_weak_unlab": dict(streams="all", layout="origin",
                              weak_only_unlab=True),
    "itemized_syn": dict(streams="all", wrap=("syn",)),
    "itemized_all": dict(streams="all", wrap=("syn", "weak", "unlab")),
    "sharded": dict(streams="all", process=(1, 2)),
}


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_three_stream_loader_matches(case, resident):
    """Every batch of two epochs equals bsed_tpu's (host path, CPU): keys,
    values, shapes and dtypes; resident batches are tensors on the
    device."""
    spec = LOADER_CASES[case]
    jcfg, cfg = _cfgs()
    wuo = spec.get("weak_only_unlab", False)
    srcs = list(_sources(cfg, ds, wuo))
    jsrcs = list(_sources(jcfg, j_ds, wuo))
    for k, name in enumerate(("syn", "weak", "unlab")):
        if name in spec.get("wrap", ()):
            srcs[k], jsrcs[k] = NoArrays(srcs[k]), NoArrays(jsrcs[k])
    if spec["streams"] == "syn":
        srcs, jsrcs = srcs[:1], jsrcs[:1]
    pi, pc = spec.get("process", (0, 1))
    kw = dict(batch_size=4, seed=5, layout=spec.get("layout", "default"),
              process_index=pi, process_count=pc)
    loader = pipe.ThreeStreamLoader(*srcs, device_resident=resident,
                                    device="cpu", **kw)
    jloader = j_pipe.ThreeStreamLoader(*jsrcs, device_resident=False, **kw)
    assert len(loader) == len(jloader)
    for epoch in (0, 3):
        got = list(loader.epoch(epoch))
        _same_batches(got, list(jloader.epoch(epoch)))
        if resident and "wrap" not in spec:
            assert all(isinstance(v, torch.Tensor)
                       for b in got for v in b.values())


@pytest.mark.parametrize("weak_only_unlab", [False, True])
def test_gather_batch_replays_epoch(weak_only_unlab):
    """epoch_arrays + gather_batch give the resident epoch's batches (None
    on the host path and for the origin layout, as in bsed_tpu)."""
    _, cfg = _cfgs()
    srcs = _sources(cfg, ds, weak_only_unlab)
    loader = pipe.ThreeStreamLoader(*srcs, batch_size=4, seed=5,
                                    device_resident=True, device="cpu")
    arrays, idx = loader.epoch_arrays(2)
    got = [pipe.gather_batch(arrays, {k: v[b] for k, v in idx.items()})
           for b in range(len(loader))]
    _same_batches(got, list(loader.epoch(2)))
    host = pipe.ThreeStreamLoader(*srcs, batch_size=4, device_resident=False,
                                  device="cpu")
    assert host.epoch_arrays(0) is None
    origin = pipe.ThreeStreamLoader(*srcs, batch_size=4, layout="origin",
                                    device_resident=True, device="cpu")
    assert origin.epoch_arrays(0) is None


def test_loader_refuses_bad_layouts():
    _, cfg = _cfgs()
    srcs = _sources(cfg, ds, False)
    with pytest.raises(ValueError):
        pipe.ThreeStreamLoader(*srcs, layout="nope", device="cpu")
    with pytest.raises(ValueError):
        pipe.ThreeStreamLoader(*srcs, batch_size=6, layout="origin",
                               device="cpu")


@pytest.mark.parametrize("wrap", [False, True], ids=["arrays", "items"])
@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("n_items", [8, 10])
def test_eval_loader_matches(n_items, resident, wrap):
    """Ids, features, targets and n_valid of every batch (a padded tail
    batch with 10 items) and the ground-truth events equal bsed_tpu's."""
    jcfg, cfg = _cfgs()
    src = ds.SyntheticDataSource(cfg, n_items=n_items, seed=8)
    jsrc = j_ds.SyntheticDataSource(jcfg, n_items=n_items, seed=8)
    if wrap:
        src, jsrc = NoArrays(src), NoArrays(jsrc)
    loader = pipe.EvalLoader(src, batch_size=4, device_resident=resident,
                             device="cpu")
    jloader = j_pipe.EvalLoader(jsrc, batch_size=4, device_resident=False)
    got, want = list(loader), list(jloader)
    assert len(got) == len(want) == len(loader) == len(jloader)
    for (m, t, names, nv), (jm, jt, jnames, jnv) in zip(got, want):
        assert names == jnames and nv == jnv
        _same(m, jm)
        _same(t, jt)
        assert isinstance(m, torch.Tensor) == (resident and not wrap)
    assert loader.groundtruth_events() == jloader.groundtruth_events()


def test_device_defaults_to_the_card():
    _, cfg = _cfgs()
    src = ds.SyntheticDataSource(cfg, n_items=4, seed=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipe.EvalLoader(src)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipe.ThreeStreamLoader(src)
    # auto residency: only on a CUDA device
    assert not pipe._resident(src.as_arrays(), torch.device("cpu"), None)
    assert pipe._resident(src.as_arrays(), torch.device("cuda"), None)
    big = [np.lib.stride_tricks.as_strided(np.zeros(1, np.float32),
                                           (2 ** 30,), (0,))]   # 4 GiB
    assert not pipe._resident(big, torch.device("cuda"), None)
    assert pipe._resident(big, torch.device("cuda"), True)


def test_dataclass_config_is_bsed_tpus():
    jcfg, cfg = _cfgs(n_mels=64)
    assert dataclasses.asdict(cfg.audio) == dataclasses.asdict(jcfg.audio)
    assert cfg.n_frames == jcfg.n_frames


@pytest.mark.parametrize("layout", ["default", "origin"])
def test_resident_batch_moves_its_indices_once(monkeypatch, layout):
    """A resident default-layout batch moves all its index vectors to the
    device in one copy (on CUDA a non-blocking one from pinned memory, so
    the host keeps its lead over the card); the origin layout's four
    stream draws move one each."""
    _, cfg = _cfgs()
    calls = []
    real = pipe._device_ids

    def counting(device, *ids):
        calls.append(len(ids))
        return real(device, *ids)

    monkeypatch.setattr(pipe, "_device_ids", counting)
    loader = pipe.ThreeStreamLoader(*_sources(cfg, ds, False), batch_size=4,
                                    layout=layout, device_resident=True,
                                    device="cpu")
    n = len(list(loader.epoch(0)))
    if layout == "default":
        assert calls == [3] * n
    else:
        assert calls == [1] * (4 * n)
    arrays, idx = loader.epoch_arrays(0) if layout == "default" else \
        (None, None)
    if arrays is not None:
        calls.clear()
        pipe.gather_batch(arrays, {k: v[0] for k, v in idx.items()})
        assert calls == [3]
