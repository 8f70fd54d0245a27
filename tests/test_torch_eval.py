"""The port's eval path against bsed_tpu's on the same seed-made inputs:
the median filter (exact, against JAX and scipy), event decoding, the
scorers (event and segment F1, PSDS counts and values, tagging F1) on the
fixtures of tests/test_decode_metrics.py and
tests/test_psds_second_source.py (scores to 1e-9), checkpoint export and
load in both directions, ``make_predict_fn`` (f32, plain versions) at
1e-4, and ``evaluate_checkpoint`` end to end on one exported checkpoint.

The port's event tables are converted to pandas DataFrames here, in the
test: the port itself imports no pandas."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.ndimage
import torch

from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.data.datasets import SyntheticDataSource as JSynthetic
from bsed_tpu.data.pipeline import EvalLoader as JEvalLoader
from bsed_tpu.eval import decode as j_decode
from bsed_tpu.eval import operating_points as j_ops
from bsed_tpu.eval import psds as j_psds
from bsed_tpu.eval import sed_scores as j_sed
from bsed_tpu.eval import tagging as j_tag
from bsed_tpu.eval import test_model as j_tm
from bsed_tpu.ops import median as j_median
from bsed_tpu.train import steps as j_steps

from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.data.datasets import SyntheticDataSource
from bsed_tpu_torch.data.pipeline import EvalLoader
from bsed_tpu_torch.eval import decode, operating_points, psds, sed_scores
from bsed_tpu_torch.eval import tagging
from bsed_tpu_torch.eval import test_model as tm
from bsed_tpu_torch.ops import median
from bsed_tpu_torch.train import steps
from bsed_tpu_torch.utils.tables import EventTable
from bsed_tpu_torch.utils.weights import init_params

from tests.test_psds_second_source import (_detections_for_op,
                                           _random_scene)


def to_frame(t: EventTable) -> pd.DataFrame:
    return pd.DataFrame({c: t[c] for c in t.columns}, columns=t.columns)


def from_frame(df: pd.DataFrame) -> EventTable:
    return EventTable(df["event_label"].to_numpy(), df["onset"].to_numpy(),
                      df["offset"].to_numpy(),
                      df["filename"].to_numpy() if "filename" in df
                      else None)


def assert_same_table(got: EventTable, want: pd.DataFrame):
    """Same columns, rows in the same order, same dtypes."""
    pd.testing.assert_frame_equal(to_frame(got), want.reset_index(drop=True),
                                  check_exact=True)


# ---------------------------------------------------------------------------
# median filter


@pytest.mark.parametrize("window", [2, 3, 7, 14, 15, 84])
def test_binary_median_matches_scipy_and_jax(window):
    rng = np.random.default_rng(window)
    x = (rng.random((2, 100, 4)) > 0.6).astype(np.float32)
    ref = np.stack([
        scipy.ndimage.median_filter(x[b], (window, 1)) for b in range(2)])
    out = median.binary_median_filter(torch.from_numpy(x), window, axis=-2)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        j_median.binary_median_filter(jnp.asarray(x), window, axis=-2)))


# windows: odd, even, classwise, and longer than T (T = 9 here)
@pytest.mark.parametrize("window,windows", [
    (1, None), (5, None), (6, None), (20, None), (31, None),
    (1, (1, 3, 4, 9, 12, 30)), (1, (2, 2, 7, 7, 1, 18))])
def test_threshold_and_filter_exact(window, windows):
    rng = np.random.default_rng(window + (0 if windows is None else 100))
    probs = rng.random((3, 9, 6)).astype(np.float32)
    probs[0, :, 0] = 0.5                     # exactly at a threshold
    thr = np.asarray([0.25, 0.5, 0.7], np.float32)
    got = median.threshold_and_filter(torch.from_numpy(probs), thr, window,
                                      windows)
    want = j_median.threshold_and_filter(jnp.asarray(probs),
                                         jnp.asarray(thr), window=window,
                                         windows=windows)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 9, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_classwise_median_matches_scipy_per_column():
    windows = get_config().median_window_classwise[:6]
    rng = np.random.default_rng(0)
    x = (rng.random((3, 120, 6)) > 0.5).astype(np.float32)
    out = median.classwise_median_filter(torch.from_numpy(x), windows).numpy()
    for c, w in enumerate(windows):
        ref = np.stack([scipy.ndimage.median_filter(
            x[b, :, c:c + 1], (w, 1))[:, 0] for b in range(3)])
        np.testing.assert_array_equal(out[:, :, c], ref)


# ---------------------------------------------------------------------------
# decoding


@pytest.fixture(scope="module")
def cfgs():
    return j_get_config(), get_config()


def test_decode_batch_produces_expected_events(cfgs):
    jcfg, cfg = cfgs
    probs = np.zeros((2, 313, cfg.nclass), dtype=np.float32)
    probs[0, 100:150, 3] = 0.9
    probs[1, 200, 5] = 0.9                   # killed by the median filter
    df = decode.decode_batch(probs, ["clipA", "clipB"], cfg.bird_list, cfg,
                             thresholds=[0.5])[0.5]
    sec = cfg.model.pooling_time_ratio / (cfg.audio.sr / cfg.audio.hop_size)
    assert list(df.filename) == ["clipA"]
    assert df.event_label[0] == cfg.bird_list[3]
    assert np.isclose(df.onset[0], 100 * sec, atol=sec)
    assert np.isclose(df.offset[0], 150 * sec, atol=sec)
    want = j_decode.decode_batch(probs, ["clipA", "clipB"], jcfg.bird_list,
                                 jcfg, thresholds=[0.5])[0.5]
    assert_same_table(df, want)


@pytest.mark.parametrize("learned_post", [False, True])
def test_decode_batch_matches(cfgs, learned_post):
    """Random posteriors, four thresholds, tensor and numpy inputs: the
    same tables, row for row, and the merge of two batches."""
    jcfg, cfg = cfgs
    rng = np.random.default_rng(3)
    thr = [0.3, 0.5, 0.55, 0.9]
    per = []
    for b in range(2):
        probs = rng.random((3, 313, cfg.nclass)).astype(np.float32)
        names = [f"b{b}c{i}" for i in range(3)]
        got = decode.decode_batch(torch.from_numpy(probs), names,
                                  cfg.bird_list, cfg, thresholds=thr,
                                  learned_post=learned_post)
        want = j_decode.decode_batch(probs, names, jcfg.bird_list, jcfg,
                                     thresholds=thr,
                                     learned_post=learned_post)
        assert list(got) == list(want)
        for th in thr:
            assert_same_table(got[th], want[th])
        per.append((got, want))
    merged = decode.merge_prediction_dfs([g for g, _ in per])
    j_merged = j_decode.merge_prediction_dfs([w for _, w in per])
    for th in thr:
        assert_same_table(merged[th], j_merged[th])


def test_extract_events_batch_matches():
    rng = np.random.default_rng(7)
    act = (rng.random((3, 4, 37, 5)) > 0.6).astype(np.uint8)
    act[0, 0, :, 0] = 1
    act[0, 0, :, 1] = 0
    act[1, 2, ::2, 3] = 1
    for g, w in zip(decode.extract_events_batch(act),
                    j_decode.extract_events_batch(act)):
        np.testing.assert_array_equal(g, w)


def test_save_prediction_dfs_same_bytes(cfgs, tmp_path):
    jcfg, cfg = cfgs
    probs = np.random.default_rng(1).random((2, 313, cfg.nclass)).astype(
        np.float32)
    names = ["a b", "c,d"]
    for thr in ([0.5], [0.4, 0.6]):
        got = decode.decode_batch(probs, names, cfg.bird_list, cfg,
                                  thresholds=thr)
        want = j_decode.decode_batch(probs, names, jcfg.bird_list, jcfg,
                                     thresholds=thr)
        p = decode.save_prediction_dfs(got, str(tmp_path / f"p{len(thr)}"))
        jp = j_decode.save_prediction_dfs(want,
                                          str(tmp_path / f"j{len(thr)}"))
        for a, b in zip(p, jp):
            assert open(a, "rb").read() == open(b, "rb").read()


def test_groundtruth_helpers_match(cfgs):
    from bsed_tpu.data.codec import ManyHotEncoder as JEnc
    from bsed_tpu_torch.data.codec import ManyHotEncoder

    jcfg, cfg = cfgs
    targets = np.zeros((2, 313, cfg.nclass), np.float32)
    targets[0, 10:40, 2] = 1
    targets[1, 300:, 7] = 1
    enc = ManyHotEncoder(cfg.bird_list, n_frames=313)
    jenc = JEnc(jcfg.bird_list, n_frames=313)
    got = decode.gt_events_from_frame_targets(targets, ["x", "y"], enc, cfg)
    assert got == j_decode.gt_events_from_frame_targets(
        targets, ["x", "y"], jenc, jcfg)
    assert_same_table(decode.groundtruth_df_from_events(got),
                      j_decode.groundtruth_df_from_events(got))
    d = decode.durations_df(["a", "b", "a"])
    jd = j_decode.durations_df(["a", "b", "a"])
    assert list(d["filename"]) == list(jd["filename"])
    np.testing.assert_array_equal(d["duration"], jd["duration"].to_numpy())


# ---------------------------------------------------------------------------
# scorers on the fixtures of test_decode_metrics.py and
# test_psds_second_source.py


def _df(rows):
    return pd.DataFrame(rows, columns=["filename", "event_label", "onset",
                                       "offset"])


GOLDEN = {   # (reference rows, estimate rows)
    "perfect": ([("f1", "EATO", 1.0, 2.0), ("f1", "WOTH", 3.0, 4.0)],
                [("f1", "EATO", 1.0, 2.0), ("f1", "WOTH", 3.0, 4.0)]),
    "collar_ok": ([("f1", "EATO", 1.0, 2.0), ("f1", "WOTH", 3.0, 4.0)],
                  [("f1", "EATO", 1.15, 2.0), ("f1", "WOTH", 3.0, 4.0)]),
    "collar_miss": ([("f1", "EATO", 1.0, 2.0), ("f1", "WOTH", 3.0, 4.0)],
                    [("f1", "EATO", 1.5, 2.0), ("f1", "WOTH", 3.0, 4.0)]),
    "one_to_one": ([("f1", "EATO", 1.0, 2.0)],
                   [("f1", "EATO", 1.0, 2.0), ("f1", "EATO", 1.05, 2.05)]),
    "segment": ([("f1", "EATO", 0.0, 5.0)], [("f1", "EATO", 0.0, 3.0)]),
    "cross_trigger": ([("f1", "EATO", 0.0, 2.0), ("f1", "WOTH", 5.0, 7.0)],
                      [("f1", "EATO", 0.0, 2.0), ("f1", "EATO", 5.0, 7.0)]),
    "bipartite": ([("f", "EATO", 0.0, 1.0), ("f", "EATO", 0.3, 1.3)],
                  [("f", "EATO", 0.1, 1.1), ("f", "EATO", 0.2, 0.8)]),
    "offset_20pct": ([("f", "EATO", 0.0, 5.0)], [("f", "EATO", 0.1, 6.0)]),
    "cross_file": ([("f1", "EATO", 1.0, 2.0), ("f2", "WOTH", 5.0, 6.0)],
                   [("f2", "EATO", 1.0, 2.0)]),
    "empty_system": ([("f", "EATO", 1.0, 2.0), ("f", "WOTH", 3.0, 4.0)],
                     []),
    "hallucinated": ([("f", "EATO", 1.0, 2.0)],
                     [("f", "EATO", 1.0, 2.0), ("f", "BCCH", 5.0, 6.0)]),
    "gt_less_file": ([("f1", "EATO", 1.0, 2.0)],
                     [("f1", "EATO", 1.0, 2.0), ("f2", "EATO", 4.0, 5.0),
                      ("f2", "BCCH", 6.0, 7.0)]),
    "psds_boundary": ([("f1", "EATO", 0.0, 2.0), ("f1", "WOTH", 5.0, 8.0)],
                      [("f1", "EATO", 0.0, 2.0)]),
}
for _seed in range(3):
    _rng = np.random.default_rng(_seed)
    _classes, _gt = _random_scene(_rng)
    GOLDEN[f"random{_seed}"] = (_gt, _detections_for_op(_rng, _gt,
                                                        _classes))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def _same_counts(got, want):
    assert list(got) == list(want)
    for k in want:
        assert (got[k].tp, got[k].n_ref, got[k].n_sys) == \
            (want[k].tp, want[k].n_ref, want[k].n_sys)


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_scores_match(case):
    ref_rows, est_rows = GOLDEN[case]
    ref, est = _df(ref_rows), _df(est_rows)
    tref, test_ = from_frame(ref), from_frame(est)
    _same_counts(sed_scores.event_based_counts(tref, test_),
                 j_sed.event_based_counts(ref, est))
    _same_counts(sed_scores.segment_based_counts(tref, test_),
                 j_sed.segment_based_counts(ref, est))
    _close(sed_scores.event_based_f1(tref, test_),
           j_sed.event_based_f1(ref, est))
    _close(sed_scores.segment_based_f1(tref, test_),
           j_sed.segment_based_f1(ref, est))
    counts = sed_scores.event_based_counts(tref, test_)
    _close(sed_scores.micro_f_measure(counts),
           j_sed.micro_f_measure(j_sed.event_based_counts(ref, est)))
    report = sed_scores.per_class_report(counts)
    j_report = j_sed.per_class_report(j_sed.event_based_counts(ref, est))
    pd.testing.assert_frame_equal(pd.DataFrame(report), j_report,
                                  check_dtype=False)

    ct, f1, per_class = psds.compute_macro_f_score(test_, tref)
    j_ct, j_f1, j_per_class = j_psds.compute_macro_f_score(est, ref)
    np.testing.assert_array_equal(ct, j_ct)
    _close(f1, j_f1)
    assert list(per_class) == list(j_per_class.index)
    _close(np.asarray(list(per_class.values())), j_per_class.to_numpy())
    op = psds.evaluate_operating_point(test_, tref)
    j_op = j_psds.evaluate_operating_point(est, ref)
    assert op.classes == j_op.classes
    for f in ("tp", "fp", "n_ref", "ct", "gt_dur"):
        np.testing.assert_array_equal(getattr(op, f), getattr(j_op, f))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("alphas", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0),
                                    (0.5, 0.7)])
def test_psds_values_match(seed, alphas):
    """test_psds_second_source's multi-OP scenes: PSDS (and the pointwise
    preview) to 1e-9, and the three-variant report."""
    rng = np.random.default_rng(100 + seed)
    classes, gt = _random_scene(rng, n_files=5, n_classes=4)
    ops, j_ops_ = [], []
    for miss, spurious in ((0.05, 4.0), (0.2, 2.0), (0.4, 1.0), (0.7, 0.3)):
        det = _detections_for_op(rng, gt, classes, miss=miss,
                                 spurious=spurious)
        ops.append(psds.evaluate_operating_point(
            from_frame(_df(det)), from_frame(_df(gt)), 0.5, 0.5, 0.3))
        j_ops_.append(j_psds.evaluate_operating_point(
            _df(det), _df(gt), 0.5, 0.5, 0.3))
    for fn in ("compute_psds", "compute_psds_pointwise"):
        got = getattr(psds, fn)(ops, 50.0, alpha_ct=alphas[0],
                                alpha_st=alphas[1])
        want = getattr(j_psds, fn)(j_ops_, 50.0, alpha_ct=alphas[0],
                                   alpha_st=alphas[1])
        _close(got.value, want.value)
        _close(got.efpr, want.efpr)
        _close(got.etpr, want.etpr)
    got, want = psds.psds_score_report(ops, 50.0), \
        j_psds.psds_score_report(j_ops_, 50.0)
    assert list(got) == list(want)
    _close(list(got.values()), list(want.values()))


def test_tagging_matches():
    rng = np.random.default_rng(0)
    acc, j_acc = tagging.TaggingF1Accumulator(5), \
        j_tag.TaggingF1Accumulator(5)
    for _ in range(3):
        probs = rng.random((4, 9, 5))
        targets = (rng.random((4, 9, 5)) > 0.7).astype(np.float64)
        acc.update(torch.from_numpy(probs), targets, threshold=0.6)
        j_acc.update(probs, targets, threshold=0.6)
        weak = rng.random((4, 5))
        acc.update(weak, (weak > 0.4).astype(float))
        j_acc.update(weak, (weak > 0.4).astype(float))
    _close(acc.per_class_f1(), j_acc.per_class_f1())
    _close(acc.macro_f1(), j_acc.macro_f1())
    fixed = tagging.TaggingF1Accumulator(3)
    fixed.update(np.array([[0.9, 0.2, 0.6], [0.1, 0.8, 0.4]]),
                 np.array([[1, 0, 0], [0, 1, 1]]))
    assert list(fixed.per_class_f1()) == [1.0, 1.0, 0.0]


def test_operating_point_sweep_matches(cfgs):
    jcfg, cfg = cfgs
    probs = np.zeros((2, 313, cfg.nclass), dtype=np.float32)
    probs[0, 100:150, 3] = 0.9
    probs[1, 40:90, 5] = 0.55
    gt = pd.DataFrame({
        "event_label": [cfg.bird_list[3], cfg.bird_list[5]],
        "onset": [100 * 0.031875, 40 * 0.031875],
        "offset": [150 * 0.031875, 90 * 0.031875],
        "filename": ["clipA", "clipB"]})
    thr = [0.25, 0.5, 0.7, 0.95]
    res = operating_points.sweep_operating_points(
        [(torch.from_numpy(probs), ["clipA", "clipB"])], cfg,
        from_frame(gt), thresholds=thr)
    want = j_ops.sweep_operating_points([(probs, ["clipA", "clipB"])], jcfg,
                                        gt, thresholds=thr)
    assert [op.tp.sum() for op in res["operating_points"]] == \
        [op.tp.sum() for op in want["operating_points"]] == [2, 2, 1, 0]
    assert list(res["psds"]) == list(want["psds"])
    _close(list(res["psds"].values()), list(want["psds"].values()))
    assert res["total_duration_s"] == want["total_duration_s"]
    assert operating_points.default_thresholds() == \
        j_ops.default_thresholds()


# ---------------------------------------------------------------------------
# checkpoints, predict, evaluate_checkpoint: a 3-block CNN on 8 mels (every
# block folds), 4 s clips at sr 3200 (T = 80 → 20 frames), a narrow BiGRU

MODEL = dict(nb_filters=(16, 32, 64), pooling=((2, 2), (2, 2), (1, 2)),
             n_rnn_cell=32)
AUDIO = dict(sr=3200, hop_size=160, max_len_seconds=4.0, n_mels=8)


def _small(head: str = "linear"):
    model = dict(MODEL, predictor_head=head)
    jcfg = j_get_config("baseline").replace(audio=JAudioConfig(**AUDIO))
    cfg = get_config("baseline").replace(audio=AudioConfig(**AUDIO))
    return (jcfg.replace(model=dataclasses.replace(jcfg.model, **model)),
            cfg.replace(model=dataclasses.replace(cfg.model, **model)))


def _weights(cfg, seed=0):
    params, stats = init_params(cfg, seed)
    # widen the heads' N(0, 0.01) init so posteriors move away from 0.5
    for head in params["predictor"].values():
        head["kernel"] *= 30.0
    rng = np.random.default_rng(seed)
    for blk in stats["encoder"]["cnn"].values():    # non-trivial BN stats
        blk["bn"]["mean"] = rng.normal(0, 0.1, blk["bn"]["mean"].shape
                                       ).astype(np.float32)
        blk["bn"]["var"] = rng.uniform(0.5, 1.5, blk["bn"]["var"].shape
                                       ).astype(np.float32)
    return params, stats


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _same_trees(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert list(la) == list(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))


@pytest.mark.parametrize("head", ["linear", "mlp"])
def test_checkpoint_roundtrips_both_ways(tmp_path, head):
    """A checkpoint the port exports loads in bsed_tpu to the same trees,
    and the other way round; the pickles hold the same entries."""
    jcfg, cfg = _small(head)
    params, stats = _weights(cfg)
    ours, theirs = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    tm.export_torch_checkpoint(cfg, params, stats, ours, epoch=3)
    j_tm.export_torch_checkpoint(jcfg, params, stats, theirs, epoch=3)
    for path in (ours, theirs):
        p, s = tm.load_torch_checkpoint(path, cfg)
        jp, js = j_tm.load_torch_checkpoint(path, jcfg)
        _same_trees(p, jp)
        _same_trees(s, js)
        _same_trees(p, params)
        _same_trees(s["encoder"], stats["encoder"])
    a = torch.load(ours, weights_only=False)
    b = torch.load(theirs, weights_only=False)
    for key in ("model", "model_p"):
        assert a[key]["kwargs"] == b[key]["kwargs"]
        assert list(a[key]["state_dict"]) == list(b[key]["state_dict"])
        for k, v in a[key]["state_dict"].items():
            assert torch.equal(v, b[key]["state_dict"][k]), k
    assert {k: v for k, v in a.items() if k not in ("model", "model_p")} \
        == {k: v for k, v in b.items() if k not in ("model", "model_p")}


@pytest.fixture(scope="module")
def small_model():
    """bsed_tpu's jitted predict function for the small model, built once;
    its weights and a batch of linear mel."""
    jcfg, cfg = _small()
    params, stats = _weights(cfg)
    j_predict = j_steps.make_predict_fn(j_steps.build_modules(jcfg),
                                        norm_stats=None)
    rng = np.random.default_rng(5)
    mel = np.abs(rng.standard_normal(
        (3, cfg.audio.max_frames, cfg.audio.n_mels))).astype(np.float32)
    return jcfg, cfg, params, stats, j_predict, mel


def _jax_predict(j_predict, params, stats, mel, **kw):
    with jax.default_matmul_precision("float32"):
        s, w = j_predict(params, stats, jnp.asarray(mel), **kw)
    return np.asarray(s), np.asarray(w)


@pytest.mark.parametrize("mode", ["default", "inference", "log_mel",
                                  "norm_stats"])
def test_predict_fn_matches(small_model, mode):
    jcfg, cfg, params, stats, j_predict, mel = small_model
    kw, norm, x = {}, None, mel
    if mode == "inference":
        kw = {"inference": True}
    elif mode == "log_mel":
        kw = {"apply_log": False}
        x = 20 * np.log10(mel + 1e-3)
    elif mode == "norm_stats":
        rng = np.random.default_rng(9)
        norm = (rng.normal(-20, 5, 8).astype(np.float32),
                rng.uniform(5, 15, 8).astype(np.float32))
    predict = steps.make_predict_fn(
        steps.TrainModules(cfg, torch.device("cpu"), use_kernels=False),
        norm_stats=norm)
    s, w = predict(params, stats, torch.from_numpy(x), **kw)
    if norm is None:
        js, jw = _jax_predict(j_predict, params, stats, x, **kw)
    else:
        jp = j_steps.make_predict_fn(j_steps.build_modules(jcfg),
                                     norm_stats=norm)
        js, jw = _jax_predict(jp, params, stats, x, **kw)
    assert s.shape == js.shape == (3, cfg.n_frames, cfg.nclass)
    np.testing.assert_allclose(s.numpy(), js, atol=1e-4)
    np.testing.assert_allclose(w.numpy(), jw, atol=1e-4)
    assert 0.05 < float(s.std())           # the gate sees real signal


def test_predict_fn_rebuilds_for_new_trees(small_model):
    _, cfg, params, stats, j_predict, mel = small_model
    predict = steps.make_predict_fn(
        steps.TrainModules(cfg, torch.device("cpu"), use_kernels=False))
    s1, _ = predict(params, stats, mel)
    p2, s2_ = _weights(cfg, seed=1)
    s2, _ = predict(p2, s2_, mel)
    np.testing.assert_allclose(s2.numpy(), _jax_predict(
        j_predict, p2, s2_, mel)[0], atol=1e-4)
    assert not torch.allclose(s1, s2)


def _flip_frames(p_a, p_b, thresholds):
    """(threshold, clip, frame, class) where the two posteriors binarize
    differently, and the smaller distance of the two from the threshold."""
    out = []
    for th in thresholds:
        diff = (p_a > th) != (p_b > th)
        for idx in zip(*np.nonzero(diff)):
            out.append(min(abs(p_a[idx] - th), abs(p_b[idx] - th)))
    return out


def test_evaluate_checkpoint_matches(tmp_path):
    """Both evaluate_checkpoints on one exported checkpoint and the same
    synthetic clips (10 clips, batches of 4: a padded tail; enough events
    that the PSDS F1 is not zero): posteriors
    within 1e-4; both decoders fed bsed_tpu's posteriors give identical
    event tables; the scores agree, or every binarized frame that differs
    lies within 1e-4 of the threshold; the confusion CSVs are the same
    bytes when the decodes agree."""
    jcfg, cfg = _small()
    params, stats = _weights(cfg)
    ckpt = tm.export_torch_checkpoint(cfg, params, stats,
                                      str(tmp_path / "ckpt.pt"))
    thr = (0.5, 0.3)
    res = tm.evaluate_checkpoint(
        cfg, EvalLoader(SyntheticDataSource(cfg, n_items=10, seed=4,
                                            event_rate=0.3),
                        batch_size=4, device="cpu"),
        torch_ckpt=ckpt, thresholds=thr, device="cpu", use_kernels=False,
        keep_posteriors=True, confusion_csv=str(tmp_path / "port.csv"))
    jsrc = JSynthetic(jcfg, n_items=10, seed=4, event_rate=0.3)
    with jax.default_matmul_precision("float32"):
        want = j_tm.evaluate_checkpoint(
            jcfg, JEvalLoader(jsrc, batch_size=4), torch_ckpt=ckpt,
            thresholds=thr, confusion_csv=str(tmp_path / "jax.csv"))
    j_predict = j_steps.make_predict_fn(j_steps.build_modules(jcfg))
    j_post = np.concatenate([
        _jax_predict(j_predict, *j_tm.load_torch_checkpoint(ckpt, jcfg),
                     mel)[0][:n] for mel, _, _, n in JEvalLoader(
                         jsrc, batch_size=4)])
    post = res["posteriors"]
    assert post.shape == j_post.shape == (10, cfg.n_frames, cfg.nclass)
    np.testing.assert_allclose(post, j_post, atol=1e-4)
    assert set(res) >= set(want) | {"seconds"}

    names = [jsrc.filename(i) for i in range(10)]
    got_ev = decode.decode_batch(j_post, names, cfg.bird_list, cfg,
                                 thresholds=thr)
    want_ev = j_decode.decode_batch(j_post, names, jcfg.bird_list, jcfg,
                                    thresholds=thr)
    for th in thr:
        assert_same_table(got_ev[th], want_ev[th])

    flips = _flip_frames(post, j_post, thr)
    if flips:
        assert max(flips) <= 1e-4, flips
    else:
        _close(res["event_f1"], want["event_f1"])
        _close(res["psds_f1"], want["psds_f1"])
        assert list(res["per_class_f1"]) == list(want["per_class_f1"])
        _close(list(res["per_class_f1"].values()),
               list(want["per_class_f1"].values()))
        _close(list(res["event_f1_per_threshold"].values()),
               list(want["event_f1_per_threshold"].values()))
        assert open(tmp_path / "port.csv", "rb").read() == \
            open(tmp_path / "jax.csv", "rb").read()
    assert want["psds_f1"] > 0.0          # the scores are not all zero


def test_evaluate_checkpoint_refusals(tmp_path):
    _, cfg = _small()
    loader = EvalLoader(SyntheticDataSource(cfg, n_items=2), batch_size=2,
                        device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint 'best'"):
        tm.evaluate_checkpoint(cfg, loader, store_dir=str(tmp_path),
                               device="cpu")
    with pytest.raises(ValueError, match="store_dir or torch_ckpt"):
        tm.evaluate_checkpoint(cfg, loader, device="cpu")
    if not torch.cuda.is_available():
        params, stats = _weights(cfg)
        ckpt = tm.export_torch_checkpoint(cfg, params, stats,
                                          str(tmp_path / "c.pt"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.evaluate_checkpoint(cfg, loader, torch_ckpt=ckpt)
