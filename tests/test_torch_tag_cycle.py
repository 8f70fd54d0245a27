"""The pseudo-labeling cycle of the port on the CPU: ``write_pseudo_labels``
(bsed_tpu_torch/train/tagging_trainer.py) against ``bsed_tpu``'s, byte
for byte, on the same weights and unlabeled set; then the three commands
of the cycle (``tag-train`` → ``pseudo-label`` → ``train
--pseudo-labels``) through the port's ``cli.main`` with ``--device cpu``
on an on-disk fixture in the layout of tests/test_cli_cycle.py (its
``TINY`` audio: 2 s clips at 3.2 kHz; npy dumps, annotations written with
``csv``), the TSV read back through the port's ``PseudoLabeledDataset``.

The weights are a fresh tagger's with running statistics away from 0 / 1
(``tests/test_torch_tagger._random_stats``) and ``fc`` set so that each
class labels one clip (``_few_clips_a_class``): some clips get labels,
some two, and some none (an empty field). A posterior within
1e-4 of the threshold would make the decision depend on rounding: the
test names it instead of comparing."""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bsed_tpu.train.tagging_trainer as j_tt
from bsed_tpu.data.codec import ManyHotEncoder as JEncoder
from bsed_tpu.data.datasets import SyntheticDataSource as JSynthetic

from bsed_tpu_torch import cli
from bsed_tpu_torch.config import get_config
from bsed_tpu_torch.data.codec import ManyHotEncoder
from bsed_tpu_torch.data.datasets import (PseudoLabeledDataset,
                                          SyntheticDataSource)
from bsed_tpu_torch.train.tagging_trainer import write_pseudo_labels

from tests.test_torch_tagger import (SMALL_AUDIO, _random_stats, cfgs,
                                     jax_trainer, port_trainer, trees)
from tests.test_torch_trainer import one_torch_thread  # noqa: F401

THRESHOLD = 0.5
TINY = ["--tiny-audio", "--device", "cpu"]


def _few_clips_a_class(cfg, params, stats, mel):
    """``params`` with ``fc`` scaled by 0.1 (the fresh tagger's logits
    here are in the tens: every posterior saturated) and each class's
    bias put in the widest gap between its four highest logits over
    ``mel``, so it labels one to four clips with no posterior near the
    threshold."""
    params = dict(params, fc=dict(params["fc"],
                                  kernel=0.1 * params["fc"]["kernel"]))
    p = port_trainer(cfg, "resnet", params, stats).predict_weak(mel)
    top = -np.sort(-np.log(p / (1.0 - p)), axis=0)[:5]     # (5, C) desc
    k = np.argmax(top[:-1] - top[1:], axis=0)
    cols = np.arange(top.shape[1])
    cut = (top[k, cols] + top[k + 1, cols]) / 2.0
    params["fc"]["bias"] = (params["fc"]["bias"] - cut).astype(np.float32)
    return params


@pytest.mark.parametrize("n_clips", [13, 0], ids=["unlabeled", "empty"])
def test_write_pseudo_labels_byte_equal(n_clips, tmp_path):
    """13 clips (a batch of 24 would hold them all: batch 8 makes two,
    the second ragged) or an empty set (the header alone)."""
    cfg, jcfg = cfgs()
    params, stats = trees(cfg, "resnet", seed=6)
    stats = _random_stats(stats, 7)
    unlab = SyntheticDataSource(cfg, n_items=n_clips, seed=3) \
        if n_clips else []
    j_unlab = JSynthetic(jcfg, n_items=n_clips, seed=3) if n_clips else []
    if n_clips:
        mel = np.stack([unlab[i][0] for i in range(n_clips)])
        params = _few_clips_a_class(cfg, params, stats, mel)
    jt = jax_trainer(jcfg, "resnet", params, stats)
    pt = port_trainer(cfg, "resnet", params, stats)
    if n_clips:
        with jax.default_matmul_precision("float32"):
            want = np.asarray(jt.predict_weak(jnp.asarray(mel)))
        np.testing.assert_allclose(pt.predict_weak(mel), want, atol=1e-4)
        near = np.abs(want - THRESHOLD) < 1e-4
        assert not near.any(), f"posteriors at the threshold: {want[near]}"
        labeled = (want > THRESHOLD).any(axis=1)
        assert labeled.any() and not labeled.all()
    out, j_out = str(tmp_path / "pl.tsv"), str(tmp_path / "j" / "pl.tsv")
    rows = write_pseudo_labels(pt.predict_weak, unlab, out,
                               ManyHotEncoder(cfg.bird_list),
                               threshold=THRESHOLD, batch_size=8)
    with jax.default_matmul_precision("float32"):
        df = j_tt.write_pseudo_labels(jt.predict_weak, j_unlab, j_out,
                                      JEncoder(jcfg.bird_list),
                                      threshold=THRESHOLD, batch_size=8)
    with open(out, "rb") as fh, open(j_out, "rb") as j_fh:
        got, want_bytes = fh.read(), j_fh.read()
    assert got == want_bytes
    assert got.startswith(b"filename\tevent_labels\n") and b"\r" not in got
    assert rows == list(df.itertuples(index=False, name=None))


def _write_split(root, sub, n, seed, cfg, with_annotations=True):
    """``n`` npy dumps under ``root/sub/wav`` and, with annotations,
    their event tables under ``root/sub/annotation`` (tests/
    test_cli_cycle.py's fixture, written with ``csv``)."""
    wav = os.path.join(root, sub, "wav")
    ann = os.path.join(root, sub, "annotation")
    os.makedirs(wav, exist_ok=True)
    os.makedirs(ann, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        name = f"clip_{seed}_{i}"
        feats = np.abs(rng.standard_normal(
            (cfg.audio.max_frames, cfg.audio.n_mels))).astype(np.float32)
        np.save(os.path.join(wav, name + ".npy"), feats)
        if not with_annotations:
            continue
        rows = []
        for _ in range(int(rng.integers(1, 3))):
            onset = float(rng.uniform(0, cfg.audio.max_len_seconds * .6))
            offset = onset + float(rng.uniform(0.2, 0.8))
            label = cfg.bird_list[int(rng.integers(cfg.nclass))]
            rows.append((label, onset, min(offset,
                                           cfg.audio.max_len_seconds)))
        with open(os.path.join(ann, name + ".txt"), "w", newline="") as fh:
            writer = csv.writer(fh, delimiter="\t", lineterminator="\n")
            writer.writerow(["event_label", "onset", "offset"])
            writer.writerows(rows)


def write_fixture(root, cfg, n_syn=24, n_weak=12, n_unlab=12, n_val=8):
    """The four splits of ``--data-root`` (SYN, weak, unlabeled without
    annotations, validation); returns the unlabeled split's directory."""
    d = cfg.data
    _write_split(root, os.path.join(d.synth_root, d.synth_feature_subdir),
                 n_syn, 1, cfg)
    _write_split(root, os.path.join(d.dataset_root, d.train_weak_subdir),
                 n_weak, 2, cfg)
    unlab = os.path.join(d.dataset_root, d.train_unlabeled_subdir)
    _write_split(root, unlab, n_unlab, 3, cfg, with_annotations=False)
    _write_split(root, os.path.join(d.dataset_root, d.val_subdir), n_val, 4,
                 cfg)
    return os.path.join(root, unlab)


def test_pseudo_labeling_cycle_via_cli(tmp_path, capsys):
    root = str(tmp_path / "root")
    cfg = get_config("baseline").replace(
        audio=cfgs()[0].audio.__class__(**SMALL_AUDIO))
    unlab_dir = write_fixture(root, cfg)
    weights = str(tmp_path / "tagger.pt")
    pl_tsv = str(tmp_path / "pl.tsv")
    run_dir = str(tmp_path / "run")

    # (1) train the weak tagger
    best = cli.main(["tag-train", *TINY, "--data-root", root, "--epochs",
                     "2", "--save", weights])
    assert os.path.exists(weights) and best["saved"] == weights
    assert best["best_epoch"] in (0, 1) and 0.0 <= best["best_weak_f1"] <= 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("{\"epoch_seconds\"")
    assert '"matmul_tf32": false, "cudnn_tf32": false' in lines[-1]

    # (2) write the pseudo-label TSV over the unlabeled set
    rows = cli.main(["pseudo-label", *TINY, "--data-root", root,
                     "--weights", weights, "--out-tsv", pl_tsv])
    assert len(rows) == 12
    assert '"tf32": {"matmul_tf32": false' in \
        capsys.readouterr().out.strip().splitlines()[-1]
    with open(pl_tsv, newline="") as fh:
        table = list(csv.reader(fh, delimiter="\t"))
    assert table[0] == ["filename", "event_labels"]
    assert [tuple(r) for r in table[1:]] == rows
    codec = ManyHotEncoder(cfg.bird_list, n_frames=cfg.n_frames,
                           sr=cfg.audio.sr, hop_size=cfg.audio.hop_size,
                           pooling_time_ratio=cfg.model.pooling_time_ratio)
    read_back = PseudoLabeledDataset(unlab_dir, pl_tsv, codec, cfg)
    assert len(read_back) == 12
    for i, (name, labels) in enumerate(sorted(rows)):
        assert read_back.filename(i) == name
        want = codec.encode_weak([labels] if labels else [])
        np.testing.assert_array_equal(read_back[i][1], want)

    # (3) consume the TSV in a training preset that reads it
    result = cli.main(["train", *TINY, "--data-root", root, "--preset",
                       "baseline_mt_isp", "--epochs", "1",
                       "--pseudo-labels", pl_tsv, "--store-dir", run_dir])
    assert os.path.exists(os.path.join(run_dir, "results.tsv"))
    assert np.isfinite(result["loss"])


def test_cycle_commands_name_missing_files(tmp_path):
    """A missing ``--weights`` or ``--weights-file`` exits naming it."""
    for argv, path in (
            (["pseudo-label", "--weights", str(tmp_path / "no.pt"),
              "--out-tsv", str(tmp_path / "pl.tsv")], "no.pt"),
            (["tag-train", "--weights-file", str(tmp_path / "none.pt")],
             "none.pt")):
        with pytest.raises(SystemExit) as exc:
            cli.main([*argv, *TINY])
        assert str(tmp_path / path) in exc.value.code


def test_tagger_entry_points_refuse_without_a_card(tmp_path):
    """``TaggingTrainer``, ``tag-train`` and ``pseudo-label`` run on the
    card unless asked for the CPU, and never fall back to it quietly."""
    import torch

    from bsed_tpu_torch.train.tagging_trainer import TaggingTrainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, _ = cfgs()
    weights = tmp_path / "w.pt"
    weights.write_bytes(b"")
    for call in (lambda: TaggingTrainer(cfg),
                 lambda: cli.main(["tag-train", "--tiny-audio", "-s", "8"]),
                 lambda: cli.main(["pseudo-label", "--tiny-audio", "-s", "8",
                                   "--weights", str(weights), "--out-tsv",
                                   str(tmp_path / "pl.tsv")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
