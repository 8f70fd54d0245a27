"""The port's CLI (python -m bsed_tpu_torch.cli) on the CPU: train → eval
from the store with no preset, --resume, export → eval of the pickle,
feature dumps against bsed_tpu's ``make_encode_fn`` (1e-4),
``evaluate_checkpoint(store_dir=…)`` against bsed_tpu's on one train
state carried into both stores (tests/test_torch_eval.py's gates:
posteriors 1e-4; scores equal, or every flipped binarized frame within
1e-4 of the threshold),
``_apply_flags`` against bsed_tpu's, and the seven subcommands ported
last exiting on a missing input naming it, not a ROADMAP item (they are
held against bsed_tpu's in ``test_torch_predict.py``,
``test_torch_preprocess.py``, ``test_torch_data_tools.py`` and
``test_torch_tag_cycle.py``).

The store-dir runs use ``--perf`` (bfloat16, the throughput configuration
a user trains with) on 2 s clips at 3.2 kHz (``--tiny-audio``); the
comparisons with bsed_tpu use float32 stores."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsed_tpu.cli as j_cli
import bsed_tpu.eval.test_model as j_tm
import bsed_tpu.train.steps as j_steps
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import config_from_dict as j_config_from_dict
from bsed_tpu.config import config_to_dict as j_config_to_dict
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.data.datasets import SyntheticDataSource as JSynthetic
from bsed_tpu.data.pipeline import EvalLoader as JEvalLoader
from bsed_tpu.eval.features import make_encode_fn as j_make_encode_fn
from bsed_tpu.utils.checkpoint import CheckpointManager as JCheckpoints

from bsed_tpu_torch import cli
from bsed_tpu_torch.config import AudioConfig, config_to_dict, get_config
from bsed_tpu_torch.data.datasets import SyntheticDataSource
from bsed_tpu_torch.data.pipeline import EvalLoader, ThreeStreamLoader
from bsed_tpu_torch.eval import test_model as tm
from bsed_tpu_torch.eval.features import load_feature_dir
from bsed_tpu_torch.train import steps
from bsed_tpu_torch.train.trainer import Trainer
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.checkpoint import CheckpointManager
from bsed_tpu_torch.utils.weights import init_params

from tests.test_torch_trainer import NARROW, one_torch_thread  # noqa: F401

TINY = ["--tiny-audio", "-s", "16", "--device", "cpu"]


def _read_tsv(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    header = lines[0].split("\t")
    return [dict(zip(header, line.split("\t"))) for line in lines[1:]]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A store trained by ``train --perf`` for one epoch, then resumed for
    a second."""
    path = str(tmp_path_factory.mktemp("cli") / "run")
    best = cli.main(["train", "--preset", "baseline_mt_isp", "--perf",
                     "--epochs", "1", "--store-dir", path, *TINY])
    rows_1 = _read_tsv(os.path.join(path, "results.tsv"))
    resumed = cli.main(["train", "--store-dir", path, "--resume",
                        "--epochs", "2", *TINY])
    return {"path": path, "best": best, "rows_1": rows_1,
            "resumed": resumed,
            "rows_2": _read_tsv(os.path.join(path, "results.tsv"))}


def test_train_writes_the_store(store):
    path = store["path"]
    assert sorted(os.listdir(os.path.join(path, "model"))) == \
        ["best", "epoch_0", "epoch_1", "meta.json"]
    meta = CheckpointManager(path).load_meta()
    assert meta["config"]["model"]["compute_dtype"] == "bfloat16"
    assert meta["config"]["model"]["folded_train_stem"] is True
    assert meta["config"]["train"]["fused_streams"] is True
    rows = store["rows_1"]
    assert [r["epoch"] for r in rows] == ["0"]
    assert all(np.isfinite(float(v)) for v in rows[0].values())
    assert store["best"]["epoch"] == 0


def test_train_resume_continues_from_newest_epoch(store):
    """--resume rebuilds the config from meta.json and continues after
    epoch_0: this run's results.tsv holds epoch 1 alone."""
    assert [r["epoch"] for r in store["rows_2"]] == ["1"]
    assert store["resumed"]["epoch"] == 1
    assert CheckpointManager(store["path"]).latest_epoch() == 1
    state = CheckpointManager(store["path"]).load("epoch_1")
    assert state["step"] == 2 and state["count"] == 2.0


def test_eval_store_dir_without_preset(store):
    """eval --store-dir rebuilds the config from meta.json and scores the
    best checkpoint: the val scores of its epoch in results.tsv."""
    res = cli.main(["eval", "--store-dir", store["path"], *TINY])
    row = store["rows_2"][0]        # epoch 1 is the resumed run's best
    assert res["event_f1"] == pytest.approx(float(row["val_event_f1"]),
                                            abs=1e-6)
    assert res["psds_f1"] == pytest.approx(float(row["val_psds_f1"]),
                                           abs=1e-6)


def test_export_then_eval_torch_checkpoint(store, tmp_path):
    out = str(tmp_path / "ref.pt")
    cli.main(["export", "--store-dir", store["path"], "--out", out, *TINY])
    a = cli.main(["eval", "--store-dir", store["path"], *TINY])
    b = cli.main(["eval", "--store-dir", store["path"],
                  "--torch-checkpoint", out, *TINY])
    for key in ("event_f1", "psds_f1", "per_class_f1"):
        assert a[key] == b[key], key


def test_eval_psds_sweep(store, tmp_path):
    res = cli.main(["eval", "--store-dir", store["path"], "--psds-sweep",
                    "--n-thresholds", "5", "--roc-out", str(tmp_path),
                    *TINY])
    for key in ("psds_ct0_st0", "psds_ct1_st0", "psds_ct0_st1"):
        assert 0.0 <= res[key] <= 1.0
        with open(tmp_path / f"roc_{key}.csv") as fh:
            assert fh.readline().strip() == "efpr,etpr"


def _f32_cfg(get, audio_cls):
    """float32, the folded train stem, and tests/test_torch_trainer.py's
    few narrow layers on 16 mel bins."""
    cfg = get("baseline_mt_isp").replace(audio=audio_cls(
        sr=3200, hop_size=160, max_len_seconds=2.0, n_mels=16))
    return cfg.replace(model=dataclasses.replace(
        cfg.model, folded_train_stem=True, fused_stem_epilogue=True,
        **NARROW))


def test_features_match_jax_encode(tmp_path):
    """``features`` on a float32 store against bsed_tpu's make_encode_fn
    on the same weights and clips, at 1e-4."""
    cfg = _f32_cfg(get_config, AudioConfig)
    syn = SyntheticDataSource(cfg, n_items=8, seed=1)
    trainer = Trainer(cfg, ThreeStreamLoader(syn, syn, syn, batch_size=4,
                                             device="cpu"),
                      store_dir=str(tmp_path / "run"), device="cpu")
    trainer.ckpt.save("best", trainer.state)
    out = str(tmp_path / "feats")
    cli.main(["features", "--store-dir", str(tmp_path / "run"), "--split",
              "val", "--out-dir", out, "-s", "16", "--device", "cpu"])
    got = load_feature_dir(out)

    jcfg = j_config_from_dict(trainer.ckpt.load_meta()["config"])
    trees = trainer.ckpt.load("best")
    encode = j_make_encode_fn(j_steps.build_modules(jcfg), trees["params"],
                              trees["batch_stats"])
    val = JSynthetic(jcfg, n_items=8, seed=4)
    with jax.default_matmul_precision("float32"):
        want = np.concatenate([np.asarray(encode(m))[:n] for m, _, _, n in
                               JEvalLoader(val, batch_size=12)])
    assert got.shape == want.shape == (8, cfg.n_frames,
                                       2 * cfg.model.n_rnn_cell)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert float(np.abs(want).mean()) > 1e-2


def test_evaluate_checkpoint_store_dir_matches_jax(tmp_path, monkeypatch):
    """One train state (widened heads, tests/test_torch_eval.py's) saved in
    both packages' stores; both evaluate_checkpoint(store_dir=…) on the
    same clips."""
    jcfg = _f32_cfg(j_get_config, JAudioConfig)
    cfg = _f32_cfg(get_config, AudioConfig)
    params, stats = init_params(cfg, 0)
    for head in params["predictor"].values():
        head["kernel"] *= 30.0
    rng = np.random.default_rng(0)
    for blk in stats["encoder"]["cnn"].values():
        blk["bn"]["mean"] = rng.normal(0, 0.1, blk["bn"]["mean"].shape
                                       ).astype(np.float32)
        blk["bn"]["var"] = rng.uniform(0.5, 1.5, blk["bn"]["var"].shape
                                       ).astype(np.float32)
    create = jax.jit(lambda k: j_steps.create_train_state(
        jcfg, j_steps.build_modules(jcfg), k))
    monkeypatch.setattr(j_tm, "create_train_state",
                        lambda c, m, k: create(k))
    jstate = create(jax.random.key(0)).replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    JCheckpoints(str(tmp_path / "jax")).save("best", jstate)
    state = steps.load_train_state(steps.build_modules(cfg, device="cpu"),
                                   weights.trees_from_jax_state(jstate))
    CheckpointManager(str(tmp_path / "port")).save("best", state)

    res = tm.evaluate_checkpoint(
        cfg, EvalLoader(SyntheticDataSource(cfg, n_items=10, seed=4,
                                            event_rate=0.3),
                        batch_size=4, device="cpu"),
        store_dir=str(tmp_path / "port"), device="cpu",
        keep_posteriors=True)
    jsrc = JSynthetic(jcfg, n_items=10, seed=4, event_rate=0.3)
    with jax.default_matmul_precision("float32"):
        want = j_tm.evaluate_checkpoint(jcfg, JEvalLoader(jsrc, batch_size=4),
                                        store_dir=str(tmp_path / "jax"))
        predict = j_steps.make_predict_fn(j_steps.build_modules(jcfg))
        j_post = np.concatenate([
            np.asarray(predict(params, stats, jnp.asarray(m))[0])[:n]
            for m, _, _, n in JEvalLoader(jsrc, batch_size=4)])
    post = res["posteriors"]
    np.testing.assert_allclose(post, j_post, atol=1e-4)
    diff = (post > 0.5) != (j_post > 0.5)
    if diff.any():
        assert np.abs(j_post[diff] - 0.5).max() <= 1e-4
    else:
        assert res["event_f1"] == pytest.approx(want["event_f1"], abs=1e-9)
        assert res["psds_f1"] == pytest.approx(want["psds_f1"], abs=1e-9)
        assert list(res["per_class_f1"]) == list(want["per_class_f1"])
    assert want["psds_f1"] > 0.0


FLAG_SETS = [[], ["--perf"], ["--tiny-audio"], ["-mt"], ["-ISP"],
             ["-fpn"], ["-stage", "adaptation"], ["-level", "frame"],
             ["--perf", "-ISP", "--tiny-audio", "-level", "clip"]]


@pytest.mark.parametrize("preset", ["baseline", "baseline_mt_isp",
                                    "scmt_ada_weak"])
@pytest.mark.parametrize("flags", FLAG_SETS, ids=" ".join)
def test_apply_flags_matches_jax(preset, flags):
    argv = ["train", "--preset", preset, *flags]
    ours = cli.build_parser().parse_args(argv)
    theirs = j_cli.build_parser().parse_args(argv)
    assert config_to_dict(cli._apply_flags(cli._resolve_config(ours),
                                           ours)) == \
        j_config_to_dict(j_cli._apply_flags(j_cli._resolve_config(theirs),
                                            theirs))


# (arguments, what the exit message names); TMP is the test's directory.
# The seven subcommands ported last no longer exit naming a ROADMAP item
# (10 or 8b): on a missing input file they exit naming the file, and on
# an empty input directory (None) they run to the end
NOT_PORTED = {
    "predict": (["--audio", "TMP/a.wav", "--out-tsv", "TMP/e.tsv",
                 "--torch-checkpoint", "TMP/missing.pt", "--device", "cpu"],
                "TMP/missing.pt"),
    "tag-train": (["--weights-file", "TMP/missing.pt", "--device", "cpu"],
                  "TMP/missing.pt"),
    "pseudo-label": (["--weights", "TMP/missing.pt", "--out-tsv",
                      "TMP/p.tsv", "--device", "cpu"], "TMP/missing.pt"),
    "visualize": (["--syn-features", "TMP/a", "--real-features", "TMP/b",
                   "--out-dir", "TMP/o"], "TMP/a"),
    "preprocess": (["--dataset-root", "TMP/d", "--device", "cpu"], None),
    "synthesize": (["--co-occur", "TMP/c.json", "--out", "TMP/o",
                    "--device", "cpu"], "TMP/c.json"),
    "analyze": (["--annotation-dir", "TMP/a", "--out-dir", "TMP/o"], None),
}


@pytest.mark.parametrize("command", sorted(NOT_PORTED))
def test_unported_subcommand_names_its_item(command, tmp_path):
    args, names = NOT_PORTED[command]
    args = [a.replace("TMP", str(tmp_path)) for a in args]
    if names is None:
        cli.main([command, *args])
        return
    with pytest.raises(SystemExit) as exc:
        cli.main([command, *args])
    assert isinstance(exc.value.code, str)        # a message: exit code 1
    assert names.replace("TMP", str(tmp_path)) in exc.value.code
    assert "item" not in exc.value.code and "not ported" not in \
        exc.value.code


def test_parser_has_every_jax_subcommand_and_flag():
    """All eleven subcommands with bsed_tpu's flags (the port adds
    --device)."""
    def flags(parser):
        sub = parser._subparsers._group_actions[0]
        return {name: sorted(o for a in sp._actions for o in a.option_strings)
                for name, sp in sub.choices.items()}
    ours, theirs = flags(cli.build_parser()), flags(j_cli.build_parser())
    assert sorted(ours) == sorted(theirs) and len(ours) == 11
    for name, opts in theirs.items():
        assert sorted(set(ours[name]) - {"--device"}) == opts, name


def test_train_without_a_card_refuses(tmp_path):
    """The CLI runs on the card by default and never falls back to the
    CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--preset", "baseline_mt_isp", "--perf",
                  "--tiny-audio", "-s", "16", "--epochs", "1",
                  "--store-dir", str(tmp_path / "run")])
