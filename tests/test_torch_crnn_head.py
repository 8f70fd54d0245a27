"""The 'crnn' conv predictor head (``predictor_head='crnn'``:
``models/crnn.EncodedCRNNPred`` over the encoder's (B, T, 2H) output)
against ``bsed_tpu`` on the CPU.

The head's frequency pools divide the encoding's width by 256, so it
exists only at 2·n_rnn_cell = 256·k: every case keeps n_rnn_cell 128 (the
parity width) and narrows the audio instead, to 2 s clips at 3.2 kHz on 16
mel bins with ``tests/test_torch_preset_units``'s four narrow encoder
blocks (``HEAD``), as ``bsed_tpu``'s own test of the head does
(``tests/test_round2_matrix.py::test_dual_crnn_conv_head_trains``).

  * the head alone, 256 wide and 512 wide (the branch that flattens a
    frequency axis left 2 wide), in eval mode, with the inference gate and
    in train mode with its BatchNorm statistics, at 1e-4 (the gate of
    ``tests/test_torch_models.py``);
  * ``init_params`` and ``create_train_state``: the trees of ``bsed_tpu``'s
    ``create_train_state`` (keys and shapes, under ``jax.eval_shape``), the
    head's statistics 0 / 1 in student and teacher;
  * one ``baseline_mt_isp`` step with the head in the reference form and in
    the --perf form (float32, folded train stem, fused streams) against
    ``bsed_tpu``'s, and one ADDA step (run g, ``scmt`` in the adaptation
    stage, an update step) whose discriminator and confusion forwards
    advance the head's statistics too: the gates of item 8a and of the DA
    steps, the head's params, statistics and EMA included;
  * ``make_predict_fn``, ``make_fast_forward`` (the standard branch: the
    head turns the folded serving stem off) and ``make_sharded_forward``
    against ``bsed_tpu``'s on the same trees at 1e-4;
  * a checkpoint round trip and resume with the head;
  * a ``Trainer.fit`` with the head and recurrent dropout into a store,
    then the CLI's ``eval --store-dir``, ``predict`` and ``features`` on
    it, the store's posteriors against ``bsed_tpu``'s predict function."""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsed_tpu.train.steps as j_steps
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import config_from_dict as j_config_from_dict
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.serve import make_fast_forward as j_make_fast_forward

import bsed_tpu_torch.train.steps as steps
from bsed_tpu_torch import cli
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.data.datasets import SyntheticDataSource
from bsed_tpu_torch.data.pipeline import ThreeStreamLoader
from bsed_tpu_torch.eval.features import load_feature_dir
from bsed_tpu_torch.models.crnn import EncodedCRNNPred
from bsed_tpu_torch.models.predictor import make_predictor_head
from bsed_tpu_torch.serve import make_fast_forward, make_sharded_forward
from bsed_tpu_torch.train.trainer import Trainer
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.checkpoint import CheckpointManager

from tests.test_torch_da_units import DA_STEP, check_run, jax_da_step
from tests.test_torch_preset_units import (EPOCH, _batch, _small,
                                           assert_step_matches, jax_step,
                                           port_step)
from tests.test_torch_train_step import _leaves
from tests.test_torch_trainer import one_torch_thread  # noqa: F401

HEAD = (("predictor_head", "crnn"), ("n_rnn_cell", 128))
GATE = 1e-4


def _head_cfgs(width, dropout=0.0):
    """bsed_tpu's and the port's configurations of a head over a
    ``width``-wide encoding (n_rnn_cell = width / 2)."""
    model = dict(predictor_head="crnn", n_rnn_cell=width // 2,
                 dropout=dropout)
    return [get("baseline").replace(model=dataclasses.replace(
        get("baseline").model, **model)) for get in (j_get_config,
                                                     get_config)]


def _jax_head(jcfg, x, seed):
    """bsed_tpu's head with params from its init and running statistics
    away from 0 / 1; its last block's GLU bias spread so the weak
    posteriors leave 0.5 and the gate decides."""
    head = j_steps.make_predictor_head(jcfg)
    variables = head.init({"params": jax.random.key(seed),
                           "dropout": jax.random.key(seed + 1)},
                          jnp.asarray(x), train=True)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, variables["params"])
    last = params["crnn_pred"]["cnn"]["block4"]["GLU_0"]["linear"]
    last["bias"] = rng.normal(0.0, 4.0, last["bias"].shape).astype(
        np.float32)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.1 * rng.standard_normal(v.shape) if
                      p[-1].key == "mean" else
                      0.5 + rng.random(v.shape)).astype(np.float32),
        variables["batch_stats"])
    return head, params, stats


@pytest.mark.parametrize("mode", ["eval", "inference", "train"])
@pytest.mark.parametrize("width", [256, 512])
def test_head_matches_jax(width, mode):
    """Strong and weak posteriors (and in train mode the updated
    statistics) of the head over a (B, T, width) encoding. At 512 the
    stack leaves a frequency axis 2 wide, which the head flattens with
    bsed_tpu's reshape (strong is then 2·nclass wide)."""
    jcfg, cfg = _head_cfgs(width)
    x = np.random.default_rng(width).standard_normal(
        (3, 10, width)).astype(np.float32)
    head_j, params, stats = _jax_head(jcfg, x, seed=width // 256)
    head = make_predictor_head(cfg)
    assert isinstance(head, EncodedCRNNPred)
    weights.load_predictor(head, params, stats)
    train = mode == "train"
    with jax.default_matmul_precision("float32"):
        out = head_j.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), train=train,
                           inference=mode == "inference",
                           mutable=["batch_stats"] if train else False)
    (s_want, w_want), new_stats = out if train else (out, None)
    head.train(train)
    with torch.no_grad():
        s_got, w_got = head(torch.from_numpy(x),
                            inference=mode == "inference")
    wide = 20 if mode == "inference" else 20 * (width // 256)
    assert s_got.shape == s_want.shape == (3, 10, wide)
    assert w_got.shape == (3, 20)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), atol=GATE)
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_want), atol=GATE)
    if mode == "inference":
        assert float(np.abs(np.asarray(w_want) - 0.5).min()) > 10 * GATE
        gate = np.asarray(w_want) > 0.5
        assert gate.any() and not gate.all()
    if train:
        for name, blk in head.crnn_pred.cnn.blocks.items():
            want = new_stats["batch_stats"]["crnn_pred"]["cnn"][name]["bn"]
            np.testing.assert_allclose(blk.bn.running_mean.numpy(),
                                       np.asarray(want["mean"]), atol=1e-5,
                                       rtol=1e-4, err_msg=name)
            np.testing.assert_allclose(blk.bn.running_var.numpy(),
                                       np.asarray(want["var"]), atol=1e-5,
                                       rtol=1e-4, err_msg=name)


def test_head_needs_a_256_wide_encoding():
    """The head's pools divide the width by 256: below that nothing is
    left for its dense layer, and it is refused."""
    _, cfg = _head_cfgs(256)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, n_rnn_cell=32))
    with pytest.raises(ValueError, match="reduce an input 64 wide"):
        make_predictor_head(cfg)


def test_train_state_has_bsed_tpus_trees():
    """init_params draws the head; create_train_state's trees have
    bsed_tpu's keys and shapes (under jax.eval_shape), the head's
    statistics in batch_stats["predictor"], 0 / 1 in student and
    teacher; init_params' default perturbs them as the encoder's."""
    jcfg = _small(j_get_config("baseline_mt_isp"), JAudioConfig, model=HEAD)
    cfg = _small(get_config("baseline_mt_isp"), AudioConfig, model=HEAD)
    jmods = j_steps.build_modules(jcfg)
    want = jax.eval_shape(lambda k: j_steps.create_train_state(
        jcfg, jmods, k), jax.random.key(0))
    state = steps.create_train_state(cfg, steps.build_modules(cfg,
                                                              device="cpu"),
                                     0)
    got = weights.export_train_state(state)

    def shapes(tree):
        return {p: np.shape(v) for p, v in _leaves(tree)}
    for key in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        w = jax.tree.map(lambda v: np.zeros(v.shape), getattr(want, key))
        assert shapes(got[key]) == shapes(w), key
    for key in ("batch_stats", "ema_batch_stats"):
        for path, v in _leaves(got[key]["predictor"]):
            np.testing.assert_array_equal(
                v, np.zeros_like(v) if path[-1] == "mean"
                else np.ones_like(v), err_msg=str(path))
    _, perturbed = weights.init_params(cfg, 0)
    var = perturbed["predictor"]["crnn_pred"]["cnn"]["block0"]["bn"]["var"]
    assert (var >= 0.5).all() and (var <= 1.5).all() and var.std() > 0.1
    params_0, _ = weights.init_params(cfg, 0, perturb_stats=False)
    for (p, a), (_, b) in zip(_leaves(params_0),
                              _leaves(weights.init_params(cfg, 0)[0])):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def head_conv_bias(path) -> bool:
    """The head's conv biases feed its BatchNorms, so their exact gradient
    is 0 and each side's is float residue (above 1e-6 in the --perf form's
    fused streams), which Adam's first step turns into ±lr of either sign:
    measured 1.99e-3 apart at lr 1e-3. They get the 2.2·lr allowance of
    the DA steps (``tests/test_torch_da_units._noise``) whatever their
    |g|; their gradients are held as every other."""
    return path[:2] == ("predictor", "crnn_pred") and \
        path[-2:] == ("conv", "bias")


@functools.lru_cache(maxsize=None)
def _jax_step(folded):
    return jax_step("baseline_mt_isp", folded, folded, model=HEAD)


@pytest.mark.parametrize("folded", [False, True],
                         ids=["reference", "perf_f32"])
def test_step_with_the_head_matches_jax(folded):
    """One baseline_mt_isp step from the same state: metrics, gradients,
    params, EMA, BatchNorm statistics (the head's under ``predictor``),
    at the gates of tests/test_torch_preset_units.py."""
    want = _jax_step(folded)
    got = port_step("baseline_mt_isp", want[0], folded, folded, model=HEAD)
    cfg = _small(get_config("baseline_mt_isp"), AudioConfig, folded, folded,
                 model=HEAD)
    assert_step_matches(want, got, cfg, adam_noise=2.2,
                        structural_zero=head_conv_bias)
    before, after = want[0], got[0]
    for key in ("batch_stats", "ema_batch_stats"):
        moved = [float(np.abs(a - b).max()) for (_, a), (_, b) in zip(
            _leaves(before[key]["predictor"]),
            _leaves(after[key]["predictor"]))]
        assert max(moved) > 0, key


@functools.lru_cache(maxsize=None)
def _jax_da(run, folded, step, model):
    return jax_da_step(run, folded, step, model)


def test_adda_step_with_the_head_matches_jax():
    """Run g (scmt, adaptation, an update step): ADDA's discriminator
    forwards (real then syn) and its confusion forward advance the head's
    statistics before the main step's forwards, in bsed_tpu's order."""
    # at the head's 256-wide encoding one element of the clip
    # discriminator's conv_2 kernel has gradients 2.97e-6 (JAX) and
    # -8.27e-6 (here), 1.1e-4 of the leaf's largest apart (measured), so
    # its first Adam steps differ by 2·lr: sign_noise
    want, got = check_run("g", _jax_da, False, DA_STEP, HEAD,
                          sign_noise=True, adam_noise=2.2,
                          structural_zero=head_conv_bias)
    assert want[4] == 2 and got[0]["disc_opt_state"]["count"] == 1
    assert "predictor" in got[0]["batch_stats"]


def _served_trees(cfg, seed=0):
    """init_params' trees with the head's last GLU bias spread (so the
    gate decides) and the statistics perturbed."""
    params, stats = weights.init_params(cfg, seed)
    last = params["predictor"]["crnn_pred"]["cnn"]["block4"]["GLU_0"][
        "linear"]
    last["bias"] = np.random.default_rng(seed).normal(
        0.0, 4.0, last["bias"].shape).astype(np.float32)
    return params, stats


def test_inference_matches_jax():
    """make_predict_fn (with the gate), make_fast_forward on raw audio and
    make_sharded_forward over two CPU replicas, against bsed_tpu's predict
    function and fast forward on the same trees."""
    jcfg = _small(j_get_config("baseline"), JAudioConfig, model=HEAD)
    cfg = _small(get_config("baseline"), AudioConfig, model=HEAD)
    params, stats = _served_trees(cfg)
    rng = np.random.default_rng(2)
    mel = np.abs(rng.standard_normal((3, cfg.audio.max_frames,
                                      cfg.audio.n_mels))).astype(np.float32)
    audio = rng.standard_normal((4, cfg.audio.n_samples)).astype(np.float32)
    jmods = j_steps.build_modules(jcfg)
    fwd_j = jax.jit(j_make_fast_forward(jcfg, jmods, params, stats))
    with jax.default_matmul_precision("float32"):
        want_p = j_steps.make_predict_fn(jmods, norm_stats=None)(
            params, stats, jnp.asarray(mel), inference=True)
        want_f = fwd_j(audio)
    predict = steps.make_predict_fn(steps.TrainModules(
        cfg, torch.device("cpu")), norm_stats=None)
    got_p = predict(params, stats, mel, inference=True)
    got_f = make_fast_forward(cfg, params, stats, device="cpu")(audio)
    got_s = make_sharded_forward(cfg, params, stats, ["cpu", "cpu"])(audio)
    for got, want in ((got_p, want_p), (got_f, want_f), (got_s, want_f)):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GATE)
    assert 0 < float((np.asarray(want_p[0]) > 0).mean()) < 1


def test_checkpoint_round_trip_and_resume(tmp_path):
    """A state with the head saves and restores bit for bit (its params,
    statistics and Adam moments included); the restored state's next step
    equals the live one's."""
    cfg = _small(get_config("baseline_mt_isp"), AudioConfig, model=HEAD)
    modules = steps.build_modules(cfg, device="cpu")
    step = steps.make_train_step(modules)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    live = steps.create_train_state(cfg, modules, 0)
    step(live, batch, 1, EPOCH)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("epoch_0", live)
    saved = ckpt.load("epoch_0")
    assert "crnn_pred" in saved["mu"]["predictor"]
    restored = ckpt.restore("epoch_0",
                            steps.create_train_state(cfg, modules, 7))
    a = dict(_leaves(weights.export_train_state(live)))
    b = dict(_leaves(weights.export_train_state(restored)))
    assert a.keys() == b.keys()
    assert any(p[:2] == ("batch_stats", "predictor") for p in a)
    for path, v in a.items():
        np.testing.assert_array_equal(b[path], v, err_msg=str(path))
    m_live = step(live, batch, 1, EPOCH)
    m_restored = step(restored, batch, 1, EPOCH)
    assert {k: float(v) for k, v in m_live.items()} == \
        {k: float(v) for k, v in m_restored.items()}
    a = dict(_leaves(weights.export_train_state(live)))
    for path, v in _leaves(weights.export_train_state(restored)):
        np.testing.assert_array_equal(a[path], v, err_msg=str(path))


def _read_tsv(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    return [dict(zip(lines[0].split("\t"), line.split("\t")))
            for line in lines[1:]]


def test_store_trained_with_the_head_serves_through_the_cli(tmp_path):
    """Trainer.fit (the head, recurrent dropout 0.5, one epoch) into a
    store; the CLI rebuilds the configuration from its meta: ``eval
    --store-dir`` scores the best epoch as results.tsv does, ``predict``
    writes its events, ``features`` its encodings; the store's posteriors
    equal bsed_tpu's predict function on the same trees."""
    cfg = _small(get_config("baseline_mt_isp"), AudioConfig,
                 model=HEAD + (("dropout_recurrent", 0.5),))
    cfg = cfg.replace(audio=dataclasses.replace(cfg.audio, noise_snr=30.0))
    syn = SyntheticDataSource(cfg, n_items=16, seed=1)
    loader = ThreeStreamLoader(syn, SyntheticDataSource(cfg, 8, seed=2),
                               SyntheticDataSource(cfg, 8, seed=3),
                               batch_size=8, device="cpu")
    store = str(tmp_path / "run")
    trainer = Trainer(cfg, loader, store_dir=store, device="cpu",
                      val_loader=None)
    trainer.fit(n_epochs=1)
    ckpt = CheckpointManager(store)
    meta = ckpt.load_meta()
    assert meta["config"]["model"]["predictor_head"] == "crnn"
    assert meta["config"]["model"]["dropout_recurrent"] == 0.5
    trees = ckpt.load("epoch_0")
    assert "predictor" in trees["batch_stats"] and trees["step"] == 2

    flags = ["-s", "16", "--device", "cpu", "--store-dir", store,
             "--tag", "epoch_0"]
    res = cli.main(["eval", *flags])
    assert 0.0 <= res["event_f1"] <= 1.0
    rec = str(tmp_path / "rec.npy")
    np.save(rec, np.random.default_rng(4).standard_normal(
        3 * cfg.audio.n_samples).astype(np.float32))
    out_tsv = str(tmp_path / "events.tsv")
    got = cli.main(["predict", *flags, "--audio", rec, "--out-tsv", out_tsv,
                    "--precision", "highest"])
    assert _read_tsv(out_tsv) == [
        dict(zip(("filename", "event_label", "onset", "offset"),
                 (n, lab, "%.3f" % a, "%.3f" % b)))
        for n, lab, a, b in got["rows"]]
    feats = str(tmp_path / "feats")
    cli.main(["features", *flags, "--split", "val", "--out-dir", feats])
    assert load_feature_dir(feats).shape[1:] == (cfg.n_frames, 256)

    jcfg = j_config_from_dict(json.loads(json.dumps(meta["config"])))
    assert jcfg.model.predictor_head == "crnn"
    mel = np.abs(np.random.default_rng(6).standard_normal(
        (2, cfg.audio.max_frames, cfg.audio.n_mels))).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = j_steps.make_predict_fn(j_steps.build_modules(jcfg),
                                       norm_stats=None)(
            trees["params"], trees["batch_stats"], jnp.asarray(mel))
    predict = steps.make_predict_fn(steps.TrainModules(
        cfg, torch.device("cpu")), norm_stats=None)
    for g, w in zip(predict(trees["params"], trees["batch_stats"], mel),
                    want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GATE)
    assert os.path.exists(os.path.join(store, "results.tsv"))
