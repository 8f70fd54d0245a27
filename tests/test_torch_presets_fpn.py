"""The feature-pyramid model (preset ``baseline_fpn_mt_isp``) in the port
against ``bsed_tpu`` on the CPU:

(a) ``CNNFPN`` and ``CRNNFPN`` in eval mode against bsed_tpu's modules on
the same weights and input at 1e-4, and ``CNNFPN``'s training forward:
the weight-tied ``block_down`` runs twice, so its BatchNorm statistics
advance twice, as bsed_tpu's do (1e-5 + 1e-4 relative);
(b) ``make_predict_fn`` on an FPN tree (the three BiGRUs hoisted on K4's
plain version) against bsed_tpu's at 1e-4, with and without the
inference gate;
(c) one train step of the preset against ``bsed_tpu.train.steps.
make_train_step`` in the reference-parity form (unfolded, float32), with
the configuration, replayed draws and gates of
``tests/test_torch_preset_units.py``;
(d) ``cli train --preset baseline_fpn_mt_isp --tiny-audio`` then
``eval --store-dir``: the store's evaluation gives the best row's val
scores; ``--perf`` on the preset fails as bsed_tpu's does."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsed_tpu.train.steps as j_steps
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.models.cnn import CNNFPN as JCNNFPN
from bsed_tpu.models.crnn import CRNNFPN as JCRNNFPN

from bsed_tpu_torch import cli
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.models.cnn import CNNFPN
from bsed_tpu_torch.models.crnn import CRNNFPN
from bsed_tpu_torch.train import steps
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.checkpoint import CheckpointManager

from tests.test_torch_cli import _read_tsv
from tests.test_torch_preset_units import (_small, assert_step_matches,
                                           jax_step, port_step)
from tests.test_torch_train_step import _assert_trees, _leaves

PRESET = "baseline_fpn_mt_isp"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (_small(j_get_config(PRESET), JAudioConfig),
            _small(get_config(PRESET), AudioConfig))


def _x(cfg, n=3, seed=0):
    return np.random.default_rng(seed).normal(
        -4.0, 3.0, (n, cfg.audio.max_frames, cfg.audio.n_mels, 1)
    ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_encoder():
    """bsed_tpu's CRNNFPN variables (running stats perturbed away from
    0/1) and its eval output on ``_x``."""
    jcfg, _ = _cfgs()
    mod = JCRNNFPN(jcfg.model, n_frames=jcfg.n_frames)
    x = jnp.asarray(_x(jcfg))
    variables = jax.jit(lambda k0, k1: mod.init(
        {"params": k0, "dropout": k1}, x, train=False))(
            jax.random.key(0), jax.random.key(1))
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape)
                              .astype(np.float32)),
        variables["batch_stats"])
    params = weights._tree_np(variables["params"])
    stats = weights._tree_np(stats)
    with jax.default_matmul_precision("float32"):
        out, _ = jax.jit(lambda v, xx: mod.apply(v, xx, train=False))(
            {"params": params, "batch_stats": stats}, x)
    return params, stats, np.asarray(out)


def test_crnn_fpn_eval_matches_jax():
    params, stats, want = _jax_encoder()
    _, cfg = _cfgs()
    enc = CRNNFPN(cfg.model)
    weights.load_crnn(enc, params, stats)
    with torch.no_grad():
        got, d_input = enc.eval()(torch.from_numpy(_x(cfg)))
    assert got is d_input
    assert want.shape == (3, cfg.n_frames, 2 * cfg.model.n_rnn_cell)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_cnn_fpn_eval_and_tied_block_stats_match_jax():
    """Eval outputs of the three levels, then one training forward: the
    new running statistics of every block, ``block_down``'s after its two
    calls."""
    params, stats, _ = _jax_encoder()
    jcfg, cfg = _cfgs()
    m = jcfg.model
    jmod = JCNNFPN(tuple(m.nb_filters), tuple(map(tuple, m.pooling)),
                   m.activation, dropout=0.0)
    cnn = CNNFPN(tuple(cfg.model.nb_filters),
                 tuple(map(tuple, cfg.model.pooling)), cfg.model.activation)
    weights.load_cnn(cnn, params["cnn"], stats["cnn"])
    weights.load_conv_block(cnn.block_down, params["cnn"]["block_down"],
                            stats["cnn"]["block_down"])
    x = _x(cfg, seed=2)
    variables = {"params": params["cnn"], "batch_stats": stats["cnn"]}
    with jax.default_matmul_precision("float32"):
        want = jmod.apply(variables, jnp.asarray(x), train=False)
        _, mut = jmod.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    with torch.no_grad():
        got = cnn.eval()(torch.from_numpy(x))
        cnn.train()(torch.from_numpy(x))
    assert [g.shape[1] for g in got] == [cfg.n_frames, cfg.n_frames // 2,
                                         cfg.n_frames // 4]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    new = {name: {"bn": {"mean": blk.bn.running_mean.numpy(),
                         "var": blk.bn.running_var.numpy()}}
           for name, blk in {**dict(cnn.blocks.items()),
                             "block_down": cnn.block_down}.items()}
    want_stats = weights._tree_np(mut["batch_stats"])
    _assert_trees(new, want_stats, "batch_stats", atol=1e-5, rtol=1e-4)
    # two updates, not one: the tied block's mean moved past one step's
    once = 0.01 * stats["cnn"]["block_down"]["bn"]["mean"]
    assert not np.allclose(want_stats["block_down"]["bn"]["mean"], once)


@pytest.mark.parametrize("inference", [False, True])
def test_predict_fn_fpn_matches_jax(inference):
    jcfg, cfg = _cfgs()
    params, stats = weights.init_params(cfg, 3)
    mel = np.abs(np.random.default_rng(4).standard_normal(
        (5, cfg.audio.max_frames, cfg.audio.n_mels))).astype(np.float32)
    # widened heads and fuse layers, so the posteriors leave 0.5
    for dense in (*params["predictor"].values(),
                  params["encoder"]["fuse_2"], params["encoder"]["fuse_4"]):
        dense["kernel"] *= 30.0
    with jax.default_matmul_precision("float32"):
        j_pred = j_steps.make_predict_fn(j_steps.build_modules(jcfg))
        want = j_pred(params, stats, jnp.asarray(mel), inference=inference)
    predict = steps.make_predict_fn(steps.TrainModules(
        cfg, torch.device("cpu")))
    got = predict(params, stats, mel, inference=inference)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    assert float(np.abs(np.asarray(want[1]) - 0.5).max()) > 0.05


@functools.lru_cache(maxsize=None)
def _jax_step():
    return jax_step(PRESET)


def test_fpn_preset_step_matches_jax():
    want = _jax_step()
    got = port_step(PRESET, want[0])
    assert_step_matches(want, got, _small(get_config(PRESET), AudioConfig))
    names = {p[:2] for p, _ in _leaves(got[0]["params"])}
    assert {("encoder", n) for n in ("rnn", "rnn_2", "rnn_4", "fuse_2",
                                     "fuse_4")} <= names


def test_init_params_fpn_tree_matches_jax_layout():
    """The port's FPN init tree has bsed_tpu's paths and shapes."""
    jcfg, cfg = _cfgs()
    modules = j_steps.build_modules(jcfg)
    state = jax.jit(lambda k: j_steps.create_train_state(
        jcfg, modules, k))(jax.random.key(0))
    params, stats = weights.init_params(cfg, 0)
    for got, want in ((params, state.params), (stats, state.batch_stats)):
        g = {p: v.shape for p, v in _leaves(got)}
        w = {p: np.asarray(v).shape for p, v in _leaves(
            weights._tree_np(want))}
        assert g == w


TINY = ["--tiny-audio", "-s", "16", "--device", "cpu"]


def test_cli_train_then_eval_store_dir(tmp_path):
    path = str(tmp_path / "fpn")
    best = cli.main(["train", "--preset", PRESET, "--epochs", "1",
                     "--store-dir", path, *TINY])
    rows = _read_tsv(os.path.join(path, "results.tsv"))
    assert [r["epoch"] for r in rows] == ["0"] and best["epoch"] == 0
    assert all(np.isfinite(float(v)) for v in rows[0].values())
    meta = CheckpointManager(path).load_meta()
    assert meta["config"]["model"]["use_fpn"] is True
    assert meta["config"]["model"]["folded_train_stem"] is False
    trees = CheckpointManager(path).load("best")
    assert "block_down" in trees["params"]["encoder"]["cnn"]
    res = cli.main(["eval", "--store-dir", path, *TINY])
    assert res["event_f1"] == pytest.approx(float(rows[0]["val_event_f1"]),
                                            abs=1e-6)
    assert res["psds_f1"] == pytest.approx(float(rows[0]["val_psds_f1"]),
                                           abs=1e-6)


def test_cli_perf_on_fpn_fails_as_jax(tmp_path):
    with pytest.raises(ValueError, match="not foldable"):
        cli.main(["train", "--preset", PRESET, "--perf", "--epochs", "1",
                  "--store-dir", str(tmp_path / "x"), *TINY])
    jcfg = j_get_config(PRESET)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model,
                                                  folded_train_stem=True))
    with pytest.raises(ValueError, match="not foldable"):
        j_steps.make_train_step(j_steps.build_modules(jcfg))


def test_evaluate_fpn_torch_checkpoint_matches_jax(tmp_path):
    """evaluate_checkpoint's torch_ckpt branch on an exported FPN
    checkpoint (widened heads and fuse layers, clips dense in events),
    both packages on the same pickle and clips: posteriors within 1e-4,
    and the scores equal, or every binarized frame that differs within
    1e-4 of the threshold."""
    import bsed_tpu.eval.test_model as j_tm
    from bsed_tpu.data.datasets import SyntheticDataSource as JSynthetic
    from bsed_tpu.data.pipeline import EvalLoader as JEvalLoader

    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import EvalLoader
    from bsed_tpu_torch.eval import test_model as tm

    jcfg, cfg = _cfgs()
    params, stats = weights.init_params(cfg, 5)
    for dense in (*params["predictor"].values(),
                  params["encoder"]["fuse_2"], params["encoder"]["fuse_4"]):
        dense["kernel"] *= 30.0
    ckpt = tm.export_torch_checkpoint(cfg, params, stats,
                                      str(tmp_path / "fpn.pt"))
    res = tm.evaluate_checkpoint(
        cfg, EvalLoader(SyntheticDataSource(cfg, n_items=10, seed=4,
                                            event_rate=0.3),
                        batch_size=4, device="cpu"),
        torch_ckpt=ckpt, device="cpu", keep_posteriors=True)
    jsrc = JSynthetic(jcfg, n_items=10, seed=4, event_rate=0.3)
    with jax.default_matmul_precision("float32"):
        want = j_tm.evaluate_checkpoint(jcfg, JEvalLoader(jsrc, batch_size=4),
                                        torch_ckpt=ckpt)
        j_predict = j_steps.make_predict_fn(j_steps.build_modules(jcfg))
        jp, js = j_tm.load_torch_checkpoint(ckpt, jcfg)
        j_post = np.concatenate([
            np.asarray(j_predict(jp, js, jnp.asarray(m), inference=True)[0])
            [:n] for m, _, _, n in JEvalLoader(jsrc, batch_size=4)])
    post = res["posteriors"]
    assert post.shape == j_post.shape == (10, cfg.n_frames, cfg.nclass)
    np.testing.assert_allclose(post, j_post, atol=1e-4)
    diff = (post > 0.5) != (j_post > 0.5)
    if diff.any():
        assert np.abs(j_post[diff] - 0.5).max() <= 1e-4
    else:
        assert res["event_f1"] == pytest.approx(want["event_f1"], abs=1e-9)
        assert res["psds_f1"] == pytest.approx(want["psds_f1"], abs=1e-9)
    assert float(np.abs(post - 0.5).max()) > 0.05
