"""The main.py lineage (preset ``origin``) in the port against
``bsed_tpu`` on the CPU: its masked combined real batch (¼ weak, ½
unlabelled, ¼ strong rows), the 'origin' ISP wiring, ICT mixup (weak,
strong and unlabelled-consistency, in bsed_tpu's forward order), the
exp_step cost ramp, dataset normalisation and the params-only EMA.

(a) One step against ``bsed_tpu.train.steps.make_train_step`` in the
reference-parity form (float32, unfolded) and in the folded fused form
(JAX's K2/K3 in interpret mode), with the configuration, replayed ISP
shifts and mixup draws, and gates of ``tests/test_torch_preset_units.py``.
(b) ``Trainer.fit`` of both packages on the origin layout, 2 epochs, as
``tests/test_torch_trainer.py`` runs the flagship: each epoch's train
metrics rel 1e-4, the final state at the train-step gates (the
BatchNorm running means with their conv bias's Adam-noise allowance, see
``_assert_mean``), the validation scores, results.tsv's header and
meta.json (the train scaler included) equal."""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

import bsed_tpu.train.trainer as j_trainer_mod
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.data.datasets import SyntheticDataSource as JSynthetic
from bsed_tpu.data.pipeline import EvalLoader as JEvalLoader
from bsed_tpu.data.pipeline import ThreeStreamLoader as JThreeStream

import bsed_tpu_torch.train.trainer as trainer_mod
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.data.datasets import SyntheticDataSource
from bsed_tpu_torch.data.pipeline import EvalLoader, ThreeStreamLoader
from bsed_tpu_torch.utils import weights

from tests.test_torch_preset_units import (_replayed_draws, _small,
                                           assert_step_matches, jax_step,
                                           port_step)
from tests.test_torch_train_step import _assert_trees
from tests.test_torch_trainer import (_assert_scores_match,
                                      _jitted_create_train_state,
                                      _train_keys)

FIT_BS = 8                # origin's combined batch: 2 weak, 4 unl, 2 strong
EPOCHS = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(folded):
    return jax_step("origin", folded=folded, fused=folded)


@pytest.mark.parametrize("folded", [False, True],
                         ids=["unfolded", "folded_fused"])
def test_origin_step_matches_jax(folded):
    want = _jax(folded)
    assert want[3] == 3                  # unlabelled, weak, strong mixups
    got = port_step("origin", want[0], folded=folded, fused=folded)
    cfg = _small(get_config("origin"), AudioConfig, folded, folded)
    assert cfg.train.normalize and cfg.train.ema_scope == "params"
    assert_step_matches(want, got, cfg)


def _fit_cfg(get, audio_cls):
    cfg = _small(get("origin"), audio_cls)
    return cfg.replace(train=dataclasses.replace(cfg.train,
                                                 batch_size=FIT_BS))


def _sources(source_cls, cfg):
    return (source_cls(cfg, n_items=2 * FIT_BS, seed=1),
            source_cls(cfg, n_items=FIT_BS, seed=2),
            source_cls(cfg, n_items=FIT_BS, seed=3),
            source_cls(cfg, n_items=8, seed=4))


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("origin_fits")
    jcfg = _fit_cfg(j_get_config, JAudioConfig)
    syn, weak, unlab, val = _sources(JSynthetic, jcfg)
    with pytest.MonkeyPatch.context() as mp, _replayed_draws(FIT_BS), \
            jax.default_matmul_precision("float32"):
        mp.setattr(j_trainer_mod, "create_train_state",
                   _jitted_create_train_state)
        jt = j_trainer_mod.Trainer(
            jcfg, JThreeStream(syn, weak, unlab, batch_size=FIT_BS,
                               seed=jcfg.train.seed, layout="origin"),
            val_loader=JEvalLoader(val, batch_size=FIT_BS),
            store_dir=str(root / "jax"), mesh="off", scan_epoch="off")
        init = weights.trees_from_jax_state(jt.state)
        jt.fit(n_epochs=EPOCHS)
        j_final = weights.trees_from_jax_state(jt.state)

        cfg = _fit_cfg(get_config, AudioConfig)
        psyn, pweak, punlab, pval = _sources(SyntheticDataSource, cfg)
        pt = trainer_mod.Trainer(
            cfg, ThreeStreamLoader(psyn, pweak, punlab, batch_size=FIT_BS,
                                   seed=cfg.train.seed, layout="origin",
                                   device="cpu"),
            val_loader=EvalLoader(pval, batch_size=FIT_BS, device="cpu"),
            store_dir=str(root / "port"), device="cpu")
        weights.load_train_state(pt.state, init)
        pt.fit(n_epochs=EPOCHS)
    return {"jax": jt, "port": pt, "j_final": j_final, "root": root,
            "p_final": weights.export_train_state(pt.state)}


def test_origin_fit_train_metrics_match_jax(fits):
    jt, pt = fits["jax"], fits["port"]
    assert len(jt.history) == len(pt.history) == EPOCHS
    for jr, pr in zip(jt.history, pt.history):
        assert list(pr) == list(jr)
        assert "mixup_cons_strong_loss" in pr
        for k in _train_keys(jr):
            np.testing.assert_allclose(pr[k], jr[k], rtol=1e-4,
                                       err_msg=f"epoch {jr['epoch']} {k}")
    # the exp_step ramp runs on the loader's steps per epoch
    assert pt.history[1]["consistency_cost"] > pt.history[0][
        "consistency_cost"] > 0


def test_origin_fit_final_state_matches_jax(fits):
    want, got = fits["j_final"], fits["p_final"]
    n_steps = EPOCHS * len(fits["port"].train_loader)
    assert got["step"] == want["step"] == n_steps
    grads = jax.tree.map(lambda m: m / 0.1, want["mu"])
    _assert_trees(jax.tree.map(lambda m: m / 0.1, got["mu"]), grads,
                  "gradient (mu/0.1)", atol=3e-4, rtol=1e-4)
    noise = n_steps * 1.1 * max(r["lr"] for r in fits["jax"].history)
    for key in ("params", "ema_params"):
        _assert_trees(got[key], want[key], key, atol=1e-5, grads=grads,
                      noise_bound=noise)
    lr = max(r["lr"] for r in fits["jax"].history)
    for key, pkey in (("batch_stats", "params"),
                      ("ema_batch_stats", "ema_params")):
        _assert_trees(_without_means(got[key]), _without_means(want[key]),
                      key, atol=1e-5, rtol=1e-4)
        for blk, stats in want[key]["encoder"]["cnn"].items():
            _assert_mean(got[key]["encoder"]["cnn"][blk]["bn"]["mean"],
                         stats["bn"]["mean"],
                         got[pkey]["encoder"]["cnn"][blk]["conv"]["bias"],
                         want[pkey]["encoder"]["cnn"][blk]["conv"]["bias"],
                         lr, f"{key} {blk}")


def _without_means(stats):
    return {"encoder": {"cnn": {
        blk: {"bn": {"var": s["bn"]["var"]}}
        for blk, s in stats["encoder"]["cnn"].items()}}}


def _assert_mean(got, want, got_bias, want_bias, lr, what):
    """A BatchNorm running mean after the fit. The block's conv bias
    enters its batch mean one to one, and its gradient is cancellation
    noise (BatchNorm removes it: |g| <= 3e-9 measured here), so each side
    moves it by Adam steps of arbitrary sign (allowance (1) of
    tests/test_torch_train_step.py). The mean was taken before the last
    step, so it carries the final bias difference plus at most one such
    step, 1.1·lr. Normalised inputs leave the means near 0, where the
    relative term gives no room."""
    bound = (1e-5 + 1e-4 * np.abs(want) + np.abs(got_bias - want_bias)
             + 1.1 * lr)
    delta = np.abs(got - want)
    assert (delta <= bound).all(), (
        f"{what} mean: |Δ| {float(delta.max())}, excess "
        f"{float((delta - bound).max())}")


def test_origin_fit_scalers_and_validation_match_jax(fits):
    """The train scaler (train + SYN) in the meta, the val-fitted one for
    validation, and the validation scores."""
    jt, pt = fits["jax"], fits["port"]
    for a, b in ((pt.norm_stats, jt.norm_stats),
                 (pt.val_norm_stats, jt.val_norm_stats)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5,
                                       atol=1e-5)
    assert pt.predict_val is not pt.predict
    pmeta = json.loads((fits["root"] / "port" / "model" / "meta.json")
                       .read_text())
    jmeta = json.loads((fits["root"] / "jax" / "model" / "meta.json")
                       .read_text())
    assert pmeta.keys() == jmeta.keys()
    np.testing.assert_allclose(pmeta["scaler"]["mean"],
                               jmeta["scaler"]["mean"], rtol=1e-5)
    np.testing.assert_allclose(pmeta["scaler"]["std"],
                               jmeta["scaler"]["std"], rtol=1e-5)
    assert {k: v for k, v in pmeta.items() if k != "scaler"} == \
        {k: v for k, v in jmeta.items() if k != "scaler"}
    p_head = (fits["root"] / "port" / "results.tsv").read_text() \
        .splitlines()[0]
    assert p_head == (fits["root"] / "jax" / "results.tsv").read_text() \
        .splitlines()[0]
    post = {"jax": [], "port": []}
    jp, js = jt._eval_params()
    pp, ps = weights.export_train_model(pt.state.model)
    with jax.default_matmul_precision("float32"):
        for (jm, _, _, n), (pm, _, _, _) in zip(jt.val_loader,
                                                pt.val_loader):
            s, w = jt.predict_val(jp, js, jm)
            post["jax"].append((np.asarray(s)[:n], np.asarray(w)[:n]))
            s, w = pt.predict_val(pp, ps, pm)
            post["port"].append((s[:n].numpy(), w[:n].numpy()))
    post = {k: tuple(np.concatenate(p) for p in zip(*v))
            for k, v in post.items()}
    for (a, b) in zip(post["port"], post["jax"]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    for jr, pr in zip(jt.history, pt.history):
        val = [k for k in jr if k.startswith("val_")]
        _assert_scores_match({k: pr[k] for k in val},
                             {k: jr[k] for k in val}, post)


def test_evaluate_store_with_scaler_ignores_it(fits):
    """The origin store's meta records the train scaler; evaluate_checkpoint
    (store_dir) does not apply it, as bsed_tpu's does not
    (TestModel.py:225-231): its posteriors are bsed_tpu's predict on the
    stored student without normalisation (1e-4), not the normalised
    ones."""
    import bsed_tpu.train.steps as j_steps

    from bsed_tpu_torch.eval import test_model as tm
    from bsed_tpu_torch.utils.checkpoint import CheckpointManager

    pt, jt = fits["port"], fits["jax"]
    store = str(fits["root"] / "port")
    assert CheckpointManager(store).load_meta()["scaler"] is not None
    val = EvalLoader(SyntheticDataSource(pt.cfg, n_items=8, seed=4),
                     batch_size=FIT_BS, device="cpu")
    res = tm.evaluate_checkpoint(pt.cfg, val, store_dir=store, device="cpu",
                                 keep_posteriors=True)
    trees = CheckpointManager(store).load("best")
    jval = JEvalLoader(JSynthetic(jt.cfg, n_items=8, seed=4),
                       batch_size=FIT_BS)
    with jax.default_matmul_precision("float32"):
        plain = j_steps.make_predict_fn(jt.modules, norm_stats=None)
        normed = j_steps.make_predict_fn(jt.modules)
        want, want_normed = (np.concatenate([
            np.asarray(fn(trees["params"], trees["batch_stats"], m)[0])[:n]
            for m, _, _, n in jval]) for fn in (plain, normed))
    np.testing.assert_allclose(res["posteriors"], want, atol=1e-4)
    assert float(np.abs(want_normed - want).max()) > 1e-3
