"""The port's Trainer (bsed_tpu_torch/train/trainer.py) against
``bsed_tpu.train.trainer.Trainer`` on the CPU, plus its own parts.

(a) ``Trainer.fit`` of both packages: preset ``baseline_mt_isp`` on 2 s
clips at 3.2 kHz with 16 mel bins and four narrow conv blocks (``NARROW``:
the three folded ones keep the epilogue's 128 lanes), float32, the folded
train stem with the fused epilogue
(JAX runs its Pallas kernels in interpret mode, the port their plain
versions), fused streams, dropout 0 and no teacher noise, batch 4, 2
epochs of 4 steps; both sides take the same fixed ISP shifts (those of
tests/test_torch_train_step.py) and the port starts from the JAX initial
state (``weights.trees_from_jax_state``). Gates, those of
tests/test_torch_train_step.py: each epoch's train metrics rel 1e-4; the
final gradients through Adam's first moment (mu/0.1) atol 3e-4 / rtol
1e-4; params and EMA params 1e-5 plus the Adam-noise allowance 1.1·lr a
step for elements whose gradient is cancellation noise (|g| < 1e-6),
scaled by the number of steps; BatchNorm statistics 1e-5 + 1e-4
relative. Validation scores equal, or every binarized frame that differs
within 2e-3 of the threshold. The same holds on widened-head weights
(tests/test_torch_eval.py's), where the scores are not zero. results.tsv
has JAX's header, meta.json JAX's content, the store JAX's layout; the
``grad_flow`` metrics JAX's names and, per epoch, the gradient gate.
(b) resume reproduces an uninterrupted fit exactly; (c) the resident
epoch runner matches the loop path; (d) the meters cover every step of a
12-step epoch; (e) the NaN guard names its steps; (f) TensorBoard's
purge_step on resume; (g) the profile trace; (i) the meters against
JAX's."""
import contextlib
import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsed_tpu.train.steps as j_steps
import bsed_tpu.train.trainer as j_trainer_mod
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.data.datasets import SyntheticDataSource as JSynthetic
from bsed_tpu.data.pipeline import EvalLoader as JEvalLoader
from bsed_tpu.data.pipeline import ThreeStreamLoader as JThreeStream
from bsed_tpu.utils import meters as j_meters
from bsed_tpu.utils.checkpoint import CheckpointManager as JCheckpoints

import bsed_tpu_torch.train.steps as steps
import bsed_tpu_torch.train.trainer as trainer_mod
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.data.datasets import SyntheticDataSource
from bsed_tpu_torch.data.pipeline import (EvalLoader, ThreeStreamLoader,
                                          gather_batch)
from bsed_tpu_torch.utils import meters, weights
from bsed_tpu_torch.utils.checkpoint import CheckpointManager
from bsed_tpu_torch.utils.weights import init_params

from tests.test_torch_train_step import _assert_trees, _leaves, _shifts

BS = 4
EPOCHS = 2
# a few narrow layers: blocks 0-2 run folded (freq fold 8 → 1), block 3
# in the standard layout, then the 2-layer BiGRU
NARROW = dict(nb_filters=(16, 32, 64, 32),
              pooling=((2, 2), (2, 2), (1, 2), (1, 2)), n_rnn_cell=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's ops here are small: torch's intra-op thread pool costs
    more than it gives, many times more beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, audio_cls, **train):
    cfg = get("baseline_mt_isp").replace(audio=audio_cls(
        sr=3200, hop_size=160, max_len_seconds=2.0, noise_snr=None,
        n_mels=16))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, folded_train_stem=True,
                                  fused_stem_epilogue=True, dropout=0.0,
                                  **NARROW),
        train=dataclasses.replace(cfg.train, batch_size=BS,
                                  fused_streams=True, **train))


def _sources(source_cls, cfg, n_syn=4 * BS):
    return (source_cls(cfg, n_items=n_syn, seed=1),
            source_cls(cfg, n_items=n_syn // 2, seed=2),
            source_cls(cfg, n_items=n_syn // 2, seed=3),
            source_cls(cfg, n_items=8, seed=4))


def _port_trainer(store, n_syn=4 * BS, device_resident=None, **kw):
    cfg = _cfg(get_config, AudioConfig)
    syn, weak, unlab, val = _sources(SyntheticDataSource, cfg, n_syn)
    loader = ThreeStreamLoader(syn, weak, unlab, batch_size=BS,
                               seed=cfg.train.seed, device="cpu",
                               device_resident=device_resident)
    return trainer_mod.Trainer(cfg, loader, val_loader=EvalLoader(
        val, batch_size=BS, device="cpu"), store_dir=str(store),
        device="cpu", **kw)


@contextlib.contextmanager
def _fixed_shifts():
    """Both packages' train steps take the same ISP shifts every step."""
    t_sh, p_sh, f_sh = _shifts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_steps, "sample_isp_shifts", lambda *a, **k: tuple(
            jnp.asarray(s, jnp.int32) for s in (t_sh, p_sh, f_sh)))
        mp.setattr(steps, "sample_isp_shifts", lambda *a, **k: tuple(
            torch.tensor(s) for s in (t_sh, p_sh, f_sh)))
        yield


def _jitted_create_train_state(cfg, modules, rng):
    return jax.jit(lambda k: j_steps.create_train_state(cfg, modules, k))(rng)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Both packages' Trainer.fit on the same data from the same initial
    state, built and run once for this file."""
    root = tmp_path_factory.mktemp("fits")
    jcfg = _cfg(j_get_config, JAudioConfig)
    syn, weak, unlab, val = _sources(JSynthetic, jcfg)
    with pytest.MonkeyPatch.context() as mp, _fixed_shifts(), \
            jax.default_matmul_precision("float32"):
        mp.setattr(j_trainer_mod, "create_train_state",
                   _jitted_create_train_state)
        jt = j_trainer_mod.Trainer(
            jcfg, JThreeStream(syn, weak, unlab, batch_size=BS,
                               seed=jcfg.train.seed),
            val_loader=JEvalLoader(val, batch_size=BS),
            store_dir=str(root / "jax"), mesh="off", grad_flow=True,
            scan_epoch="off")
        init = weights.trees_from_jax_state(jt.state)
        jt.fit(n_epochs=EPOCHS)
        j_final = weights.trees_from_jax_state(jt.state)

        pt = _port_trainer(root / "port", grad_flow=True)
        weights.load_train_state(pt.state, init)
        pt.fit(n_epochs=EPOCHS)
    return {"jax": jt, "port": pt, "j_final": j_final, "root": root,
            "p_final": weights.export_train_state(pt.state)}


def _train_keys(row):
    return [k for k in row if k != "epoch" and not k.startswith("val_")]


def test_fit_train_metrics_match_jax(fits):
    jt, pt = fits["jax"], fits["port"]
    assert len(jt.history) == len(pt.history) == EPOCHS
    for jr, pr in zip(jt.history, pt.history):
        assert list(pr) == list(jr)
        assert pr["epoch"] == jr["epoch"]
        for k in _train_keys(jr):
            if k.startswith("grad_abs/"):
                continue                     # test_grad_flow_matches_jax
            np.testing.assert_allclose(pr[k], jr[k], rtol=1e-4,
                                       err_msg=f"epoch {jr['epoch']} {k}")


def test_fit_final_state_matches_jax(fits):
    want, got = fits["j_final"], fits["p_final"]
    n_steps = EPOCHS * len(fits["port"].train_loader)
    assert got["step"] == want["step"] == n_steps
    assert got["count"] == want["count"] == n_steps
    grads = jax.tree.map(lambda m: m / 0.1, want["mu"])
    _assert_trees(jax.tree.map(lambda m: m / 0.1, got["mu"]), grads,
                  "gradient (mu/0.1)", atol=3e-4, rtol=1e-4)
    noise = n_steps * 1.1 * max(r["lr"] for r in fits["jax"].history)
    for key in ("params", "ema_params"):
        _assert_trees(got[key], want[key], key, atol=1e-5, grads=grads,
                      noise_bound=noise)
    for key in ("batch_stats", "ema_batch_stats"):
        _assert_trees(got[key], want[key], key, atol=1e-5, rtol=1e-4)


def _val_posteriors(jt, pt, j_loader, p_loader):
    """Both students' strong and weak posteriors on a val loader."""
    jp, js = jt._eval_params()
    pp, ps = weights.export_train_model(pt.state.model)
    out = {"jax": [], "port": []}
    with jax.default_matmul_precision("float32"):
        for (jm, _, _, n), (pm, _, _, _) in zip(j_loader, p_loader):
            s, w = jt.predict(jp, js, jnp.asarray(jm))
            out["jax"].append((np.asarray(s)[:n], np.asarray(w)[:n]))
            s, w = pt.predict(pp, ps, pm)
            out["port"].append((s[:n].numpy(), w[:n].numpy()))
    return {k: tuple(np.concatenate(p) for p in zip(*v))
            for k, v in out.items()}


def _assert_scores_match(got, want, post, threshold=0.5, gate=2e-3):
    """Equal scores, or every binarized posterior that differs lies within
    ``gate`` of the threshold on both sides (strong and weak)."""
    if got == pytest.approx(want, abs=1e-12):
        return
    for a, b in zip(post["port"], post["jax"]):
        diff = (a > threshold) != (b > threshold)
        assert diff.any(), (got, want)
        dist = np.maximum(np.abs(a[diff] - threshold),
                          np.abs(b[diff] - threshold))
        assert dist.max() <= gate, (got, want, dist.max())


def test_fit_validation_scores_match_jax(fits):
    jt, pt = fits["jax"], fits["port"]
    post = _val_posteriors(jt, pt, jt.val_loader, pt.val_loader)
    for jr, pr in zip(jt.history, pt.history):
        val = [k for k in jr if k.startswith("val_")]
        assert val == ["val_weak_f1", "val_event_f1", "val_psds_f1"]
        _assert_scores_match({k: pr[k] for k in val},
                             {k: jr[k] for k in val}, post)


def test_evaluate_widened_heads_matches_jax(fits):
    """Trainer.evaluate on weights whose posteriors leave 0.5 (the widened
    heads of tests/test_torch_eval.py), on clips dense in events, so the
    scores are not zero."""
    jt, pt = fits["jax"], fits["port"]
    params, stats = init_params(pt.cfg, 0)
    for head in params["predictor"].values():
        head["kernel"] *= 30.0
    rng = np.random.default_rng(0)
    for blk in stats["encoder"]["cnn"].values():
        blk["bn"]["mean"] = rng.normal(0, 0.1, blk["bn"]["mean"].shape
                                       ).astype(np.float32)
        blk["bn"]["var"] = rng.uniform(0.5, 1.5, blk["bn"]["var"].shape
                                       ).astype(np.float32)
    jt.state = jt.state.replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    weights.load_train_model(pt.state.model, params, stats)
    j_val = JEvalLoader(JSynthetic(jt.cfg, n_items=10, seed=4,
                                   event_rate=0.3), batch_size=BS)
    p_val = EvalLoader(SyntheticDataSource(pt.cfg, n_items=10, seed=4,
                                           event_rate=0.3),
                       batch_size=BS, device="cpu")
    with jax.default_matmul_precision("float32"):
        want = jt.evaluate(j_val)
    got = pt.evaluate(p_val)
    assert list(got) == list(want)
    assert want["psds_f1"] > 0.0 and want["weak_f1"] > 0.0
    _assert_scores_match(got, want, _val_posteriors(jt, pt, j_val, p_val))


def test_results_tsv_and_meta_match_jax(fits):
    jdir, pdir = fits["root"] / "jax", fits["root"] / "port"
    j_lines = (jdir / "results.tsv").read_text().splitlines()
    p_lines = (pdir / "results.tsv").read_text().splitlines()
    assert p_lines[0] == j_lines[0]
    assert len(p_lines) == len(j_lines) == EPOCHS + 1
    header = p_lines[0].split("\t")
    for line, row in zip(p_lines[1:], fits["port"].history):
        fields = line.split("\t")
        assert len(fields) == len(header)
        assert [float(v) for v in fields] == pytest.approx(
            [float(row[k]) for k in header], rel=1e-15)
    assert json.loads((pdir / "model" / "meta.json").read_text()) == \
        json.loads((jdir / "model" / "meta.json").read_text())


def test_checkpoint_layout_matches_jax(fits):
    jdir, pdir = fits["root"] / "jax", fits["root"] / "port"
    assert sorted(os.listdir(pdir / "model")) == \
        sorted(os.listdir(jdir / "model")) == \
        ["best", "epoch_0", "epoch_1", "meta.json"]
    ours, theirs = CheckpointManager(str(pdir)), JCheckpoints(str(jdir))
    for tag in ("best", "epoch_0", "epoch_1", "epoch_2"):
        assert ours.has(tag) == theirs.has(tag) == (tag != "epoch_2")
    assert ours.latest_epoch() == theirs.latest_epoch() == EPOCHS - 1
    assert os.listdir(pdir / "model" / "best") == ["state.pt"]
    # what the port saved last is its final state, bit for bit
    saved = ours.load(f"epoch_{EPOCHS - 1}")
    final = dict(_leaves(fits["p_final"]))
    assert dict(_leaves(saved)).keys() == final.keys()
    for path, v in _leaves(saved):
        np.testing.assert_array_equal(v, final[path], err_msg=str(path))


def test_grad_flow_matches_jax(fits):
    """grad_flow metrics: JAX's names (flax path joined by dots, no bias
    leaves) and, per epoch, the mean |grad| at the gradient gate."""
    jt, pt = fits["jax"], fits["port"]
    for jr, pr in zip(jt.history, pt.history):
        j_keys = [k for k in jr if k.startswith("grad_abs/")]
        p_keys = [k for k in pr if k.startswith("grad_abs/")]
        assert sorted(p_keys) == sorted(j_keys)
        assert "grad_abs/encoder.cnn.block0.conv.kernel" in p_keys
        assert not [k for k in p_keys if "bias" in k]
        for k in j_keys:
            np.testing.assert_allclose(pr[k], jr[k], atol=3e-4, rtol=1e-4,
                                       err_msg=k)
    assert os.path.isfile(fits["root"] / "port" / "gradient_flow.png")


class _FakeWriter:
    purge_steps: list = []

    def __init__(self, log_dir, purge_step=None):
        _FakeWriter.purge_steps.append(purge_step)

    def add_scalar(self, *a, **k):
        pass


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """(b), (f), (g): an uninterrupted fit of 2 epochs of 2 steps (its
    first epoch profiled) against 1 epoch, then a fresh Trainer resuming
    at epoch 1; the two with TensorBoard on a fake writer."""
    root = tmp_path_factory.mktemp("resume")
    _FakeWriter.purge_steps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "summary_writer", _FakeWriter)
        whole = _port_trainer(root / "whole", n_syn=2 * BS,
                              profile_dir=str(root / "trace"))
        whole.fit(n_epochs=2)
        first = _port_trainer(root / "parts", n_syn=2 * BS,
                              use_tensorboard=True)
        first.fit(n_epochs=1)
        second = _port_trainer(root / "parts", n_syn=2 * BS,
                               use_tensorboard=True)
        second.fit(n_epochs=2, start_epoch=1)
    return {"whole": whole, "first": first, "second": second,
            "root": root, "purge_steps": list(_FakeWriter.purge_steps)}


def test_resume_is_exact(resumed):
    whole, second = resumed["whole"], resumed["second"]
    a = dict(_leaves(weights.export_train_state(whole.state)))
    b = dict(_leaves(weights.export_train_state(second.state)))
    assert a.keys() == b.keys()
    for path, v in a.items():
        np.testing.assert_array_equal(b[path], v, err_msg=str(path))
    assert whole.state.step == second.state.step == 2 * len(
        whole.train_loader)
    assert [r["epoch"] for r in second.history] == [1]
    assert second.history[0] == whole.history[1]
    assert resumed["first"].history[0] == whole.history[0]


def test_tensorboard_resume_passes_purge_step(resumed):
    """A resume constructs the writer with purge_step in STEP units
    (train scalars are step-indexed)."""
    assert resumed["purge_steps"] == [
        None, 1 * len(resumed["second"].train_loader)]


def test_profile_dir_writes_trace(resumed):
    traces = glob.glob(str(resumed["root"] / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1                       # the first epoch only
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_epoch_runner_matches_loop_path(tmp_path):
    """(c) On resident CPU tensors the epoch runner (``scan_epoch='auto'``)
    and the prefetching loop (``'off'``) see the same batches in the same
    order and end in the same state with the same metrics."""
    runner = _port_trainer(tmp_path / "runner", n_syn=2 * BS,
                           device_resident=True, scan_epoch="auto")
    loop = _port_trainer(tmp_path / "loop", n_syn=2 * BS,
                         device_resident=True, scan_epoch="off")
    arrays, idx = runner.train_loader.epoch_arrays(0)
    assert all(isinstance(v, torch.Tensor) for v in arrays.values())
    loop_batches = list(loop.train_loader.epoch(0))
    assert len(loop_batches) == len(idx["syn"]) == 2
    for i, want in enumerate(loop_batches):
        got = gather_batch(arrays, {k: v[i] for k, v in idx.items()})
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    calls = []
    runner._epoch_runner = None
    orig = steps.make_epoch_runner

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "make_epoch_runner", counting)
        runner.fit(n_epochs=1)
        loop.fit(n_epochs=1)
    assert calls == [1]                     # only the resident trainer
    assert runner.history == loop.history
    a = dict(_leaves(weights.export_train_state(runner.state)))
    for path, v in _leaves(weights.export_train_state(loop.state)):
        np.testing.assert_array_equal(a[path], v, err_msg=str(path))


@pytest.mark.parametrize("scan_epoch,resident", [("off", None),
                                                 ("auto", True)])
def test_epoch_meters_cover_every_step(tmp_path, scan_epoch, resident):
    """(d) The epoch averages cover EVERY step of a 12-step epoch (the
    reference's AverageMeterSet, main_baseline.py:188), across the host's
    fetch every 10 steps."""
    trainer = _port_trainer(tmp_path, n_syn=12 * BS,
                            device_resident=resident, scan_epoch=scan_epoch)
    trainer.val_loader = None
    sunk = []
    orig = trainer._sink_metrics
    trainer._sink_metrics = lambda m, s, b, f, l: (  # noqa: E731
        sunk.append((f, l)), orig(m, s, b, f, l))
    trainer.train_epoch(0)
    n = len(trainer.train_loader)
    assert n == 12 and trainer.state.step == 12
    assert sunk == ([(1, 10), (11, 12)] if scan_epoch == "off"
                    else [(1, 12)])
    for key in ("loss", "weak_class_loss", "strong_class_loss", "lr"):
        assert trainer.last_meters.meters[key].count == n, key


@pytest.mark.parametrize("bad", [float("nan"), 1e6])
def test_nan_guard_names_step_range(tmp_path, bad):
    """(e) A non-finite or exploded metric stops the epoch and names the
    fetch window it fell in."""
    trainer = _port_trainer(tmp_path, n_syn=12 * BS, scan_epoch="off")

    def fake_step(state, batch, seed, epoch):
        state.step += 1
        return {"lr": 1e-3, "loss": torch.tensor(
            bad if state.step == 11 else 0.5)}

    trainer.train_step = fake_step
    with pytest.raises(FloatingPointError,
                       match=r"Loss explosion in loss within steps 11\.\.12"):
        trainer.train_epoch(0)


def test_unsupported_preset_is_refused(tmp_path):
    """Configurations the train step cannot run yet fail in build_modules
    with their ROADMAP item, before anything is built."""
    cfg = get_config("baseline")
    syn, weak, unlab, _ = _sources(SyntheticDataSource, cfg, 2 * BS)
    loader = ThreeStreamLoader(syn, weak, unlab, batch_size=BS,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        trainer_mod.Trainer(cfg, loader, store_dir=str(tmp_path),
                            device="cpu")


def _meter_ops(seed):
    rng = np.random.default_rng(seed)
    return [(f"m{int(rng.integers(3))}", float(rng.normal()),
             int(rng.integers(1, 4))) for _ in range(40)]


@pytest.mark.parametrize("seed", range(4))
def test_meters_match_jax(seed):
    """(i) AverageMeterSet, SaveBest and EarlyStopping against bsed_tpu's
    on random sequences."""
    ops = _meter_ops(seed)
    ours, theirs = meters.AverageMeterSet(), j_meters.AverageMeterSet()
    for name, v, n in ops:
        ours.update(name, v, n)
        theirs.update(name, v, n)
    assert ours.averages() == theirs.averages()
    assert str(ours) == str(theirs)
    rng = np.random.default_rng(seed + 10)
    scores = rng.random(30).round(1)
    for compare in ("sup", "inf"):
        a, b = meters.SaveBest(compare), j_meters.SaveBest(compare)
        assert [a.apply(s, e) for e, s in enumerate(scores)] == \
            [b.apply(s, e) for e, s in enumerate(scores)]
        assert (a.best_val, a.best_epoch) == (b.best_val, b.best_epoch)
    a = meters.EarlyStopping(3, init_wait=5)
    b = j_meters.EarlyStopping(3, init_wait=5)
    assert [a.apply(s, e) for e, s in enumerate(scores)] == \
        [b.apply(s, e) for e, s in enumerate(scores)]


def test_profiling_helpers_match_jax(tmp_path):
    """StepTimer's summary keys and annotate's region, and plot_grad_flow
    (False without grad_abs entries, a PNG with them when matplotlib is
    present), as bsed_tpu's."""
    from bsed_tpu.utils import profiling as j_profiling

    from bsed_tpu_torch.utils import profiling

    timer = profiling.StepTimer()
    for _ in range(3):
        with timer, profiling.annotate("step"):
            torch.ones(4).sum()
    j_timer = j_profiling.StepTimer()
    with j_timer:
        pass
    assert timer.summary().keys() == j_timer.summary().keys()
    assert timer.summary()["steps"] == 3
    assert profiling.plot_grad_flow({"loss": 1.0}, str(tmp_path / "a.png")) \
        is j_profiling.plot_grad_flow({"loss": 1.0}, str(tmp_path / "b.png")) \
        is False
    metrics = {"grad_abs/encoder.cnn.block0.conv.kernel": 0.1,
               "grad_abs/predictor.dense.kernel": 0.2}
    drawn = profiling.plot_grad_flow(metrics, str(tmp_path / "c.png"))
    assert drawn == j_profiling.plot_grad_flow(metrics,
                                               str(tmp_path / "d.png"))
    assert os.path.isfile(tmp_path / "c.png") == drawn
