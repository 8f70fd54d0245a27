"""The port's TaggingTrainer (bsed_tpu_torch/train/tagging_trainer.py)
against ``bsed_tpu``'s on the CPU at ``SMALL_AUDIO`` (40 × 128), both
from the same trees (``tests/test_torch_tagger.jax_trainer``), the JAX
side under ``jax.default_matmul_precision("float32")``.

One step of ``bsed_tpu``'s jitted ``_train_step`` against the port's
``train_step`` on one batch of 4 SYN + 4 real clips, for ResNet, ResNet
with its mean teacher (JAX's SNR noise injected: ``k_noise`` of the
step's key, drawn as ``_train_step`` draws it) and VGG (JAX's keep mask
injected: read off ``k_drop``'s forward; it is the same for both student
forwards). Gates, those of tests/test_torch_train_step.py: the loss rel
1e-4; the gradients through Adam's first moment (mu = 0.1·g) at atol 3e-4
/ rtol 1e-4 on mu/0.1; BatchNorm running statistics of student and
teacher at 1e-5 absolute plus 1e-4 relative, leaf by leaf (they move
twice a step); params and EMA params at 1e-5; the Adam count.

The steps are held in float64 on both sides. In float32 the taggers'
ReLUs and max pools decide on float32 roundings: a step has ~2·10⁶ ReLU
inputs, and the two frameworks' activations differ by ~1e-6 relative,
so some inputs change sign between them. One such flip in ResNet's
layer4_block1.bn1 (32 positions a channel at this size) moved every
gradient below it by up to 25% (measured: the port's float32 gradient
against its own float64 one, 1.0e-3 absolute on
layer4_block1.conv1.kernel, max 0.015; JAX's float32 one against the
port's float64, 1.5e-3 on layer1_block0.conv2.kernel): rounding, not
wiring. In float64 the two agree within 1.2e-6 (both frameworks' BatchNorm
statistics stay float32, ``TorchBatchNorm``). That float32 residue
still reaches Adam's first step, which moves every element by ±lr
whatever its gradient's size, so params and EMA params get 2.2·lr where
|g| < 1e-5 (the allowance of tests/test_torch_da_units.py at ten times
its threshold). The float32 forwards and their statistics are held in
tests/test_torch_tagger.py. VGG's step takes 2 + 2 clips (XLA's float64
convs are slow on the CPU).

Then two steps of ``train_epoch`` in float64 (ResNet with the teacher, no
noise: no draw) at lr 1e-5: at 1e-3 the noise elements' ±lr steps of the
first step moved the second step's loss by 1.4e-4 relative (measured).
Its gradients are not held and its params only within two steps of
2.2·lr: the second step runs on params that differ by those steps, and
a ReLU decision moved layer1_block0.conv1's Adam moment by 5.4e-4 and
turned the second step of an element of layer1_block0.bn1.scale
(measured); the one-step tests hold gradients and params.
Then ``evaluate``'s macro F1 and the shared dropout mask of the two
student forwards."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsed_tpu.data.datasets import SyntheticDataSource as JSynthetic
from bsed_tpu.data.pipeline import EvalLoader as JEvalLoader

from bsed_tpu_torch.data.datasets import SyntheticDataSource
from bsed_tpu_torch.data.pipeline import EvalLoader
from bsed_tpu_torch.ops import dropout as dropout_mod
from bsed_tpu_torch.utils import weights

from tests.test_torch_tagger import (_random_stats, cfgs, jax_keep_mask,
                                     jax_trainer, np_tree, port_trainer,
                                     trees)
from tests.test_torch_train_step import _assert_trees
from tests.test_torch_trainer import one_torch_thread  # noqa: F401

BS = 4
LR = 1e-3
EPOCH_LR = 1e-5


def _batch(cfg, seed=5, strong=False, n=BS):
    rng = np.random.default_rng(seed)
    t_in, f = cfg.audio.max_frames, cfg.audio.n_mels
    syn_t = (rng.random((n, cfg.n_frames, cfg.nclass)) > 0.9).astype(
        np.float32)
    out = {"syn": np.abs(rng.standard_normal((n, t_in, f))).astype(
               np.float32),
           "real": np.abs(rng.standard_normal((n, t_in, f))).astype(
               np.float32),
           "real_weak": (rng.random((n, cfg.nclass)) > 0.7).astype(
               np.float32)}
    if strong:
        out["syn_strong"] = syn_t
    else:
        out["syn_weak"] = syn_t.max(axis=1)
    return out


def _port_trees(trainer):
    params, stats = weights.export_named(trainer.model)
    out = {"params": params, "batch_stats": stats}
    out.update(weights._export_opt(trainer.optimizer,
                                   weights.named_param_map(trainer.model)))
    if trainer.ema_model is not None:
        out["ema_params"], out["ema_batch_stats"] = weights.export_named(
            trainer.ema_model)
    return out


def _jax_trees(params, stats, opt_state, ema_params=None, ema_stats=None):
    adam = opt_state[0]
    out = {"params": np_tree(params), "batch_stats": np_tree(stats),
           "mu": np_tree(adam.mu), "nu": np_tree(adam.nu),
           "count": int(adam.count)}
    if ema_params is not None:
        out["ema_params"] = np_tree(ema_params)
        out["ema_batch_stats"] = np_tree(ema_stats)
    return out


def _assert_state(got, want, grads, noise):
    """The gates of the module docstring; ``grads`` the gradient tree."""
    assert got["count"] == want["count"]
    for key in ("batch_stats", "ema_batch_stats"):
        if key in want:
            _assert_trees(got[key], want[key], key, atol=1e-5, rtol=1e-4)
    small = jax.tree.map(lambda g: np.where(np.abs(g) < 1e-5, 0.0, 1.0),
                         grads)
    for key in ("params", "ema_params"):
        if key in want:
            _assert_trees(got[key], want[key], key, atol=1e-5, grads=small,
                          noise_bound=noise)


# (arch, mean teacher, clips a stream): XLA's float64 convs are slow on
# the CPU, and VGG's step costs ~14 s at 4 + 4 clips
STEP_CASES = {"resnet": ("resnet", False, BS),
              "resnet_mt": ("resnet", True, BS), "vgg": ("vgg", False, 2)}


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _port_f64(trainer):
    """The trainer's modules in float64 (the optimizer keeps its
    parameters: ``.double()`` converts them in place)."""
    trainer.model.double()
    if trainer.ema_model is not None:
        trainer.ema_model.double()
    return trainer


def _run_step(case):
    """(port trees, JAX trees, port loss, JAX loss) after one float64 step
    (inside ``jax.enable_x64``)."""
    arch, mean_teacher, n = STEP_CASES[case]
    cfg, jcfg = cfgs()
    params, stats = trees(cfg, arch, seed=1)
    batch = {k: v.astype(np.float64) for k, v in _batch(cfg, n=n).items()}
    jt = jax_trainer(jcfg, arch, _f64(params), _f64(stats), mean_teacher)
    rng = jax.random.key(7)
    k_noise, k_drop = jax.random.split(rng)
    new = jt._step(jt.params, jt.batch_stats, jt.opt_state,
                   {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                   jt.ema_params, jt.ema_batch_stats, jnp.asarray(0))
    draws = {}
    if mean_teacher:       # _train_step's draw (bsed_tpu/ops/augment.py)
        draws["noise"] = torch.from_numpy(np.array(jax.random.normal(
            k_noise, batch["real"].shape, jnp.float64)))
    if arch == "vgg":
        draws["keep"] = jax_keep_mask(
            jt.model, {"params": jt.params, "batch_stats": jt.batch_stats},
            n, k_drop)
    want = _jax_trees(new[0], new[1], new[2], new[4], new[5])
    pt = _port_f64(port_trainer(cfg, arch, params, stats, mean_teacher))
    loss = pt.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                         torch.Generator().manual_seed(0), draws)
    assert pt.step_count == 1
    return _port_trees(pt), want, float(loss), float(new[3])


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    """The step in float64 on both sides (see the module docstring for
    why): loss, gradients, params, statistics, EMA trees, count."""
    with jax.enable_x64(True):
        got, want, loss, j_loss = _run_step(case)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-4)
    grads = jax.tree.map(lambda m: m / 0.1, want["mu"])
    _assert_trees(jax.tree.map(lambda m: m / 0.1, got["mu"]), grads,
                  "gradient (mu/0.1)", atol=3e-4, rtol=1e-4)
    _assert_state(got, want, grads, 2.2 * LR)


def test_train_epoch_matches_jax():
    """Two steps of ``train_epoch`` in float64 at lr 1e-5 (ResNet, mean
    teacher, noise_snr None, strong SYN targets reduced by a max over
    time): the mean loss, the statistics and EMA statistics after (four
    and two updates), the params and EMA params within two steps."""
    cfg, jcfg = cfgs(noise_snr=None)
    params, stats = trees(cfg, "resnet", seed=2)
    batches = [{k: v.astype(np.float64) for k, v in
                _batch(cfg, seed=s, strong=True).items()} for s in (11, 12)]
    with jax.enable_x64(True):
        jt = jax_trainer(jcfg, "resnet", _f64(params), _f64(stats),
                         mean_teacher=True, lr=EPOCH_LR)
        j_loss = jt.train_epoch(batches, 0)
        want = _jax_trees(jt.params, jt.batch_stats, jt.opt_state,
                          jt.ema_params, jt.ema_batch_stats)
    pt = _port_f64(port_trainer(cfg, "resnet", params, stats,
                                mean_teacher=True, lr=EPOCH_LR))
    loss = pt.train_epoch(batches, 0)
    got = _port_trees(pt)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-4)
    assert pt.step_count == jt.step_count == 2
    # every element may take its second Adam step the other way (the
    # module docstring): params are held at two steps of 2.2·lr each
    _assert_state(got, want, jax.tree.map(np.zeros_like, want["mu"]),
                  4.4 * EPOCH_LR)


def test_evaluate_matches_jax():
    """Macro tagging F1 over a padded loader (10 clips in batches of 4,
    strong targets) equal to ``bsed_tpu``'s on the same weights; a
    posterior within 1e-4 of the threshold would make the decisions
    ambiguous, and the test names it instead of comparing."""
    cfg, jcfg = cfgs()
    params, stats = trees(cfg, "resnet", seed=3)
    stats = _random_stats(stats, 5)
    jt = jax_trainer(jcfg, "resnet", params, stats)
    pt = port_trainer(cfg, "resnet", params, stats)
    j_loader = JEvalLoader(JSynthetic(jcfg, n_items=10, seed=4),
                           batch_size=BS)
    loader = EvalLoader(SyntheticDataSource(cfg, n_items=10, seed=4),
                        batch_size=BS, device="cpu")
    with jax.default_matmul_precision("float32"):
        j_f1 = jt.evaluate(j_loader)
        j_post = np.concatenate([jt.predict_weak(mel)[:n]
                                 for mel, _, _, n in j_loader])
    post = np.concatenate([pt.predict_weak(mel)[:n]
                           for mel, _, _, n in loader])
    np.testing.assert_allclose(post, j_post, atol=1e-4)
    near = np.abs(j_post - 0.5) < 1e-4
    assert not near.any(), f"posteriors at the threshold: {j_post[near]}"
    f1 = pt.evaluate(loader)
    assert f1 == j_f1 and 0.0 < f1 < 1.0


@pytest.mark.parametrize("mean_teacher", [False, True],
                         ids=["student", "with_teacher"])
def test_student_forwards_share_dropout_mask(mean_teacher, monkeypatch):
    """``bsed_tpu``'s two student forwards use one dropout key, so VGG
    drops the same units on SYN and on real; the teacher's key is
    another. The port restarts the step's generator for the second
    student forward: the masks are equal, the teacher's differs."""
    cfg, _ = cfgs()
    masks = []
    draw = dropout_mod.keep_mask

    def recorded(*a, **k):
        masks.append(draw(*a, **k))
        return masks[-1]

    monkeypatch.setattr(dropout_mod, "keep_mask", recorded)
    pt = port_trainer(cfg, "vgg", *trees(cfg, "vgg"), mean_teacher)
    pt.train_step({k: torch.from_numpy(v) for k, v in _batch(cfg).items()},
                  torch.Generator().manual_seed(0))
    assert len(masks) == 2 + mean_teacher
    *teacher, syn, real = masks
    assert syn.shape == (BS, 4096) and torch.equal(syn, real)
    assert 0.3 < float(syn.float().mean()) < 0.7
    if teacher:
        assert not torch.equal(teacher[0], syn)
