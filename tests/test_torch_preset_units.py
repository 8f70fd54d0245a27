"""The modules the port's other presets add, against their JAX counterparts
on identical inputs: the ramps, ``entropy``, ICT ``mixup`` (an injected
draw, and the draws themselves), ``time_interp_matrix``,
``SmallChannelConv3x3``, SGD against optax over 3 steps, the SGD
checkpoint round trip and resume, which configurations
``build_modules`` accepts and refuses, and the forward order of every
lineage, the nine adaptation-stage runs included.

It also holds what the one-step preset tests share
(``tests/test_torch_presets_*.py``): the small configuration (2 s clips at
3.2 kHz, 16 mel bins, four narrow conv blocks, float32, dropout 0, no
teacher noise), the batch, the replayed ISP shifts and mixup draws, one
JAX step per case and the gates of ``tests/test_torch_train_step.py``:
metrics rel 1e-4; the gradient through the optimizer's first slot (Adam:
mu/0.1; SGD: the momentum trace after one step, g + wd·p) at atol 3e-4 /
rtol 1e-4; params and EMA params 1e-5 with its Adam-noise allowance (1.1·lr
where |g| < 1e-6); BatchNorm statistics 1e-5 + 1e-4 relative. The
adaptation-stage runs (``RUNS``, ``run_cfg``: the discriminator's dropout
0, clips of 13 s where a clip discriminator needs ≥ 63 frames) add the
replayed ADDA half-batch draws and the discriminator's and aux optimizers'
gates (``tests/test_torch_da_units.py``)."""
import argparse
import contextlib
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bsed_tpu.train.steps as j_steps
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.models.layers import SmallChannelConv3x3 as JSmallConv
from bsed_tpu.models.layers import time_interp_matrix as j_interp
from bsed_tpu.ops import augment as j_augment
from bsed_tpu.train import losses as j_losses
from bsed_tpu.train import ramps as j_ramps

import bsed_tpu_torch.train.steps as steps
from bsed_tpu_torch.config import AudioConfig, get_config, perf_config
from bsed_tpu_torch.models.layers import SmallChannelConv3x3, \
    time_interp_matrix
from bsed_tpu_torch.ops import augment
from bsed_tpu_torch.train import losses, ramps
from bsed_tpu_torch.train.state import make_optimizer
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.checkpoint import CheckpointManager

from tests.test_torch_train_step import _assert_trees, _leaves

BS = 4
EPOCH = 30.0
EXP_STEP = 200            # state step of the exp_step cases (cost ≈ 0.29)
STEPS_PER_EPOCH = 8
NARROW = dict(nb_filters=(16, 32, 64, 32),
              pooling=((2, 2), (2, 2), (1, 2), (1, 2)), n_rnn_cell=32)
PRESETS = ("baseline", "baseline_mt", "baseline_mt_isp", "baseline_ena",
           "baseline_fpn_mt_isp", "scmt", "scmt_ada", "scmt_ada_origin",
           "scmt_ada_weak", "sct_ada_weak", "pseudo_labeling", "origin")


# --- shared by the one-step preset tests ---------------------------------

def _small(cfg, audio_cls, folded=False, fused=False, narrow=True,
           model=()):
    """The test configuration of ``cfg``: see the module docstring;
    ``folded``/``fused`` select the folded train stem with the fused
    epilogue and fused streams (the --perf form in float32); ``model``:
    (field, value) pairs set on the model configuration last. The JAX
    GRU's scan is not unrolled (``rnn_unroll``, numerics-neutral): that
    halves each JAX step's compile."""
    cfg = cfg.replace(audio=audio_cls(sr=3200, hop_size=160,
                                      max_len_seconds=2.0, noise_snr=None,
                                      n_mels=16 if narrow else 128))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, folded_train_stem=folded,
                                  fused_stem_epilogue=True, dropout=0.0,
                                  rnn_unroll=1,
                                  **{**(NARROW if narrow else {}),
                                     **dict(model)}),
        train=dataclasses.replace(cfg.train, fused_streams=fused))


# the nine adaptation-stage runs: each DA mode and lineage bsed_tpu trains
RUNS = {"a": "baseline_adaptation", "b": "scmt_ada_weak_separate_2crnn",
        "c": "scmt_ada_weak_separate", "d": "pseudo_labeling",
        "e": "sct_ada_weak", "f": "scmt_ada", "g": "scmt", "h": "origin",
        "i": "scmt_ada_origin"}
CLIP_SECONDS = 13.0       # 260 input frames → 65 ≥ 63 output frames


def run_cfg(get, audio_cls, run, folded=False, fused=False, model=()):
    """Run ``run``'s preset in the adaptation stage, in ``_small``'s
    configuration (``model`` as there) with the discriminator's dropout
    0; a clip
    discriminator's five stride-2 VALID convs need ≥ 63 frames (the JAX
    one returns nan below that), so those runs take 13 s clips."""
    cfg = get(RUNS[run])
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                stage="adaptation"),
                      da=dataclasses.replace(cfg.da, disc_dropout=0.0))
    cfg = _small(cfg, audio_cls, folded, fused, model=model)
    if cfg.da.level == "clip" and cfg.da.mode in ("cdan", "adda"):
        cfg = cfg.replace(audio=dataclasses.replace(
            cfg.audio, max_len_seconds=CLIP_SECONDS))
    return cfg


def _n_real(cfg):
    """The real stream's rows: origin's combined batch is 2·BS (¼ weak,
    ½ unlabelled, ¼ strong), else BS."""
    return 2 * BS if cfg.train.isp_flavor == "origin" else BS


def _batch(cfg):
    rng = np.random.default_rng(5)
    t_in, f, nr = cfg.audio.max_frames, cfg.audio.n_mels, _n_real(cfg)

    def strong(n):
        return (rng.random((n, cfg.n_frames, cfg.nclass)) > 0.9).astype(
            np.float32)
    out = {"syn": np.abs(rng.standard_normal((BS, t_in, f))).astype(
               np.float32),
           "syn_strong": strong(BS),
           "real": np.abs(rng.standard_normal((nr, t_in, f))).astype(
               np.float32),
           "real_strong": strong(nr)}
    out["real_weak"] = np.maximum(
        out["real_strong"].max(axis=1),
        (rng.random((nr, cfg.nclass)) > 0.7)).astype(np.float32)
    return out


def _norm_stats(cfg):
    """A (mean, std) per mel bin near the batch's log-mel statistics."""
    rng = np.random.default_rng(9)
    f = cfg.audio.n_mels
    return (rng.normal(-5.0, 1.0, f).astype(np.float32),
            rng.uniform(3.0, 6.0, f).astype(np.float32))


def _shifts(n):
    """One step's ISP draws in the reference's order (time then freq)."""
    rr = random.Random(2023)
    t = [rr.randint(-32, 32) for _ in range(n)]
    f = [rr.randint(-4, 4) for _ in range(n)]
    return [s * 4 for s in t], t, f


_LAMS = (0.3, 0.72, 0.55)


def _mix_draw(i, n):
    """The i-th mixup call's (λ, permutation of n rows), i modulo 3: the
    JAX step traces its three calls once, the port calls them every
    step."""
    return _LAMS[i % 3], np.random.default_rng(100 + i % 3).permutation(n)


@contextlib.contextmanager
def _replayed_draws(n_shift):
    """Both packages' steps take the same ISP shifts and mixup draws."""
    t_sh, p_sh, f_sh = _shifts(n_shift)
    calls = {"jax": 0, "port": 0}

    def j_mixup(rng, x, *targets, alpha=1.0):
        lam, perm = _mix_draw(calls["jax"], x.shape[0])
        calls["jax"] += 1
        lam = jnp.float32(lam)
        mixed = tuple(lam * a + (1.0 - lam) * a[perm]
                      for a in (x,) + targets)
        return (*mixed, lam)

    def p_mixup(gen, x, *targets, alpha=1.0, rng=None):
        lam, perm = _mix_draw(calls["port"], x.shape[0])
        calls["port"] += 1
        return augment.mixup(gen, x, *targets, lam=lam,
                             perm=torch.from_numpy(perm))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_steps, "sample_isp_shifts", lambda *a, **k: tuple(
            jnp.asarray(s, jnp.int32) for s in (t_sh, p_sh, f_sh)))
        mp.setattr(steps, "sample_isp_shifts", lambda *a, **k: tuple(
            torch.tensor(s) for s in (t_sh, p_sh, f_sh)))
        mp.setattr(j_steps, "mixup", j_mixup)
        mp.setattr(steps, "mixup", p_mixup)
        yield calls


def _start_step(cfg):
    return EXP_STEP if cfg.train.cost_ramp == "exp_step" else 0


def spread_crnn_head(state):
    """At its init the 'crnn' head's posteriors are 0.5 within ~1e-5, so
    the consistency MSEs between student and teacher (~1e-10) are float32
    cancellation noise, which a relative gate cannot hold (measured:
    consistency_weak 1.5e-3 apart). The bias of the head's last GLU is
    spread, N(0, 4), in the student and the teacher (other seeds), so the
    posteriors leave 0.5 and differ; other heads pass unchanged."""
    if "crnn_pred" not in state.params["predictor"]:
        return state

    def spread(params, seed):
        if params is None:
            return None
        head = params["predictor"]["crnn_pred"]
        glu = head["cnn"]["block4"]["GLU_0"]["linear"]
        bias = np.random.default_rng(seed).normal(
            0.0, 4.0, glu["bias"].shape).astype(np.float32)
        block4 = dict(head["cnn"]["block4"],
                      GLU_0={"linear": dict(glu, bias=jnp.asarray(bias))})
        head = dict(head, cnn=dict(head["cnn"], block4=block4))
        return dict(params, predictor=dict(params["predictor"],
                                           crnn_pred=head))
    return state.replace(params=spread(state.params, 1),
                         ema_params=spread(state.ema_params, 2))


def jax_step(preset, folded=False, fused=False, narrow=True, model=()):
    """(trees before, trees after, metrics) of one JAX step of ``preset``
    in the test configuration; callers cache it per file."""
    cfg = _small(j_get_config(preset), JAudioConfig, folded, fused, narrow,
                 model)
    ns = _norm_stats(cfg) if cfg.train.normalize else None
    modules = j_steps.build_modules(cfg, norm_stats=ns)
    state = jax.jit(lambda k: j_steps.create_train_state(cfg, modules, k))(
        jax.random.key(3))
    state = spread_crnn_head(state.replace(
        step=jnp.asarray(_start_step(cfg), jnp.int32)))
    before = weights.trees_from_jax_state(state)
    with _replayed_draws(_n_real(cfg)) as calls, \
            jax.default_matmul_precision("float32"):
        step = j_steps.make_train_step(modules,
                                       steps_per_epoch=STEPS_PER_EPOCH)
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        new, metrics = step(state, batch, jax.random.key(1),
                            jnp.asarray(EPOCH, jnp.float32))
        after = weights.trees_from_jax_state(new)
        n_mix = calls["jax"]
    return before, after, {k: float(v) for k, v in metrics.items()}, n_mix


def port_step(preset, before, folded=False, fused=False, narrow=True,
              model=()):
    """(trees after, metrics, mixup calls) of the port's step from the JAX
    initial trees."""
    cfg = _small(get_config(preset), AudioConfig, folded, fused, narrow,
                 model)
    ns = _norm_stats(cfg) if cfg.train.normalize else None
    modules = steps.build_modules(cfg, device="cpu", norm_stats=ns)
    state = steps.load_train_state(modules, before)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with _replayed_draws(_n_real(cfg)) as calls:
        metrics = steps.make_train_step(
            modules, steps_per_epoch=STEPS_PER_EPOCH)(state, batch, 1, EPOCH)
    return weights.export_train_state(state), metrics, calls["port"]


def assert_step_matches(jax_result, port_result, cfg, adam_noise=1.1,
                        structural_zero=None):
    """The gates of the module docstring; ``adam_noise``: the Adam-noise
    allowance in units of lr (2.2 where noise gradients were measured
    stepping with opposite signs on the two sides); ``structural_zero``:
    a predicate on a leaf's path that gives the allowance to the whole
    leaf, whatever its |g| (a conv bias that feeds a BatchNorm, whose
    exact gradient is 0)."""
    before, after, j_metrics, j_mix = jax_result
    got, metrics, p_mix = port_result
    assert p_mix == j_mix
    assert got["step"] == after["step"] == before["step"] + 1
    assert metrics.keys() == j_metrics.keys()
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4,
                                   err_msg=k)
    if cfg.train.optimizer == "sgd":
        grads, got_g = after["trace"], got["trace"]
        noise = 0.0
    else:
        assert got["count"] == after["count"] == 1
        grads = jax.tree.map(lambda m: m / 0.1, after["mu"])
        got_g = jax.tree.map(lambda m: m / 0.1, got["mu"])
        noise = adam_noise * j_metrics["lr"]
    _assert_trees(got_g, grads, "gradient", atol=3e-4, rtol=1e-4)
    if structural_zero is not None:
        grads = _zero_leaves(grads, structural_zero)
    keys = ["params"] + (["ema_params"] if cfg.train.mean_teacher else [])
    for key in keys:
        _assert_trees(got[key], after[key], key, atol=1e-5, grads=grads,
                      noise_bound=noise)
    stat_keys = ["batch_stats"] + (["ema_batch_stats"]
                                   if cfg.train.mean_teacher else [])
    for key in stat_keys:
        _assert_trees(got[key], after[key], key, atol=1e-5, rtol=1e-4)
    if not cfg.train.mean_teacher:
        assert got["ema_params"] is None and after["ema_params"] is None


def _zero_leaves(tree, pred, prefix=()):
    """``tree`` with the leaves whose path satisfies ``pred`` zeroed."""
    if isinstance(tree, dict):
        return {k: _zero_leaves(v, pred, prefix + (k,))
                for k, v in tree.items()}
    return np.zeros_like(tree) if pred(prefix) else tree


# --- units ---------------------------------------------------------------

@pytest.mark.parametrize("current", [0.0, 7.0, 25.0, 50.0, 80.0])
def test_ramps_match_jax(current):
    for name in ("exp_rampup", "sigmoid_rampup", "sigmoid_rampdown"):
        np.testing.assert_allclose(
            getattr(ramps, name)(current, 50),
            float(getattr(j_ramps, name)(current, 50)), rtol=1e-6,
            err_msg=name)
        assert getattr(ramps, name)(current, 0) == 1.0
    np.testing.assert_allclose(ramps.cosine_rampdown(current, 80),
                               float(j_ramps.cosine_rampdown(current, 80)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_entropy_matches_jax(reduction):
    p = np.random.default_rng(2).dirichlet(np.ones(20), size=(6, 9)).astype(
        np.float32)
    np.testing.assert_allclose(
        losses.entropy(torch.from_numpy(p), reduction).numpy(),
        np.asarray(j_losses.entropy(jnp.asarray(p), reduction)),
        rtol=1e-6, atol=1e-6)


def test_mixup_with_injected_draw_matches_jax():
    """JAX's mixup draws λ and the permutation from its key; the port's,
    given those two, returns the same mixes and λ."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 40, 16, 1)).astype(np.float32)
    ys = rng.random((6, 10, 20)).astype(np.float32)
    yw = rng.random((6, 20)).astype(np.float32)
    key = jax.random.key(4)
    want = j_augment.mixup(key, jnp.asarray(x), jnp.asarray(ys),
                           jnp.asarray(yw), alpha=2.0)
    perm = np.array(jax.random.permutation(jax.random.split(key)[1], 6))
    got = augment.mixup(None, torch.from_numpy(x), torch.from_numpy(ys),
                        torch.from_numpy(yw), lam=float(want[-1]),
                        perm=torch.from_numpy(perm))
    assert len(got) == len(want) == 4
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert got[3] == float(np.float32(want[3]))


def test_mixup_draws():
    """λ from the numpy generator (Beta(α, α); 1 at α = 0), the
    permutation from the torch generator; the same seeds, the same
    draws."""
    x = torch.arange(8.0)[:, None]

    def draw(alpha):
        return augment.mixup(torch.Generator().manual_seed(1), x,
                             alpha=alpha, rng=np.random.default_rng(2))
    (mx1, lam1), (mx2, lam2) = draw(1.0), draw(1.0)
    assert lam1 == lam2 and 0.0 < lam1 < 1.0 and torch.equal(mx1, mx2)
    perm = torch.randperm(8, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(mx1, lam1 * x + (1 - lam1) * x[perm])
    assert draw(0.0)[1] == 1.0
    lams = [augment.mixup(None, x, alpha=2.0, rng=np.random.default_rng(s),
                          perm=torch.arange(8))[1] for s in range(400)]
    assert abs(np.mean(lams) - 0.5) < 0.03          # Beta(2, 2): mean ½


@pytest.mark.parametrize("in_len,out_len", [(78, 156), (156, 313),
                                            (2, 5), (5, 10), (1, 3), (4, 1)])
def test_time_interp_matrix_matches_jax(in_len, out_len):
    got = time_interp_matrix(in_len, out_len)
    assert got.dtype == torch.float32 and got.shape == (out_len, in_len)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_interp(in_len, out_len)))


@pytest.mark.parametrize("cin", [1, 16])
def test_small_channel_conv_matches_jax(cin):
    x = np.random.default_rng(cin).standard_normal(
        (2, 12, 9, cin)).astype(np.float32)
    mod = JSmallConv(8)
    params = mod.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": jax.random.normal(jax.random.key(1), (8,))}
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    conv = SmallChannelConv3x3(cin, 8)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(weights.conv_weight(
            params["kernel"])))
        conv.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    got = conv(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the same map as nn.Conv2d with these parameters (ConvBlock's conv)
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), conv.weight, conv.bias,
        padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref.detach().numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sgd_matches_optax_over_three_steps():
    """The port's SGD (Nesterov momentum 0.9, weight decay 1e-4) against
    bsed_tpu's ``_base_optimizer``: params and the momentum trace, with
    the lr set per step on both sides."""
    cfg = get_config("scmt_ada_weak")
    jcfg = j_get_config("scmt_ada_weak")
    assert cfg.train.optimizer == jcfg.train.optimizer == "sgd"
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [rng.standard_normal((7, 5)).astype(np.float32) for _ in range(3)]
    opt = j_steps._base_optimizer(jcfg)
    params = {"w": jnp.asarray(p0)}
    st = opt.init(params)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = make_optimizer(cfg, [pt])
    assert isinstance(topt, torch.optim.SGD)
    for i, g in enumerate(grads):
        lr = 5e-4 * (i + 1)
        st.hyperparams["learning_rate"] = lr
        upd, st = opt.update({"w": jnp.asarray(g)}, st, params)
        params = optax.apply_updates(params, upd)
        topt.param_groups[0]["lr"] = lr
        pt.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(pt.detach().numpy(),
                                   np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(
            topt.state[pt]["momentum_buffer"].numpy(),
            np.asarray(st.inner_state[1][0].trace["w"]), rtol=1e-6,
            atol=1e-7)


def _sgd_cfg():
    return _small(get_config("scmt_ada_weak"), AudioConfig)


def test_sgd_checkpoint_round_trip_and_resume(tmp_path):
    """An SGD state's checkpoint holds the momentum trace and restores it
    bit for bit; a restored state's next step equals the live one's."""
    cfg = _sgd_cfg()
    modules = steps.build_modules(cfg, device="cpu")
    step = steps.make_train_step(modules)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    live = steps.create_train_state(cfg, modules, 0)
    step(live, batch, 1, EPOCH)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("epoch_0", live)
    saved = ckpt.load("epoch_0")
    assert "trace" in saved and "mu" not in saved
    assert float(np.abs(saved["trace"]["encoder"]["rnn"]["weight_ih_l0"])
                 .max()) > 0
    restored = ckpt.restore("epoch_0",
                            steps.create_train_state(cfg, modules, 7))
    a = dict(_leaves(weights.export_train_state(live)))
    b = dict(_leaves(weights.export_train_state(restored)))
    assert a.keys() == b.keys()
    for path, v in a.items():
        np.testing.assert_array_equal(b[path], v, err_msg=str(path))
    m_live = step(live, batch, 1, EPOCH)
    m_restored = step(restored, batch, 1, EPOCH)
    assert {k: float(v) for k, v in m_live.items()} == \
        {k: float(v) for k, v in m_restored.items()}
    a = dict(_leaves(weights.export_train_state(live)))
    for path, v in _leaves(weights.export_train_state(restored)):
        np.testing.assert_array_equal(a[path], v, err_msg=str(path))


def test_sgd_state_carries_from_jax():
    """trees_from_jax_state reads SGD's trace; the port loads it as the
    momentum buffer and exports it back unchanged."""
    cfg = _sgd_cfg()
    jcfg = _small(j_get_config("scmt_ada_weak"), JAudioConfig)
    jmod = j_steps.build_modules(jcfg)
    state = jax.jit(lambda k: j_steps.create_train_state(jcfg, jmod, k))(
        jax.random.key(0))
    trace = jax.tree.map(lambda p: p * 0.5 + 1.0, state.params)
    opt_state = state.opt_state._replace(inner_state=(
        state.opt_state.inner_state[0],
        (state.opt_state.inner_state[1][0]._replace(trace=trace),)
        + tuple(state.opt_state.inner_state[1][1:])))
    trees = weights.trees_from_jax_state(state.replace(opt_state=opt_state))
    assert "mu" not in trees
    port = steps.load_train_state(steps.build_modules(cfg, device="cpu"),
                                  trees)
    got = weights.export_train_state(port)
    for path, v in _leaves(trees["trace"]):
        np.testing.assert_array_equal(dict(_leaves(got["trace"]))[path], v)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("perf", [False, True])
def test_build_modules_accepts_pretrain_presets(preset, perf):
    cfg = get_config(preset)
    assert cfg.train.stage == "pretrain"
    if perf:
        cfg = perf_config(cfg)
        if cfg.model.use_fpn:
            # bsed_tpu's make_folded_encoder_fwd refuses it the same way
            with pytest.raises(ValueError, match="not foldable"):
                steps.build_modules(cfg, device="cpu")
            jcfg = j_get_config(preset)
            jcfg = jcfg.replace(model=dataclasses.replace(
                jcfg.model, folded_train_stem=True))
            with pytest.raises(ValueError, match="not foldable"):
                j_steps.make_folded_encoder_fwd(jcfg)
            return
    assert steps.build_modules(cfg, device="cpu").cfg is cfg


@pytest.mark.parametrize("case,item", [
    ("baseline_adaptation", "8b"), ("scmt_ada_weak_separate", "8b"),
    ("crnn_head", "8c"), ("recurrent_dropout", "8c")])
def test_build_modules_refuses_naming_its_item(case, item):
    """What ``build_modules`` refused until its ROADMAP item was ported is
    now accepted and built: item 8b's adaptation presets with their
    discriminator, item 8c's 'crnn' head (with its BatchNorm statistics in
    the train state) and recurrent dropout (in the GRUs' training
    forward)."""
    if item == "8b":
        cfg = get_config(case)
        assert cfg.train.stage == "adaptation" and cfg.da.mode != "none"
        modules = steps.build_modules(cfg, device="cpu")
        assert modules.cfg is cfg
        assert modules.make_discriminator() is not None
        return
    if case == "crnn_head":
        cfg = get_config("baseline_mt")
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    predictor_head="crnn"))
    elif case == "recurrent_dropout":
        cfg = get_config("baseline_mt_isp")
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    dropout_recurrent=0.2))
    modules = steps.build_modules(cfg, device="cpu")
    assert modules.cfg is cfg
    model = modules.make_model()
    if case == "crnn_head":
        head = model.predictor.crnn_pred
        assert head.dense_softmax.in_features == cfg.nclass
        assert any(path[0] == "predictor"
                   for path, _ in weights.train_stat_map(model))
    else:
        assert model.encoder.rnn.dropout.rate == 0.2
        assert len(model.encoder.rnn._layers) == cfg.model.n_layers_rnn


def test_cli_flags_reach_the_step():
    """-fpn, -mt, -ISP and --stage pretrain through the port's CLI flags
    give a configuration the step accepts, equal to bsed_tpu's."""
    from bsed_tpu.cli import _apply_flags as j_apply
    from bsed_tpu.config import config_to_dict as j_to_dict

    from bsed_tpu_torch.cli import _apply_flags
    from bsed_tpu_torch.config import config_to_dict

    args = argparse.Namespace(perf=False, tiny_audio=True, use_fpn=True,
                              meanteacher=True, isp=True, stage="pretrain",
                              level=None)
    got = _apply_flags(get_config("baseline"), args)
    assert config_to_dict(got) == j_to_dict(j_apply(j_get_config("baseline"),
                                                    args))
    assert got.model.use_fpn and got.train.mean_teacher and got.train.isp
    steps.build_modules(got, device="cpu")


# bsed_tpu's forward order per lineage (teacher, then student): the order
# in which the BatchNorm statistics advance (steps.py:712-737, 751, 797-918,
# 1005-1077). The one-step tests see it only through the last forwards'
# statistics (momentum 0.01 leaves 1e-4 of a batch's statistics two
# forwards later), so the order is checked here directly.
FORWARD_ORDER = {
    "baseline": ([], ["syn", "real"]),
    "baseline_mt_isp": (["real", "real_shift", "real_freq"],
                        ["syn", "real", "real_shift", "real_freq",
                         "syn_shift", "syn_freq"]),
    "sct_ada_weak": (["real", "real_shift", "real_freq"],
                     ["syn", "real", "real_freq", "real_shift", "syn_shift",
                      "syn_freq"]),
    "scmt": (["real", "real_shift", "real_freq"],
             ["syn", "real", "syn_shift", "syn_freq"]),
    "origin": (["real", "real_unlabelled"],
               ["real", "real_shift", "real_freq", "mixup 2 rows",
                "mixup 2 rows", "mixup 4 rows"]),
    # the adaptation stage (key "<run>-<preset>", RUNS): the GRL pre-step's
    # syn then real forwards, or ADDA's real then syn (discriminator step)
    # then its confusion forward, precede the main step's; a joint domain
    # loss reads the main forwards (steps.py:438-443, 516-593, 661-668)
    "a-baseline_adaptation": (
        ["real", "real_shift", "real_freq"],
        ["syn", "real", "syn", "real", "real_shift", "real_freq",
         "syn_shift", "syn_freq"]),
    "b-scmt_ada_weak_separate_2crnn": (["real"],
                                       ["syn", "real", "syn", "real"]),
    "c-scmt_ada_weak_separate": (["real"], ["syn", "real"]),
    "d-pseudo_labeling": (["real"], ["syn", "real"]),
    "e-sct_ada_weak": (["real", "real_shift", "real_freq"],
                       ["syn", "real", "real_freq", "real_shift",
                        "syn_shift", "syn_freq"]),
    "f-scmt_ada": (["real"], ["syn", "real", "syn", "real"]),
    "g-scmt": (["real", "real_shift", "real_freq"],
               ["real", "syn", "real", "syn", "real", "syn_shift",
                "syn_freq"]),
    "h-origin": (["real", "real_unlabelled"],
                 ["real", "syn", "real", "real", "real_shift", "real_freq",
                  "mixup 2 rows", "mixup 2 rows", "mixup 4 rows"]),
    "i-scmt_ada_origin": (["real", "real_shift", "real_freq"],
                          ["real", "syn", "syn", "syn", "real", "syn_shift",
                           "syn_freq"]),
}


def _order_cfg(key):
    if "-" in key:
        return run_cfg(get_config, AudioConfig, key.split("-")[0])
    return _small(get_config(key), AudioConfig)


@pytest.mark.parametrize("preset", sorted(FORWARD_ORDER))
def test_forward_order_matches_bsed_tpu(preset, monkeypatch):
    """Which stream each forward of one step takes, in order, told apart
    by its input (the replayed shifts make every stream distinct)."""
    cfg = _order_cfg(preset)
    ns = _norm_stats(cfg) if cfg.train.normalize else None
    modules = steps.build_modules(cfg, device="cpu", norm_stats=ns)
    state = steps.create_train_state(cfg, modules, 0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}

    def inp(lin):
        x = steps._log_input(lin)
        if ns is not None:
            x = (x - torch.from_numpy(ns[0])[:, None]) / \
                torch.from_numpy(ns[1])[:, None]
        return x
    t_sh, _, f_sh = (torch.tensor(s) for s in _shifts(_n_real(cfg)))
    syn, real = inp(batch["syn"]), inp(batch["real"])
    b = real.shape[0]
    named = {"syn": syn, "real": real,
             "real_shift": augment.roll_batch(real, t_sh, 1),
             "real_freq": augment.roll_batch(real, f_sh, 2),
             "real_unlabelled": real[b // 4: 3 * b // 4]}
    if cfg.train.isp_flavor != "origin":
        named.update(syn_shift=augment.roll_batch(syn, t_sh, 1),
                     syn_freq=augment.roll_batch(syn, f_sh, 2))
    seen = {"teacher": [], "student": []}
    forward = steps.TrainModel.forward

    def spy(model, x, gen=None):
        who = "teacher" if model is state.ema_model else "student"
        name = next((k for k, v in named.items()
                     if v.shape == x.shape and torch.equal(v, x)),
                    f"mixup {x.shape[0]} rows")
        seen[who].append(name)
        return forward(model, x, gen)

    monkeypatch.setattr(steps.TrainModel, "forward", spy)
    with _replayed_draws(_n_real(cfg)):
        steps.make_train_step(modules, steps_per_epoch=STEPS_PER_EPOCH)(
            state, batch, 1, EPOCH)
    assert (seen["teacher"], seen["student"]) == FORWARD_ORDER[preset]
