"""The train slice's building blocks in the port against their JAX
counterparts on identical inputs: dropout, augmentation, pooling gradient,
losses, ramps and lr, EMA, Adam, ``perf_config`` and the train-form folded
stem (BatchNorm statistics and gradients). Random draws are injected where
the two frameworks' generators differ."""
import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bsed_tpu.cli import _apply_flags
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import config_to_dict as j_config_to_dict
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.ops import augment as j_augment
from bsed_tpu.ops import dropout as j_dropout
from bsed_tpu.ops.pooling import fast_avg_pool as j_fast_avg_pool
from bsed_tpu.train import ema as j_ema
from bsed_tpu.train import losses as j_losses
from bsed_tpu.train import ramps as j_ramps
from bsed_tpu.train import schedule as j_schedule
from bsed_tpu.train import steps as j_steps

from bsed_tpu_torch.config import (AudioConfig, config_to_dict, get_config,
                                   perf_config)
from bsed_tpu_torch.ops import augment, dropout
from bsed_tpu_torch.ops.pooling import fast_avg_pool
from bsed_tpu_torch.train import ema, losses, ramps, schedule, steps
from bsed_tpu_torch.utils import weights


@pytest.mark.parametrize("rate", [0.5, 0.25, 0.3, 0.0])
def test_u8_threshold_matches_jax(rate):
    assert dropout._u8_threshold(1.0 - rate) == \
        j_dropout._u8_threshold(1.0 - rate)


def test_fast_dropout_keep_rate_and_scale():
    """P(keep) = k/256 = 0.5 and kept values ×2; identity in eval mode and
    at rate 0; the same generator state gives the same mask."""
    x = torch.rand((64, 1024)) + 0.5
    layer = dropout.FastDropout(0.5)
    y = layer(x, torch.Generator().manual_seed(0))
    kept = y != 0
    frac = float(kept.float().mean())
    assert abs(frac - 0.5) < 0.01                    # 65536 Bernoulli draws
    torch.testing.assert_close(y[kept], 2 * x[kept], rtol=0, atol=0)
    torch.testing.assert_close(layer(x, torch.Generator().manual_seed(0)), y)
    assert layer.eval()(x) is x
    assert dropout.FastDropout(0.0).train()(x) is x


@pytest.mark.parametrize("axis", [1, 2])
def test_roll_batch_matches_jax(axis):
    x = np.random.default_rng(0).standard_normal((3, 9, 7, 1)).astype(
        np.float32)
    shifts = np.array([-12, 0, 5], np.int32)
    want = np.asarray(j_augment.roll_batch(jnp.asarray(x),
                                           jnp.asarray(shifts), axis))
    got = augment.roll_batch(torch.from_numpy(x), torch.from_numpy(shifts),
                             axis).numpy()
    np.testing.assert_array_equal(got, want)


def test_gaussian_snr_noise_matches_jax_with_its_draw():
    x = np.abs(np.random.default_rng(1).standard_normal((2, 41, 16))).astype(
        np.float32)
    key = jax.random.key(4)
    want = np.asarray(j_augment.gaussian_snr_noise(key, jnp.asarray(x), 30.0))
    normal = np.array(jax.random.normal(key, x.shape, jnp.float32))
    got = augment.gaussian_snr_noise(None, torch.from_numpy(x), 30.0,
                                     normal=torch.from_numpy(normal))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    xt = torch.from_numpy(x)
    assert augment.gaussian_snr_noise(None, xt, None) is xt


def test_isp_shift_ranges():
    gen = torch.Generator().manual_seed(0)
    t, p, f = augment.sample_isp_shifts(gen, 4000, 64, 4, 4)
    torch.testing.assert_close(t, p * 4)
    assert int(p.min()) == -64 and int(p.max()) == 64
    assert int(f.min()) == -4 and int(f.max()) == 4


@pytest.mark.parametrize("window", [(2, 2), (2, 1), (1, 2)])
def test_fast_avg_pool_gradient_matches_jax(window):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 21, 9, 3)).astype(np.float32)
    out_shape = (2, 21 // window[0], 9 // window[1], 3)
    cot = rng.standard_normal(out_shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        j_fast_avg_pool(a, window) * cot))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (fast_avg_pool(xt, window) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    p = rng.random((4, 10, 20)).astype(np.float32)
    p[0, 0, :3] = [0.0, 1.0, 1e-30]                # the −100 clamp
    y = (rng.random((4, 10, 20)) > 0.7).astype(np.float32)
    q = rng.random((4, 10, 20)).astype(np.float32)
    pt, yt, qt = (torch.from_numpy(a) for a in (p, y, q))
    np.testing.assert_allclose(float(losses.bce(pt, yt)),
                               float(j_losses.bce(p, y)), rtol=1e-6)
    np.testing.assert_allclose(float(losses.mse(pt, qt)),
                               float(j_losses.mse(p, q)), rtol=1e-6)


@pytest.mark.parametrize("epoch", [0, 7.5, 29, 30, 100, 101, 121, 160])
def test_lr_and_ramps_match_jax(epoch):
    np.testing.assert_allclose(
        schedule.learning_rate(epoch, 1e-3, True, 30),
        float(j_schedule.learning_rate(epoch, 1e-3, True, 30)), rtol=1e-6)
    assert schedule.learning_rate(epoch, 5e-4, False) == 5e-4
    np.testing.assert_allclose(ramps.sigmoid_rampdown(epoch, 30),
                               float(j_ramps.sigmoid_rampdown(epoch, 30)),
                               rtol=1e-6)


@pytest.mark.parametrize("step", [1, 5000])
def test_ema_update_matches_jax(step):
    rng = np.random.default_rng(step)
    e, s = (rng.standard_normal((5, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(j_ema.ema_update({"a": e}, {"a": s}, step, 0.999)["a"])
    et = torch.from_numpy(e.copy())
    ema.ema_update([et], [torch.from_numpy(s)], step, 0.999)
    np.testing.assert_allclose(et.numpy(), want, rtol=1e-6, atol=1e-7)
    if step == 1:
        np.testing.assert_allclose(et.numpy(), 0.5 * (e + s), rtol=1e-6)


def test_adam_matches_optax_inject_hyperparams():
    """torch.optim.Adam with the lr set per step, as the port's step does,
    against optax.inject_hyperparams(optax.adam) on the same gradients."""
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [rng.standard_normal((7, 5)).astype(np.float32) * 10 ** -i
             for i in range(4)]
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    params, st = jnp.asarray(p0), None
    st = opt.init(params)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.Adam([pt], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for i, g in enumerate(grads):
        lr = 1e-3 * (i + 1) / 4
        st.hyperparams["learning_rate"] = lr
        upd, st = opt.update(jnp.asarray(g), st, params)
        params = optax.apply_updates(params, upd)
        topt.param_groups[0]["lr"] = lr
        pt.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(params),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(topt.state[pt]["exp_avg"].numpy(),
                               np.asarray(st.inner_state[0].mu), rtol=1e-6,
                               atol=1e-9)


def test_perf_config_is_the_cli_perf_flag():
    args = argparse.Namespace(perf=True, tiny_audio=False, use_fpn=False,
                              meanteacher=False, isp=False, stage=None,
                              level=None)
    want = _apply_flags(j_get_config("baseline_mt_isp"), args)
    got = perf_config(get_config("baseline_mt_isp"))
    assert config_to_dict(got) == j_config_to_dict(want)


def test_unsupported_step_options_raise():
    """What the train step refuses: origin's masked batch with a joint GRL
    domain loss (DANN here), with bsed_tpu's ValueError
    (steps.py:377-386)."""
    origin = get_config("origin")
    joint_dann = origin.replace(
        train=dataclasses.replace(origin.train, stage="adaptation"),
        da=dataclasses.replace(origin.da, mode="dann", joint_backward=True))
    with pytest.raises(ValueError, match="isp_flavor='origin' is "
                                         "incompatible with da.joint"):
        steps.build_modules(joint_dann, device="cpu")


# --- the train-form folded stem against make_folded_encoder_fwd ----------

def _enc_cfg(mod, audio_cls, fused):
    cfg = mod("baseline").replace(audio=audio_cls(sr=3200, hop_size=160,
                                                  max_len_seconds=2.0))
    return cfg.replace(model=dataclasses.replace(
        cfg.model, dropout=0.0, folded_train_stem=True,
        fused_stem_epilogue=fused))


@functools.lru_cache(maxsize=None)
def _jax_encoder(fused):
    """(params, stats, x, out, new stats, grads) of the JAX folded encoder,
    once per configuration in this file."""
    cfg = _enc_cfg(j_get_config, JAudioConfig, fused)
    modules = j_steps.build_modules(cfg)
    state = jax.jit(lambda k: j_steps.create_train_state(cfg, modules, k))(
        jax.random.key(0))
    fwd = j_steps.make_folded_encoder_fwd(cfg)
    x = np.random.default_rng(3).standard_normal(
        (3, cfg.audio.max_frames, cfg.audio.n_mels, 1)).astype(np.float32)
    key = jax.random.key(7)
    p, s = state.params["encoder"], state.batch_stats["encoder"]
    with jax.default_matmul_precision("float32"):
        out, new = jax.jit(lambda p, s: fwd(p, s, x, key))(p, s)
        grads = jax.jit(jax.grad(lambda p: fwd(p, s, x, key)[0].sum()))(p)
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (tree(state.params), tree(state.batch_stats), x,
            np.asarray(out), tree(new), tree(grads))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("fused", [False, True])
def test_folded_train_stem_matches_jax_encoder(fused):
    """Outputs 2e-5, BatchNorm running stats 1e-5, gradients atol 3e-4 /
    rtol 1e-4 (tests/test_folded_stem.py:135-192), float32, dropout 0;
    ``fused`` runs K2/K3 (their plain versions here) on both sides."""
    params, stats, x, j_out, j_stats, j_grads = _jax_encoder(fused)
    cfg = _enc_cfg(get_config, AudioConfig, fused)
    model = steps.build_modules(
        perf_config(get_config("baseline_mt_isp")).replace(
            audio=cfg.audio, model=dataclasses.replace(
                cfg.model, compute_dtype="float32")),
        device="cpu").make_model()
    weights.load_train_model(model, params, stats)
    enc = model.encoder.train()
    out = enc(torch.from_numpy(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out.detach().numpy(), j_out, atol=2e-5)
    _, got_stats = weights.export_train_model(model)
    want_s = _flat(j_stats)
    for path, v in _flat(got_stats["encoder"]).items():
        np.testing.assert_allclose(v, want_s[path], atol=1e-5,
                                   err_msg=str(path))
    out.sum().backward()
    want_g = _flat(j_grads)
    for path, param, kind in weights.train_param_map(model):
        if path[0] != "encoder":
            continue
        g = weights._TO_FLAX[kind](param.grad.numpy())
        np.testing.assert_allclose(g, want_g[path[1:]], atol=3e-4,
                                   rtol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("f,cin,cout", [(8, 1, 16), (4, 16, 32), (2, 32, 64)])
def test_fold_kernel_gather_matches_jax(f, cin, cout):
    """The differentiable kernel fold and its backward (each tap sums its
    fold copies) against bsed_tpu's constant-index take."""
    from bsed_tpu.ops.folded_stem import _fold_kernel_jnp

    from bsed_tpu_torch.ops import folded_stem as fs

    rng = np.random.default_rng(f)
    k = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    cot = rng.standard_normal((3, 3, f * cin, f * cout)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: _fold_kernel_jnp(a, f), jnp.asarray(k))
    kt = torch.from_numpy(k).requires_grad_(True)
    got = fs._fold_kernel_torch(kt, f, *fs._fold_gather_plan(f, cin, cout,
                                                             "cpu"))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(vjp(cot)[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preset", ["baseline_mt_isp", "baseline_fpn_mt_isp"])
def test_fresh_train_state_has_fresh_batchnorm(preset):
    """A fresh train state's BatchNorm running statistics are exactly 0
    (mean) and 1 (variance) for the student and the mean teacher, FPN's
    block_down included, as ``bsed_tpu``'s and the reference's; its trees
    have the keys and shapes of ``bsed_tpu``'s jitted
    ``create_train_state`` (traced by ``jax.eval_shape``)."""
    small = dict(sr=3200, hop_size=160, max_len_seconds=2.0)
    cfg = get_config(preset).replace(audio=AudioConfig(**small))
    jcfg = j_get_config(preset).replace(audio=JAudioConfig(**small))
    state = steps.create_train_state(
        cfg, steps.build_modules(cfg, device="cpu"), 0)
    trees = weights.export_train_state(state)
    jstate = jax.eval_shape(lambda k: j_steps.create_train_state(
        jcfg, j_steps.build_modules(jcfg), k), jax.random.key(0))

    def shapes(tree):
        return {jax.tree_util.keystr(k): tuple(np.shape(v))
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    for name in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        assert shapes(trees[name]) == shapes(getattr(jstate, name)), name
    blocks = trees["batch_stats"]["encoder"]["cnn"]
    assert ("block_down" in blocks) == ("fpn" in preset)
    for name in ("batch_stats", "ema_batch_stats"):
        for block, s in trees[name]["encoder"]["cnn"].items():
            assert (s["bn"]["mean"] == 0).all(), (name, block)
            assert (s["bn"]["var"] == 1).all(), (name, block)
    # serving's random weights keep their perturbed statistics, and the
    # parameters do not depend on the choice
    p_pert, s_pert = weights.init_params(cfg, 3)
    p_fresh, s_fresh = weights.init_params(cfg, 3, perturb_stats=False)
    assert shapes(p_pert) == shapes(p_fresh)
    for (k, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(p_pert),
            jax.tree_util.tree_leaves_with_path(p_fresh)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(k))
    v = s_pert["encoder"]["cnn"]["block0"]["bn"]["var"]
    assert (v >= 0.5).all() and v.std() > 0.1
    assert (s_fresh["encoder"]["cnn"]["block0"]["bn"]["var"] == 1).all()


@pytest.mark.parametrize("shape", [(40, 5, 64), (1000, 20, 96), (7, 3, 1)])
def test_randomized_maps_are_the_chunked_cpu_draw(shape, monkeypatch):
    """R_f is drawn row chunk by row chunk from one CPU generator seeded
    by the seed, R_g after it, whatever the device; small chunks here so
    the draw takes several."""
    from bsed_tpu_torch.train import da

    monkeypatch.setattr(da, "MAP_CHUNK_ELEMENTS", 1000)
    features, classes, out = shape
    rf, rg = da.make_randomized_maps(features, classes, out, seed=5,
                                     device="cpu")
    gen = torch.Generator().manual_seed(5)
    rows = max(1, 1000 // out)
    want_f = torch.cat([torch.randn((min(rows, features - i), out),
                                    generator=gen)
                        for i in range(0, features, rows)])
    want_g = torch.randn((classes, out), generator=gen)
    assert rf.shape == (features, out) and rg.shape == (classes, out)
    assert rf.dtype == rg.dtype == torch.float32
    assert torch.equal(rf, want_f) and torch.equal(rg, want_g)
