"""The port's domain adaptation (bsed_tpu_torch/ops/grl.py,
models/discriminators.py, train/da.py, models/crnn.CRNNDA, the DA parts of
train/steps.py, the trainer's stage-boundary resume) against ``bsed_tpu``
on the CPU, unit by unit:

  * the GRL reverses the gradient once (for DANN as in
    tests/test_train_step.py:146) and λ equals ``warm_start_lambda``;
  * each discriminator's forward and input gradient from carried weights
    at 1e-5, the clip ones on a (B, 65, 128) encoding, whose last map has
    an odd h = 3, so the pool's two rows overlap; BatchNorm statistics
    after the call; a bfloat16 input computes in float32 as flax promotes
    it;
  * every loss of train/da.py on the same inputs (and JAX's R_f / R_g) at
    1e-6; ``CRNNDA`` at 1e-5; the port's own R_f / R_g;
  * what ``build_modules`` accepts (the nine runs of
    ``tests.test_torch_preset_units.RUNS``, both forms) and refuses, with
    ``bsed_tpu``'s error classes and messages;
  * the DA state's carry and checkpoint round trip (bit-exact), and
    ``Trainer.resume`` at and off the stage boundary against
    ``bsed_tpu``'s; the CLI's ``train --stage adaptation``.

It also holds what the one-step DA tests share
(``tests/test_torch_da_{grl,joint,adda}.py``): one JAX step of a run at
state step 200 (λ ≈ 0.0997; ADDA's ``update_step`` 2 updates there and
skips at 201) with the replayed ISP shifts, mixup and ADDA half-batch
draws, the port's step from the JAX state, and the gates of
``assert_step_matches`` extended to the discriminator's params (1e-5 with
the Adam-noise allowance), BatchNorm statistics (1e-5 + 1e-4 relative)
and optimizer state, and to the encoder's aux optimizer: the gradient
through the first slot as for the main optimizer; encoder params get the
allowance of both their optimizers."""
import argparse
import contextlib
import dataclasses
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
from bsed_tpu.data.pipeline import ThreeStreamLoader as JThreeStream
from bsed_tpu.models import crnn as j_crnn
from bsed_tpu.models import discriminators as j_disc
from bsed_tpu.ops import grl as j_grl
from bsed_tpu.train import da as j_da

import bsed_tpu_torch.train.steps as steps
import bsed_tpu_torch.train.trainer as trainer_mod
from bsed_tpu_torch.config import AudioConfig, ModelConfig, get_config, \
    perf_config
from bsed_tpu_torch.data.datasets import SyntheticDataSource
from bsed_tpu_torch.data.pipeline import ThreeStreamLoader
from bsed_tpu_torch.models import crnn, discriminators
from bsed_tpu_torch.ops import grl
from bsed_tpu_torch.train import da
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.checkpoint import CheckpointManager

from tests.test_torch_preset_units import (EPOCH, RUNS, STEPS_PER_EPOCH,
                                           _batch, _n_real, _norm_stats,
                                           _replayed_draws,
                                           assert_step_matches, run_cfg,
                                           spread_crnn_head)
from tests.test_torch_train_step import _assert_trees, _leaves

DA_STEP = 200


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small ops: torch's intra-op pool costs more than it gives beside
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- shared by the one-step DA tests -------------------------------------

def _choice(i, n):
    """The i-th ADDA half-batch draw over n rows."""
    return np.random.default_rng(300 + i).permutation(n)[: n // 2]


@contextlib.contextmanager
def _replayed_da_draws(cfg):
    """``_replayed_draws`` plus ADDA's half-batch draws, in call order on
    each side."""
    calls = {"jax": 0, "port": 0}

    def j_choice(rng, n):
        calls["jax"] += 1
        return jnp.asarray(_choice(calls["jax"] - 1, n), jnp.int32)

    def p_choice(gen, n):
        calls["port"] += 1
        return torch.from_numpy(_choice(calls["port"] - 1, n))

    with _replayed_draws(_n_real(cfg)) as mix_calls, \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_steps, "sample_adda_choice", j_choice)
        mp.setattr(steps, "sample_adda_choice", p_choice)
        yield mix_calls, calls


def _widen_head(params, scales):
    """At their N(0, 0.01) init the heads' posteriors are 0.5 to within
    ~1e-2 (linear head) or ~1e-6 (the mlp head chains four dense layers
    linearly): the mlp head's consistency MSEs (~1e-12) are then float32
    cancellation noise, and the softmaxed weak predictions that CDAN's
    entropy weights read are uniform, so the weights are all 1. The dense
    kernels named in ``scales`` are scaled so the heads' outputs
    differ."""
    pred = dict(params["predictor"])
    for name, scale in scales.items():
        pred[name] = dict(pred[name], kernel=pred[name]["kernel"] * scale)
    return dict(params, predictor=pred)


def jax_da_step(run, folded=False, step=DA_STEP, model=()):
    """(trees before, trees after, metrics, mixup calls, ADDA draws, JAX's
    R_f / R_g or None) of one JAX step of ``run`` (``model``: as
    ``run_cfg``'s)."""
    cfg = run_cfg(j_get_config, JAudioConfig, run, folded, folded, model)
    ns = _norm_stats(cfg) if cfg.train.normalize else None
    modules = j_steps.build_modules(cfg, norm_stats=ns)
    state = jax.jit(lambda k: j_steps.create_train_state(cfg, modules, k))(
        jax.random.key(3))
    state = spread_crnn_head(state.replace(step=jnp.asarray(step,
                                                            jnp.int32)))
    scales = ({"dense1": 10.0, "dense2": 10.0, "dense3": 10.0}
              if cfg.model.predictor_head == "mlp" else
              {"dense": 100.0} if cfg.da.entropy_conditioning else {})
    if scales:
        state = state.replace(params=_widen_head(state.params, scales),
                              ema_params=_widen_head(state.ema_params,
                                                     scales))
    before = weights.trees_from_jax_state(state)
    with _replayed_da_draws(cfg) as (mix, choice), \
            jax.default_matmul_precision("float32"):
        fn = j_steps.make_train_step(modules,
                                     steps_per_epoch=STEPS_PER_EPOCH)
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        new, metrics = fn(state, batch, jax.random.key(1),
                          jnp.asarray(EPOCH, jnp.float32))
        after = weights.trees_from_jax_state(new)
    maps = (None if modules.rand_maps is None
            else tuple(np.asarray(r) for r in modules.rand_maps))
    return (before, after, {k: float(v) for k, v in metrics.items()},
            mix["jax"], choice["jax"], maps)


def port_da_step(run, jax_result, folded=False, model=()):
    """(trees after, metrics, mixup calls, ADDA draws, the discriminator's
    params after ADDA's discriminator step or None) of the port's step
    from the JAX state (and JAX's randomized map).

    ADDA's confusion step runs against the discriminator its
    discriminator step produced. Where that step's gradient is float noise
    Adam moves the element by ±lr on either side (the clip
    discriminator's conv and deep BatchNorm biases, whose gradients
    cancel over the batch), and the confusion gradient follows (2% of the
    encoder's in run g). So the discriminator step's result is recorded
    for its own gate and JAX's result is handed to the confusion step, as
    the replayed draws hand over JAX's random draws."""
    before, after, maps = jax_result[0], jax_result[1], jax_result[5]
    cfg = run_cfg(get_config, AudioConfig, run, folded, folded, model)
    ns = _norm_stats(cfg) if cfg.train.normalize else None
    modules = steps.build_modules(cfg, device="cpu", norm_stats=ns,
                                  rand_maps=maps)
    state = steps.load_train_state(modules, before)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    seen = {}
    if cfg.da.mode == "adda":
        disc, disc_step = state.discriminator, state.disc_optimizer.step

        def step_then_hand_over(*a, **k):
            out = disc_step(*a, **k)
            seen["params"], stats = weights.export_named(disc)
            weights.load_named(disc, after["disc_params"], stats)
            return out
        state.disc_optimizer.step = step_then_hand_over
    with _replayed_da_draws(cfg) as (mix, choice):
        metrics = steps.make_train_step(
            modules, steps_per_epoch=STEPS_PER_EPOCH)(state, batch, 1, EPOCH)
    return (weights.export_train_state(state), metrics, mix["port"],
            choice["port"], seen.get("params"))


def _slot_grads(opt_trees, family):
    """The gradient of one optimizer step from its first slot: Adam's
    mu / 0.1, SGD's trace."""
    if family == "sgd":
        return opt_trees["trace"]
    return jax.tree.map(lambda m: m / 0.1, opt_trees["mu"])


def _noise(opt_trees, family, bound):
    """The Adam-noise allowance of one optimizer: ``bound`` where its
    step's |g| < 1e-6 (an Adam step of arbitrary sign), 0 where it did not
    step or is SGD. The DA steps use 2.2·lr (``assert_step_matches`` has
    1.1·lr): such elements were measured stepping with opposite signs on
    the two sides (the clip discriminator's bn_4 bias: g = 7.1e-8 in JAX,
    −1.2e-7 here; run d's encoder conv biases, 7.1e-4 apart at lr 5e-4)."""
    grads = _slot_grads(opt_trees, family)
    stepped = family == "adam" and opt_trees["count"] > 0
    return jax.tree.map(
        lambda g: np.where(np.abs(g) < 1e-6, bound if stepped else 0.0,
                           0.0), grads)


def _assert_within(got, want, what, atol, allowance, rtol=0.0):
    want_l, got_l = dict(_leaves(want)), dict(_leaves(got))
    extra = dict(_leaves(allowance))
    assert got_l.keys() == want_l.keys(), what
    for path, v in want_l.items():
        delta = np.abs(got_l[path] - v)
        bound = atol + rtol * np.abs(v) + extra.get(path, 0.0)
        assert (delta <= bound).all(), (
            f"{what} {path}: |Δ| {float(delta.max())}, "
            f"excess {float((delta - bound).max())}")


def _assert_bias_noise(got, want):
    """A clip discriminator's conv bias feeds a BatchNorm, so its gradient
    is 0 in exact arithmetic (the batch mean absorbs it): each side's float
    residual is held below 1e-3 of the conv kernel's largest gradient, not
    to the other side's."""
    for name in want:
        if name.startswith("conv_"):
            scale = 1e-3 * float(np.abs(want[name]["kernel"]).max())
            for side in (got, want):
                assert float(np.abs(side[name]["bias"]).max()) <= scale, name


def _without_conv_bias(grads):
    convs = {k: ({"kernel": v["kernel"]} if k.startswith("conv_") else v)
             for k, v in grads["convs"].items()}
    return dict(grads, convs=convs)


def assert_da_step_matches(jax_result, port_result, cfg, sign_noise=False,
                           **step_gates):
    """``assert_step_matches`` (``step_gates``: its options), the
    encoder's params held to the allowances of both their optimizers,
    then the DA state (module docstring). ``sign_noise``: the
    discriminator's params also get the 2.2·lr allowance where the two
    sides' gradients (each within the gradient gate) differ in sign, since
    Adam's first step is ±lr by the sign."""
    before, after, j_metrics, j_mix, j_choice, _ = jax_result
    got, metrics, p_mix, p_choice, disc_step_params = port_result
    skipped = cfg.da.mode == "adda" and before["step"] % cfg.da.update_step
    # JAX traces both branches of its lax.cond, so it draws either way
    assert p_choice == (0 if skipped else j_choice)
    assert np.isfinite(j_metrics["domain_loss"])
    main_family = cfg.train.optimizer
    aux_family = cfg.da.aux_optimizer or main_family
    aux_lr = cfg.train.max_learning_rate * cfg.da.aux_lr_factor
    main_noise = _noise(after, main_family, 2.2 * j_metrics["lr"])
    aux_noise = _noise(after["enc_opt_state"], aux_family, 2.2 * aux_lr)
    allowance = dict(main_noise, encoder=jax.tree.map(
        np.add, main_noise["encoder"], aux_noise))
    _assert_within(got["params"], after["params"], "params", 1e-5,
                   allowance)
    # BatchNorm statistics: a conv bias feeds each block's BatchNorm, so
    # its gradient is noise and an Adam aux step moves it by ±lr on either
    # side before the main forwards, whose batch mean takes the bias one
    # to one (momentum 0.01: 0.99 of it reaches the running mean)
    mean_allowance = {"encoder": {"cnn": {
        blk: {"bn": {"mean": 0.99 * aux_noise["cnn"][blk]["conv"]
                     ["bias"]}}
        for blk in aux_noise["cnn"]}}}
    _assert_within(got["batch_stats"], after["batch_stats"], "batch_stats",
                   1e-5, mean_allowance, rtol=1e-4)
    # the main step's other gates (metrics, domain_loss among them, rel
    # 1e-4; gradients; the teacher), params and statistics held above
    assert_step_matches((before, after, j_metrics, j_mix),
                        (dict(got, params=after["params"],
                              batch_stats=after["batch_stats"]),
                         metrics, p_mix), cfg, **step_gates)
    for key in ("enc_opt_state", "disc_opt_state"):
        assert got[key].keys() == after[key].keys(), key
        if aux_family == "adam":
            assert got[key]["count"] == after[key]["count"], key
        g_got = _slot_grads(got[key], aux_family)
        g_want = _slot_grads(after[key], aux_family)
        if "convs" in g_want:
            _assert_bias_noise(g_got["convs"], g_want["convs"])
            g_got, g_want = _without_conv_bias(g_got), \
                _without_conv_bias(g_want)
        _assert_trees(g_got, g_want, f"{key} gradient", atol=3e-4,
                      rtol=1e-4)
    disc_allowance = _noise(after["disc_opt_state"], aux_family,
                            2.2 * aux_lr)
    if sign_noise:
        disc_allowance = jax.tree.map(
            lambda a, gw, gg: np.where(np.sign(gw) != np.sign(gg),
                                       2.2 * aux_lr, a), disc_allowance,
            _slot_grads(after["disc_opt_state"], aux_family),
            _slot_grads(got["disc_opt_state"], aux_family))
    if "convs" in disc_allowance:
        # the conv biases' gradients are all float residual (see
        # _assert_bias_noise): an Adam step of arbitrary sign each
        for name, leaf in disc_allowance["convs"].items():
            if name.startswith("conv_") and aux_family == "adam":
                leaf["bias"] = np.full_like(leaf["bias"], 2.2 * aux_lr)
    _assert_within(got["disc_params"] if disc_step_params is None
                   else disc_step_params, after["disc_params"],
                   "disc_params", 1e-5, disc_allowance)
    _assert_trees(got["disc_batch_stats"], after["disc_batch_stats"],
                  "disc_batch_stats", atol=1e-5, rtol=1e-4)


def check_run(run, jax_cache, folded=False, step=DA_STEP, model=(),
              **gates):
    """One step of ``run`` against JAX's (``jax_cache(run, folded,
    step)``, or ``jax_cache(run, folded, step, model)`` with ``model``, a
    per-file cache of ``jax_da_step``; ``gates``: the options of
    ``assert_da_step_matches``); returns both."""
    want = (jax_cache(run, folded, step, model) if model
            else jax_cache(run, folded, step))
    got = port_da_step(run, want, folded, model)
    assert got[0]["step"] == want[1]["step"] == step + 1
    assert_da_step_matches(want, got, run_cfg(get_config, AudioConfig, run,
                                              folded, folded, model),
                           **gates)
    return want, got


# --- units ---------------------------------------------------------------

@pytest.mark.parametrize("coeff", [1.0, 0.25])
def test_grl_reverses_once_for_dann(coeff):
    """The port's dann_loss reverses the features' gradient exactly once
    (tests/test_train_step.py:146): the gradient through the loss equals
    −coeff × the gradient of the same BCE without the reversal; the
    forward is the identity."""
    rng = np.random.default_rng(0)
    fs = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    ft = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    lin = torch.nn.Linear(8, 1)

    def disc(h):
        return torch.sigmoid(lin(h))

    fs.requires_grad_(True)
    loss = da.dann_loss(disc, fs, ft, coeff)
    (g_rev,) = torch.autograd.grad(loss, fs)
    fs2 = fs.detach().clone().requires_grad_(True)
    labels = torch.cat([torch.ones(3, 1), torch.zeros(3, 1)])
    plain = da.bce(disc(torch.cat([fs2, ft])), labels)
    (g_plain,) = torch.autograd.grad(plain, fs2)
    torch.testing.assert_close(g_rev, -coeff * g_plain)
    torch.testing.assert_close(loss, plain)
    x = torch.randn(4, 3, requires_grad=True)
    y = grl.grad_reverse(x, coeff)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y.sum(), x)
    torch.testing.assert_close(g, torch.full_like(x, -coeff))


@pytest.mark.parametrize("step", [0, 500, 1000, 5000])
def test_warm_start_lambda_matches_jax(step):
    got = grl.warm_start_lambda(step)
    np.testing.assert_allclose(got, float(j_grl.warm_start_lambda(step)),
                               rtol=1e-6, atol=1e-7)
    kw = dict(alpha=10.0, lo=0.1, hi=2.0, max_iters=300)
    np.testing.assert_allclose(
        grl.warm_start_lambda(step, **kw),
        float(j_grl.warm_start_lambda(step, **kw)), rtol=1e-6, atol=1e-7)
    assert grl.warm_start_lambda(0) == 0.0


def _jax_init(module, x, **kw):
    variables = jax.jit(lambda xx: module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, xx,
        train=True, **kw))(x)
    return variables["params"], variables.get("batch_stats", {})


def _perturb(tree, seed):
    """Init trees with non-trivial values (biases and statistics off 0/1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), tree)


DISCS = {
    "frame_grl": (lambda: j_disc.FrameDiscriminatorGRL(dropout=0.0),
                  lambda: discriminators.FrameDiscriminatorGRL(
                      40, dropout=0.0), (6, 7, 40)),
    "frame_grl_1_nogrl": (
        lambda: j_disc.FrameDiscriminatorGRL(dropout=0.0, n_out=1,
                                             apply_grl=False),
        lambda: discriminators.FrameDiscriminatorGRL(
            96, dropout=0.0, n_out=1, apply_grl=False), (6, 96)),
    "frame": (lambda: j_disc.FrameDiscriminator(dropout=0.0),
              lambda: discriminators.FrameDiscriminator(64, dropout=0.0),
              (6, 9, 64)),
    "clip_softmax": (j_disc.ClipDiscriminatorSoftmax,
                     discriminators.ClipDiscriminatorSoftmax, (3, 65, 128)),
    "clip": (j_disc.ClipDiscriminator, discriminators.ClipDiscriminator,
             (3, 65, 128)),
}


@pytest.mark.parametrize("name", sorted(DISCS))
def test_discriminator_matches_jax(name):
    """Forward, input gradient and (clip) BatchNorm statistics in training
    mode from carried weights; the clip map ends at h = 3, so the pooled
    rows overlap."""
    j_make, p_make, shape = DISCS[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = j_make()
    params, stats = _jax_init(jmod, jnp.asarray(x))
    params, stats = _perturb(params, 2), _perturb(stats, 3)
    stats = jax.tree.map(np.abs, stats)
    cot = rng.standard_normal((shape[0],) + ((shape[1],) if len(shape) == 3
                                             and "clip" not in name else ())
                              ).astype(np.float32)

    def j_fwd(xx):
        if stats:
            out, mut = jmod.apply({"params": params, "batch_stats": stats},
                                  xx, train=True, mutable=["batch_stats"])
        else:
            out, mut = jmod.apply({"params": params}, xx, train=True), {}
        return out, mut

    with jax.default_matmul_precision("float32"):
        (want, mut), vjp = jax.vjp(jax.jit(j_fwd), jnp.asarray(x))
        cot_full = np.broadcast_to(cot[..., None], want.shape).astype(
            np.float32)
        (want_g,) = vjp((jnp.asarray(cot_full), jax.tree.map(
            jnp.zeros_like, mut)))
    disc = p_make()
    weights.load_named(disc, params, stats)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = disc(xt)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(cot_full))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)
    if stats:
        got_p, got_s = weights.export_named(disc)
        _assert_trees(got_s, mut["batch_stats"], "disc stats", atol=1e-5,
                      rtol=1e-5)
        assert set(dict(_leaves(got_p))) == set(dict(_leaves(params)))
    if "clip" in name:
        # the last map is 3 rows high: overlapping pool rows
        h = 128
        for _ in range(5):
            h = (h - 3) // 2 + 1
        assert h == 3


def test_discriminator_promotes_bfloat16_like_flax():
    """Under --perf the discriminators compute in the dtype JAX's do: flax
    promotes a bfloat16 input against float32 params to float32."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 65, 128)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    for name in ("clip", "frame"):
        j_make, p_make, _ = DISCS[name]
        jmod = j_make()
        params, stats = _jax_init(jmod, jnp.asarray(x[..., :64] if name ==
                                                    "frame" else x))
        inp = xb[..., :64] if name == "frame" else xb
        variables = ({"params": params, "batch_stats": stats} if stats
                     else {"params": params})
        want = jax.jit(lambda i: jmod.apply(variables, i, train=True,
                                            mutable=["batch_stats"])[0])(inp)
        disc = p_make()
        weights.load_named(disc, params, stats)
        got = disc(torch.from_numpy(np.asarray(inp.astype(jnp.float32)))
                   .to(torch.bfloat16))
        assert want.dtype == jnp.float32 and got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _loss_inputs(b=3, t=5, f=16, c=4, d=32):
    rng = np.random.default_rng(7)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"g_s": arr(b, c), "g_t": arr(b, c), "f_s": arr(b, f),
            "f_t": arr(b, f), "e_s": arr(b, t, f), "e_t": arr(b, t, f),
            "rf": arr(f, d), "rg": arr(c, d), "w1": arr(d, 1),
            "wf": arr(f, 1), "wm": arr(c * f, 1)}


def _both(fn_j, fn_p, *names, **kw):
    inp = _loss_inputs()
    with jax.default_matmul_precision("float32"):
        want = fn_j(*[jnp.asarray(inp[n]) for n in names], inp, **kw)
    got = fn_p(*[torch.from_numpy(inp[n]) for n in names], inp, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-6)


def _jd(w):
    return lambda h: jax.nn.sigmoid(h @ jnp.asarray(w))


def _pd(w):
    return lambda h: torch.sigmoid(h @ torch.from_numpy(w))


@pytest.mark.parametrize("entropy", [False, True])
@pytest.mark.parametrize("randomized", [False, True])
def test_cdan_loss_matches_jax(entropy, randomized):
    def j(g_s, f_s, g_t, f_t, inp):
        w = inp["w1"] if randomized else inp["wm"]
        maps = ((jnp.asarray(inp["rf"]), jnp.asarray(inp["rg"]))
                if randomized else (None, None))
        return j_da.cdan_loss(_jd(w), g_s, f_s, g_t, f_t, *maps,
                              entropy_conditioning=entropy, grl_coeff=0.7)

    def p(g_s, f_s, g_t, f_t, inp):
        w = inp["w1"] if randomized else inp["wm"]
        maps = ((torch.from_numpy(inp["rf"]), torch.from_numpy(inp["rg"]))
                if randomized else (None, None))
        return da.cdan_loss(_pd(w), g_s, f_s, g_t, f_t, *maps,
                            entropy_conditioning=entropy, grl_coeff=0.7)
    _both(j, p, "g_s", "f_s", "g_t", "f_t")


def test_maps_and_frame_losses_match_jax():
    inp = _loss_inputs()
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    jj = {k: jnp.asarray(v) for k, v in inp.items()}
    with jax.default_matmul_precision("float32"):
        want_m = j_da.multilinear_map(jj["f_s"], jj["g_s"])
        want_r = j_da.randomized_multilinear_map(jj["f_s"], jj["g_s"],
                                                 jj["rf"], jj["rg"])
        want_dann = j_da.dann_loss(_jd(inp["wf"]), jj["f_s"], jj["f_t"], 0.3)
        want_cf = j_da.cdan_frame_loss(_jd(inp["wf"]), jj["g_s"], jj["e_s"],
                                       jj["g_t"], jj["e_t"], 0.3)
    np.testing.assert_allclose(da.multilinear_map(t["f_s"], t["g_s"]),
                               np.asarray(want_m), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        da.randomized_multilinear_map(t["f_s"], t["g_s"], t["rf"], t["rg"]),
        np.asarray(want_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(da.dann_loss(_pd(inp["wf"]), t["f_s"],
                                                  t["f_t"], 0.3)),
                               float(want_dann), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(da.cdan_frame_loss(_pd(inp["wf"]), t["g_s"], t["e_s"],
                                 t["g_t"], t["e_t"], 0.3)),
        float(want_cf), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("labels", ["split", "all_target"])
@pytest.mark.parametrize("frame", [False, True])
def test_adda_losses_match_jax(labels, frame):
    """Both ADDA losses on (B, 2) clip or (B, T, 2) frame outputs; the
    syn stream may have fewer rows than the choice's range (origin),
    where JAX's gather clamps the index and drops those rows' gradient."""
    rng = np.random.default_rng(8)
    shape = (8, 5, 2) if frame else (8, 2)
    d_real = rng.random(shape).astype(np.float32)
    d_syn = rng.random((4,) + shape[1:]).astype(np.float32)
    choice = np.array([6, 1, 3, 7])
    want, want_g = jax.value_and_grad(
        lambda a, b: j_da.adda_discriminator_loss(a, b, jnp.asarray(choice),
                                                  2.5, labels),
        argnums=(0, 1))(jnp.asarray(d_real), jnp.asarray(d_syn))
    tr, ts = (torch.from_numpy(a).requires_grad_(True)
              for a in (d_real, d_syn))
    got = da.adda_discriminator_loss(tr, ts, torch.from_numpy(choice), 2.5,
                                     labels)
    got_g = torch.autograd.grad(got, (tr, ts))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # rows past the syn stream: clamped forward, no gradient (JAX's gather)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    for ch, flipped in ((choice, False), (None, True), (None, False)):
        want = j_da.adda_confusion_loss(
            jnp.asarray(d_real), None if ch is None else jnp.asarray(ch),
            5.0, flipped=flipped)
        got = da.adda_confusion_loss(
            torch.from_numpy(d_real),
            None if ch is None else torch.from_numpy(ch), 5.0,
            flipped=flipped)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_randomized_maps_are_the_ports_own():
    """R_f / R_g: standard normal float32 of the asked shapes on the asked
    device, the same for the same seed, other for another;
    ``build_modules`` draws them from cfg.train.seed for frame-level CDAN
    only, or takes the pair it is given."""
    a = da.make_randomized_maps(40, 5, 64, seed=3)
    b = da.make_randomized_maps(40, 5, 64, seed=3)
    c = da.make_randomized_maps(40, 5, 64, seed=4)
    assert a[0].shape == (40, 64) and a[1].shape == (5, 64)
    assert a[0].dtype == torch.float32 and a[0].device.type == "cpu"
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert abs(float(a[0].std()) - 1.0) < 0.1
    cfg = run_cfg(get_config, AudioConfig, "d")
    modules = steps.build_modules(cfg, device="cpu")
    rf, rg = modules.rand_maps
    assert rf.shape == (2 * cfg.model.n_rnn_cell * cfg.n_frames,
                        cfg.da.randomized_dim)
    assert rg.shape == (cfg.nclass, cfg.da.randomized_dim)
    want = da.make_randomized_maps(rf.shape[0], cfg.nclass,
                                   cfg.da.randomized_dim, cfg.train.seed)
    assert torch.equal(rf, want[0]) and torch.equal(rg, want[1])
    given = steps.build_modules(cfg, device="cpu",
                                rand_maps=(np.ones((2, 3)), np.zeros(3)))
    assert torch.equal(given.rand_maps[0], torch.ones(2, 3))
    for run in "abcefghi":
        assert steps.build_modules(run_cfg(get_config, AudioConfig, run),
                                   device="cpu").rand_maps is None


def test_crnnda_matches_jax():
    """CRNN with the built-in GRL frame discriminator: (encoded, d_input,
    domain_pred) and the reversed gradient into the input, from carried
    weights, in eval mode (no dropout, running statistics)."""
    cfg = ModelConfig(nb_filters=(16, 32, 64, 32),
                      pooling=((2, 2), (2, 2), (1, 2), (1, 2)),
                      n_rnn_cell=32)
    from bsed_tpu.config import ModelConfig as JModelConfig
    jcfg = JModelConfig(nb_filters=cfg.nb_filters, pooling=cfg.pooling,
                        n_rnn_cell=32)
    x = np.random.default_rng(2).standard_normal((2, 40, 16, 1)).astype(
        np.float32)
    jmod = j_crnn.CRNNDA(jcfg)
    params, stats = _jax_init(jmod, jnp.asarray(x))
    stats = jax.tree.map(np.abs, _perturb(stats, 5))

    def j_fwd(xx):
        return jmod.apply({"params": params, "batch_stats": stats}, xx,
                          train=False, grl_coeff=0.5)

    with jax.default_matmul_precision("float32"):
        want, vjp = jax.vjp(jax.jit(j_fwd), jnp.asarray(x))
        (want_g,) = vjp((jnp.zeros_like(want[0]), jnp.zeros_like(want[1]),
                         jnp.ones_like(want[2])))
    model = crnn.CRNNDA(cfg).eval()
    weights.load_crnnda(model, params, stats)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = model(xt, grl_coeff=0.5)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    (got_g,) = torch.autograd.grad(got[2].sum(), xt)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-6)


# --- which configurations build_modules takes ----------------------------

@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("perf", [False, True])
def test_build_modules_accepts_every_run(run, perf):
    """The nine runs in both forms, each with bsed_tpu's discriminator
    flavour and the aux optimizers' family."""
    cfg = get_config(RUNS[run])
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                stage="adaptation"))
    jcfg = j_get_config(RUNS[run])
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train,
                                                  stage="adaptation"))
    if perf:
        cfg = perf_config(cfg)
    # a stand-in map: run d's own is (80128, 8192) at full width, 2.6 GB
    # (drawn and allocated on the card by tests/test_torch_cuda.py)
    modules = steps.build_modules(cfg, device="cpu",
                                  rand_maps=(np.zeros((1, 1)),) * 2)
    disc = modules.make_discriminator()
    want = j_steps._make_discriminator(jcfg)
    assert type(disc).__name__ == type(want).__name__
    for attr in ("n_out", "apply_grl"):
        if hasattr(want, attr):
            got_v = (disc.dense_d_3.out_features if attr == "n_out"
                     else disc.apply_grl)
            assert got_v == getattr(want, attr), attr
    if run in "abcdefghi" and cfg.da.mode == "dann":
        assert disc.dense_d_1.in_features == \
            2 * cfg.model.n_rnn_cell * cfg.n_frames == 80128


@pytest.mark.parametrize("case", ["origin_joint_dann", "origin_joint_cdan",
                                  "frame_cdan_no_map"])
def test_build_modules_refuses_da_like_bsed_tpu(case):
    """origin with a joint GRL mode (bsed_tpu raises in make_train_step,
    steps.py:377-386) and frame-level CDAN without a randomized map
    (steps.py:165-176): ValueError with bsed_tpu's message."""
    def make(get):
        if case.startswith("origin"):
            cfg = get("origin")
            mode = "dann" if case.endswith("dann") else "cdan"
            # a small randomized map: bsed_tpu draws it before refusing
            return cfg.replace(
                train=dataclasses.replace(cfg.train, stage="adaptation"),
                da=dataclasses.replace(cfg.da, mode=mode,
                                       joint_backward=True,
                                       randomized_dim=16))
        cfg = get("pseudo_labeling")
        return cfg.replace(
            train=dataclasses.replace(cfg.train, stage="adaptation"),
            da=dataclasses.replace(cfg.da, randomized_dim=0))
    with pytest.raises(ValueError) as want:
        jcfg = make(j_get_config)
        j_steps.make_train_step(j_steps.build_modules(jcfg), jit=False,
                                steps_per_epoch=8)
    with pytest.raises(ValueError) as got:
        steps.build_modules(make(get_config), device="cpu")
    assert str(got.value) == str(want.value)


# --- the DA state's carry, checkpoints and resume -------------------------

def _jax_da_state(run, seed=3):
    cfg = run_cfg(j_get_config, JAudioConfig, run)
    modules = j_steps.build_modules(cfg)
    return jax.jit(lambda k: j_steps.create_train_state(cfg, modules, k))(
        jax.random.key(seed))


def _shifted(tree, amount):
    return jax.tree.map(
        lambda a: a + amount if jnp.issubdtype(jnp.asarray(a).dtype,
                                               jnp.floating) else a + 1,
        tree)


@pytest.mark.parametrize("run", ["a", "d", "g"])
def test_da_state_carries_both_ways(run):
    """disc params, statistics and both aux optimizers' states (Adam:
    mu, nu, count; SGD: trace) from a JAX state into the port's modules
    and back, unchanged."""
    state = _jax_da_state(run)
    state = state.replace(disc_opt_state=_shifted(state.disc_opt_state, 0.5),
                          enc_opt_state=_shifted(state.enc_opt_state, 0.25),
                          disc_batch_stats=_shifted(state.disc_batch_stats,
                                                    0.1))
    trees = weights.trees_from_jax_state(state)
    for key in ("disc_params", "disc_batch_stats", "disc_opt_state",
                "enc_opt_state"):
        assert key in trees
    cfg = run_cfg(get_config, AudioConfig, run)
    port = steps.load_train_state(steps.build_modules(cfg, device="cpu"),
                                  trees)
    got = weights.export_train_state(port)
    want_l, got_l = dict(_leaves(trees)), dict(_leaves(got))
    assert want_l.keys() == got_l.keys()
    for path, v in want_l.items():
        np.testing.assert_array_equal(got_l[path], v, err_msg=str(path))


def test_da_checkpoint_round_trip_is_bit_exact(tmp_path):
    """A state with a discriminator, stepped once (every slot non-zero),
    saved and restored into a fresh state: every leaf bit-exact, and the
    next step of both the same."""
    cfg = run_cfg(get_config, AudioConfig, "a")
    modules = steps.build_modules(cfg, device="cpu")
    step = steps.make_train_step(modules)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    live = steps.create_train_state(cfg, modules, 0)
    live.step = DA_STEP
    step(live, batch, 1, EPOCH)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("epoch_0", live)
    saved = ckpt.load("epoch_0")
    assert float(np.abs(saved["enc_opt_state"]["mu"]["rnn"]
                        ["weight_ih_l0"]).max()) > 0
    assert saved["disc_opt_state"]["count"] == 1
    restored = ckpt.restore("epoch_0",
                            steps.create_train_state(cfg, modules, 9))
    a = dict(_leaves(weights.export_train_state(live)))
    b = dict(_leaves(weights.export_train_state(restored)))
    assert a.keys() == b.keys()
    for path, v in a.items():
        np.testing.assert_array_equal(b[path], v, err_msg=str(path))
    m_live = step(live, batch, 1, EPOCH)
    m_restored = step(restored, batch, 1, EPOCH)
    assert {k: float(v) for k, v in m_live.items()} == \
        {k: float(v) for k, v in m_restored.items()}


def _resume_trainers(tmp_path):
    """Both packages' Trainers on baseline_adaptation in the small
    configuration, the port's from the JAX initial state (A), and an
    epoch_0 checkpoint of a different state B in each store."""
    jcfg = run_cfg(j_get_config, JAudioConfig, "a")
    cfg = run_cfg(get_config, AudioConfig, "a")

    def sources(cls, c):
        return (cls(c, n_items=8, seed=1), cls(c, n_items=4, seed=2),
                cls(c, n_items=4, seed=3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_trainer_mod, "create_train_state",
                   lambda c, m, k: jax.jit(
                       lambda kk: j_steps.create_train_state(c, m, kk))(k))
        jt = j_trainer_mod.Trainer(
            jcfg, JThreeStream(*sources(JSynthetic, jcfg), batch_size=4,
                               seed=1), store_dir=str(tmp_path / "jax"),
            mesh="off", scan_epoch="off")
    pt = trainer_mod.Trainer(
        cfg, ThreeStreamLoader(*sources(SyntheticDataSource, cfg),
                               batch_size=4, seed=1, device="cpu"),
        store_dir=str(tmp_path / "port"), device="cpu")
    state_a = jt.state
    weights.load_train_state(pt.state, weights.trees_from_jax_state(state_a))
    state_b = state_a.replace(
        step=jnp.asarray(40, jnp.int32),
        params=_shifted(state_a.params, 0.01),
        disc_params=_shifted(state_a.disc_params, 0.02),
        enc_opt_state=_shifted(state_a.enc_opt_state, 0.03),
        disc_opt_state=_shifted(state_a.disc_opt_state, 0.04))
    jt.ckpt.save("epoch_0", state_b)
    jt.ckpt.save("epoch_1", state_b)
    port_b = steps.load_train_state(pt.modules,
                                    weights.trees_from_jax_state(state_b))
    pt.ckpt.save("epoch_0", port_b)
    pt.ckpt.save("epoch_1", port_b)
    return jt, pt, weights.trees_from_jax_state(state_a), \
        weights.trees_from_jax_state(state_b)


@pytest.mark.parametrize("epoch", [1, 2])
def test_resume_at_stage_boundary_matches_jax(tmp_path, epoch):
    """``resume(1)`` in the adaptation stage keeps the live (fresh)
    discriminator, its statistics and optimizer, and takes everything
    else from epoch_0, as bsed_tpu's Trainer.resume does
    (trainer.py:168-180); ``resume(2)`` takes the discriminator too."""
    jt, pt, trees_a, trees_b = _resume_trainers(tmp_path)
    jt.resume(epoch)
    pt.resume(epoch)
    want = weights.trees_from_jax_state(jt.state)
    got = weights.export_train_state(pt.state)
    want_l, got_l = dict(_leaves(want)), dict(_leaves(got))
    assert want_l.keys() == got_l.keys()
    for path, v in want_l.items():
        np.testing.assert_array_equal(got_l[path], v, err_msg=str(path))
    src = trees_a if epoch == 1 else trees_b
    for key in ("disc_params", "disc_batch_stats", "disc_opt_state"):
        for path, v in _leaves(src[key]):
            np.testing.assert_array_equal(dict(_leaves(got[key]))[path], v)
    for path, v in _leaves(trees_b["enc_opt_state"]):
        np.testing.assert_array_equal(
            dict(_leaves(got["enc_opt_state"]))[path], v)
    assert got["step"] == 40


def test_cli_trains_the_adaptation_stage(tmp_path):
    """``train --preset scmt_ada --stage adaptation`` (and the adaptation
    preset baseline_adaptation) run through the port's CLI on fixtures;
    the domain loss reaches results.tsv; the flags give bsed_tpu's
    configuration."""
    from bsed_tpu.cli import _apply_flags as j_apply
    from bsed_tpu.config import config_to_dict as j_to_dict

    from bsed_tpu_torch import cli
    from bsed_tpu_torch.cli import _apply_flags
    from bsed_tpu_torch.config import config_to_dict

    args = argparse.Namespace(perf=False, tiny_audio=True, use_fpn=False,
                              meanteacher=False, isp=False,
                              stage="adaptation", level=None)
    got = _apply_flags(get_config("scmt_ada"), args)
    assert config_to_dict(got) == j_to_dict(j_apply(j_get_config("scmt_ada"),
                                                    args))
    assert got.train.stage == "adaptation" and got.da.mode == "dann"
    for argv in (["--preset", "scmt_ada", "-stage", "adaptation"],
                 ["--preset", "baseline_adaptation"]):
        store = tmp_path / argv[1]
        cli.main(["train", *argv, "--tiny-audio", "-s", "12", "--epochs",
                  "1", "--store-dir", str(store), "--device", "cpu"])
        with open(os.path.join(store, "results.tsv")) as fh:
            header = fh.readline().rstrip("\n").split("\t")
        assert "domain_loss" in header and "loss" in header
        saved = CheckpointManager(str(store)).load("epoch_0")
        assert "disc_params" in saved and "enc_opt_state" in saved
