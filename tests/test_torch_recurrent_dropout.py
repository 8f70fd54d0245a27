"""Recurrent dropout in training (``ModelConfig.dropout_recurrent``): the
port's ``models/rnn.BidirectionalGRU`` drops each layer's output but the
last, in the compute dtype, with a mask drawn from the step's generator,
as ``bsed_tpu``'s module does (rnn.py:109-110), against ``bsed_tpu`` on the
CPU:

  * the module in float32 and bfloat16, at rates 0.5 (uint8 bits) and 0.2
    (a float uniform), fed ``bsed_tpu``'s mask (read off its forward with
    ``capture_intermediates``): the output, and the gradients of the input
    and of every weight for one cotangent, at 1e-5 in float32 and at
    bfloat16 resolution in bfloat16 (3e-2 of the output's scale, the
    bf16 gate of ``tests/test_torch_gru_kernel.py``);
  * one ``baseline_mt_isp`` step, every other dropout 0, in the reference
    form at 0.5 and in the --perf form (float32, folded stem, fused
    streams) at 0.2, with the masks ``bsed_tpu``'s step drew replayed
    through the port's ``keep_mask`` (recorded by a wrapper of
    ``bsed_tpu.ops.dropout.keep_mask`` that hands each mask out of the
    jitted step with an ordered ``jax.debug.callback``), at the gates of
    item 8a;
  * the port's own draws: both draw paths keep 1 − rate of the elements
    (within 4σ), the same generator state draws the same mask, eval mode
    and rate 0 run the single ``nn.GRU`` call, and the feature-pyramid
    encoder's three GRUs and the folded encoder's tail draw theirs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsed_tpu.ops.dropout as j_dropout
import bsed_tpu.train.steps as j_steps
from bsed_tpu.models.rnn import BidirectionalGRU as JBiGRU

import bsed_tpu_torch.train.steps as steps
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.models.rnn import BidirectionalGRU
from bsed_tpu_torch.ops import dropout as dropout_mod

from tests.test_torch_preset_units import (EPOCH, _batch, _small,
                                           assert_step_matches, jax_step,
                                           port_step)
from tests.test_torch_trainer import one_torch_thread  # noqa: F401

B, T, N_IN, H = 3, 12, 32, 16


def _module_case(rate, dtype, seed=0):
    """bsed_tpu's 2-layer BiGRU, its params, an input, its mask and its
    output and gradients (input, params) for one cotangent."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else None
    mod = JBiGRU(H, 2, rate, unroll=1, dtype=jdt)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, N_IN)).astype(np.float32)
    cot = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    params = mod.init(jax.random.key(seed), jnp.asarray(x))["params"]
    key = {"dropout": jax.random.key(seed + 7)}
    _, inter = mod.apply({"params": params}, jnp.asarray(x), train=True,
                         rngs=key, mutable=["intermediates"],
                         capture_intermediates=True)
    dropped = np.asarray(inter["intermediates"]["FastDropout_0"]
                         ["__call__"][0], np.float32)
    keep = dropped != 0

    def fwd(p, xx):
        return mod.apply({"params": p}, xx, train=True, rngs=key)
    with jax.default_matmul_precision("float32"):
        out, vjp = jax.vjp(fwd, params, jnp.asarray(x))
        g_params, g_x = vjp(jnp.asarray(cot))
    return (params, x, cot, keep, np.asarray(out),
            jax.tree.map(np.asarray, g_params), np.asarray(g_x))


@pytest.mark.parametrize("rate", [0.5, 0.2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_module_matches_jax_with_its_mask(rate, dtype, monkeypatch):
    params, x, cot, keep, want, g_params, g_x = _module_case(rate, dtype)
    assert abs(keep.mean() - (1 - rate)) < 0.1
    drawn = []

    def replay(gen, shape, r, device):
        assert tuple(shape) == keep.shape and r == rate
        drawn.append(shape)
        return torch.from_numpy(keep)
    monkeypatch.setattr(dropout_mod, "keep_mask", replay)
    dt = None if dtype == torch.float32 else dtype
    rnn = BidirectionalGRU(N_IN, H, 2, rate, dtype=dt, cast_weights=False)
    with torch.no_grad():
        for name, p in rnn.gru.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name])))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = rnn(xt, torch.Generator())
    out.backward(torch.from_numpy(cot))
    assert len(drawn) == 1 and out.dtype == torch.float32
    if dtype == torch.float32:
        gate = dict(atol=1e-5, rtol=1e-5)
    else:
        gate = dict(atol=3e-2 * float(np.abs(want).max()), rtol=0.0)
    np.testing.assert_allclose(out.detach().numpy(), want, **gate)
    for got_g, want_g, name in [(xt.grad, g_x, "x")] + [
            (p.grad, g_params[n], n) for n, p in rnn.gru.named_parameters()]:
        scale = float(np.abs(want_g).max())
        tol = (dict(atol=1e-5 * max(scale, 1.0), rtol=1e-4)
               if dtype == torch.float32 else
               dict(atol=3e-2 * scale, rtol=0.0))
        np.testing.assert_allclose(got_g.numpy(), want_g, err_msg=name,
                                   **tol)


@functools.lru_cache(maxsize=None)
def _jax_step_and_masks(folded, rate):
    """One JAX step with recurrent dropout ``rate`` (every other dropout
    0) and the masks its jitted step drew, in program order."""
    masks, recording = [], [False]
    draw = j_dropout.keep_mask

    def recorded(rng, shape, r):
        mask = draw(rng, shape, r)
        if recording[0]:
            jax.debug.callback(lambda m: masks.append(np.asarray(m)), mask,
                               ordered=True)
        return mask
    make = j_steps.make_train_step

    def make_then_record(*a, **k):
        recording[0] = True            # the state's init draws no more
        return make(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_dropout, "keep_mask", recorded)
        mp.setattr(j_steps, "make_train_step", make_then_record)
        result = jax_step("baseline_mt_isp", folded, folded,
                          model=(("dropout_recurrent", rate),))
    return result, masks


@pytest.mark.parametrize("folded,rate", [(False, 0.5), (True, 0.2)],
                         ids=["reference-0.5", "perf_f32-0.2"])
def test_step_with_replayed_masks_matches_jax(folded, rate, monkeypatch):
    """Every mask of the step in bsed_tpu's order (teacher forwards, then
    the student's), each of the forward's (B, T', 2H) shape, then the
    step's gates."""
    want, masks = _jax_step_and_masks(folded, rate)
    # reference: 3 teacher + 6 student forwards; --perf: one fused each
    assert len(masks) == (2 if folded else 9)
    queue = list(masks)

    def replay(gen, shape, r, device):
        mask = queue.pop(0)
        assert tuple(shape) == mask.shape and r == rate
        return torch.from_numpy(np.array(mask))
    monkeypatch.setattr(dropout_mod, "keep_mask", replay)
    model = (("dropout_recurrent", rate),)
    got = port_step("baseline_mt_isp", want[0], folded, folded, model=model)
    assert queue == []
    assert_step_matches(want, got, _small(get_config("baseline_mt_isp"),
                                          AudioConfig, folded, folded,
                                          model=model))


@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_both_draw_paths_keep_their_share(rate):
    """0.5 is on the 1/256 grid (uint8 bits), 0.2 is not (a float
    uniform): each keeps 1 − rate of the (B, T, 2H) elements within 4σ,
    and the same generator state draws the same mask."""
    rnn = BidirectionalGRU(N_IN, H, 2, rate).train()
    x = torch.randn((64, 40, N_IN), generator=torch.Generator()
                    .manual_seed(1))
    masks = []
    draw = dropout_mod.keep_mask

    def recorded(*a, **k):
        masks.append(draw(*a, **k))
        return masks[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dropout_mod, "keep_mask", recorded)
        with torch.no_grad():
            a = rnn(x, torch.Generator().manual_seed(5))
            b = rnn(x, torch.Generator().manual_seed(5))
            c = rnn(x, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert len(masks) == 3 and torch.equal(masks[0], masks[1])
    keep = masks[0]
    assert keep.shape == (64, 40, 2 * H)
    sigma = (rate * (1 - rate) / keep.numel()) ** 0.5
    assert abs(1 - float(keep.float().mean()) - rate) < 4 * sigma
    assert (dropout_mod._u8_threshold(1 - rate) is not None) == (rate == 0.5)


def test_eval_and_rate_zero_run_one_gru_call(monkeypatch):
    """Without dropout in training, and in eval mode, the module makes its
    single ``nn.GRU`` call (every preset's path) and draws nothing."""
    calls = []
    forward = torch.nn.GRU.forward

    def counted(self, *a, **k):
        calls.append(self.num_layers)
        return forward(self, *a, **k)
    monkeypatch.setattr(torch.nn.GRU, "forward", counted)
    monkeypatch.setattr(dropout_mod, "keep_mask", lambda *a, **k: 1 / 0)
    x = torch.randn((2, 9, N_IN))
    for rate, train in ((0.0, True), (0.5, False)):
        rnn = BidirectionalGRU(N_IN, H, 2, rate).train(train)
        rnn(x, torch.Generator())
    assert calls == [2, 2]
    rnn = BidirectionalGRU(N_IN, H, 2, 0.5).train()
    monkeypatch.setattr(dropout_mod, "keep_mask",
                        lambda g, s, r, d: torch.ones(s, dtype=torch.bool))
    calls.clear()
    rnn(x, torch.Generator())
    assert calls == [1, 1]
    # the parameters stay nn.GRU's, so checkpoints do not change
    assert [n for n, _ in rnn.named_parameters()] == [
        "gru." + n for n, _ in torch.nn.GRU(N_IN, H, 2, bidirectional=True)
        .named_parameters()]


@pytest.mark.parametrize("preset,folded", [("baseline_fpn_mt_isp", False),
                                           ("baseline_mt_isp", True)])
def test_every_gru_of_the_step_draws(preset, folded, monkeypatch):
    """The feature-pyramid encoder's three GRUs (T', T'/2, T'/4 frames)
    and the folded encoder's tail each draw a mask a forward, from the
    step's generator."""
    cfg = _small(get_config(preset), AudioConfig, folded, folded,
                 model=(("dropout_recurrent", 0.5),))
    modules = steps.build_modules(cfg, device="cpu")
    state = steps.create_train_state(cfg, modules, 0)
    shapes = []
    draw = dropout_mod.keep_mask

    def recorded(gen, shape, rate, device):
        shapes.append(tuple(shape))
        return draw(gen, shape, rate, device)
    monkeypatch.setattr(dropout_mod, "keep_mask", recorded)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    metrics = steps.make_train_step(modules)(state, batch, 1, EPOCH)
    assert np.isfinite(float(metrics["loss"]))
    t, w = cfg.n_frames, 2 * cfg.model.n_rnn_cell
    if folded:
        # one fused teacher forward (3 × 4 rows), one fused student (6 × 4)
        assert shapes == [(12, t, w), (24, t, w)]
    else:
        per_forward = [(4, t, w), (4, t // 2, w), (4, t // 4, w)]
        assert shapes == per_forward * 9
