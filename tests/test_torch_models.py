"""The port's eval-mode CRNN and predictors against flax, on weights made by
``create_train_state`` and carried over by bsed_tpu_torch/utils/weights.py.
Gate 1e-4, the tolerance of tests/test_models.py. The JAX side runs under
float32 matmul precision: XLA:CPU's default routes convs through a bf16
fastpath on AMX hosts (conftest.py), which the 1e-4 gate would see."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.train.steps import build_modules, create_train_state

from bsed_tpu_torch.config import get_config
from bsed_tpu_torch.models.crnn import CRNN
from bsed_tpu_torch.models.layers import ConvBlock
from bsed_tpu_torch.models.predictor import make_predictor_head
from bsed_tpu_torch.utils import weights

T_IN = 40            # 40 mel frames → 10 post-CNN frames


@functools.lru_cache(maxsize=None)
def _train_state(seed, **model_kw):
    """create_train_state once per (seed, model overrides) in this file."""
    # a short clip keeps create_train_state's init trace small; the
    # parameters do not depend on the clip length
    cfg = j_get_config("baseline").replace(audio=JAudioConfig(
        sr=3200, hop_size=160, max_len_seconds=2.0))
    if model_kw:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    modules = build_modules(cfg)
    # jitted: one compile instead of the eager init's op-by-op warm-up
    state = jax.jit(lambda k: create_train_state(cfg, modules, k))(
        jax.random.key(seed))
    return (cfg, modules, jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.batch_stats))


def _state(seed=0, **model_kw):
    cfg, modules, params, stats = _train_state(seed, **model_kw)
    # non-trivial running stats, so the BatchNorm carry is exercised
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree.map(
        lambda v: (rng.normal(0.1, 0.3, v.shape) ** 2 + 0.5).astype(
            np.float32), stats)
    return cfg, modules, params, stats


@pytest.mark.parametrize("model_kw", [
    {},
    {"activation": "cg"},
    {"predictor_head": "mlp"},                  # Predictor2 head
])
def test_crnn_and_predictor_match_flax(model_kw):
    cfg, modules, params, stats = _state(**model_kw)
    x = np.random.default_rng(1).standard_normal(
        (2, T_IN, 128, 1)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        enc, _ = modules.encoder.apply(
            {"params": params["encoder"], "batch_stats": stats["encoder"]},
            jnp.asarray(x), train=False)
        s_want, w_want = modules.predictor.apply(
            {"params": params["predictor"]}, enc, train=False)

    pcfg = get_config("baseline")
    pcfg = pcfg.replace(model=dataclasses.replace(pcfg.model, **model_kw))
    crnn = CRNN(pcfg.model).eval()
    weights.load_crnn(crnn, params["encoder"], stats["encoder"])
    head = make_predictor_head(pcfg).eval()
    weights.load_predictor(head, params["predictor"])
    with torch.no_grad():
        enc_t, d_in = crnn(torch.from_numpy(x))
        s_got, w_got = head(enc_t)
    assert enc_t.shape == (2, T_IN // 4, 256) and d_in is enc_t
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc), atol=1e-4)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), atol=1e-4)
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_want), atol=1e-4)


def test_inference_gate_matches_flax():
    cfg, modules, params, _ = _state()
    x = np.random.default_rng(3).standard_normal((3, 7, 256)).astype(
        np.float32) * 30.0           # wide logits: some weak > 0.5
    s_want, w_want = modules.predictor.apply(
        {"params": params["predictor"]}, jnp.asarray(x), train=False,
        inference=True)
    head = make_predictor_head(get_config("baseline")).eval()
    weights.load_predictor(head, params["predictor"])
    with torch.no_grad():
        s_got, w_got = head(torch.from_numpy(x), inference=True)
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_want), atol=1e-5)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), atol=1e-5)


def test_conv_block_bf16_close_to_flax():
    """compute_dtype bfloat16: conv, BatchNorm, GLU and pool in bf16 on
    both sides; agreement at bf16 resolution."""
    from bsed_tpu.models.layers import ConvBlock as JConvBlock
    _, _, params, stats = _state()
    p = params["encoder"]["cnn"]["block1"]
    s = stats["encoder"]["cnn"]["block1"]
    x = np.random.default_rng(5).standard_normal((2, 12, 32, 16)).astype(
        np.float32)
    with jax.default_matmul_precision("float32"):
        want = JConvBlock(32, (2, 2), "glu", 0.5, dtype=jnp.bfloat16).apply(
            {"params": p, "batch_stats": s}, jnp.asarray(x), train=False)
    blk = ConvBlock(16, 32, (2, 2), "glu", dtype=torch.bfloat16).eval()
    weights.load_conv_block(blk, p, s)
    with torch.no_grad():
        got = blk(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)


def test_init_params_has_the_flax_tree():
    """init_params builds the tree create_train_state builds (same keys and
    shapes), so chip_smoke runs the real topology without JAX."""
    _, _, params, stats = _state()
    got_p, got_s = weights.init_params(get_config("baseline"), seed=0)

    def shapes(tree):
        return {jax.tree_util.keystr(k): np.shape(v)
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(got_p) == shapes(params)
    assert shapes(got_s) == shapes(stats)
    # the initializers' distributions
    w_hh = got_p["encoder"]["rnn"]["weight_hh_l0"]           # (384, 128)
    np.testing.assert_allclose(w_hh.T @ w_hh, np.eye(128), atol=1e-5)
    k = got_p["encoder"]["cnn"]["block1"]["conv"]["kernel"]  # (3,3,16,32)
    bound = np.sqrt(2.0) * np.sqrt(6.0 / (9 * 16 + 9 * 32))
    assert np.abs(k).max() <= bound and np.abs(k).max() > 0.9 * bound
    v = got_s["encoder"]["cnn"]["block0"]["bn"]["var"]
    assert (v >= 0.5).all() and (v <= 1.5).all() and v.std() > 0.1
