"""Kernel K4's module (bsed_tpu_torch/ops/gru_kernel.py) and the hoisted
BiGRU form (models/rnn.bigru_hoisted) against bsed_tpu on the same numpy
inputs and weights.

The plain recurrence (which the K4 wrapper runs for CPU tensors) is held
against the JAX Pallas kernel in interpret mode and against
``_gru_scan_bidir`` at 1e-5 in float32; in bfloat16 within 3e-2 of the
float32 scan (tests/test_gru_kernel.py). A whole 2-layer BiGRU in the
hoisted form, through K4's entry (its plain version on the CPU; the
card's route is tests/test_torch_cuda.py's), is held against bsed_tpu's
BidirectionalGRU and against the port's cuDNN-form ``nn.GRU`` at 1e-4.
The serving form (``HoistedBiGRU``, weights laid out once) equals the
per-call form to 1e-6 in float32, and in bfloat16 on K4's plain version
stays within 3e-2 of bsed_tpu's float32 module (tests/test_gru_kernel.py's
gate for the JAX kernel in bfloat16)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsed_tpu.models.rnn import BidirectionalGRU as JBidirectionalGRU
from bsed_tpu.models.rnn import _gru_scan_bidir
from bsed_tpu.ops.gru_kernel import gru_bidir_recurrence as j_recurrence

from bsed_tpu_torch.config import get_config
from bsed_tpu_torch.models.rnn import (BidirectionalGRU, HoistedBiGRU,
                                       bigru_hoisted, gru_scan_bidir)
from bsed_tpu_torch.ops import gru_kernel
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.weights import init_params

B, H = 8, 128


def _inputs(t, seed, bias_scale=0.1):
    rng = np.random.default_rng(seed)
    xp2 = rng.standard_normal((2, B, t, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((2, 3 * H, H)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((2, 3 * H)) * bias_scale).astype(np.float32)
    return xp2, w, bias


def _port(xp2, w, bias, dtype=torch.float32):
    before = gru_kernel.gru_bidir_recurrence.launches
    out = gru_kernel.gru_bidir_recurrence(
        torch.from_numpy(xp2).to(dtype), torch.from_numpy(w).to(dtype),
        torch.from_numpy(bias).to(dtype))
    assert gru_kernel.gru_bidir_recurrence.launches == before   # CPU: plain
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("t", [77, 313, 32])
def test_plain_matches_jax_f32(t):
    xp2, w, bias = _inputs(t, 0)
    got = _port(xp2, w, bias)
    scan = np.asarray(_gru_scan_bidir(jnp.asarray(xp2), jnp.asarray(w),
                                      jnp.asarray(bias)))
    assert got.shape == scan.shape == (2, B, t, H)
    np.testing.assert_allclose(got, scan, rtol=1e-5, atol=1e-5)
    kern = np.asarray(j_recurrence(jnp.asarray(xp2), jnp.asarray(w),
                                   jnp.asarray(bias)))       # interpret mode
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)
    # the port's scan is the same recurrence in float32
    np.testing.assert_array_equal(gru_scan_bidir(
        *map(torch.from_numpy, (xp2, w, bias))).numpy(), got)


def test_plain_bf16_close_to_f32_scan():
    xp2, w, _ = _inputs(64, 1)
    bias = np.zeros((2, 3 * H), np.float32)
    got = _port(xp2, w, bias, torch.bfloat16)
    ref = np.asarray(_gru_scan_bidir(jnp.asarray(xp2), jnp.asarray(w),
                                     jnp.asarray(bias)))
    np.testing.assert_allclose(got, ref, atol=3e-2)
    # the JAX kernel's bf16 numerics (bf16 operands, f32 state): within a
    # few bf16 ulps of the port's plain version
    kern = np.asarray(j_recurrence(jnp.asarray(xp2, jnp.bfloat16),
                                   jnp.asarray(w, jnp.bfloat16),
                                   jnp.asarray(bias, jnp.bfloat16)),
                      np.float32)
    np.testing.assert_allclose(got, kern, atol=1e-2)


def test_hoisted_bigru_matches_jax_and_nn_gru():
    params, _ = init_params(get_config("baseline"), 5)
    rnn_params = params["encoder"]["rnn"]
    x = np.random.default_rng(6).standard_normal((3, 40, 128)).astype(
        np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JBidirectionalGRU(128, 2).apply(
            {"params": rnn_params}, jnp.asarray(x)))
    rnn = BidirectionalGRU(128, 128, 2).eval()
    weights.load_gru(rnn, rnn_params)
    with torch.no_grad():
        got = bigru_hoisted(rnn, torch.from_numpy(x))
        cudnn_form = rnn(torch.from_numpy(x))
    assert got.shape == (3, 40, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), cudnn_form.numpy(), rtol=1e-4,
                               atol=1e-4)


def _rnn_and_input(seed, dtype=None, shape=(3, 40, 128)):
    params, _ = init_params(get_config("baseline"), seed)
    rnn_params = params["encoder"]["rnn"]
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    rnn = BidirectionalGRU(128, 128, 2, dtype=dtype).eval()
    weights.load_gru(rnn, rnn_params)
    return rnn_params, rnn, x


def test_built_weights_match_per_call_form():
    """HoistedBiGRU lays W_ih of both directions out as one (D, 6H)
    matrix and W_hh in K4's layout once; the result is the per-call form's
    (two projections a layer, the layout made in the K4 wrapper) to 1e-6,
    and no launch happens on CPU tensors."""
    _, rnn, x = _rnn_and_input(7)
    before = gru_kernel.gru_bidir_recurrence.launches
    with torch.no_grad():
        built = HoistedBiGRU(rnn)
        got = built(torch.from_numpy(x))
        want = bigru_hoisted(rnn, torch.from_numpy(x))
    assert gru_kernel.gru_bidir_recurrence.launches == before
    assert got.shape == (3, 40, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    w_ih, b_ih, w_hh = built.layers[1]
    assert w_ih.shape == (256, 768) and b_ih.shape == (768,)
    assert w_hh.w_t2.shape == (2, 128, 384) and w_hh.b2.dtype == torch.float32


def test_bf16_hoisted_on_plain_recurrence_close_to_jax_f32():
    """The serving form in bfloat16 (projections and h rounded to bf16,
    state carried in f32, as K4 computes) on K4's plain version, against
    bsed_tpu's float32 BidirectionalGRU on the same weights: 3e-2."""
    rnn_params, rnn, x = _rnn_and_input(9, torch.bfloat16, (2, 64, 128))
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JBidirectionalGRU(128, 2).apply(
            {"params": rnn_params}, jnp.asarray(x)))
    with torch.no_grad():
        got = HoistedBiGRU(rnn)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=3e-2)


def test_rows_per_block_fills_one_wave():
    """K4's (RB, C) helper: the fewest batch rows per cluster of 2 blocks
    that run both directions in one wave of 132 SMs (66 clusters); past 8
    rows the launch takes several waves."""
    assert gru_kernel.cluster_shape(1, 132) == (1, 2)
    assert gru_kernel.cluster_shape(5, 132) == (1, 2)
    assert gru_kernel.cluster_shape(8, 132) == (1, 2)
    assert gru_kernel.cluster_shape(64, 132) == (2, 2)
    assert gru_kernel.cluster_shape(72, 132) == (4, 2)
    assert gru_kernel.cluster_shape(128, 132) == (4, 2)
    assert gru_kernel.cluster_shape(1000, 132) == (8, 2)
    # a card whose GPCs hold fewer clusters than sms // C
    assert gru_kernel.cluster_shape(64, 132, clusters=60) == (4, 2)


@pytest.mark.parametrize("batch", [1, 5, 64, 128])
def test_cluster_shape_fills_one_wave(batch):
    rows, cluster = gru_kernel.cluster_shape(batch, 132)
    clusters = 2 * -(-batch // rows)
    assert cluster == gru_kernel.CLUSTER and rows in (1, 2, 4, 8)
    assert clusters * cluster <= 132
    if rows > 1:                     # no fewer rows would fit
        assert 2 * -(-batch // (rows // 2)) * cluster > 132
