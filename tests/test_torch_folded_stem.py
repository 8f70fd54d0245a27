"""The port's folded stem (bsed_tpu_torch/ops/folded_stem.py) against the
JAX build_folded_stem on the same flax-layout parameters, float32, with
the fused epilogue off and on (the JAX kernel in interpret mode, the
port's K2 wrapper on its plain version). Gate 1e-5."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from bsed_tpu.ops import folded_stem as jfs

from bsed_tpu_torch.config import get_config
from bsed_tpu_torch.ops import folded_stem as fs
from bsed_tpu_torch.utils.weights import init_params

FILTERS = (16, 32, 64, 128, 128, 128, 128)
POOLING = ((2, 2), (2, 2), (1, 2), (1, 2), (1, 2), (1, 2), (1, 2))


def _cnn_trees(activation, seed=0):
    cfg = get_config("baseline")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                activation=activation))
    params, stats = init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    # non-trivial conv/GLU biases and BN affine on top of the init
    cnn = jax.tree.map(
        lambda v: v + rng.normal(0, 0.05, v.shape).astype(np.float32),
        params["encoder"]["cnn"])
    return cnn, stats["encoder"]["cnn"]


def test_fold_helpers_match_jax():
    k = np.random.default_rng(0).normal(size=(3, 3, 4, 6)).astype(np.float32)
    for f in (1, 2, 4):
        np.testing.assert_array_equal(fs.fold_conv_kernel(k, f),
                                      jfs.fold_conv_kernel(k, f))
    np.testing.assert_array_equal(fs._block_diag(k[0, 0], 4),
                                  jfs._block_diag(k[0, 0], 4))
    np.testing.assert_array_equal(fs._freq_pool_matrix(8, 2, 16),
                                  jfs._freq_pool_matrix(8, 2, 16))


@pytest.mark.parametrize("activation,fused", [
    ("glu", False), ("glu", True), ("cg", True), ("relu", False)])
def test_folded_stem_matches_jax(activation, fused):
    cnn, stats = _cnn_trees(activation)
    mel = np.random.default_rng(7).normal(size=(2, 64, 128, 1)).astype(
        np.float32)
    jstem, jn = jfs.build_folded_stem(cnn, stats, FILTERS, POOLING,
                                      activation=activation,
                                      fused_epilogue=fused)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(jstem)(mel))
    stem, n = fs.build_folded_stem(cnn, stats, FILTERS, POOLING,
                                   activation=activation,
                                   fused_epilogue=fused, device="cpu")
    assert n == jn == 3
    with torch.no_grad():
        got = stem(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
