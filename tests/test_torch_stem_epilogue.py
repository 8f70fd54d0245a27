"""K2's plain version (bsed_tpu_torch/ops/stem_epilogue.py, what the
wrapper runs on CPU tensors) against the JAX fused stem epilogue in
interpret mode, on identical numpy inputs: odd T=21, general inv/c, the
folded stem's pair-averaging pool_w. Gate 1e-5 in float32, as
tests/test_stem_epilogue.py holds the Pallas kernel."""
import numpy as np
import pytest
import torch

from bsed_tpu.ops.folded_stem import _freq_pool_matrix as j_freq_pool_matrix
from bsed_tpu.ops.stem_epilogue import make_fused_epilogue as j_make

from bsed_tpu_torch.ops import stem_epilogue as se
from bsed_tpu_torch.ops.folded_stem import _freq_pool_matrix

B, T, G, L, L2 = 2, 21, 16, 128, 64


def _inputs(seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, T, G, L)).astype(np.float32)
    inv = rng.uniform(0.5, 1.5, L).astype(np.float32)
    c = (rng.standard_normal(L) * 0.3).astype(np.float32)
    w = (rng.standard_normal((L, L)) / np.sqrt(L)).astype(np.float32)
    b = (rng.standard_normal(L) * 0.1).astype(np.float32)
    return h, inv, c, w, b


@pytest.mark.parametrize("act", ["glu", "cg"])
@pytest.mark.parametrize("pt", [1, 2])
def test_plain_matches_jax_kernel(act, pt):
    h, inv, c, w, b = _inputs(0)
    pool_w = _freq_pool_matrix(2, 2, 64)
    want = np.asarray(j_make(act, pt, 0.0, pool_w, tile_target=8)(
        h, inv, c, w, b, None))
    ep = se.make_fused_epilogue(act, pt, torch.from_numpy(pool_w))
    before = se.stem_epilogue_fwd.launches
    got = ep(*map(torch.from_numpy, (h, inv, c, w, b)))
    assert se.stem_epilogue_fwd.launches == before   # no launch on CPU
    assert got.shape == (B, T // pt, G, L2) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f,c", [(8, 16), (4, 32), (2, 64)])
def test_pair_pool_channels_recovers_fold(f, c):
    """The three serving blocks' pool matrices (the JAX package's own) are
    recognised with the channels per fold copy the kernel needs."""
    assert se.pair_pool_channels(j_freq_pool_matrix(f, 2, c)) == c


def test_rejects_what_the_kernel_does_not_compute():
    pool_w = _freq_pool_matrix(2, 2, 64)
    with pytest.raises(ValueError, match="pair-averaging"):
        se.make_fused_epilogue("glu", 2,
                               torch.from_numpy(pool_w[:, ::-1].copy()))
    with pytest.raises(ValueError, match="pair-averaging"):
        se.make_fused_epilogue("glu", 2, torch.ones(128, 64) / 128)
    with pytest.raises(ValueError, match="glu/cg"):
        se.make_fused_epilogue("relu", 2, torch.from_numpy(pool_w))
    with pytest.raises(ValueError, match="time pool"):
        se.make_fused_epilogue("glu", 4, torch.from_numpy(pool_w))


def test_bf16_plain_close_to_jax_kernel():
    """bf16: the plain chain rounds at every op, the kernel keeps f32
    registers; the repo's bf16 gate (test_stem_epilogue.py:111-113)."""
    h, inv, c, w, b = _inputs(3)
    pool_w = _freq_pool_matrix(2, 2, 64)
    import jax.numpy as jnp
    want = j_make("glu", 2, 0.0, pool_w, tile_target=8)(
        jnp.asarray(h, jnp.bfloat16), inv, c, jnp.asarray(w, jnp.bfloat16),
        b, None)
    got = se.make_fused_epilogue("glu", 2, torch.from_numpy(pool_w))(
        torch.from_numpy(h).bfloat16(), torch.from_numpy(inv),
        torch.from_numpy(c), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0.06, atol=0.06)
