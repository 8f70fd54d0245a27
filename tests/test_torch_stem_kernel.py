"""Kernel K5's module (bsed_tpu_torch/ops/stem_kernel.py) and the fused-stem
serving branch against bsed_tpu on the same numpy inputs and flax-layout
weights, float32, device='cpu'.

The folding and the plain version (``reference_stem_block``, which the K5
wrapper runs for CPU tensors) are held against the JAX Pallas kernel in
interpret mode and the flax ConvBlock block 0, at atol 2e-5
(tests/test_stem_kernel.py). The fused-stem ``make_fast_forward`` is held
against ``bsed_tpu.serve.make_fast_forward(use_fused_stem=True)`` at
test_torch_serve.py's small geometry (128 mels), atol 1e-4 with the JAX
side at float32 matmul precision."""
import dataclasses

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.models.layers import ConvBlock as JConvBlock
from bsed_tpu.ops import stem_kernel as jsk
from bsed_tpu.serve import make_fast_forward as j_make_fast_forward
from bsed_tpu.train.steps import build_modules

from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.models.layers import ConvBlock
from bsed_tpu_torch.ops import stem_kernel as sk
from bsed_tpu_torch.serve import make_fast_forward
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.weights import init_params

SMALL = dict(sr=3200, hop_size=160, max_len_seconds=2.0)


def _block0(seed):
    """Block 0's flax-layout params with non-trivial biases and stats."""
    params, stats = init_params(get_config("baseline"), seed)
    rng = np.random.default_rng(seed + 1)
    p0 = jax.tree.map(
        lambda v: v + rng.normal(0, 0.05, v.shape).astype(np.float32),
        params["encoder"]["cnn"]["block0"])
    s0 = {"bn": {"mean": 0.1 * np.arange(16, dtype=np.float32),
                 "var": 1.0 + 0.05 * np.arange(16, dtype=np.float32)}}
    return p0, s0


def _flax_block0(x, p0, s0):
    class OnlyBlock0(nn.Module):
        @nn.compact
        def __call__(self, x):
            return JConvBlock(16, (2, 2), "glu", 0.5, 3, name="block0")(
                x, train=False)
    with jax.default_matmul_precision("float32"):
        return np.asarray(OnlyBlock0().apply(
            {"params": {"block0": p0}, "batch_stats": {"block0": s0}}, x))


@pytest.mark.parametrize("t", [100, 37])
def test_fold_and_plain_match_jax(t):
    p0, s0 = _block0(t)
    x = np.random.default_rng(t).standard_normal((2, t, 128, 1)).astype(
        np.float32)
    folded = sk.fold_block0_params(p0, s0)
    jfolded = jsk.fold_block0_params(p0, s0)
    for k in ("w_gate", "b_gate", "w_lin", "b_lin"):
        np.testing.assert_allclose(folded[k].numpy(), np.asarray(jfolded[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    before = sk.fused_stem_block.launches
    got = sk.fused_stem_block(torch.from_numpy(x), folded).numpy()
    assert sk.fused_stem_block.launches == before     # CPU: plain version
    want = np.asarray(jsk.fused_stem_block(x, jfolded))   # interpret mode
    assert got.shape == want.shape == (2, t // 2, 64, 16)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, _flax_block0(x, p0, s0), atol=2e-5)
    # the port's own eval ConvBlock on the same weights
    blk = ConvBlock(1, 16, (2, 2), "glu").eval()
    weights.load_conv_block(blk, p0, s0)
    with torch.no_grad():
        np.testing.assert_allclose(got, blk(torch.from_numpy(x)).numpy(),
                                   atol=2e-5)


def _pair(model_kw, seed=0):
    jcfg = j_get_config("baseline").replace(audio=JAudioConfig(**SMALL))
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **model_kw))
    cfg = get_config("baseline").replace(audio=AudioConfig(**SMALL))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    params, stats = init_params(cfg, seed)
    for head in params["predictor"].values():
        head["kernel"] *= 30.0
    return jcfg, cfg, params, stats


@pytest.mark.parametrize("stem_impl,compute_dtype", [
    ("pallas", "float32"), ("reference", "float32"), ("pallas", "bfloat16")])
def test_fused_stem_forward_matches_jax(stem_impl, compute_dtype):
    """The fused branch (K5's entry, its plain version on the CPU) against
    bsed_tpu's with the Pallas stem and with its reference stem. It runs
    blocks 1-6 and the BiGRU in float32 whatever compute_dtype says, on
    both sides, so bfloat16 holds the same gate."""
    jcfg, cfg, params, stats = _pair({"compute_dtype": compute_dtype}, 3)
    audio = np.random.default_rng(4).standard_normal(
        (3, cfg.audio.n_samples)).astype(np.float32)
    jfwd = jax.jit(j_make_fast_forward(jcfg, build_modules(jcfg), params,
                                       stats, use_fused_stem=True,
                                       stem_impl=stem_impl))
    with jax.default_matmul_precision("float32"):
        want = jfwd(audio)
    fwd = make_fast_forward(cfg, params, stats, device="cpu",
                            use_fused_stem=True)
    before = sk.fused_stem_block.launches
    got = fwd(audio)
    assert sk.fused_stem_block.launches == before
    assert got[0].shape == (3, cfg.n_frames, 20) and got[1].shape == (3, 20)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


# ---- K5's persistent walk and its ring (csrc/stem_kernel.cu) ---------------

@pytest.mark.parametrize("t", [2, 3, 8, 1255])
@pytest.mark.parametrize("blocks", [1, 3, 132, 5000])
def test_work_items_cover_every_pooled_row_once(t, blocks):
    """The persistent blocks' walk takes every pooled row of every clip
    exactly once, in items of at most ROWS_PER_ITEM rows, for any block
    count (more blocks than items leaves the rest idle)."""
    batch = 3
    walk = sk.work_items(batch, t, blocks)
    assert len(walk) == blocks
    seen = [(clip, t0 + r) for items in walk for clip, t0, rows in items
            for r in range(rows)]
    assert sorted(seen) == [(c, r) for c in range(batch)
                            for r in range(t // 2)]
    assert all(0 < rows <= sk.ROWS_PER_ITEM and t0 % sk.ROWS_PER_ITEM == 0
               for items in walk for _, t0, rows in items)
    sizes = [len(items) for items in walk]
    assert max(sizes) - min(sizes) <= 1         # round robin


def test_ring_shared_memory_holds_two_halo_tiles():
    """Two stages of an item's (2·RT + 2)-row halo tile, rows of 136
    floats (f = -1 .. 128 with 16-byte aligned copies of f = 0 .. 127);
    far below what a block may use (the kernel runs one block an SM)."""
    rows = 2 * sk.ROWS_PER_ITEM + 2
    assert sk.ring_shared_memory() == 2 * rows * 136 * 4 == 36_992
    assert sk.ring_shared_memory() + 1024 <= 228 * 1024
