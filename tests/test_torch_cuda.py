"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an NVIDIA GPU with the CUDA toolkit (the kernels are built with
nvcc at first use) and skip elsewhere; the file imports no JAX, so it runs
on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from bsed_tpu_torch.config import AudioConfig
from bsed_tpu_torch.ops import mel, mel_kernel, stem_epilogue
from bsed_tpu_torch.ops.filterbank import mel_filterbank
from bsed_tpu_torch.ops.folded_stem import _freq_pool_matrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_mel_kernel_matches_plain(dev):
    cfg = AudioConfig(max_len_seconds=2.0)
    fb = mel_filterbank(cfg.sr, cfg.n_window, cfg.n_mels, dtype=np.float64)
    kb = mel_kernel.build_mel_kernel_bases(cfg.n_window, cfg.hop_size, fb,
                                           device=dev)
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, cfg.n_samples)).astype(np.float32)).to(dev)
    before = mel_kernel.fused_block_mel.launches
    got = mel_kernel.fused_block_mel(audio, kb, cfg.n_window, cfg.hop_size,
                                     cfg.n_mels)
    want = mel_kernel.fused_block_mel_plain(audio, kb, cfg.n_window,
                                            cfg.hop_size, cfg.n_mels)
    torch.cuda.synchronize()
    assert mel_kernel.fused_block_mel.launches == before + 1
    diff = (mel.amplitude_to_db(got) - mel.amplitude_to_db(want)).abs()
    assert float(diff.max()) < 1e-3                       # dB


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.06)])
@pytest.mark.parametrize("act,pt,pc", [("glu", 2, 16), ("cg", 1, 64)])
def test_stem_epilogue_matches_plain(dev, dtype, tol, act, pt, pc):
    rng = np.random.default_rng(1)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    h = g(2, 21, 16, 128).to(dtype)
    inv, c, b = g(128) * 0.2 + 1.0, g(128) * 0.3, g(128) * 0.1
    w = (g(128, 128) / np.sqrt(128)).to(dtype)
    pool_w = torch.from_numpy(_freq_pool_matrix(128 // pc, 2, pc)).to(dev)
    ep = stem_epilogue.make_fused_epilogue(act, pt, pool_w)
    got = ep(h, inv, c, w, b)
    want = stem_epilogue.stem_epilogue_plain(h, inv, c, w, b, act, pt,
                                             pool_w)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, 21 // pt, 16, 64)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
