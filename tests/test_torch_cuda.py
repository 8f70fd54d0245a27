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
from bsed_tpu_torch.models.rnn import (BidirectionalGRU, bigru_hoisted,
                                       gru_scan_bidir)
from bsed_tpu_torch.ops import (gru_kernel, mel, mel_kernel, stem_epilogue,
                                stem_kernel)
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


@pytest.mark.parametrize("batch", [1, 3, 64])
def test_mel_kernel_matches_plain(dev, batch):
    """K1 against its plain version and a float64 torch.stft golden, 1e-3
    dB; 2 s clips give T = 251 frames, not a multiple of the 8-frame
    tile."""
    cfg = AudioConfig(max_len_seconds=2.0)
    fb = mel_filterbank(cfg.sr, cfg.n_window, cfg.n_mels, dtype=np.float64)
    kb = mel_kernel.build_mel_kernel_bases(cfg.n_window, cfg.hop_size, fb,
                                           device=dev)
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, cfg.n_samples)).astype(np.float32)).to(dev)
    before = mel_kernel.fused_block_mel.launches
    got = mel_kernel.fused_block_mel(audio, kb, cfg.n_window, cfg.hop_size,
                                     cfg.n_mels)
    want = mel_kernel.fused_block_mel_plain(audio, kb, cfg.n_window,
                                            cfg.hop_size, cfg.n_mels)
    spec = torch.stft(audio.double(), cfg.n_window, cfg.hop_size,
                      window=torch.hamming_window(cfg.n_window,
                                                  periodic=False,
                                                  dtype=torch.float64,
                                                  device=dev),
                      center=True, pad_mode="reflect", return_complex=True)
    gold = spec.abs().transpose(1, 2) @ torch.from_numpy(fb).to(dev)
    torch.cuda.synchronize()
    assert mel_kernel.fused_block_mel.launches == before + 1
    assert got.shape == (batch, 251, cfg.n_mels)
    db = mel.amplitude_to_db
    assert float((db(got) - db(want)).abs().max()) < 1e-3          # dB
    assert float((db(got.double()) - db(gold)).abs().max()) < 1e-3  # dB


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


def _train_inputs(dev, dtype, t_in, pc, seed=2):
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    h = g(2, t_in, 16, 128).to(dtype)
    inv, c, b = g(128) * 0.2 + 1.0, g(128) * 0.3, g(128) * 0.1
    w = (g(128, 128) / np.sqrt(128)).to(dtype)
    bits = torch.from_numpy(rng.integers(0, 256, (2, t_in * 16, 128),
                                         dtype=np.uint8)).to(dev)
    pool_w = torch.from_numpy(_freq_pool_matrix(128 // pc, 2, pc)).to(dev)
    return h, inv, c, w, b, bits, pool_w


@pytest.mark.parametrize("act,pt,pc,t_in", [("glu", 2, 16, 21),
                                            ("glu", 2, 32, 23),
                                            ("cg", 1, 64, 21)])
@pytest.mark.parametrize("with_bits", [False, True])
def test_stem_epilogue_train_matches_plain_f32(dev, act, pt, pc, t_in,
                                               with_bits):
    """K2 (train form) and K3 against the plain chain and its autograd,
    float32: forward 1e-5, the five gradients 2e-4
    (tests/test_stem_epilogue.py gates)."""
    h, inv, c, w, b, bits, pool_w = _train_inputs(dev, torch.float32, t_in,
                                                  pc)
    bits = bits if with_bits else None
    ep = stem_epilogue.make_fused_epilogue(act, pt, pool_w,
                                           rate=0.5 if with_bits else 0.0)
    leaves = [t.clone().requires_grad_(True) for t in (h, inv, c, w, b)]
    n_fwd = stem_epilogue.stem_epilogue_fwd.launches
    n_bwd = stem_epilogue.stem_epilogue_bwd.launches
    got = ep(*leaves, bits)
    gz = torch.randn(got.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(5))
    grads = torch.autograd.grad(got, leaves, gz)
    want = stem_epilogue.stem_epilogue_plain(h, inv, c, w, b, act, pt,
                                             pool_w, bits,
                                             128 if with_bits else 0)
    want_g = stem_epilogue.stem_epilogue_bwd_plain(
        gz, h, inv, c, w, b, act, pt, pool_w, bits, 128 if with_bits else 0)
    torch.cuda.synchronize()
    assert stem_epilogue.stem_epilogue_fwd.launches == n_fwd + 1
    assert stem_epilogue.stem_epilogue_bwd.launches == n_bwd + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for name, a, e in zip("h inv c w b".split(), grads, want_g):
        torch.testing.assert_close(a.float(), e.float(), rtol=2e-4,
                                   atol=2e-4, msg=f"grad {name}")
    if t_in % pt:                                 # the dropped odd row
        assert float(grads[0][:, -1].abs().max()) == 0.0


def test_stem_epilogue_train_bf16_and_deterministic(dev):
    """bf16: forward within 0.06 and each gradient within 5e-2 relative
    Frobenius error of the plain chain (which rounds every op to bf16);
    K3's parameter reductions are bit-identical across two runs."""
    h, inv, c, w, b, bits, pool_w = _train_inputs(dev, torch.bfloat16, 21,
                                                  16, seed=3)
    gz = torch.randn((2, 10, 16, 64), device=dev,
                     generator=torch.Generator(dev).manual_seed(6)).bfloat16()
    out = stem_epilogue.stem_epilogue_fwd(h, inv, c, w, b, "glu", 2, pool_w,
                                          16, bits, 128)
    want = stem_epilogue.stem_epilogue_plain(h, inv, c, w, b, "glu", 2,
                                             pool_w, bits, 128)
    torch.testing.assert_close(out.float(), want.float(), rtol=0.06,
                               atol=0.06)
    run = lambda: stem_epilogue.stem_epilogue_bwd(  # noqa: E731
        gz, h, inv, c, w, b, "glu", 2, pool_w, 16, bits, 128)
    first, second = run(), run()
    plain = stem_epilogue.stem_epilogue_bwd_plain(gz, h, inv, c, w, b, "glu",
                                                  2, pool_w, bits, 128)
    torch.cuda.synchronize()
    for name, a, a2, e in zip("h inv c w b".split(), first, second, plain):
        assert torch.equal(a, a2), f"grad {name} differs between runs"
        rel = float((a.float() - e.float()).norm() / e.float().norm())
        assert rel < 5e-2, f"grad {name}: relative error {rel}"


@pytest.mark.parametrize("t", [100, 37])
def test_stem_kernel_matches_plain(dev, t):
    """K5 against reference_stem_block, float32, 2e-5
    (tests/test_stem_kernel.py); odd T drops the last row."""
    rng = np.random.default_rng(7)
    p0 = {"conv": {"kernel": rng.normal(0, 0.3, (3, 3, 1, 16)),
                   "bias": rng.normal(0, 0.1, 16)},
          "bn": {"scale": rng.uniform(0.5, 1.5, 16),
                 "bias": rng.normal(0, 0.1, 16)},
          "GLU_0": {"linear": {"kernel": rng.normal(0, 0.3, (16, 16)),
                               "bias": rng.normal(0, 0.1, 16)}}}
    s0 = {"bn": {"mean": rng.normal(0, 0.1, 16),
                 "var": rng.uniform(0.5, 1.5, 16)}}
    folded = stem_kernel.fold_block0_params(p0, s0, device=dev)
    x = torch.from_numpy(rng.standard_normal((3, t, 128, 1)).astype(
        np.float32)).to(dev)
    before = stem_kernel.fused_stem_block.launches
    got = stem_kernel.fused_stem_block(x, folded)
    want = stem_kernel.reference_stem_block(x, folded)
    torch.cuda.synchronize()
    assert stem_kernel.fused_stem_block.launches == before + 1
    assert got.shape == want.shape == (3, t // 2, 64, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("t", [1, 32, 313])
@pytest.mark.parametrize("batch", [1, 5, 64])
def test_gru_kernel_matches_plain(dev, batch, t):
    """K4 against its plain version: 1e-5 in float32; in bfloat16 within
    3e-2 of the float32 scan (tests/test_gru_kernel.py)."""
    rng = np.random.default_rng(8)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev)
    xp2, w, bias = g(2, batch, t, 384), g(2, 384, 128) * 0.1, g(2, 384) * 0.1
    before = gru_kernel.gru_bidir_recurrence.launches
    got = gru_kernel.gru_bidir_recurrence(xp2, w, bias)
    want = gru_kernel.gru_bidir_recurrence_plain(xp2, w, bias)
    scan = gru_scan_bidir(xp2, w, bias)
    got16 = gru_kernel.gru_bidir_recurrence(xp2.bfloat16(), w.bfloat16(),
                                            bias.bfloat16())
    torch.cuda.synchronize()
    assert gru_kernel.gru_bidir_recurrence.launches == before + 2
    assert got.shape == (2, batch, t, 128) and got16.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, scan, rtol=1e-5, atol=1e-5)
    assert float((got16.float() - scan).abs().max()) <= 3e-2


def test_hoisted_bigru_kernel_matches_nn_gru(dev):
    """A 2-layer BiGRU through the hoisted form + K4 against the module's
    own nn.GRU (cuDNN) on the same weights, float32, 1e-4."""
    torch.manual_seed(0)
    rnn = BidirectionalGRU(128, 128, 2).to(dev).eval()
    x = torch.randn((4, 50, 128), device=dev)
    with torch.no_grad():
        got = bigru_hoisted(rnn, x)
        want = rnn(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("g,pt,pg", [(16, 1, 2), (2, 1, 2), (8, 2, 2),
                                     (4, 1, 1)])
@pytest.mark.parametrize("with_bits", [False, True])
def test_stem_epilogue_group_pool_matches_plain(dev, g, pt, pg, with_bits):
    """K2-pg and K3-pg against the plain chain and its autograd, float32:
    forward 1e-5, the five gradients 2e-4."""
    rng = np.random.default_rng(9)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev)
    h = f(2, 21, g, 128)
    inv, c, b = f(128) * 0.2 + 1.0, f(128) * 0.3, f(128) * 0.1
    w = f(128, 128) / np.sqrt(128)
    bits = (torch.from_numpy(rng.integers(0, 256, (2, 21 * g, 128),
                                          dtype=np.uint8)).to(dev)
            if with_bits else None)
    keep_k = 128 if with_bits else 0
    ep = stem_epilogue.make_fused_epilogue(
        "glu", pt, None, rate=0.5 if with_bits else 0.0, pg=pg)
    leaves = [t.clone().requires_grad_(True) for t in (h, inv, c, w, b)]
    n_fwd = stem_epilogue.stem_epilogue_fwd.launches
    n_bwd = stem_epilogue.stem_epilogue_bwd.launches
    got = ep(*leaves, bits)
    gz = torch.randn(got.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(5))
    grads = torch.autograd.grad(got, leaves, gz)
    want = stem_epilogue.stem_epilogue_plain(h, inv, c, w, b, "glu", pt,
                                             None, bits, keep_k, pg)
    want_g = stem_epilogue.stem_epilogue_bwd_plain(
        gz, h, inv, c, w, b, "glu", pt, None, bits, keep_k, pg)
    torch.cuda.synchronize()
    assert stem_epilogue.stem_epilogue_fwd.launches == n_fwd + 1
    assert stem_epilogue.stem_epilogue_bwd.launches == n_bwd + 1
    assert got.shape == (2, 21 // pt, g // pg, 128)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for name, a, e in zip("h inv c w b".split(), grads, want_g):
        torch.testing.assert_close(a.float(), e.float(), rtol=2e-4,
                                   atol=2e-4, msg=f"grad {name}")
