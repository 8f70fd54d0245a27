"""The port's CUDA kernels against their plain PyTorch versions on the card.

The plain side of each comparison runs inside ``kernels.plain_versions()``,
which makes every kernel entry take its plain version on the card too.

These need an NVIDIA GPU with the CUDA toolkit (the kernels are built with
nvcc at first use) and skip elsewhere; the file imports no JAX, so it runs
on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

import dataclasses

from bsed_tpu_torch import kernels
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.models.rnn import (BidirectionalGRU, HoistedBiGRU,
                                       bigru_hoisted, gru_scan_bidir)
from bsed_tpu_torch.ops import (gru_kernel, mel, mel_kernel, pos_conv,
                                stem_epilogue, stem_kernel)
from bsed_tpu_torch.ops.filterbank import mel_filterbank
from bsed_tpu_torch.ops.folded_stem import _freq_pool_matrix
from bsed_tpu_torch.serve import make_fast_forward
from bsed_tpu_torch.utils.weights import init_params

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


@pytest.mark.parametrize("batch", [3, 64])
def test_mel_kernel_power_db_matches_plain(dev, batch):
    """K1's power-dB form at HTS-AT's geometry (N = 1024, H = 320, 64
    Slaney mels, periodic Hann, 10 s at 32 kHz: T = 1001 frames, not a
    multiple of the 8-frame tile) against its plain version and a float64
    torch.stft golden of the power mel's unclamped dB, 1e-3 dB; one launch,
    counted as the power-dB form's."""
    cfg = AudioConfig(n_window=1024, hop_size=320, n_mels=64,
                      mel_f_min=50.0, mel_f_max=14000.0)
    fb = mel_filterbank(cfg.sr, cfg.n_window, cfg.n_mels, cfg.mel_f_min,
                        cfg.mel_f_max, dtype=np.float64, norm="slaney")
    kb = mel_kernel.build_mel_kernel_bases(
        cfg.n_window, cfg.hop_size, fb, device=dev,
        window=mel.hann_window(cfg.n_window), power_db=True)
    audio = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (batch, cfg.n_samples)).astype(np.float32)).to(dev)
    k1 = mel_kernel.fused_block_mel
    before = (k1.launches, k1.launches_db)
    got = mel_kernel.fused_block_mel(audio, kb, cfg.n_window, cfg.hop_size,
                                     cfg.n_mels)
    want = mel_kernel.fused_block_mel_plain(audio, kb, cfg.n_window,
                                            cfg.hop_size, cfg.n_mels)
    spec = torch.stft(audio[:3].double(), cfg.n_window, cfg.hop_size,
                      window=torch.hann_window(cfg.n_window, periodic=True,
                                               dtype=torch.float64,
                                               device=dev),
                      center=True, pad_mode="reflect", return_complex=True)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
    gold = mel.power_to_db(power @ torch.from_numpy(fb).to(dev),
                           top_db=None)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_db) == (before[0] + 1, before[1] + 1)
    assert got.shape == (batch, 1001, cfg.n_mels)
    assert float((got - want).abs().max()) < 1e-3                   # dB
    assert float((got[:3].double() - gold).abs().max()) < 1e-3       # dB


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


FORMS = [("glu", 2, 16), ("cg", 1, 64), ("glu", 1, 32), ("cg", 2, 32)]


def _matrix_inputs(dev, dtype, batch, t_in, pt, pc, with_bits, seed=21):
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev)
    h = g(batch, t_in, 16, 128).to(dtype)
    inv, c, b = g(128) * 0.2 + 1.0, g(128) * 0.3, g(128) * 0.1
    w = (g(128, 128) / np.sqrt(128)).to(dtype)
    bits = (torch.from_numpy(rng.integers(0, 256, (batch, t_in * 16, 128),
                                          dtype=np.uint8)).to(dev)
            if with_bits else None)
    gz = g(batch, t_in // pt, 16, 64).to(dtype)
    pool_w = torch.from_numpy(_freq_pool_matrix(128 // pc, 2, pc)).to(dev)
    return h, inv, c, w, b, bits, gz, pool_w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 3, 72])
@pytest.mark.parametrize("t_in", [20, 21, 23])
@pytest.mark.parametrize("act,pt,pc", FORMS)
@pytest.mark.parametrize("with_bits", [False, True])
def test_stem_epilogue_forms_match_plain(dev, dtype, batch, t_in, act, pt,
                                         pc, with_bits):
    """K2 and K3 against their plain versions over batch sizes, even and
    odd T, a ragged last panel (T = 23: 11 pooled rows in panels of 2), the
    lane pools of blocks 0-2, both gates, both time pools, with and
    without dropout bits. float32 (FMA bodies): forward 1e-5, gradients
    2e-4, the parameter reductions also passing when no farther from the
    float64 chain than twice the plain version is; bfloat16 (tensor-core
    bodies): forward 0.06, gradients 5e-2 relative Frobenius."""
    h, inv, c, w, b, bits, gz, pool_w = _matrix_inputs(
        dev, dtype, batch, t_in, pt, pc, with_bits)
    keep_k = 128 if with_bits else 0
    args = (h, inv, c, w, b, act, pt, pool_w)
    n_fwd = stem_epilogue.stem_epilogue_fwd.launches
    n_bwd = stem_epilogue.stem_epilogue_bwd.launches
    got = stem_epilogue.stem_epilogue_fwd(*args, pc, bits, keep_k)
    grads = stem_epilogue.stem_epilogue_bwd(gz, *args, pc, bits, keep_k)
    want = stem_epilogue.stem_epilogue_plain(*args, bits, keep_k)
    want_g = stem_epilogue.stem_epilogue_bwd_plain(gz, *args, bits, keep_k)
    torch.cuda.synchronize()
    assert stem_epilogue.stem_epilogue_fwd.launches == n_fwd + 1
    assert stem_epilogue.stem_epilogue_bwd.launches == n_bwd + 1
    assert got.shape == (batch, t_in // pt, 16, 64)
    if t_in % pt:                                 # the dropped odd row
        assert float(grads[0][:, -1].abs().max()) == 0.0
    if dtype is torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=0.06,
                                   atol=0.06)
        for name, a, e in zip("h inv c w b".split(), grads, want_g):
            rel = float((a.float() - e.float()).norm()
                        / e.float().norm().clamp_min(1e-30))
            assert rel < 5e-2, f"grad {name}: relative error {rel}"
        return
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[0], want_g[0], rtol=2e-4, atol=2e-4)
    g64 = stem_epilogue.stem_epilogue_bwd_plain(
        gz.double(), h.double(), inv.double(), c.double(), w.double(),
        b.double(), act, pt, pool_w.double(), bits, keep_k)
    for name, a, e, e64 in zip("inv c w b".split(), grads[1:], want_g[1:],
                               g64[1:]):
        close = bool(((a - e).abs() <= 2e-4 + 2e-4 * e.abs()).all())
        far_k = float((a.double() - e64).abs().max())
        far_p = float((e.double() - e64).abs().max())
        assert close or far_k <= 2 * far_p, (
            f"grad {name}: {float((a - e).abs().max())} from the plain "
            f"version, {far_k} from float64 (plain: {far_p})")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 72])
def test_stem_epilogue_bwd_is_bit_identical(dev, dtype, batch):
    """K3 twice on the same input: all five outputs have the same bits."""
    h, inv, c, w, b, bits, gz, pool_w = _matrix_inputs(
        dev, dtype, batch, 23, 2, 16, True, seed=22)
    run = lambda: stem_epilogue.stem_epilogue_bwd(  # noqa: E731
        gz, h, inv, c, w, b, "glu", 2, pool_w, 16, bits, 128)
    first, second = run(), run()
    torch.cuda.synchronize()
    for name, a, a2 in zip("h inv c w b".split(), first, second):
        assert torch.equal(a, a2), f"grad {name} differs between runs"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bits", [False, True])
def test_stem_epilogue_bwd_ignores_nan_in_dropped_rows(dev, dtype,
                                                       with_bits):
    """h rows past Tout·pt (the odd last row under pt = 2) set to NaN: the
    rows never reach a product, so dW, dinv, dc and db stay finite and
    equal the run with finite values there, and dh of those rows is 0."""
    h, inv, c, w, b, bits, gz, pool_w = _matrix_inputs(
        dev, dtype, 3, 23, 2, 32, with_bits, seed=23)
    keep_k = 128 if with_bits else 0
    run = lambda x: stem_epilogue.stem_epilogue_bwd(  # noqa: E731
        gz, x, inv, c, w, b, "glu", 2, pool_w, 32, bits, keep_k)
    clean = run(h)
    poisoned = h.clone()
    poisoned[:, -1] = float("nan")
    got = run(poisoned)
    torch.cuda.synchronize()
    for name, a, e in zip("h inv c w b".split(), got, clean):
        assert torch.isfinite(a).all(), f"grad {name} is not finite"
        assert torch.equal(a, e), f"grad {name} moved with the NaN rows"
    assert float(got[0][:, -1].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_pool_shared_memory_matches_source(dev, dtype):
    """K2's group-pool form requests the bytes the Python helper states."""
    import ctypes
    from bsed_tpu_torch import kernels
    entry = kernels.load("stem_epilogue").bsed_stem_epilogue_pg_smem_bytes
    entry.restype, entry.argtypes = ctypes.c_int, [ctypes.c_int]
    want = stem_epilogue.kernel_shared_memory("fwd", dtype, False)["bytes"]
    assert entry(int(dtype is torch.bfloat16)) == want


@pytest.mark.parametrize("dtype,body", [(torch.float32, "fma"),
                                        (torch.bfloat16, "mma")])
def test_stem_epilogue_shared_memory_matches_sources(dev, dtype, body):
    """The shared-memory bytes the Python helper states are what the built
    sources request, for K2 and K3."""
    import ctypes
    from bsed_tpu_torch import kernels
    assert stem_epilogue.kernel_body(dtype) == {"fwd": body, "bwd": body}
    for kernel, lib, fn in (("fwd", "stem_epilogue",
                             "bsed_stem_epilogue_smem_bytes"),
                            ("bwd", "stem_epilogue_bwd",
                             "bsed_stem_epilogue_bwd_smem_bytes")):
        entry = getattr(kernels.load(lib), fn)
        entry.restype, entry.argtypes = ctypes.c_int, [ctypes.c_int]
        want = stem_epilogue.kernel_shared_memory(kernel, dtype)["bytes"]
        assert entry(int(dtype is torch.bfloat16)) == want


@pytest.mark.parametrize("t", [100, 37])
def test_stem_kernel_matches_plain(dev, t):
    """K5 against reference_stem_block, float32, 2e-5
    (tests/test_stem_kernel.py); odd T drops the last row."""
    rng = np.random.default_rng(7)
    p0, s0 = _stem_params(rng)
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


def _stem_params(rng):
    p0 = {"conv": {"kernel": rng.normal(0, 0.3, (3, 3, 1, 16)),
                   "bias": rng.normal(0, 0.1, 16)},
          "bn": {"scale": rng.uniform(0.5, 1.5, 16),
                 "bias": rng.normal(0, 0.1, 16)},
          "GLU_0": {"linear": {"kernel": rng.normal(0, 0.3, (16, 16)),
                               "bias": rng.normal(0, 0.1, 16)}}}
    s0 = {"bn": {"mean": rng.normal(0, 0.1, 16),
                 "var": rng.uniform(0.5, 1.5, 16)}}
    return p0, s0


@pytest.mark.parametrize("t", [2, 3, 255, 1255])
@pytest.mark.parametrize("batch", [1, 3, 64])
def test_stem_kernel_shapes_match_plain(dev, batch, t):
    """K5 against reference_stem_block, float32, 2e-5, at T = 2 and 3 (one
    pooled row, one work item cut short), 255 and 1255 (ragged last item),
    over batch sizes. The clips sit between NaN rows of their neighbours
    in memory: the conv's padding at the clip edges must come from the
    kernel's zero fill, so the output is finite."""
    rng = np.random.default_rng(17)
    p0, s0 = _stem_params(rng)
    folded = stem_kernel.fold_block0_params(p0, s0, device=dev)
    buf = torch.full((batch + 2, t, 128, 1), float("nan"), device=dev)
    buf[1:batch + 1] = torch.from_numpy(rng.standard_normal(
        (batch, t, 128, 1)).astype(np.float32)).to(dev)
    x = buf[1:batch + 1]
    got = stem_kernel.fused_stem_block(x, folded)
    want = stem_kernel.reference_stem_block(x, folded)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (batch, t // 2, 64, 16)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_stem_kernel_shared_memory_matches_source(dev):
    """K5's ring is the bytes ring_shared_memory states."""
    import ctypes
    from bsed_tpu_torch import kernels
    entry = kernels.load("stem_kernel").bsed_stem_smem_bytes
    entry.restype, entry.argtypes = ctypes.c_int, []
    assert entry() == stem_kernel.ring_shared_memory()


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
    own nn.GRU (cuDNN) on the same weights, float32, 1e-4; the serving
    form (weights laid out once) equals the per-call form to 1e-6."""
    torch.manual_seed(0)
    rnn = BidirectionalGRU(128, 128, 2).to(dev).eval()
    x = torch.randn((4, 50, 128), device=dev)
    before = gru_kernel.gru_bidir_recurrence.launches
    with torch.no_grad():
        got = bigru_hoisted(rnn, x)
        served = HoistedBiGRU(rnn)(x)
        want = rnn(x)
    torch.cuda.synchronize()
    assert gru_kernel.gru_bidir_recurrence.launches == before + 4
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(served, got, rtol=1e-6, atol=1e-6)


def test_bf16_serving_path_close_to_f32_plain_path(dev):
    """make_fast_forward in bfloat16 on the kernels (K1, K2 and the
    hoisted BiGRU on K4: 2 launches a batch) against the float32 path on
    the plain versions, 2 s clips, heads widened so posteriors spread:
    within 1e-2 (on the CPU the same comparison of the plain versions
    differs by ~1e-3)."""
    cfg = get_config("baseline").replace(
        audio=AudioConfig(max_len_seconds=2.0))
    params, stats = init_params(cfg, 0)
    for head in params["predictor"].values():
        head["kernel"] *= 30.0
    c16 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    audio = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, cfg.audio.n_samples)).astype(np.float32) * 0.1).to(dev)
    before = gru_kernel.gru_bidir_recurrence.launches
    got = make_fast_forward(c16, params, stats, device=dev)(audio)
    assert gru_kernel.gru_bidir_recurrence.launches == before + 2
    with kernels.plain_versions():
        want = make_fast_forward(cfg, params, stats, device=dev)(audio)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-2)


def test_unfused_epilogue_launches_no_k2(dev):
    """make_fast_forward float32, 2 s clips, B=3: by default a batch
    launches K2 7 times, 4 of them in the group-pool form (blocks 3-6);
    with ``use_fused_epilogue=False`` none, blocks 3-6 on K2's plain
    version; the two within the float32 serving gate (2e-3)."""
    cfg = get_config("baseline").replace(
        audio=AudioConfig(max_len_seconds=2.0))
    params, stats = init_params(cfg, 0)
    audio = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, cfg.audio.n_samples)).astype(np.float32) * 0.1).to(dev)
    fwd = stem_epilogue.stem_epilogue_fwd
    out, counts = {}, {}
    for fused in (True, False):
        before = (fwd.launches, fwd.launches_pg)
        out[fused] = make_fast_forward(cfg, params, stats, device=dev,
                                       use_fused_epilogue=fused)(audio)
        torch.cuda.synchronize()
        counts[fused] = (fwd.launches - before[0],
                         fwd.launches_pg - before[1])
    assert counts == {True: (7, 4), False: (0, 0)}, counts
    for g, w in zip(out[True], out[False]):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=2e-3)


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


@pytest.mark.parametrize("g", [16, 8, 4, 2])
@pytest.mark.parametrize("pt,pg", [(1, 1), (1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("act", ["glu", "cg"])
@pytest.mark.parametrize("with_bits", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 72])
@pytest.mark.parametrize("t_in", [20, 21])
def test_group_pool_bf16_tensor_core_body(dev, g, pt, pg, act, with_bits,
                                          batch, t_in):
    """K2-pg in bfloat16 (the wgmma body, kernel_body 'mma') against the
    plain chain over G, both pools, both gates, dropout bits on and off,
    batch sizes and even and odd T: 0.06 rtol + atol."""
    assert stem_epilogue.kernel_body(torch.bfloat16, False)["fwd"] == "mma"
    rng = np.random.default_rng(31 + g + 10 * pt + 100 * pg)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev)
    h = f(batch, t_in, g, 128).bfloat16()
    inv, c, b = f(128) * 0.2 + 1.0, f(128) * 0.3, f(128) * 0.1
    w = (f(128, 128) / np.sqrt(128)).bfloat16()
    bits = (torch.from_numpy(rng.integers(0, 256, (batch, t_in * g, 128),
                                          dtype=np.uint8)).to(dev)
            if with_bits else None)
    keep_k = 128 if with_bits else 0
    before = stem_epilogue.stem_epilogue_fwd.launches
    got = stem_epilogue.stem_epilogue_fwd(h, inv, c, w, b, act, pt, None, 0,
                                          bits, keep_k, pg)
    want = stem_epilogue.stem_epilogue_plain(h, inv, c, w, b, act, pt, None,
                                             bits, keep_k, pg)
    torch.cuda.synchronize()
    assert stem_epilogue.stem_epilogue_fwd.launches == before + 1
    assert got.shape == want.shape == (batch, t_in // pt, g // pg, 128)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0.06,
                               atol=0.06)


@pytest.mark.parametrize("g", [16, 8, 4, 2])
@pytest.mark.parametrize("act", ["glu", "cg"])
def test_group_pool_eval_form_at_serving_shapes(dev, g, act):
    """K2-pg's eval form (no bits, pt 1, pg 2) at the shapes serving runs
    blocks 3-6 at: B = 64, T = 313, G = 16, 8, 4, 2, bfloat16, against
    the plain chain: 0.06 rtol + atol, as the bf16 body's other forms."""
    rng = np.random.default_rng(40 + g)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev)
    h = f(64, 313, g, 128).bfloat16()
    inv, c, b = f(128) * 0.2 + 1.0, f(128) * 0.3, f(128) * 0.1
    w = (f(128, 128) / np.sqrt(128)).bfloat16()
    before = (stem_epilogue.stem_epilogue_fwd.launches,
              stem_epilogue.stem_epilogue_fwd.launches_pg)
    got = stem_epilogue.stem_epilogue_fwd(h, inv, c, w, b, act, 1, None, 0,
                                          pg=2)
    want = stem_epilogue.stem_epilogue_plain(h, inv, c, w, b, act, 1, None,
                                             pg=2)
    torch.cuda.synchronize()
    assert (stem_epilogue.stem_epilogue_fwd.launches,
            stem_epilogue.stem_epilogue_fwd.launches_pg) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == want.shape == (64, 313, g // 2, 128)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0.06,
                               atol=0.06)


def test_group_form_counts_under_a_wrapped_entry(dev, monkeypatch):
    """A profiler that puts a wrapper carrying only ``launches`` in the
    module's place of K2's entry (as a benchmark's traced run does):
    serving's blocks 3-6 still run, ``launches`` counts on the wrapper and
    ``launches_pg`` on the entry itself, 4 a forward."""
    from bsed_tpu_torch import serve
    from tests.test_torch_serve_cnn import START, _cfg, _randomize

    entry = stem_epilogue.stem_epilogue_fwd

    def wrapper(*args, **kwargs):
        return entry(*args, **kwargs)
    wrapper.launches = entry.launches
    monkeypatch.setattr(stem_epilogue, "stem_epilogue_fwd", wrapper)
    rest = _randomize(serve._RestCNN(_cfg(), start=START,
                                     dtype=torch.bfloat16), 7).to(dev)
    x = torch.randn((2, 9, 16, 64), device=dev, dtype=torch.bfloat16)
    before = (wrapper.launches, entry.launches_pg)
    with torch.inference_mode():
        serve.GroupPoolCNN(rest, "glu", torch.bfloat16)(x)
    torch.cuda.synchronize()
    assert (wrapper.launches - before[0],
            entry.launches_pg - before[1]) == (4, 4)


@pytest.mark.parametrize("dtype,batch", [(torch.float32, 32),
                                         (torch.bfloat16, 64)])
def test_group_pool_cnn_on_card_matches_rest_cnn(dev, dtype, batch):
    """Serving's blocks 3-6 on the card, full width (313 frames, G = 16
    at block 3), as conv + K2-pg (``serve.GroupPoolCNN``: 4 launches)
    against ``_RestCNN``'s eval-mode ConvBlock chain on the same numpy-
    seeded weights and statistics: float32 (FMA body, TF32 off) 1e-4,
    bfloat16 2e-2 of the output's largest magnitude, as the CPU test."""
    from bsed_tpu_torch import serve
    from tests.test_torch_serve_cnn import START, _cfg, _randomize

    cfg = _cfg()
    dt = None if dtype is torch.float32 else dtype
    rest = _randomize(serve._RestCNN(cfg, start=START, dtype=dt), 7).to(dev)
    cnn = serve.GroupPoolCNN(rest, "glu", dt)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (batch, 313, 16, 64)).astype(np.float32)).to(dev, dtype)
    with torch.inference_mode():
        want = rest(x)
        before = stem_epilogue.stem_epilogue_fwd.launches
        got = cnn(x)
    torch.cuda.synchronize()
    assert stem_epilogue.stem_epilogue_fwd.launches == before + 4
    assert got.shape == want.shape == (batch, 313, 1, 128)
    scale = float(want.abs().max())
    gate = 1e-4 if dtype is torch.float32 else 2e-2 * scale
    torch.testing.assert_close(got, want, rtol=0, atol=gate)


# ---------------------------------------------------------------------------
# the eval path: median filter, loaders and make_predict_fn on the card


@pytest.mark.parametrize("window,windows", [
    (1, None), (14, None), (15, None), (400, None),
    (1, tuple(get_config().median_window_classwise))])
def test_threshold_and_filter_card_equals_cpu(dev, window, windows):
    """Binarize + median filter on the card equals the CPU result exactly:
    B=64 clips of 313 frames × 20 classes, three thresholds, odd, even,
    classwise and longer-than-T windows."""
    from bsed_tpu_torch.ops.median import threshold_and_filter

    probs = torch.from_numpy(np.random.default_rng(window).random(
        (64, 313, 20)).astype(np.float32))
    thr = (0.3, 0.5, 0.7)
    got = threshold_and_filter(probs.to(dev), thr, window, windows)
    want = threshold_and_filter(probs, thr, window, windows)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("layout", ["default", "origin"])
def test_three_stream_loader_card_gather_equals_host(dev, layout):
    """Resident batches, gathered on the card, equal the host batches of
    two epochs, and stay on the card."""
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import ThreeStreamLoader

    cfg = get_config("baseline").replace(
        audio=AudioConfig(max_len_seconds=2.0))
    syn = SyntheticDataSource(cfg, n_items=20, seed=1)
    weak = SyntheticDataSource(cfg, n_items=8, seed=2)
    unlab = SyntheticDataSource(cfg, n_items=8, seed=3, weak_only=True)
    card = ThreeStreamLoader(syn, weak, unlab, batch_size=8, layout=layout,
                             device=dev)
    host = ThreeStreamLoader(syn, weak, unlab, batch_size=8, layout=layout,
                             device=dev, device_resident=False)
    for epoch in (0, 1):
        got, want = list(card.epoch(epoch)), list(host.epoch(epoch))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                assert a[k].device.type == "cuda", k
                assert np.array_equal(a[k].cpu().numpy(), b[k]), k


def test_eval_loader_card_batches_equal_host(dev):
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import EvalLoader

    cfg = get_config("baseline").replace(
        audio=AudioConfig(max_len_seconds=2.0))
    src = SyntheticDataSource(cfg, n_items=10, seed=8)
    card = list(EvalLoader(src, batch_size=4, device=dev))
    host = list(EvalLoader(src, batch_size=4, device=dev,
                           device_resident=False))
    assert len(card) == len(host) == 3
    for (m, t, n, v), (hm, ht, hn, hv) in zip(card, host):
        assert m.device.type == "cuda" and (n, v) == (hn, hv)
        assert np.array_equal(m.cpu().numpy(), hm)
        assert np.array_equal(t, ht)


@pytest.mark.parametrize("compute_dtype,gate", [("float32", 2e-3),
                                                ("bfloat16", 1e-2)])
def test_predict_fn_kernels_match_plain(dev, compute_dtype, gate):
    """make_predict_fn on the kernels (K2 eval 7 times: blocks 0-2 and,
    in its group-pool form, blocks 3-6; K4 twice a batch) against the
    same function on their plain versions, full width
    (1255 frames × 128 mels), B=8, heads widened: within the serving gate
    of the compute dtype."""
    from bsed_tpu_torch.train.steps import TrainModules, make_predict_fn

    cfg = get_config("baseline")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype=compute_dtype))
    params, stats = init_params(cfg, 0)
    for head in params["predictor"].values():
        head["kernel"] *= 30.0
    mel = torch.from_numpy(np.abs(np.random.default_rng(2).standard_normal(
        (8, cfg.audio.max_frames, cfg.audio.n_mels))).astype(
            np.float32)).to(dev)
    k2 = stem_epilogue.stem_epilogue_fwd.launches
    k4 = gru_kernel.gru_bidir_recurrence.launches
    got = make_predict_fn(TrainModules(cfg, dev))(params, stats, mel)
    torch.cuda.synchronize()
    assert stem_epilogue.stem_epilogue_fwd.launches == k2 + 7
    assert gru_kernel.gru_bidir_recurrence.launches == k4 + 2
    with kernels.plain_versions():
        want = make_predict_fn(TrainModules(cfg, dev))(params, stats, mel)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=gate)


def _card_trainer(dev, store, scan_epoch="auto"):
    """A small Trainer on the card: baseline_mt_isp, float32, the folded
    train stem with the fused epilogue, fused streams, 2 s clips at 32 kHz
    (full mel width), batch 4: 2 steps an epoch over resident loaders,
    validation on 8 clips."""
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import EvalLoader, ThreeStreamLoader
    from bsed_tpu_torch.train.trainer import Trainer

    cfg = get_config("baseline_mt_isp").replace(
        audio=AudioConfig(max_len_seconds=2.0))
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, folded_train_stem=True,
                                  fused_stem_epilogue=True),
        train=dataclasses.replace(cfg.train, batch_size=4,
                                  fused_streams=True))
    syn = SyntheticDataSource(cfg, n_items=8, seed=1)
    weak = SyntheticDataSource(cfg, n_items=4, seed=2)
    unlab = SyntheticDataSource(cfg, n_items=4, seed=3)
    val = SyntheticDataSource(cfg, n_items=8, seed=4)
    return Trainer(cfg, ThreeStreamLoader(syn, weak, unlab, batch_size=4,
                                          seed=cfg.train.seed, device=dev),
                   val_loader=EvalLoader(val, batch_size=4, device=dev),
                   store_dir=str(store), device=dev, scan_epoch=scan_epoch)


def _state_leaves(state):
    from bsed_tpu_torch.utils.weights import export_train_state

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, np.asarray(tree)
    return dict(leaves(export_train_state(state)))


@pytest.fixture
def deterministic_cudnn():
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


def test_trainer_fit_kernels_match_plain(dev, tmp_path, deterministic_cudnn):
    """A 1-epoch fit with the kernels (K2 train 6 and K3 3 times a step;
    K2 eval 7 and K4 2 times a val batch) against the same fit on their
    plain versions, float32, dropout 0.5 with the same bits: the f32
    train-step gates (metrics 1e-4 relative, Adam moments 3e-5, BN
    statistics 1e-5 + 1e-5 relative)."""
    launches = (stem_epilogue.stem_epilogue_fwd.launches,
                stem_epilogue.stem_epilogue_bwd.launches,
                gru_kernel.gru_bidir_recurrence.launches)
    kern = _card_trainer(dev, tmp_path / "kernels")
    kern.fit(n_epochs=1)
    torch.cuda.synchronize()
    assert (stem_epilogue.stem_epilogue_fwd.launches - launches[0],
            stem_epilogue.stem_epilogue_bwd.launches - launches[1],
            gru_kernel.gru_bidir_recurrence.launches - launches[2]) == \
        (2 * 6 + 2 * 7, 2 * 3, 2 * 2)
    with kernels.plain_versions():
        plain = _card_trainer(dev, tmp_path / "plain")
        plain.fit(n_epochs=1)
    (got,), (want,) = kern.history, plain.history
    assert list(got) == list(want)
    for k, v in want.items():
        if not k.startswith("val_"):
            assert abs(got[k] - v) <= 1e-4 * abs(v), k
        assert np.isfinite(got[k]), k
    a, b = _state_leaves(kern.state), _state_leaves(plain.state)
    for path, v in b.items():
        if path[0] == "mu":
            np.testing.assert_allclose(a[path], v, rtol=0, atol=3e-5,
                                       err_msg=str(path))
        elif path[0] in ("batch_stats", "ema_batch_stats"):
            np.testing.assert_allclose(a[path], v, rtol=1e-5, atol=1e-5,
                                       err_msg=str(path))


def test_checkpoint_from_card_restores_bit_for_bit(dev, tmp_path):
    """A state saved from card tensors after a step (Adam populated) and
    restored into a fresh state on the card: every tensor equal, on the
    card."""
    from bsed_tpu_torch.train.steps import create_train_state
    from bsed_tpu_torch.utils.checkpoint import CheckpointManager

    trainer = _card_trainer(dev, tmp_path)
    trainer.fit(n_epochs=1)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("probe", trainer.state)
    fresh = create_train_state(trainer.cfg, trainer.modules, seed=99)
    ckpt.restore("probe", fresh)
    assert fresh.step == trainer.state.step == 2
    assert next(fresh.model.parameters()).device.type == "cuda"
    for st in fresh.optimizer.state.values():
        assert st["exp_avg"].device.type == "cuda"
    a, b = _state_leaves(trainer.state), _state_leaves(fresh)
    assert a.keys() == b.keys()
    for path, v in a.items():
        assert np.array_equal(b[path], v), path


def test_epoch_runner_matches_loop_on_card(dev, tmp_path,
                                           deterministic_cudnn):
    """On card-resident loaders the epoch runner and the prefetching loop
    give the same metrics and the same state, bit for bit."""
    runner = _card_trainer(dev, tmp_path / "runner")
    loop = _card_trainer(dev, tmp_path / "loop", scan_epoch="off")
    runner.fit(n_epochs=1)
    loop.fit(n_epochs=1)
    assert runner._epoch_runner is not None and loop._epoch_runner is None
    assert runner.history == loop.history
    a, b = _state_leaves(runner.state), _state_leaves(loop.state)
    for path, v in a.items():
        assert np.array_equal(b[path], v), path


# --- the presets that need no discriminator ------------------------------

# K2's train form and K3 per step of each preset's --perf form: 3 folded
# blocks a forward. origin: 2 teacher forwards (the noisy real batch, the
# unlabelled rows for mixup) and 4 student forwards (the fused 3-stream
# batch, the weak, strong and unlabelled mixups), each backpropagated;
# scmt: one fused teacher forward and one fused 4-stream student forward.
PRESET_LAUNCHES = {"origin": (18, 12), "scmt": (6, 3)}


def _preset_step_on_card(dev, preset, stage="pretrain", model=None,
                         plain=False):
    """One float32 --perf step of ``preset`` at full width: (metrics, the
    exported state, (K2, K3) launches); with ``plain``, all of it inside
    ``kernels.plain_versions()``."""
    if plain:
        with kernels.plain_versions():
            return _preset_step_on_card(dev, preset, stage, model)
    from bsed_tpu_torch.config import perf_config
    from bsed_tpu_torch.train import steps
    from bsed_tpu_torch.utils.weights import export_train_state

    cfg = get_config(preset)
    cfg = perf_config(cfg.replace(train=dataclasses.replace(cfg.train,
                                                            stage=stage)))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="float32",
                                                **(model or {})))
    ns = None
    if cfg.train.normalize:
        ns = (np.full(cfg.audio.n_mels, -20.0, np.float32),
              np.full(cfg.audio.n_mels, 10.0, np.float32))
    modules = steps.build_modules(cfg, device=dev, norm_stats=ns)
    state = steps.create_train_state(cfg, modules, 0)
    n_real = 8 if preset == "origin" else 4
    gen = torch.Generator(device=dev).manual_seed(11)
    t_in, f = cfg.audio.max_frames, cfg.audio.n_mels
    strong = lambda n: (torch.rand((n, cfg.n_frames, cfg.nclass),  # noqa
                                   generator=gen, device=dev) > 0.9).float()
    batch = {"syn": torch.randn((4, t_in, f), generator=gen,
                                device=dev).abs(),
             "syn_strong": strong(4),
             "real": torch.randn((n_real, t_in, f), generator=gen,
                                 device=dev).abs(),
             "real_strong": strong(n_real)}
    batch["real_weak"] = batch["real_strong"].amax(dim=1)
    counts = (stem_epilogue.stem_epilogue_fwd.launches,
              stem_epilogue.stem_epilogue_bwd.launches)
    metrics = steps.make_train_step(modules, steps_per_epoch=8)(
        state, batch, 7, 30.0)
    torch.cuda.synchronize()
    launched = (stem_epilogue.stem_epilogue_fwd.launches - counts[0],
                stem_epilogue.stem_epilogue_bwd.launches - counts[1])
    return ({k: float(v) for k, v in metrics.items()},
            export_train_state(state), launched)


def _assert_f32_steps_match(got, want):
    """chip_smoke's train_equality gates: metrics 1e-4 relative, Adam
    moments 3e-5, BN statistics 1e-5 + 1e-5 relative."""
    (mk, tk), (mp, tp) = got, want
    assert mk.keys() == mp.keys()
    for k, v in mp.items():
        assert np.isfinite(mk[k]) and abs(mk[k] - v) <= 1e-4 * abs(v), k
    a = dict(_tree_leaves({k: tk[k] for k in ("mu", "batch_stats",
                                              "ema_batch_stats")}))
    for path, v in _tree_leaves({k: tp[k] for k in ("mu", "batch_stats",
                                                    "ema_batch_stats")}):
        rtol = 0 if path[0] == "mu" else 1e-5
        atol = 3e-5 if path[0] == "mu" else 1e-5
        np.testing.assert_allclose(a[path], v, rtol=rtol, atol=atol,
                                   err_msg=str(path))


# the 'crnn' head and recurrent dropout on the flagship preset: K2's train
# form 6 and K3 3 times a step, as without them
SLICE_8C = {"crnn_head": dict(predictor_head="crnn"),
            "recurrent_dropout": dict(dropout_recurrent=0.5)}


@pytest.mark.parametrize("case", sorted(SLICE_8C))
def test_8c_f32_step_kernels_match_plain(dev, case, deterministic_cudnn):
    """baseline_mt_isp's float32 --perf step with the 'crnn' head, and
    with recurrent dropout 0.5, on the kernels against the same step on
    their plain versions, full width, dropout 0.5 with the same bits
    (the GRUs' masks too): train_equality's gates; the head's statistics
    are among the BN statistics held."""
    mk, tk, launched = _preset_step_on_card(dev, "baseline_mt_isp",
                                            model=SLICE_8C[case])
    mp, tp, plain_launched = _preset_step_on_card(
        dev, "baseline_mt_isp", model=SLICE_8C[case], plain=True)
    assert launched == (6, 3) and plain_launched == (0, 0)
    assert ("predictor" in tk["batch_stats"]) == (case == "crnn_head")
    _assert_f32_steps_match((mk, tk), (mp, tp))


@pytest.mark.parametrize("fused_stem", [False, True])
def test_crnn_head_serving_kernels_match_plain(dev, fused_stem):
    """make_fast_forward with the 'crnn' head, full width, B=8, float32:
    the head turns the folded stem off, so the standard branch runs K1
    once and K4 twice a batch and K2 never (with use_fused_stem, K5
    once); within 2e-3 of the plain versions."""
    cfg = get_config("baseline")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                predictor_head="crnn"))
    params, stats = init_params(cfg, 0)
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, cfg.audio.n_samples)).astype(np.float32) * 0.1).to(dev)
    counters = (mel_kernel.fused_block_mel, stem_epilogue.stem_epilogue_fwd,
                gru_kernel.gru_bidir_recurrence, stem_kernel.fused_stem_block)
    before = [c.launches for c in counters]
    got = make_fast_forward(cfg, params, stats, device=dev,
                            use_fused_stem=fused_stem)(audio)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == [1, 0, 2, int(fused_stem)], launched
    with kernels.plain_versions():
        want = make_fast_forward(cfg, params, stats, device=dev,
                                 use_fused_stem=fused_stem)(audio)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=2e-3)


@pytest.mark.parametrize("preset", sorted(PRESET_LAUNCHES))
def test_preset_f32_step_kernels_match_plain(dev, preset,
                                             deterministic_cudnn):
    """The float32 --perf step of origin (3-stream fused student, three
    mixups) and scmt (4-stream fused student) with the kernels against
    the same step on their plain versions, full width, dropout 0.5 with
    the same bits: chip_smoke's train_equality gates (metrics 1e-4
    relative, Adam moments 3e-5, BN statistics 1e-5 + 1e-5 relative); K2
    and K3 launch the preset's count."""
    mk, tk, launched = _preset_step_on_card(dev, preset)
    mp, tp, plain_launched = _preset_step_on_card(dev, preset, plain=True)
    assert launched == PRESET_LAUNCHES[preset]
    assert plain_launched == (0, 0)
    assert mk.keys() == mp.keys()
    for k, v in mp.items():
        assert np.isfinite(mk[k]) and abs(mk[k] - v) <= 1e-4 * abs(v), k

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, np.asarray(tree)
    a = dict(leaves({k: tk[k] for k in ("mu", "batch_stats",
                                        "ema_batch_stats")}))
    for path, v in leaves({k: tp[k] for k in ("mu", "batch_stats",
                                              "ema_batch_stats")}):
        rtol = 0 if path[0] == "mu" else 1e-5
        atol = 3e-5 if path[0] == "mu" else 1e-5
        np.testing.assert_allclose(a[path], v, rtol=rtol, atol=atol,
                                   err_msg=str(path))


@pytest.mark.parametrize("t", [156, 78])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_kernel_matches_plain_at_fpn_lengths(dev, t, dtype):
    """K4 at the FPN pyramid's coarse lengths (313 is
    test_gru_kernel_matches_plain's), B = 64: float32 1e-5; bfloat16 the
    plain version in bfloat16 within 2e-2."""
    rng = np.random.default_rng(t)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa
        np.float32)).to(dev)
    xp2, w, bias = g(2, 64, t, 384), g(2, 384, 128) * 0.1, g(2, 384) * 0.1
    before = gru_kernel.gru_bidir_recurrence.launches
    got = gru_kernel.gru_bidir_recurrence(xp2.to(dtype), w.to(dtype), bias)
    want = gru_kernel.gru_bidir_recurrence_plain(xp2.to(dtype), w.to(dtype),
                                                 bias)
    torch.cuda.synchronize()
    assert gru_kernel.gru_bidir_recurrence.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def test_cnn_fpn_tied_block_stats_card_equals_cpu(dev):
    """CNNFPN's training forward on the card: its outputs and every
    block's new running statistics, block_down's after its two calls,
    equal the CPU's (1e-5 + 1e-4 relative)."""
    from bsed_tpu_torch.models.cnn import CNNFPN
    from bsed_tpu_torch.utils.weights import load_cnn, load_conv_block

    cfg = get_config("baseline_fpn_mt_isp")
    params, stats = init_params(cfg, 0)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        -4.0, 3.0, (4, 1255, 128, 1)).astype(np.float32))
    out, new = {}, {}
    for where in ("cpu", dev):
        cnn = CNNFPN(dropout=0.0)
        load_cnn(cnn, params["encoder"]["cnn"], stats["encoder"]["cnn"])
        load_conv_block(cnn.block_down, params["encoder"]["cnn"]["block_down"],
                        stats["encoder"]["cnn"]["block_down"])
        cnn.to(where).train()
        with torch.no_grad():
            out[str(where)] = [o.cpu() for o in cnn(x.to(where))]
        new[str(where)] = {n: b.cpu() for n, b in cnn.named_buffers()}
    assert any("block_down" in n for n in new["cpu"])
    for a, b in zip(out[str(dev)], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for name, want in new["cpu"].items():
        torch.testing.assert_close(new[str(dev)][name], want, rtol=1e-4,
                                   atol=1e-5, msg=name)


# --- the adaptation stage -------------------------------------------------

# K2's train form and K3 in one float32 --perf step at state step 0:
# baseline_adaptation (run a) adds its GRL pre-step's 2 backpropagated
# forwards to baseline_mt_isp's (6, 3); origin (run h) its ADDA update's 2
# discriminator-step forwards (no encoder gradient) and confusion forward
# to its (18, 12)
DA_LAUNCHES = {"baseline_adaptation": (12, 9), "origin": (27, 15)}


@pytest.mark.parametrize("preset", sorted(DA_LAUNCHES))
def test_da_f32_step_kernels_match_plain(dev, preset, deterministic_cudnn):
    """The adaptation stage's float32 --perf step, a GRL pre-step run (a)
    and an ADDA run (h), with the kernels against the same step on their
    plain versions at full width: chip_smoke's da_equality gates (metrics
    with domain_loss 1e-4 relative; every Adam first moment, the aux
    optimizers' included, 3e-5; BatchNorm statistics 1e-5 + 1e-5
    relative); K2 and K3 launch the run's count, their plain versions
    none. A conv bias feeds each block's BatchNorm, so its gradient is
    noise and the aux optimizer's Adam step (ADDA's confusion step) moves
    it by up to lr with an arbitrary sign before the main forwards, whose
    batch mean takes it one to one: where that gradient is below 1e-6 the
    running mean gets 0.99 · 2.2 · lr more (origin on an H100: 4.3e-5 on
    block 3's means)."""
    mk, tk, launched = _preset_step_on_card(dev, preset, "adaptation")
    mp, tp, plain_launched = _preset_step_on_card(dev, preset, "adaptation",
                                                  plain=True)
    assert launched == DA_LAUNCHES[preset]
    assert plain_launched == (0, 0)
    assert mk.keys() == mp.keys() and "domain_loss" in mk
    for k, v in mp.items():
        assert np.isfinite(mk[k]) and abs(mk[k] - v) <= 1e-4 * abs(v), k

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, np.asarray(tree)
    keys = ("mu", "batch_stats", "ema_batch_stats", "enc_opt_state",
            "disc_opt_state", "disc_batch_stats")
    a = dict(leaves({k: tk[k] for k in keys}))
    enc_mu = dict(leaves(tp["enc_opt_state"]["mu"]))
    aux_lr = get_config(preset).train.max_learning_rate
    for path, v in leaves({k: tp[k] for k in keys}):
        moment = path[0] == "mu" or path[1:2] == ("mu",)
        if path[0].endswith("opt_state") and not moment:
            continue                    # nu and count: held through mu
        bound = (3e-5 if moment else 1e-5 + 1e-5 * np.abs(v))
        if path[0] == "batch_stats" and path[-1] == "mean":
            g = enc_mu[("cnn", path[3], "conv", "bias")] / 0.1
            bound = bound + np.where(np.abs(g) < 1e-6,
                                     0.99 * 2.2 * aux_lr, 0.0)
        delta = np.abs(a[path] - v)
        assert (delta <= bound).all(), (path, float(delta.max()))


@pytest.mark.parametrize("preset", ["pseudo_labeling", "sct_ada_weak"])
def test_da_full_width_discriminators_on_card(dev, preset):
    """Frame CDAN's randomized map (R_f (80128, 8192), R_g (20, 8192),
    2.63 GB) and DANN's discriminator (dense_d_1 over 80128 features) are
    drawn and allocated on the card at full width, and a reference-form
    step of 2 + 2 clips trains through them: finite loss and domain loss,
    the discriminator's first layer moved."""
    from bsed_tpu_torch.train import steps

    cfg = get_config(preset)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                stage="adaptation"))
    modules = steps.build_modules(cfg, device=dev)
    feat = 2 * cfg.model.n_rnn_cell * cfg.n_frames
    assert feat == 80128
    if cfg.da.mode == "cdan":
        rf, rg = modules.rand_maps
        assert rf.shape == (feat, 8192) and rg.shape == (cfg.nclass, 8192)
        assert rf.device.type == "cuda" and rf.dtype == torch.float32
    else:
        assert modules.rand_maps is None
    state = steps.create_train_state(cfg, modules, 0)
    first = state.discriminator.dense_d_1
    assert first.weight.device.type == "cuda"
    assert first.in_features == (8192 if cfg.da.mode == "cdan" else feat)
    before = first.weight.detach().clone()
    gen = torch.Generator(device=dev).manual_seed(3)
    t_in, f = cfg.audio.max_frames, cfg.audio.n_mels
    strong = (torch.rand((2, cfg.n_frames, cfg.nclass), generator=gen,
                         device=dev) > 0.9).float()
    batch = {"syn": torch.randn((2, t_in, f), generator=gen,
                                device=dev).abs(),
             "syn_strong": strong,
             "real": torch.randn((2, t_in, f), generator=gen,
                                 device=dev).abs(),
             "real_strong": strong.flip(0)}
    batch["real_weak"] = batch["real_strong"].amax(dim=1)
    metrics = steps.make_train_step(modules, steps_per_epoch=8)(
        state, batch, 1, 30.0)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["domain_loss"]))
    assert not torch.equal(first.weight.detach(), before)


def test_da_randomized_maps_equal_on_cpu_and_card(dev, monkeypatch):
    """Frame-CDAN's R_f / R_g drawn for the card are bit-equal to the CPU
    draw (one CPU generator, chunks copied to the device), in several
    chunks."""
    from bsed_tpu_torch.train import da

    monkeypatch.setattr(da, "MAP_CHUNK_ELEMENTS", 1 << 16)
    cpu = da.make_randomized_maps(3000, 20, 512, seed=1215, device="cpu")
    card = da.make_randomized_maps(3000, 20, 512, seed=1215, device=dev)
    assert all(c.device.type == "cuda" for c in card)
    assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card))


@pytest.fixture
def raw_audio(tmp_path):
    """A 60 s recording at 32 kHz (11 windows at a 5 s hop: B = 11, below
    the batch of 32) and a 3 s raw-audio .npy (one padded window)."""
    from scipy.io import wavfile
    rng = np.random.default_rng(12)
    wav = str(tmp_path / "minute.wav")
    wavfile.write(wav, 32000, (rng.standard_normal(60 * 32000) * 3000
                               ).astype(np.int16))
    npy = str(tmp_path / "short.npy")
    np.save(npy, (rng.standard_normal(3 * 32000) * 0.1).astype(np.float32))
    return [wav, npy]


def test_predict_ragged_batch_kernels_match_plain(dev, raw_audio):
    """``predict_recordings`` at full width, precision 'high' (K1, K2 and
    K4 once, seven and twice a forward call), against the same call on
    the plain versions: posteriors within the serving gate (2e-3), the
    ragged B = 11 batch and the one-window recording included."""
    from bsed_tpu_torch.predict import predict_recordings

    cfg = get_config("baseline")
    params, stats = init_params(cfg, 0)
    counters = (mel_kernel.fused_block_mel, stem_epilogue.stem_epilogue_fwd,
                gru_kernel.gru_bidir_recurrence)
    before = [c.launches for c in counters]
    def run():
        return predict_recordings(
            cfg, params, stats, raw_audio, device=dev, precision="high",
            hop_seconds=5.0, keep_posteriors=True)
    runs = {True: run()}
    calls = sum(map(len, runs[True]["batches"]))
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [calls, 7 * calls, 2 * calls]
    with kernels.plain_versions():
        runs[False] = run()
    assert runs[True]["batches"] == [[11], [1]]
    for a, b in zip(runs[True]["posteriors"], runs[False]["posteriors"]):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert float(np.abs(a - b).max()) <= 2e-3
    highest = predict_recordings(cfg, params, stats, raw_audio[1:],
                                 device=dev, precision="highest")
    assert highest["tf32"] == {"matmul_tf32": False, "cudnn_tf32": False}


# -- the weak tagger (models/resnet.py, train/tagging_trainer.py) ---------
TAG_AUDIO = AudioConfig(sr=3200, hop_size=160, max_len_seconds=2.0)


def _tagger_pair(dev, arch, mean_teacher=False, dtype=torch.float32):
    """The same fresh tagger on the card and on the CPU (the init draws
    from one CPU generator either way), in ``dtype``."""
    from bsed_tpu_torch.train.tagging_trainer import TaggingTrainer

    cfg = get_config("baseline").replace(audio=TAG_AUDIO)
    pair = [TaggingTrainer(cfg, arch=arch, mean_teacher=mean_teacher,
                           device=d) for d in (dev, "cpu")]
    for t in pair:
        t.model.to(dtype)
        if t.ema_model is not None:
            t.ema_model.to(dtype)
    return cfg, pair


def _tree_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tagger_batch(cfg, n=4, seed=5, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shape = (n, cfg.audio.max_frames, cfg.audio.n_mels)
    return {"syn": np.abs(rng.standard_normal(shape)).astype(dtype),
            "syn_weak": (rng.random((n, cfg.nclass)) > 0.8).astype(dtype),
            "real": np.abs(rng.standard_normal(shape)).astype(dtype),
            "real_weak": (rng.random((n, cfg.nclass)) > 0.7).astype(dtype)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch", ["resnet", "vgg"])
def test_tagger_forward_card_matches_cpu(dev, arch, train):
    """Both taggers' forwards, TF32 off, at 1e-4 (VGG's keep mask fed to
    both in training mode), and the running statistics a training-mode
    forward leaves at 1e-5 + 1e-4 relative."""
    from bsed_tpu_torch.ops.mel import amplitude_to_db
    from bsed_tpu_torch.utils import weights

    cfg, (card, cpu) = _tagger_pair(dev, arch)
    x = amplitude_to_db(torch.from_numpy(_tagger_batch(cfg)["syn"]))
    keep = torch.rand((4, 4096), generator=torch.Generator().manual_seed(1)
                      ) < 0.5
    outs, stats = [], []
    for t, d in ((card, dev), (cpu, "cpu")):
        with torch.no_grad():
            outs.append(t.model.train(train)(x.to(d), keep=keep.to(d)).cpu())
        stats.append(weights.export_named(t.model)[1])
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4
    got = dict(_tree_leaves(stats[0]))
    for path, want in _tree_leaves(stats[1]):
        assert (np.abs(got[path] - want) <= 1e-5 + 1e-4 * np.abs(want)
                ).all(), path


@pytest.mark.parametrize("case", ["resnet", "resnet_mt", "vgg"])
def test_tagger_step_card_matches_cpu(dev, case):
    """One step of the three cases on the card against the CPU in float64
    (float32 ReLU and max-pool decisions turn on roundings: see
    tests/test_torch_tagging_trainer.py): the loss 1e-4 relative, Adam's
    first moment at 3e-4 + 1e-4 relative on mu/0.1, the statistics of
    student and teacher at 1e-5 + 1e-4 relative; the noise and VGG's mask
    drawn once and fed to both."""
    from bsed_tpu_torch.utils import weights

    arch, mt = {"resnet": ("resnet", False), "resnet_mt": ("resnet", True),
                "vgg": ("vgg", False)}[case]
    cfg, pair = _tagger_pair(dev, arch, mt, torch.float64)
    batch = _tagger_batch(cfg, dtype=np.float64)
    gen = torch.Generator().manual_seed(3)
    draws = {"noise": torch.randn((4,) + batch["real"].shape[1:],
                                  generator=gen, dtype=torch.float64),
             "keep": torch.rand((4, 4096), generator=gen) < 0.5}
    res = []
    for t, d in zip(pair, (dev, "cpu")):
        loss = t.train_step({k: torch.from_numpy(v).to(d)
                             for k, v in batch.items()},
                            torch.Generator(device=d).manual_seed(0),
                            {k: v.to(d) for k, v in draws.items()})
        trees = {"loss": float(loss),
                 "mu": weights._export_opt(
                     t.optimizer, weights.named_param_map(t.model))["mu"],
                 "stats": weights.export_named(t.model)[1]}
        if mt:
            trees["ema_stats"] = weights.export_named(t.ema_model)[1]
        res.append(trees)
    got, want = res
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    for key, atol, rtol, scale in (("mu", 3e-4, 1e-4, 10.0),
                                   ("stats", 1e-5, 1e-4, 1.0),
                                   ("ema_stats", 1e-5, 1e-4, 1.0)):
        if key not in want:
            continue
        g = dict(_tree_leaves(got[key]))
        for path, w in _tree_leaves(want[key]):
            delta = np.abs(g[path] - w) * scale
            assert (delta <= atol + rtol * np.abs(w) * scale).all(), \
                (key, path, float(delta.max()))


def test_pseudo_label_tsv_card_equals_cpu(dev, tmp_path):
    """``pseudo-label``'s TSV, the card against the CPU, on 24 synthetic
    clips at ``TAG_AUDIO``: equal, unless a posterior lies within 1e-4 of
    the threshold, which the test names."""
    from bsed_tpu_torch.data.codec import ManyHotEncoder
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.train.tagging_trainer import write_pseudo_labels
    from bsed_tpu_torch.utils.device import float32_precision

    cfg, (card, cpu) = _tagger_pair(dev, "resnet")
    unlab = SyntheticDataSource(cfg, n_items=24, seed=3)
    mel = np.stack([unlab[i][0] for i in range(len(unlab))])
    with float32_precision("highest"):
        post = [t.predict_weak(mel) for t in (card, cpu)]
        files = []
        for t, name in ((card, "card.tsv"), (cpu, "cpu.tsv")):
            write_pseudo_labels(t.predict_weak, unlab, str(tmp_path / name),
                                ManyHotEncoder(cfg.bird_list))
            files.append((tmp_path / name).read_bytes())
    assert float(np.abs(post[0] - post[1]).max()) <= 1e-4
    near = np.abs(post[1] - 0.5) < 1e-4
    assert not near.any(), f"posteriors at the threshold: {post[1][near]}"
    assert files[0] == files[1]


def test_learning_gate_on_card(dev):
    """The event-F1 learning gate (``chip_smoke.learning_gate``, the port
    of ``tests/f1_gate_worker.py``) in the reference form: the decode-path
    oracle above 0.9 and the best val event F1 at least 0.10 within 300
    epochs, as ``bsed_tpu``'s gate on its accelerator."""
    import chip_smoke

    res = chip_smoke.learning_gate(dev, perf=False)
    assert res["oracle_f1"] > chip_smoke.GATE_MIN_ORACLE, res
    assert res["best_f1"] >= chip_smoke.GATE_MIN_F1, res


def test_data_parallel_torchrun_nccl_train(dev, tmp_path):
    """``train --mesh auto`` under torchrun with one rank: the CLI joins a
    1-rank NCCL group and writes one finite results row."""
    import math
    import subprocess
    import sys

    import chip_smoke

    store = tmp_path / "store"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "bsed_tpu_torch.cli", "train",
         "--preset", "baseline", "--tiny-audio", "-s", "24", "--epochs",
         "1", "--store-dir", str(store)], capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = chip_smoke.read_results(store / "results.tsv")
    assert len(rows) == 1 and all(math.isfinite(v)
                                  for v in rows[0].values()), rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_data_parallel_step_two_ranks_on_card(dev, dtype):
    """Two gloo ranks sharing the card: the --perf flagship step (12 + 12
    full-width clips, K2 train 6 and K3 3 times a step on each rank)
    against the 1-rank step on the same global batch, within
    ``chip_smoke.DP_GATES[dtype]``."""
    import chip_smoke
    from bsed_tpu_torch.parallel.launch import spawn

    ref = chip_smoke._dp_step(torch, dev, None, dtype)
    ranks = spawn(chip_smoke._dp_step_worker, 2, backend="gloo",
                  device="cuda:0", args=(dtype,), timeout=600)
    for r in ranks:
        assert r[2] == ref[2] == {"stem_epilogue_fwd": 6,
                                  "stem_epilogue_bwd": 3, "gru_kernel": 0}
        gaps = chip_smoke.dp_step_gap(np, ref, r)
        for k, gate in chip_smoke.DP_GATES[dtype].items():
            assert gaps[k] <= gate, (k, gaps)


def test_data_parallel_sharded_forward_on_card(dev):
    """``make_sharded_forward`` on ["cuda:0", "cuda:0"] at B=64 (float32,
    'high': K1, K2 eval and K4 in each replica) against the single
    forward, within ``chip_smoke.DP_GATES['serve_abs']``."""
    import chip_smoke
    from bsed_tpu_torch.serve import make_sharded_forward

    cfg = get_config("baseline")
    params, stats = init_params(cfg, 0)
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, cfg.audio.n_samples)).astype(np.float32) * 0.1)
    want = make_fast_forward(cfg, params, stats, device=dev,
                             precision="high")(audio)
    k1 = mel_kernel.fused_block_mel.launches
    got = make_sharded_forward(cfg, params, stats, ["cuda:0", "cuda:0"],
                               precision="high")(audio)
    assert mel_kernel.fused_block_mel.launches - k1 == 2
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= chip_smoke.DP_GATES["serve_abs"]


# ---------------------------------------------------------------------------
# BEATs fused into the CRNN (the crnn_beats configuration)


def test_rel_attention_bf16_matches_float32_at_496_tokens(dev):
    """The bf16 entry (the kernel, g ⊙ P added in its float32 scores)
    against its float32 form written out on the float32 inputs, at BEATs'
    shapes (8 clips, 12 heads of 64, 496 tokens, unit-scale bias, gates
    in (1, 2)): the inputs are rounded to bf16 too, which keeps 8 bits,
    so 2e-2 of the output's largest magnitude."""
    from bsed_tpu_torch.ops import rel_attention as RA
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(8, 12, 496, 64, generator=gen, device=dev)
               for _ in range(3))
    gate = 1 + torch.rand(8, 12, 496, 1, generator=gen, device=dev)
    bias = torch.randn(12, 496, 496, generator=gen, device=dev)
    before = RA.gated_rel_attention.launches
    got = RA.gated_rel_attention(*(t.bfloat16() for t in (q, k, v, gate)),
                                 bias.bfloat16())
    want = RA.gated_rel_attention_plain(q, k, v, gate, bias)
    torch.cuda.synchronize()
    assert RA.gated_rel_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=2e-2 * float(want.abs().max()))



def _attention_inputs(dev, b, n, dtype, seed, h=12):
    """q, k, v as ``models/beats._SelfAttention`` passes them: views
    (B, H, L, 64) of (B, L, H·64) projections; gates in (1, 2), a
    unit-normal bias (H, L, L)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, n, h * 64, generator=gen, device=dev)
               .to(dtype).view(b, n, h, 64).transpose(1, 2)
               for _ in range(3))
    gate = (1 + torch.rand(b, h, n, 1, generator=gen, device=dev)).to(dtype)
    bias = torch.randn(h, n, n, generator=gen, device=dev).to(dtype)
    return q, k, v, gate, bias


# The bf16 kernel against the float32 plain form on the same bf16 inputs:
# the kernel rounds the weights to bf16 before p·v and the output once,
# 2^-9 of a value each, and its exponential is ex2.approx; 1e-2 of the
# output's largest magnitude holds both roundings with room. The float32
# body sums in another order than the plain form's products (TF32 off on
# both): 2e-5 of it.
ATTN_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}


def _check_attention(args):
    """One call of the entry against the plain form: the tolerance above,
    q's dtype, the output's (B, L, H, D) storage and one launch."""
    from bsed_tpu_torch.ops import rel_attention as RA
    before = RA.gated_rel_attention.launches
    got = RA.gated_rel_attention(*args)
    want = RA.gated_rel_attention_plain(*args)
    torch.cuda.synchronize()
    assert RA.gated_rel_attention.launches == before + 1
    assert got.dtype == args[0].dtype and got.shape == want.shape
    assert got.transpose(1, 2).is_contiguous()
    tol = ATTN_TOL[args[0].dtype] * float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= tol
    return got


@pytest.mark.parametrize("batch", [8, 64])
def test_rel_attention_kernel_at_the_cells_shapes(dev, batch):
    """BEATs at B = 8 and the cell's B = 64: 12 heads of 64, 496 tokens,
    bf16, the model's views; and no (B, H, L, L) tensor allocated inside
    the call (its peak over the inputs stays under one bf16 mask)."""
    from bsed_tpu_torch.ops import rel_attention as RA
    args = _attention_inputs(dev, batch, 496, torch.bfloat16, batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    RA.gated_rel_attention(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak < batch * 12 * 496 * 496 * 2, peak
    _check_attention(args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [37, 200, 496])
def test_rel_attention_kernel_ragged_lengths(dev, dtype, n):
    """Token counts that no tile divides (37, 200; 496 = 7·64 + 48) in
    both bodies: the ragged key tile masked, the rows past L not
    stored."""
    _check_attention(_attention_inputs(dev, 3, n, dtype, n))


def test_rel_attention_kernel_float32_past_the_bf16_limit(dev):
    """The float32 body streams its keys: 600 tokens, more than the bf16
    body holds; the bf16 body refuses them."""
    from bsed_tpu_torch.ops import rel_attention as RA
    _check_attention(_attention_inputs(dev, 2, 600, torch.float32, 6))
    with pytest.raises(ValueError, match="at most 512 tokens"):
        RA.gated_rel_attention(*_attention_inputs(dev, 1, 600,
                                                  torch.bfloat16, 6))


@pytest.mark.parametrize("fault", ["rel_bias_left_out", "gate_left_out"])
def test_rel_attention_kernel_reads_the_faults_inputs(dev, fault):
    """The benchmark's faults call the entry with a zero bias or a unit
    gate: the kernel gives the plain form of those inputs, and an output
    far from the true one (it reads bias and gate as given)."""
    q, k, v, gate, bias = _attention_inputs(dev, 4, 496, torch.bfloat16, 9)
    if fault == "rel_bias_left_out":
        bias_f, gate_f = torch.zeros_like(bias), gate
    else:
        bias_f, gate_f = bias, torch.ones_like(gate)
    got = _check_attention((q, k, v, gate_f, bias_f))
    true = _check_attention((q, k, v, gate, bias))
    assert float((got - true).float().abs().max()) > 0.1


def test_rel_attention_kernel_contiguous_and_other_dtypes(dev):
    """Contiguous (B, H, L, D) inputs are copied into the model's layout
    and give what the views give; a float16 input is refused, not sent
    elsewhere."""
    from bsed_tpu_torch.ops import rel_attention as RA
    q, k, v, gate, bias = _attention_inputs(dev, 2, 120, torch.bfloat16, 4)
    views = RA.gated_rel_attention(q, k, v, gate, bias)
    _check_attention((q.contiguous(), k.contiguous(), v.contiguous(), gate,
                      bias))
    got = RA.gated_rel_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), gate, bias)
    assert torch.equal(got, views)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        RA.gated_rel_attention(q.half(), k.half(), v.half(), gate.half(),
                               bias.half())

# BEATs' position convolution (ops/pos_conv.py), (B, L, d, groups, taps,
# dtype): the published widths; a group of 64 (16-wide chunks) over two
# token tiles (700 = 512 + 188); odd taps on a short clip (the last weight
# stage padded); float32 at the widths of the served float32 test below,
# and 3 groups of 24 channels (no multiple of 16).
POS_CONV_CASES = [(4, 496, 768, 16, 128, torch.bfloat16),
                  (2, 700, 256, 4, 128, torch.bfloat16),
                  (3, 37, 64, 2, 31, torch.bfloat16),
                  (3, 96, 128, 4, 16, torch.float32),
                  (2, 75, 72, 3, 9, torch.float32)]
# The kernel against the plain entry on the same inputs: both sum in
# float32 and round x + GELU(conv + bias) once, so in bfloat16 they differ
# where another order of sums moves a rounding (2^-8 of a value): 2e-3 of
# the norm, 1e-2 of the largest magnitude; float32 (TF32 off on both)
# 1e-5 of either.
POS_CONV_TOL = {torch.bfloat16: (2e-3, 1e-2), torch.float32: (1e-5, 1e-5)}


@pytest.mark.parametrize("b,n,d,groups,taps,dtype", POS_CONV_CASES)
def test_pos_conv_kernel_matches_plain(dev, b, n, d, groups, taps, dtype):
    """The kernel against its plain version (``kernels.plain_versions()``)
    on the whole output and, apart, on the first and last 64 tokens, where
    the zero padding acts; one launch a call, none on the plain side."""
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(b, n, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn(d, d // groups, taps, generator=gen, device=dev)
         / (taps * d // groups) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
    before = pos_conv.pos_conv_residual.launches
    got = pos_conv.pos_conv_residual(x, w, bias, groups,
                                     pos_conv.pack_weight(w, groups))
    with kernels.plain_versions():
        want = pos_conv.pos_conv_residual(x, w, bias, groups)
    torch.cuda.synchronize()
    assert pos_conv.pos_conv_residual.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    rel, top = POS_CONV_TOL[dtype]
    edge = min(64, n)
    for part in (slice(None), slice(0, edge), slice(n - edge, n)):
        g, r = got[:, part].float(), want[:, part].float()
        assert float((g - r).norm() / r.norm()) <= rel, part
        assert float((g - r).abs().max()) <= top * float(r.abs().max()), part


def test_pos_conv_kernel_refuses_what_it_does_not_take(dev):
    """bfloat16 groups of 24 channels and float16 raise before any launch;
    the float32 body takes the groups of 24."""
    x = torch.randn(1, 20, 72, device=dev)
    w, bias = torch.randn(72, 24, 9, device=dev), torch.zeros(72, device=dev)
    before = pos_conv.pos_conv_residual.launches
    with pytest.raises(ValueError, match="multiples of 16"):
        pos_conv.pos_conv_residual(x.bfloat16(), w.bfloat16(),
                                   bias.bfloat16(), 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pos_conv.pos_conv_residual(x.half(), w.half(), bias.half(), 3)
    assert pos_conv.pos_conv_residual.launches == before
    pos_conv.pos_conv_residual(x, w, bias, 3)
    assert pos_conv.pos_conv_residual.launches == before + 1


def test_crnn_beats_forward_on_card_matches_reference(dev):
    """crnn_beats at its published widths through make_fast_forward, bf16
    'high', B = 8 ten-second clips, against the benchmark's float32
    reference (TF32 off): the posterior and embedding gaps within the
    limits of the cell ``serve_beats_crnn_b64``; K1 once, K4 twice and the
    attention 12 times and the position convolution once a forward."""
    import json
    import os
    from bsed_tpu_torch.ops import rel_attention as RA
    from portbench.harness import beats as B, synth, weights as Wt
    from portbench.harness.port import port_config
    from portbench.reference import beats as RB, crnn as R
    from portbench.reference.frontend import log_mel

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    load = lambda *p: json.load(open(os.path.join(root, "portbench", *p)))  # noqa: E731
    config = load("configs", "crnn_beats.json")
    mix = load("traffic", "serve_beats_b64.json")
    limits = load("limits", "serve_beats_crnn_b64.json")["limits"]
    from bsed_tpu_torch.config import BeatsConfig
    cfg = port_config(config, "serve", mix)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, beats=BeatsConfig(**config["beats"])))
    params = B.make_params(config, 21, 22, dev)
    audio = synth.clips(23, 8, config["audio"], mix["audio"], dev)
    with torch.no_grad():
        stats = {"encoder": {"cnn": R.block_input_stats(
            log_mel(audio, config["audio"]), params, config["model"])}}
    fwd = make_fast_forward(cfg, Wt.to_numpy(params), Wt.to_numpy(stats),
                            device=dev, precision="high")
    seen = []
    fwd.beats.encoder.register_forward_hook(lambda m, i, o: seen.append(o))
    k1, k4 = (mel_kernel.fused_block_mel.launches,
              gru_kernel.gru_bidir_recurrence.launches)
    attn = RA.gated_rel_attention.launches
    pc = pos_conv.pos_conv_residual.launches
    strong, weak = fwd(audio)
    torch.cuda.synchronize()
    assert mel_kernel.fused_block_mel.launches == k1 + 1
    assert gru_kernel.gru_bidir_recurrence.launches == k4 + 2
    assert RA.gated_rel_attention.launches == attn + 12
    assert pos_conv.pos_conv_residual.launches == pc + 1
    assert seen[0].shape == (8, 496, 768) and seen[0].dtype == torch.bfloat16
    with torch.no_grad():
        h, emb = RB.encode(audio, params, stats, config)
        rs, rw = R.predictor(h, params["predictor"])
    gaps = {"frame_posterior_gap": float((strong - rs).abs().max()),
            "clip_posterior_gap": float((weak - rw).abs().max()),
            "embedding_gap": float((seen[0].float() - emb).norm()
                                   / emb.norm())}
    print("crnn_beats B=8 gaps", gaps)
    for k, v in gaps.items():
        assert v <= limits[k], (k, v, limits[k])


def test_crnn_beats_served_plain_launches_no_attention(dev):
    """crnn_beats at a small width (2 layers, d = 128 in 2 heads of 64;
    the CRNN cut as tests/test_torch_beats.py cuts it), float32, 3 clips
    of 2 s: BEATs' branch launches the attention kernel once a layer and
    the position convolution's float32 body once (4 groups of 32, 16
    taps); inside ``kernels.plain_versions()`` the whole forward launches
    neither, and the branch's embeddings are the kernels' within 1e-4 of
    their norm."""
    import json
    import os
    from bsed_tpu_torch.config import BeatsConfig
    from bsed_tpu_torch.ops import rel_attention as RA
    from portbench.harness import beats as B, synth, weights as Wt
    from portbench.harness.port import port_config
    from portbench.reference import crnn as R
    from portbench.reference.frontend import log_mel

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs",
                           "crnn_beats.json")) as fh:
        config = json.load(fh)
    config["audio"].update(n_window=256, n_mels=16, max_len_seconds=2.0)
    config["model"].update(nb_filters=[16, 32, 64, 16],
                           pooling=[[2, 2], [2, 2], [1, 2], [1, 2]],
                           n_rnn_cell=16)
    config["beats"].update(embed_dim=32, encoder_layers=2,
                           encoder_embed_dim=128, encoder_ffn_embed_dim=256,
                           encoder_attention_heads=2, conv_pos=16,
                           conv_pos_groups=4)
    config["fusion"].update(in_features=144, out_features=16)
    cfg = port_config(config, "serve", {"runner": "serve_beats"})
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="float32",
        beats=BeatsConfig(**config["beats"])))
    params = B.make_params(config, 31, 32, dev)
    audio = synth.clips(33, 3, config["audio"], {
        "gain_db": [-50, -20], "events": 4, "event_s": [0.1, 0.5],
        "freq_hz": [500, 6000], "sweep_hz_per_s": 2000,
        "event_db": [0, 25]}, dev)
    with torch.no_grad():
        stats = {"encoder": {"cnn": R.block_input_stats(
            log_mel(audio, config["audio"]), params, config["model"])}}
    fwd = make_fast_forward(cfg, Wt.to_numpy(params), Wt.to_numpy(stats),
                            device=dev, precision="high")
    before = RA.gated_rel_attention.launches
    pc = pos_conv.pos_conv_residual.launches
    with torch.inference_mode():
        emb = fwd.beats(audio)
    torch.cuda.synchronize()
    assert RA.gated_rel_attention.launches == before + 2
    assert pos_conv.pos_conv_residual.launches == pc + 1
    with kernels.plain_versions():
        strong, weak = fwd(audio)
        with torch.inference_mode():
            plain = fwd.beats(audio)
    torch.cuda.synchronize()
    assert RA.gated_rel_attention.launches == before + 2
    assert pos_conv.pos_conv_residual.launches == pc + 1
    assert strong.shape == (3, 251 // 4, 20) and torch.isfinite(strong).all()
    assert float((emb - plain).norm() / plain.norm()) < 1e-4


# HTS-AT (the htsat configuration)

def test_htsat_forward_on_card_matches_reference(dev):
    """htsat at its published widths through make_fast_forward, bf16
    'high', B = 8 ten-second clips, against the benchmark's float32
    reference (TF32 off): the posterior gaps, the last stage's token gap
    and the first stage's in the band its shifted windows wrap, within the
    limits of the cell ``serve_htsat_b64``; the window attention 12 times
    a forward, and K1 once, in its power-dB form."""
    import json
    import os
    from bsed_tpu_torch.ops import window_attention as WA
    from portbench.harness import htsat as H, synth, weights as Wt
    from portbench.reference import htsat as RH
    from portbench.runners.serve_htsat import port_config, wrap_band

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    load = lambda *p: json.load(open(os.path.join(root, "portbench", *p)))  # noqa: E731
    config = load("configs", "htsat.json")
    mix = load("traffic", "serve_htsat_b64.json")
    limits = load("limits", "serve_htsat_b64.json")["limits"]
    cfg = port_config(config, mix)
    params = H.make_params(config, 31, dev)
    audio = synth.clips(33, 8, config["audio"], mix["audio"], dev)
    with torch.no_grad():
        stats = H.bn0_stats(RH.log_mel(audio, config["audio"]))
    fwd = make_fast_forward(cfg, Wt.to_numpy(params), Wt.to_numpy(stats),
                            device=dev, precision="high")
    seen, first = [], []
    fwd.htsat.register_forward_hook(lambda m, i, o: seen.append(o))
    fwd.htsat.layers[0].register_forward_hook(lambda m, i, o: first.append(o))
    calls = WA.calls
    k1 = mel_kernel.fused_block_mel
    k1_before = (k1.launches, k1.launches_db)
    strong, weak = fwd(audio)
    torch.cuda.synchronize()
    assert WA.calls == calls + 12
    assert (k1.launches, k1.launches_db) == (k1_before[0] + 1,
                                             k1_before[1] + 1)
    assert strong.shape == (8, 1024, 20) and weak.shape == (8, 20)
    assert seen[0].shape == (8, 64, 768) and seen[0].dtype == torch.bfloat16
    with torch.no_grad():
        rs, rw, rt, r1 = RH.forward(audio, params, stats, config)
    assert first[0].shape == r1.shape == (8, 1024, 192)
    band = wrap_band(config).to(dev)
    e1, r1 = first[0][:, band].float(), r1[:, band]
    gaps = {"frame_posterior_gap": float((strong - rs).abs().max()),
            "clip_posterior_gap": float((weak - rw).abs().max()),
            "token_gap": float((seen[0].float() - rt).norm() / rt.norm()),
            "stage1_band_gap": float((e1 - r1).norm() / r1.norm())}
    print("htsat B=8 gaps", gaps)
    for k, v in gaps.items():
        assert v <= limits[k], (k, v, limits[k])
