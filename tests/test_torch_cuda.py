"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an NVIDIA GPU with the CUDA toolkit (the kernels are built with
nvcc at first use) and skip elsewhere; the file imports no JAX, so it runs
on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

import dataclasses

from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.models.rnn import (BidirectionalGRU, HoistedBiGRU,
                                       bigru_hoisted, gru_scan_bidir)
from bsed_tpu_torch.ops import (gru_kernel, mel, mel_kernel, stem_epilogue,
                                stem_kernel)
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
    want = make_fast_forward(cfg, params, stats, device=dev,
                             use_kernels=False)(audio)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-2)


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
    """make_predict_fn on the kernels (K2 eval 3 times and K4 twice a
    batch) against the same function on their plain versions, full width
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
    assert stem_epilogue.stem_epilogue_fwd.launches == k2 + 3
    assert gru_kernel.gru_bidir_recurrence.launches == k4 + 2
    want = make_predict_fn(TrainModules(cfg, dev, use_kernels=False))(
        params, stats, mel)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=gate)


def _card_trainer(dev, store, use_kernels=True, scan_epoch="auto"):
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
                   store_dir=str(store), device=dev,
                   use_kernels=use_kernels, scan_epoch=scan_epoch)


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
    K2 eval 3 and K4 2 times a val batch) against the same fit on their
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
        (2 * 6 + 2 * 3, 2 * 3, 2 * 2)
    plain = _card_trainer(dev, tmp_path / "plain", use_kernels=False)
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
