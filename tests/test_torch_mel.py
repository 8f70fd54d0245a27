"""The port's mel front end (bsed_tpu_torch/ops/mel.py, mel_kernel.py)
against the JAX package's on identical numpy audio.

Default AudioConfig with 1 s clips: the mel kernel K1 needs N//H == 8,
which the small test geometry (hop 160) does not meet. On the CPU the K1
wrapper runs its plain version; the JAX side runs its Pallas kernel in
interpret mode, as tests/test_mel.py does. The gate is the repo's 1e-3 dB.
"""
import jax
import numpy as np
import pytest
import torch

from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.ops import mel as jmel
from bsed_tpu.ops.filterbank import mel_filterbank as j_mel_filterbank

from bsed_tpu_torch.config import AudioConfig
from bsed_tpu_torch.ops import mel, mel_kernel
from bsed_tpu_torch.ops.filterbank import mel_filterbank

CFG = AudioConfig(max_len_seconds=1.0)
JCFG = JAudioConfig(max_len_seconds=1.0)
GATE_DB = 1e-3


def assert_db_close(got, want, what, gate=GATE_DB):
    """max |got − want| < gate (dB); a failure names the distance, where it
    is, both values, how many elements miss and the torch matmul state."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got - want)
    at = np.unravel_index(int(np.argmax(diff)), diff.shape)
    assert diff[at] < gate, (
        f"{what}: max |Δ| = {diff[at]:.3e} dB at {at} (got {got[at]:.6f}, "
        f"want {want[at]:.6f}; clip peak {want[at[0]].max():.3f} dB), "
        f"{int((diff >= gate).sum())} of {diff.size} elements at or over "
        f"the {gate} dB gate; torch threads {torch.get_num_threads()}, "
        f"float32 matmul precision {torch.get_float32_matmul_precision()}")


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(11)
    return rng.standard_normal((2, CFG.n_samples)).astype(np.float32) * 0.1


@pytest.fixture(scope="module")
def jax_dense_db(audio):
    """The JAX dense front end, in float32 whatever XLA:CPU's default
    matmul precision is on the host (as the port's other test files run
    their JAX side), copied out of the JAX buffer."""
    with jax.default_matmul_precision("float32"):
        out = jmel.MelFrontEnd(JCFG, algorithm="dense",
                               precision="highest")(audio.copy(), log=True)
    return np.array(out, dtype=np.float32, copy=True)


@pytest.fixture(scope="module")
def golden_db(audio):
    """float64 torch.stft -> |.| -> float64 filterbank -> dB: the referee
    that says which side moved when the port and JAX disagree."""
    x = torch.from_numpy(audio.copy()).double()
    spec = torch.stft(x, CFG.n_window, CFG.hop_size,
                      window=torch.hamming_window(CFG.n_window,
                                                  periodic=False,
                                                  dtype=torch.float64),
                      center=True, pad_mode="reflect", return_complex=True)
    fb = torch.from_numpy(mel_filterbank(CFG.sr, CFG.n_window, CFG.n_mels,
                                         CFG.mel_f_min, CFG.mel_f_max,
                                         dtype=np.float64))
    return mel.amplitude_to_db(spec.abs().transpose(1, 2) @ fb).numpy()


def test_filterbank_copy_matches():
    np.testing.assert_array_equal(mel_filterbank(), j_mel_filterbank())


@pytest.mark.parametrize("algorithm", ["dense"])
def test_front_end_matches_jax_dense(audio, jax_dense_db, golden_db,
                                     algorithm):
    """The port's front end against JAX's dense one, 1e-3 dB. Each side is
    first held against the float64 golden at the same gate (alone they sit
    at 1.5e-5 and 4.4e-5 dB from it, 4.1e-5 dB from each other), so a miss
    names the side that moved and by how much. The inputs are private
    copies: ``torch.from_numpy`` and JAX's CPU arrays may both alias the
    numpy buffer of the module-scoped fixture."""
    fe = mel.MelFrontEnd(CFG, algorithm=algorithm, device="cpu")
    got = fe(torch.from_numpy(audio.copy()), log=True).numpy()
    assert got.shape == jax_dense_db.shape == golden_db.shape == (2, 126, 128)
    assert_db_close(got, golden_db, f"port {algorithm} vs float64 golden")
    assert_db_close(jax_dense_db, golden_db, "JAX dense vs float64 golden")
    assert_db_close(got, jax_dense_db, f"port {algorithm} vs JAX dense")


def test_fft_reference_matches_jax(audio, golden_db):
    """``mel_spectrogram`` (the rfft reference) against bsed_tpu's, each
    side first against the float64 golden, 1e-3 dB."""
    window = np.hamming(CFG.n_window).astype(np.float32)
    fb = mel_filterbank(CFG.sr, CFG.n_window, CFG.n_mels, CFG.mel_f_min,
                        CFG.mel_f_max)
    with jax.default_matmul_precision("float32"):
        want_s = np.array(jmel.mel_spectrogram(
            audio.copy(), window, fb, CFG.n_window, CFG.hop_size, log=True),
            dtype=np.float32)
    got_s = mel.mel_spectrogram(torch.from_numpy(audio.copy()),
                                torch.from_numpy(window),
                                torch.from_numpy(fb), CFG.n_window,
                                CFG.hop_size, log=True).numpy()
    what = "mel_spectrogram"
    assert got_s.shape == want_s.shape == golden_db.shape
    assert_db_close(got_s, golden_db, f"port {what} vs float64 golden")
    assert_db_close(want_s, golden_db, f"JAX {what} vs float64 golden")
    assert_db_close(got_s, want_s, f"port {what} vs JAX {what}")
    linear = mel.mel_spectrogram(torch.from_numpy(audio.copy()),
                                 torch.from_numpy(window),
                                 torch.from_numpy(fb), CFG.n_window,
                                 CFG.hop_size)
    np.testing.assert_allclose(mel.amplitude_to_db(linear).numpy(), got_s)


def test_block_kernel_plain_matches_jax_block_pallas(audio, jax_dense_db):
    """K1's plain version (what the CPU wrapper runs) against the JAX
    fused_block_mel in interpret mode, and against JAX dense."""
    want = np.asarray(jmel.MelFrontEnd(JCFG, algorithm="block_pallas",
                                       precision="high")(audio, log=True))
    fe = mel.MelFrontEnd(CFG, algorithm="block_kernel", device="cpu")
    got = fe(torch.from_numpy(audio), log=True).numpy()
    assert got.shape == want.shape
    assert_db_close(got, want, "K1 plain vs JAX block_pallas")
    assert_db_close(got, jax_dense_db, "K1 plain vs JAX dense")


def test_block_kernel_linear_mel_matches_dense(audio):
    """Linear mel of the kernel's live-bin constants against the port's
    dense path; the wrapper on a CPU tensor is the plain version."""
    fb = mel_filterbank(CFG.sr, CFG.n_window, CFG.n_mels, dtype=np.float64)
    kb = mel_kernel.build_mel_kernel_bases(CFG.n_window, CFG.hop_size, fb,
                                           device="cpu")
    # the bands end at bin 1023: the Nyquist bin is never read
    assert int((kb.bands[:, 0] + kb.bands[:, 1]).max()) == 1024
    assert kb.weights.numel() == 2016 == int(np.count_nonzero(fb))
    x = torch.from_numpy(audio)
    before = mel_kernel.fused_block_mel.launches
    got = mel_kernel.fused_block_mel(x, kb, CFG.n_window, CFG.hop_size,
                                     CFG.n_mels)
    assert mel_kernel.fused_block_mel.launches == before  # no launch on CPU
    want = mel.MelFrontEnd(CFG, device="cpu")(x)
    scale = float(want.max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-5 * scale)


def test_padded_signal_matches_jax():
    x = np.random.default_rng(1).standard_normal((3, 3000)).astype(np.float32)
    p, t, lead = mel._padded_signal(torch.from_numpy(x), 2048, 255)
    jp, jt, jlead = jmel._padded_signal(x, 2048, 255)
    assert (t, lead) == (jt, tuple(jlead))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


def test_amplitude_to_db_per_clip_clamp():
    """Two clips of different loudness: each is clamped at its own peak
    minus 80 dB, as the JAX function does."""
    rng = np.random.default_rng(2)
    quiet = rng.random((5, 4)).astype(np.float32) * 1e-3
    loud = rng.random((5, 4)).astype(np.float32) * 1e3
    loud[0, 0] = 1e-9                        # far below loud's peak - 80 dB
    batch = np.stack([quiet, loud])
    got = mel.amplitude_to_db(torch.from_numpy(batch)).numpy()
    want = np.asarray(jmel.amplitude_to_db(batch))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.isclose(got[1].min(), got[1].max() - 80.0, atol=1e-4)
    # the quiet clip is held to its own peak, not to the batch's
    assert got[1].max() - 80.0 > got[0].min() >= got[0].max() - 80.0


def test_kernel_geometry_guards():
    fb = mel_filterbank()
    with pytest.raises(ValueError, match="tail"):
        mel_kernel.build_mel_kernel_bases(2048, 256, fb, device="cpu")
    with pytest.raises(ValueError, match="N//H"):
        mel_kernel.build_mel_kernel_bases(2048, 160, fb, device="cpu")
    assert mel_kernel.supports(2048, 255, 128)
    assert not mel_kernel.supports(2048, 255, 130)


def test_kernel_refuses_non_power_of_two_window():
    """The FFT needs N a power of two; N=2000, H=230 passes the rest of the
    JAX kernel's envelope (N//H == 8, N % H != 0, H < 256), so only the FFT
    condition refuses it."""
    assert 2000 // 230 == 8 and 2000 % 230
    with pytest.raises(ValueError, match="power of two"):
        mel_kernel.check_geometry(2000, 230, 128)
    assert not mel_kernel.supports(2000, 230, 128)
    fb = mel_filterbank(n_fft=2000)
    with pytest.raises(ValueError, match="power of two"):
        mel_kernel.build_mel_kernel_bases(2000, 230, fb, device="cpu")


GEOMETRIES = [(2048, 255, 128), (1024, 127, 128), (512, 63, 64),
              (256, 31, 32)]


@pytest.mark.parametrize("n_window,hop,n_mels", GEOMETRIES)
def test_band_table_rebuilds_dense_filterbank(n_window, hop, n_mels):
    """Scattering the band weights back gives the float32 dense filterbank
    bit for bit."""
    fb = mel_filterbank(CFG.sr, n_window, n_mels, dtype=np.float64)
    kb = mel_kernel.build_mel_kernel_bases(n_window, hop, fb, device="cpu")
    assert kb.bands.dtype == torch.int32 and kb.bands.shape == (n_mels, 3)
    dense = np.zeros(fb.shape, np.float32)
    w = kb.weights.numpy()
    for m, (start, length, off) in enumerate(kb.bands.numpy()):
        dense[start:start + length, m] = w[off:off + length]
    np.testing.assert_array_equal(dense, fb.astype(np.float32))
    assert int(kb.bands[-1, 2] + kb.bands[-1, 1]) == w.size


@pytest.mark.parametrize("n_window,hop,n_mels", GEOMETRIES)
def test_twiddle_and_window_tables_match_float64(n_window, hop, n_mels):
    """W_N^q for q < M, then the four-step W_M^{j·k1} at M + k1·Q + j, and
    the symmetric Hamming window: float64 numpy rounded once to float32."""
    fb = mel_filterbank(CFG.sr, n_window, n_mels, dtype=np.float64)
    kb = mel_kernel.build_mel_kernel_bases(n_window, hop, fb, device="cpu")
    m = n_window // 2
    p, q = mel_kernel.fft_split(n_window)
    assert p * q == m and q <= p <= 2 * q
    want = np.exp(-2j * np.pi * np.arange(m) / n_window)
    k1, j = np.arange(p)[:, None], np.arange(q)[None, :]
    want = np.concatenate([want, np.exp(-2j * np.pi * k1 * j / m).ravel()])
    tw = kb.twiddle.numpy()
    assert tw.shape == (n_window, 2) and tw.dtype == np.float32
    np.testing.assert_array_equal(tw[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], want.imag.astype(np.float32))
    np.testing.assert_array_equal(kb.window.numpy(),
                                  np.hamming(n_window).astype(np.float32))


@pytest.mark.parametrize("n_window,hop,n_mels", GEOMETRIES)
def test_kernel_plain_matches_float64_stft(n_window, hop, n_mels):
    """K1's plain version (packing, M-point FFT, split step, bands) against
    torch.stft in float64 and the float64 filterbank, with a clip length
    whose frame count is not a multiple of the kernel's 8-frame tile."""
    rng = np.random.default_rng(3)
    n = 13 * hop + 5                       # T = 14 frames
    x = rng.standard_normal((2, n)).astype(np.float32)
    fb = mel_filterbank(CFG.sr, n_window, n_mels, dtype=np.float64)
    kb = mel_kernel.build_mel_kernel_bases(n_window, hop, fb, device="cpu")
    got = mel_kernel.fused_block_mel(torch.from_numpy(x), kb, n_window, hop,
                                     n_mels)
    spec = torch.stft(torch.from_numpy(x).double(), n_window, hop,
                      window=torch.hamming_window(n_window, periodic=False,
                                                  dtype=torch.float64),
                      center=True, pad_mode="reflect", return_complex=True)
    want = spec.abs().transpose(1, 2) @ torch.from_numpy(fb)
    assert got.shape == want.shape == (2, 14, n_mels)
    db = lambda a: mel.amplitude_to_db(a.double())        # noqa: E731
    assert_db_close(db(got).numpy(), db(want).numpy(),
                    f"K1 plain vs float64 stft, N={n_window}")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.max()))


# K1's power-dB form (torchlibrosa's front end, HTS-AT's): periodic Hann,
# |X|², the Slaney area-normalised bands, 10·log10(max(mel, 1e-10))
# unclamped. (N, H, n_mels, sr, f_max, frames): HTS-AT's published
# geometry (N // H = 3), the tiny HTS-AT tests' and librosa's default
# (N // H = 4, an exact multiple) with 14 frames, not a multiple of the
# kernel's 8-frame tile.
DB_GEOMETRIES = [(1024, 320, 64, 32000, 14000.0, 16),
                 (256, 80, 32, 8000, 3500.0, 16),
                 (2048, 512, 128, 32000, 16000.0, 14)]


def _slaney(n_window, n_mels, sr, f_max):
    return mel_filterbank(sr, n_window, n_mels, 50.0, f_max,
                          dtype=np.float64, norm="slaney")


def _db_bases(n_window, hop, fb):
    return mel_kernel.build_mel_kernel_bases(
        n_window, hop, fb, device="cpu", window=mel.hann_window(n_window),
        power_db=True)


@pytest.mark.parametrize("n_window,hop,n_mels,sr,f_max,frames",
                         DB_GEOMETRIES)
def test_power_db_plain_matches_float64_stft(n_window, hop, n_mels, sr,
                                             f_max, frames):
    """K1's plain version in the power-dB form against torch.stft in
    float64 (periodic Hann, centre reflect pad), the float64 Slaney
    filterbank on the power spectrum and the unclamped dB, 1e-3 dB."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, (frames - 1) * hop + 7)).astype(np.float32)
    fb = _slaney(n_window, n_mels, sr, f_max)
    kb = _db_bases(n_window, hop, fb)
    before = (mel_kernel.fused_block_mel.launches,
              mel_kernel.fused_block_mel.launches_db)
    got = mel_kernel.fused_block_mel(torch.from_numpy(x), kb, n_window, hop,
                                     n_mels)
    assert (mel_kernel.fused_block_mel.launches,
            mel_kernel.fused_block_mel.launches_db) == before  # CPU: plain
    spec = torch.stft(torch.from_numpy(x).double(), n_window, hop,
                      window=torch.hann_window(n_window, periodic=True,
                                               dtype=torch.float64),
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2
    want = 10.0 * torch.log10(torch.clamp(
        power.transpose(1, 2) @ torch.from_numpy(fb), min=1e-10))
    assert got.shape == want.shape == (2, frames, n_mels)
    assert got.dtype == torch.float32
    assert_db_close(got.numpy(), want.numpy(),
                    f"K1 power-dB plain vs float64 stft, N={n_window}")


@pytest.mark.parametrize("n_window,hop,n_mels,sr,f_max,frames",
                         DB_GEOMETRIES)
def test_power_db_band_table_rebuilds_slaney_filterbank(
        n_window, hop, n_mels, sr, f_max, frames):
    """The Slaney area-normalised filterbank's band table scatters back to
    the float32 dense filterbank bit for bit."""
    fb = _slaney(n_window, n_mels, sr, f_max)
    kb = _db_bases(n_window, hop, fb)
    assert kb.power_db is True
    assert kb.bands.dtype == torch.int32 and kb.bands.shape == (n_mels, 3)
    dense = np.zeros(fb.shape, np.float32)
    w = kb.weights.numpy()
    for m, (start, length, off) in enumerate(kb.bands.numpy()):
        dense[start:start + length, m] = w[off:off + length]
    np.testing.assert_array_equal(dense, fb.astype(np.float32))
    assert int(kb.bands[-1, 2] + kb.bands[-1, 1]) == w.size


@pytest.mark.parametrize("n_window,hop,n_mels,sr,f_max,frames",
                         DB_GEOMETRIES)
def test_power_db_window_table_is_periodic_hann(n_window, hop, n_mels, sr,
                                                f_max, frames):
    """The power-dB form's window is the periodic Hann, 0.5 − 0.5·cos(2πk
    / N) in float64 rounded once to float32 (torch's periodic window,
    computed in float32, to a few ulp); its twiddles are the magnitude
    form's."""
    fb = _slaney(n_window, n_mels, sr, f_max)
    kb = _db_bases(n_window, hop, fb)
    k = np.arange(n_window)
    want = (0.5 - 0.5 * np.cos(2 * np.pi * k / n_window)).astype(np.float32)
    np.testing.assert_array_equal(kb.window.numpy(), want)
    assert kb.window[0] == 0.0 and kb.window.dtype == torch.float32
    torch.testing.assert_close(
        kb.window, torch.hann_window(n_window, periodic=True),
        rtol=0, atol=4e-7)
    plain = mel_kernel.build_mel_kernel_bases(
        n_window, 255 if n_window == 2048 else n_window // 8 - 1,
        mel_filterbank(sr, n_window, n_mels, dtype=np.float64), device="cpu")
    assert torch.equal(kb.twiddle, plain.twiddle)
    assert plain.power_db is False


def test_power_db_envelope():
    """The power-dB form admits HTS-AT's N // H = 3 and an exact multiple,
    any hop up to ``MAX_HOP_DB``, and refuses a longer hop, a window the
    kernel has no FFT for and n_mels the banded sum does not take; the
    magnitude form keeps the JAX kernel's envelope and refuses them."""
    ok = lambda *g: mel_kernel.supports(*g, power_db=True)  # noqa: E731
    assert ok(1024, 320, 64) and ok(256, 80, 32) and ok(2048, 512, 128)
    assert ok(2048, 255, 128) and ok(128, 1, 4)
    assert ok(2048, mel_kernel.MAX_HOP_DB, 128)
    assert not mel_kernel.supports(1024, 320, 64)
    assert not mel_kernel.supports(2048, 512, 128)
    with pytest.raises(ValueError, match="hop_size"):
        mel_kernel.check_geometry(2048, mel_kernel.MAX_HOP_DB + 1, 128,
                                  power_db=True)
    with pytest.raises(ValueError, match="hop_size"):
        mel_kernel.check_geometry(1024, 0, 64, power_db=True)
    for n in (64, 1000, 4096):
        with pytest.raises(ValueError, match="power of two"):
            mel_kernel.check_geometry(n, 320, 64, power_db=True)
    for m in (66, 132):
        with pytest.raises(ValueError, match="n_mels"):
            mel_kernel.check_geometry(1024, 320, m, power_db=True)
    fb = mel_filterbank(32000, 1024, 64, dtype=np.float64)
    with pytest.raises(ValueError, match="hop_size"):
        mel_kernel.build_mel_kernel_bases(1024, 600, fb, device="cpu",
                                          power_db=True)
    with pytest.raises(ValueError, match="N//H"):
        mel_kernel.build_mel_kernel_bases(1024, 320, fb, device="cpu")
