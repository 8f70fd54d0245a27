"""The port's mel front end (bsed_tpu_torch/ops/mel.py, mel_kernel.py)
against the JAX package's on identical numpy audio.

Default AudioConfig with 1 s clips: the mel kernel K1 needs N//H == 8,
which the small test geometry (hop 160) does not meet. On the CPU the K1
wrapper runs its plain version; the JAX side runs its Pallas kernel in
interpret mode, as tests/test_mel.py does. The gate is the repo's 1e-3 dB.
"""
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


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(11)
    return rng.standard_normal((2, CFG.n_samples)).astype(np.float32) * 0.1


@pytest.fixture(scope="module")
def jax_dense_db(audio):
    return np.asarray(jmel.MelFrontEnd(JCFG, algorithm="dense",
                                       precision="highest")(audio, log=True))


def test_filterbank_copy_matches():
    np.testing.assert_array_equal(mel_filterbank(), j_mel_filterbank())


@pytest.mark.parametrize("algorithm", ["dense", "block"])
def test_front_end_matches_jax_dense(audio, jax_dense_db, algorithm):
    fe = mel.MelFrontEnd(CFG, algorithm=algorithm, device="cpu")
    got = fe(torch.from_numpy(audio), log=True)
    assert got.shape == jax_dense_db.shape == (2, 126, 128)
    assert np.max(np.abs(got.numpy() - jax_dense_db)) < 1e-3  # dB


def test_block_kernel_plain_matches_jax_block_pallas(audio, jax_dense_db):
    """K1's plain version (what the CPU wrapper runs) against the JAX
    fused_block_mel in interpret mode, and against JAX dense."""
    want = np.asarray(jmel.MelFrontEnd(JCFG, algorithm="block_pallas",
                                       precision="high")(audio, log=True))
    fe = mel.MelFrontEnd(CFG, algorithm="block_kernel", device="cpu")
    got = fe(torch.from_numpy(audio), log=True).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-3  # dB
    assert np.max(np.abs(got - jax_dense_db)) < 1e-3  # dB


def test_block_kernel_linear_mel_matches_dense(audio):
    """Linear mel of the kernel's live-bin constants against the port's
    dense path; the wrapper on a CPU tensor is the plain version."""
    fb = mel_filterbank(CFG.sr, CFG.n_window, CFG.n_mels, dtype=np.float64)
    kb = mel_kernel.build_mel_kernel_bases(CFG.n_window, CFG.hop_size, fb,
                                           device="cpu")
    assert kb.fb.shape[0] == 1024          # live bins, a multiple of 32
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
