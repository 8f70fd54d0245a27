"""STFT → mel → log-power front end in PyTorch.

Port of ``bsed_tpu/ops/mel.py`` (librosa semantics: symmetric Hamming
window, reflect pad of N/2, frame t starts at t·H, Slaney filterbank with
norm=None, ``amplitude_to_db`` with a per-clip top_db clamp). Two
algorithms compute the same mel:

  * ``dense``        — frames @ (cos, −sin) DFT bases, |·|, @ filterbank;
  * ``block_kernel`` — one hand-written CUDA kernel from audio to mel
                       (``ops/mel_kernel.fused_block_mel``: an FFT and a
                       banded mel on the H100), the counterpart of the JAX
                       package's ``block_pallas`` (its plain version
                       where ``kernels.launches_on`` says not to launch).

Every path computes in float32; whether the card's matmuls round to TF32
is the caller's to set (``utils/device.float32_precision``, which the
CLI's ``predict``, ``preprocess`` and ``synthesize`` hold for the length
of their call). The JAX package's precision tiers ('highest', 'high',
'fast') set its MXU pass count; here they gate, in
``serve.make_fast_forward``, whether the kernel may run, and set TF32
through ``float32_precision``. ``mel_spectrogram`` is the FFT reference
(``torch.fft.rfft``) for cross-checking the DFT path.

HTS-AT's front end (torchlibrosa's, ``MelFrontEnd(torchlibrosa=True)``)
takes other settings: a periodic Hann window, the mel of the power
spectrum through a Slaney area-normalised filterbank, and the dB of that
power with no top_db clamp. Either algorithm computes it; with
``block_kernel`` it is K1's power-dB form, which writes the dB itself
(``serve.make_htsat_forward`` serves it; ``dense`` is its reference).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bsed_tpu_torch.config import AudioConfig
from bsed_tpu_torch.ops.filterbank import mel_filterbank
from bsed_tpu_torch.utils.device import resolve_device

_AMIN_POWER = 1e-10   # amplitude_to_db: amin=1e-5 on amplitude → 1e-10 on power
_TOP_DB = 80.0
PRECISIONS = ("highest", "high", "fast")
ALGORITHMS = ("dense", "block_kernel")


def hamming_window(n: int, dtype=np.float32) -> np.ndarray:
    """Symmetric Hamming window == np.hamming(n) (librosa passes np.hamming)."""
    return np.hamming(n).astype(dtype)


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, 0.5 − 0.5·cos(2πk/n) for k < n (scipy's
    ``get_window('hann', n)``, as torchlibrosa builds it)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(dtype)


def num_frames(n_samples: int, hop_size: int) -> int:
    """Frame count for a center-padded STFT: 1 + n_samples // hop."""
    return 1 + n_samples // hop_size


def dft_basis(n_window: int, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis (cos, −sin) of shape (n_window, 1 + n_window//2),
    built on host in float64."""
    n_freqs = 1 + n_window // 2
    k = np.arange(n_window)[:, None] * np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * k / n_window
    return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)


def _padded_signal(audio: torch.Tensor, n_window: int, hop_size: int):
    """Center reflect-pad by N/2, then right zero-pad to
    ``need = J·H + T·H`` (J = N//H) so every frame exists.
    Returns (padded (B', need), t_frames, lead_shape)."""
    n_samples = audio.shape[-1]
    t = num_frames(n_samples, hop_size)
    lead = tuple(audio.shape[:-1])
    flat = audio.reshape(-1, 1, n_samples)
    pad = n_window // 2
    p = F.pad(flat, (pad, pad), mode="reflect")[:, 0]
    need = (n_window // hop_size) * hop_size + t * hop_size
    if p.shape[1] < need:
        p = F.pad(p, (0, need - p.shape[1]))
    return p[:, :need], t, lead


def frame_signal(audio: torch.Tensor, n_window: int,
                 hop_size: int) -> torch.Tensor:
    """(..., n_samples) → (..., T, n_window) with center reflect padding."""
    p, t, lead = _padded_signal(audio, n_window, hop_size)
    frames = p.unfold(-1, n_window, hop_size)[:, :t]
    return frames.reshape(lead + (t, n_window))


def stft_power(audio: torch.Tensor, window: torch.Tensor,
               cos_basis: torch.Tensor, sin_basis: torch.Tensor,
               n_window: int, hop_size: int) -> torch.Tensor:
    """(..., n_samples) → (..., T, n_freqs) |STFT|² via DFT matmuls."""
    frames = frame_signal(audio.float(), n_window, hop_size) * window
    re = frames @ cos_basis
    im = frames @ sin_basis
    return re * re + im * im


def stft_magnitude(audio: torch.Tensor, window: torch.Tensor,
                   cos_basis: torch.Tensor, sin_basis: torch.Tensor,
                   n_window: int, hop_size: int) -> torch.Tensor:
    """(..., n_samples) → (..., T, n_freqs) |STFT| via DFT matmuls."""
    return torch.sqrt(stft_power(audio, window, cos_basis, sin_basis,
                                 n_window, hop_size))


def amplitude_to_db(mel_amp: torch.Tensor, top_db: Optional[float] = _TOP_DB,
                    per_clip_axes=(-2, -1)) -> torch.Tensor:
    """librosa.amplitude_to_db with ref=1.0, amin=1e-5 (elementwise on
    amplitude), top_db clamp relative to each clip's maximum over
    ``per_clip_axes`` (T, mels)."""
    return power_to_db(mel_amp * mel_amp, top_db, per_clip_axes)


def power_to_db(power: torch.Tensor, top_db: Optional[float] = _TOP_DB,
                per_clip_axes=(-2, -1)) -> torch.Tensor:
    """librosa.power_to_db with ref=1.0, amin=1e-10; with ``top_db`` the
    clamp of ``amplitude_to_db``, without it none."""
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=_AMIN_POWER))
    if top_db is not None:
        peak = torch.amax(log_spec, dim=per_clip_axes, keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


class MelFrontEnd:
    """Batched mel extractor: (B, n_samples) → (B, T, n_mels) linear mel,
    or dB with ``log=True``. ``block_kernel`` calls
    ``mel_kernel.fused_block_mel``, looked up at call time. By default
    the CRNN's front end, K1's magnitude form; with ``torchlibrosa``
    HTS-AT's: a periodic Hann window, the power spectrum through a Slaney
    area-normalised filterbank, its dB unclamped (K1's power-dB form,
    which gives the dB alone: call it with ``log=True``)."""

    def __init__(self, cfg: AudioConfig = AudioConfig(),
                 algorithm: str = "dense", device="cuda", *,
                 torchlibrosa: bool = False):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown mel algorithm {algorithm}")
        self.cfg = cfg
        self.algorithm = algorithm
        self.torchlibrosa = torchlibrosa
        self.device = resolve_device(device)
        dev = lambda a: torch.as_tensor(a, device=self.device)
        fb64 = mel_filterbank(cfg.sr, cfg.n_window, cfg.n_mels,
                              cfg.mel_f_min, cfg.mel_f_max, dtype=np.float64,
                              norm="slaney" if torchlibrosa else None)
        window = hann_window if torchlibrosa else hamming_window
        if algorithm == "block_kernel":
            from bsed_tpu_torch.ops.mel_kernel import build_mel_kernel_bases
            self.kernel_bases = build_mel_kernel_bases(
                cfg.n_window, cfg.hop_size, fb64, device=self.device,
                window=window(cfg.n_window), power_db=torchlibrosa)
            return
        self.window = dev(window(cfg.n_window))
        cos_b, sin_b = dft_basis(cfg.n_window)
        self.cos_basis, self.sin_basis = dev(cos_b), dev(sin_b)
        self.mel_fb = dev(fb64.astype(np.float32))

    def __call__(self, audio: torch.Tensor, log: bool = False) -> torch.Tensor:
        cfg = self.cfg
        if self.algorithm == "block_kernel":
            if self.torchlibrosa and not log:
                raise ValueError("K1's power-dB form gives the dB alone: "
                                 "call the front end with log=True")
            from bsed_tpu_torch.ops import mel_kernel
            mel = mel_kernel.fused_block_mel(audio, self.kernel_bases,
                                             cfg.n_window, cfg.hop_size,
                                             cfg.n_mels)
            if self.torchlibrosa:
                return mel                   # the kernel wrote the dB
        else:
            spec = (stft_power if self.torchlibrosa else stft_magnitude)(
                audio, self.window, self.cos_basis, self.sin_basis,
                cfg.n_window, cfg.hop_size)
            mel = spec @ self.mel_fb
        if log:
            mel = (power_to_db(mel, top_db=None) if self.torchlibrosa
                   else amplitude_to_db(mel))
        return mel


def mel_spectrogram(audio: torch.Tensor, window: torch.Tensor,
                    mel_fb: torch.Tensor, n_window: int = 2048,
                    hop_size: int = 255, log: bool = False) -> torch.Tensor:
    """FFT-based reference implementation (kept for cross-checking the DFT
    path in tests; prefer MelFrontEnd for production)."""
    frames = frame_signal(audio.float(), n_window, hop_size)
    mag = torch.fft.rfft(frames * window, dim=-1).abs().float()
    mel = mag @ mel_fb
    if log:
        mel = amplitude_to_db(mel)
    return mel
