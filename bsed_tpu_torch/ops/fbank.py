"""BEATs' front end on the device: the clip decimated 2:1, then Kaldi's
log-mel filterbank as BEATs computes it (``torchaudio.compliance.kaldi.
fbank`` at its defaults, 128 bins, 25 ms frames every 10 ms; written out,
since torchaudio is not a dependency), normalised by BEATs' dataset mean
and twice its standard deviation.

Per frame of ``frame_length`` samples every ``frame_shift`` (Kaldi's
``snip_edges``: only whole frames): the DC offset removed, pre-emphasis
with x[−1] = x[0], the Povey window (Hann^0.85), zero padding to the next
power of two and the power spectrum; triangular filters on Kaldi's mel
scale (1127·ln(1 + f/700)) from ``low_freq`` to the Nyquist rate over the
bins below Nyquist; log(max(·, float32 ε)). Float32 throughout.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bsed_tpu_torch.config import BeatsConfig

EPS = float(np.finfo(np.float32).eps)


def decimation_filter(taps: int, cutoff: float) -> np.ndarray:
    """The 2:1 decimator's low-pass: a ``taps``-tap Hann-windowed sinc
    with its cutoff at ``cutoff`` × the output's Nyquist rate (a quarter
    of the input rate), scaled to unit gain at DC; float64, symmetric."""
    n = np.arange(taps) - (taps - 1) / 2.0
    fc = cutoff / 4.0                               # cycles an input sample
    h = 2.0 * fc * np.sinc(2.0 * fc * n) * np.hanning(taps)
    return h / h.sum()


def kaldi_mel_banks(bc: BeatsConfig) -> np.ndarray:
    """(n_fft/2 + 1, num_mel_bins) float64: Kaldi's triangular mel
    filters over the power spectrum's bins, the Nyquist bin's row zero
    (``get_mel_banks`` without VTLN warping, padded as ``fbank`` pads
    it)."""
    n_fft = padded_length(bc.frame_length)
    mel = lambda f: 1127.0 * np.log1p(np.asarray(f) / 700.0)  # noqa: E731
    lo, hi = mel(bc.low_freq), mel(bc.sample_rate / 2.0)
    delta = (hi - lo) / (bc.num_mel_bins + 1)
    edges = lo + delta * np.arange(bc.num_mel_bins + 2)
    m = mel(np.arange(n_fft // 2) * bc.sample_rate / n_fft)[:, None]
    left, centre, right = edges[:-2], edges[1:-1], edges[2:]
    up = (m - left) / (centre - left)
    down = (right - m) / (right - centre)
    banks = np.maximum(0.0, np.minimum(up, down))
    return np.concatenate([banks, np.zeros((1, bc.num_mel_bins))])


def padded_length(n: int) -> int:
    """Kaldi's ``round_to_power_of_two``."""
    return 1 << (n - 1).bit_length()


def povey_window(n: int) -> np.ndarray:
    """Kaldi's Povey window: the symmetric Hann window to the power
    0.85."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))) ** 0.85


class BeatsFbank:
    """``fbank(audio (B, n) float32 at 2·sample_rate) -> (B, frames,
    num_mel_bins)`` float32, normalised, on ``device``."""

    def __init__(self, bc: BeatsConfig, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.bc = bc
        self.lowpass = torch.tensor(
            decimation_filter(bc.decimation_taps, bc.decimation_cutoff),
            **f32)[None, None]
        self.window = torch.tensor(povey_window(bc.frame_length), **f32)
        self.banks = torch.tensor(kaldi_mel_banks(bc), **f32)
        self.n_fft = padded_length(bc.frame_length)

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        bc = self.bc
        x = F.conv1d(audio.float()[:, None], self.lowpass, stride=2,
                     padding=bc.decimation_taps // 2)[:, 0]
        frames = (x * 32768.0).unfold(-1, bc.frame_length, bc.frame_shift)
        frames = frames - frames.mean(-1, keepdim=True)
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = (frames - bc.preemphasis * prev) * self.window
        spec = torch.fft.rfft(frames, n=self.n_fft).abs().square()
        mel = torch.log((spec @ self.banks).clamp_min(EPS))
        return (mel - bc.fbank_mean) / (2.0 * bc.fbank_std)
