"""Plain front end: audio → log-mel, in float32 PyTorch and numpy.

librosa's semantics, as the reference recipe computes its features: a
symmetric Hamming window, reflect padding of N/2 at both ends, frame t
starting at t·H, |rfft|, a Slaney-scale triangular filterbank without
normalisation, and ``amplitude_to_db`` (ref 1, amin 1e-5 on amplitude,
top_db 80 below each clip's peak). Written from those definitions;
imports nothing of the program.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3.0)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filterbank(audio: Mapping) -> np.ndarray:
    """(1 + N/2, n_mels) float64 Slaney filterbank, norm=None."""
    n_fft, n_mels = audio["n_window"], audio["n_mels"]
    freqs = np.linspace(0.0, audio["sr"] / 2.0, 1 + n_fft // 2)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(audio["mel_f_min"]),
                                   _hz_to_mel(audio["mel_f_max"]),
                                   n_mels + 2))
    fb = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        lo, mid, hi = edges[i], edges[i + 1], edges[i + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        fb[i] = np.maximum(0.0, np.minimum(rise, fall))
    return fb.T


def linear_mel(audio: torch.Tensor, cfg: Mapping) -> torch.Tensor:
    """(B, samples) float32 → (B, frames, n_mels) linear mel, float32."""
    n, hop = cfg["n_window"], cfg["hop_size"]
    x = F.pad(audio.float()[:, None], (n // 2, n // 2), mode="reflect")[:, 0]
    frames = 1 + audio.shape[-1] // hop
    x = x.unfold(-1, n, hop)[:, :frames]
    window = torch.as_tensor(np.hamming(n), dtype=torch.float32,
                             device=audio.device)
    mag = torch.fft.rfft(x * window, dim=-1).abs()
    fb = torch.as_tensor(mel_filterbank(cfg), dtype=torch.float32,
                         device=audio.device)
    return mag @ fb


def to_db(mel: torch.Tensor) -> torch.Tensor:
    """``amplitude_to_db`` with top_db 80 below each clip's peak."""
    db = 10.0 * torch.log10(torch.clamp(mel * mel, min=1e-10))
    peak = db.amax(dim=(-2, -1), keepdim=True)
    return torch.maximum(db, peak - 80.0)


def log_mel(audio: torch.Tensor, cfg: Mapping) -> torch.Tensor:
    """(B, samples) float32 → (B, frames, n_mels) dB, float32."""
    return to_db(linear_mel(audio, cfg))
