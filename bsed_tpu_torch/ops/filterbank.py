"""Slaney-scale mel filterbank, computed on host in float64.

The port's own copy of ``bsed_tpu/ops/filterbank.py`` (numpy only).

Reproduces ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax, htk=False,
norm=None)`` as configured by the reference front end
(reference src/data/preprocess.py:30-38) without depending on librosa,
and with ``norm="slaney"`` librosa's default, each filter scaled to unit
area, 2 / (f[m + 2] − f[m]) (torchlibrosa's ``LogmelFilterBank``, HTS-AT's
front end).
The Slaney auditory-toolbox mel scale is linear below 1 kHz (step 200/3 Hz)
and logarithmic above (27 steps per ln(6.4)).
"""
from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-12) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freqs = mels * _F_SP
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """n_mels points equally spaced on the Slaney mel scale between fmin/fmax."""
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(
    sr: int = 32000,
    n_fft: int = 2048,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float = 16000.0,
    dtype=np.float32,
    norm=None,
) -> np.ndarray:
    """Triangular mel filterbank, shape (1 + n_fft//2, n_mels): norm None
    (peak 1) or "slaney" (unit area).

    Returned transposed relative to librosa (freq-major) so the on-device mel
    projection is a plain ``|stft| @ fb`` matmul that maps onto the MXU.
    """
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs, dtype=np.float64)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]          # (n_mels+2, n_freqs)

    lower = -ramps[:-2] / fdiff[:-1, None]              # rising edge
    upper = ramps[2:] / fdiff[1:, None]                 # falling edge
    weights = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_freqs)
    if norm == "slaney":
        weights *= (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    elif norm is not None:
        raise ValueError(f"unknown filterbank norm {norm!r}")

    return weights.T.astype(dtype)
