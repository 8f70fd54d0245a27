"""STFT → mel → log-power front end in PyTorch.

Port of ``bsed_tpu/ops/mel.py`` (librosa semantics: symmetric Hamming
window, reflect pad of N/2, frame t starts at t·H, Slaney filterbank with
norm=None, ``amplitude_to_db`` with a per-clip top_db clamp). Three
algorithms compute the same linear mel:

  * ``dense``        — frames @ (cos, −sin) DFT bases, |·|, @ filterbank;
  * ``factored``     — the same DFT in two Cooley–Tukey stages
                       (``factored_dft_bases``: N = N1·N2, small matmuls
                       and a twiddle), kept as an exactness-tested
                       reference as in the JAX package;
  * ``block``        — the overlap-reusing block STFT (``block_dft_bases``):
                       each hop block is transformed once and an 8-tap
                       stencil recombines frames;
  * ``block_kernel`` — one hand-written CUDA kernel from audio to mel
                       (``ops/mel_kernel.fused_block_mel``: an FFT and a
                       banded mel on the H100), the counterpart of the JAX
                       package's ``block_pallas``.

Every path computes in float32; whether the card's matmuls round to TF32
is the caller's to set (``utils/device.float32_precision``, which the
CLI's ``predict``, ``preprocess`` and ``synthesize`` hold for the length
of their call). The JAX package's precision tiers ('highest', 'high',
'fast') set its MXU pass count; here they gate, in
``serve.make_fast_forward``, whether the kernel may run, and set TF32
through ``float32_precision``. ``mel_spectrogram`` is the FFT reference
(``torch.fft.rfft``) for cross-checking the DFT paths.
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
ALGORITHMS = ("dense", "factored", "block", "block_kernel")


def hamming_window(n: int, dtype=np.float32) -> np.ndarray:
    """Symmetric Hamming window == np.hamming(n) (librosa passes np.hamming)."""
    return np.hamming(n).astype(dtype)


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


def factored_dft_bases(n_window: int, n1: int, dtype=np.float32):
    """Two-stage Cooley–Tukey factorization of the length-N real DFT,
    N = N1·N2, as three small constant tensors (built in float64 on host):

      inner  W2[n2, k2] = exp(−2πi·n2·k2/N2)      — (N2, N2) complex
      twiddle T[k2, n1] = exp(−2πi·n1·k2/N)        — (N2, N1) complex
      outer  W1[n1, k1] = exp(−2πi·n1·k1/N1)       — (N1, N1) complex

    With frames reshaped (…, N2, N1) (row-major: element [n2, n1] =
    x[N1·n2 + n1]), X[N2·k1 + k2] = Σ_{n1} W1[n1,k1]·T[k2,n1]·
    Σ_{n2} x[N1·n2+n1]·W2[n2,k2]. MAC count per frame drops from the dense
    2·N·(N/2+1) to 2N(N2+2N1).

    Returns ((w2_re, w2_im), (t_re, t_im), (w1_re, w1_im)) as dtype arrays.
    """
    assert n_window % n1 == 0
    n2 = n_window // n1
    a2 = 2.0 * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2
    at = 2.0 * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n_window
    a1 = 2.0 * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1
    return ((np.cos(a2).astype(dtype), (-np.sin(a2)).astype(dtype)),
            (np.cos(at).astype(dtype), (-np.sin(at)).astype(dtype)),
            (np.cos(a1).astype(dtype), (-np.sin(a1)).astype(dtype)))


def factored_dft_magnitude(frames: torch.Tensor, bases, n1: int,
                           n_freqs: int) -> torch.Tensor:
    """|DFT| of windowed real frames (…, N) via the two-stage factorization
    (see factored_dft_bases), bases as tensors. Returns (…, n_freqs)."""
    (w2_re, w2_im), (t_re, t_im), (w1_re, w1_im) = bases
    n = frames.shape[-1]
    n2 = n // n1
    x = frames.reshape(frames.shape[:-1] + (n2, n1))     # [n2, n1]
    # stage 1: length-N2 DFT over the stride-N1 subsequences (real input)
    i_re = torch.einsum("...qp,qk->...kp", x, w2_re)
    i_im = torch.einsum("...qp,qk->...kp", x, w2_im)
    # stage 2: twiddle (elementwise complex over [k2, n1])
    y_re = i_re * t_re - i_im * t_im
    y_im = i_re * t_im + i_im * t_re
    # stage 3: length-N1 DFT over n1 (complex × complex)
    x_re = (torch.einsum("...kp,pl->...kl", y_re, w1_re)
            - torch.einsum("...kp,pl->...kl", y_im, w1_im))
    x_im = (torch.einsum("...kp,pl->...kl", y_re, w1_im)
            + torch.einsum("...kp,pl->...kl", y_im, w1_re))
    # bin index k = N2·k1 + k2 → order (k1, k2) row-major, keep rfft half
    x_re = x_re.transpose(-1, -2).reshape(frames.shape[:-1] + (n,))
    x_im = x_im.transpose(-1, -2).reshape(frames.shape[:-1] + (n,))
    x_re = x_re[..., :n_freqs]
    x_im = x_im[..., :n_freqs]
    return torch.sqrt(x_re * x_re + x_im * x_im)


def block_dft_bases(n_window: int, hop_size: int, dtype=np.float32,
                    n_bins: Optional[int] = None):
    """Bases for the overlap-reusing block STFT (Hamming window), built in
    float64 on the host.

    The window is rank-3 separable across the block split n = jH + r,
    w[jH+r] = Σ_{p<3} u_p[j]·v_p[r], and the DFT twiddle splits as
    e^{−2πik(jH+r)/N} = T_j[k]·e^{−2πikr/N}. So the STFT is three complex
    (H → bins) transforms of the non-overlapping hop blocks plus a k-dependent
    stencil over J = N//H taps, plus a small transform of the N − J·H tail
    samples.

    Returns (e_basis (H, 3, 2, F), d_re (J, 3, 2, F), d_im (J, 3, 2, F),
    e_tail (rem, 2, F) or None), c-axis order (re, im), with
    X_re[t] = Σ_j (Y[t+j]·d_re[j]).sum(p, c) and likewise X_im, where
    Y = blocks @ e_basis. ``n_bins`` (default 1 + N//2) limits the bins.
    """
    n_freqs = 1 + n_window // 2 if n_bins is None else n_bins
    j_full = n_window // hop_size
    rem = n_window - j_full * hop_size
    k = np.arange(n_freqs, dtype=np.float64)
    r = np.arange(hop_size, dtype=np.float64)
    j = np.arange(j_full, dtype=np.float64)

    v = np.stack([np.ones_like(r),
                  np.cos(2 * np.pi * r / (n_window - 1)),
                  np.sin(2 * np.pi * r / (n_window - 1))])        # (3, H)
    u = np.stack([np.full_like(j, 0.54),
                  -0.46 * np.cos(2 * np.pi * j * hop_size / (n_window - 1)),
                  0.46 * np.sin(2 * np.pi * j * hop_size / (n_window - 1))])

    ang_r = 2 * np.pi * np.outer(r, k) / n_window                 # (H, F)
    e_basis = np.stack(
        [np.stack([v[p][:, None] * np.cos(ang_r),
                   v[p][:, None] * -np.sin(ang_r)], axis=1)
         for p in range(3)], axis=1)                              # (H,3,2,F)

    ang_j = 2 * np.pi * np.outer(j * hop_size, k) / n_window      # (J, F)
    t_re, t_im = np.cos(ang_j), -np.sin(ang_j)
    # complex product d_pj·Y: re = dre·Yre − dim·Yim, im = dre·Yim + dim·Yre
    d_re = np.stack([np.stack([u[p][:, None] * t_re,
                               -u[p][:, None] * t_im], axis=1)
                     for p in range(3)], axis=1)                  # (J,3,2,F)
    d_im = np.stack([np.stack([u[p][:, None] * t_im,
                               u[p][:, None] * t_re], axis=1)
                     for p in range(3)], axis=1)

    e_tail = None
    if rem:
        w = np.hamming(n_window).astype(np.float64)
        n_tail = j_full * hop_size + np.arange(rem, dtype=np.float64)
        ang_t = 2 * np.pi * n_tail[:, None] * k[None, :] / n_window
        e_tail = np.stack([w[j_full * hop_size:][:, None] * np.cos(ang_t),
                           w[j_full * hop_size:][:, None] * -np.sin(ang_t)],
                          axis=1)                                 # (rem,2,F)
    cast = lambda a: None if a is None else a.astype(dtype)
    return cast(e_basis), cast(d_re), cast(d_im), cast(e_tail)


def _padded_signal(audio: torch.Tensor, n_window: int, hop_size: int):
    """Center reflect-pad by N/2, then right zero-pad to
    ``need = J·H + T·H`` so every frame and hop block exists.
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


def stft_magnitude(audio: torch.Tensor, window: torch.Tensor,
                   cos_basis: torch.Tensor, sin_basis: torch.Tensor,
                   n_window: int, hop_size: int) -> torch.Tensor:
    """(..., n_samples) → (..., T, n_freqs) |STFT| via DFT matmuls."""
    frames = frame_signal(audio.float(), n_window, hop_size) * window
    re = frames @ cos_basis
    im = frames @ sin_basis
    return torch.sqrt(re * re + im * im)


def block_stft_magnitude(audio: torch.Tensor, bases, n_window: int,
                         hop_size: int) -> torch.Tensor:
    """(..., n_samples) → (..., T, F) |STFT| via the block DFT
    (``block_dft_bases``; F is the bases' bin count). Rows of ``e_basis``
    past the hop size are ignored."""
    e_basis, d_re, d_im, e_tail = bases
    p, t, lead = _padded_signal(audio.float(), n_window, hop_size)
    b = p.shape[0]
    m = p.shape[1] // hop_size
    blocks = p.reshape(b, m, hop_size)
    j_full = n_window // hop_size

    # stage 1: transform every hop block once
    y = torch.einsum("bmh,hpcf->bmpcf", blocks, e_basis[:hop_size])

    # remainder samples: frame t's last N − J·H samples are the head of
    # block t+J
    n_bins = y.shape[-1]
    if e_tail is not None:
        rem = e_tail.shape[0]
        tail = blocks[:, j_full:j_full + t, :rem]
        x8 = torch.einsum("bth,hcf->btcf", tail, e_tail)
        x_re, x_im = x8[:, :, 0], x8[:, :, 1]
    else:
        x_re = blocks.new_zeros((b, t, n_bins))
        x_im = blocks.new_zeros((b, t, n_bins))

    # stage 2: J-tap k-dependent complex stencil over frames
    for jj in range(j_full):
        yj = y[:, jj:jj + t]                       # (B, T, 3, 2, F)
        x_re = x_re + (yj * d_re[jj]).sum(dim=(2, 3))
        x_im = x_im + (yj * d_im[jj]).sum(dim=(2, 3))
    mag = torch.sqrt(x_re * x_re + x_im * x_im)
    return mag.reshape(lead + (t, n_bins))


def amplitude_to_db(mel_amp: torch.Tensor, top_db: Optional[float] = _TOP_DB,
                    per_clip_axes=(-2, -1)) -> torch.Tensor:
    """librosa.amplitude_to_db with ref=1.0, amin=1e-5 (elementwise on
    amplitude), top_db clamp relative to each clip's maximum over
    ``per_clip_axes`` (T, mels)."""
    power = mel_amp * mel_amp
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=_AMIN_POWER))
    if top_db is not None:
        peak = torch.amax(log_spec, dim=per_clip_axes, keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


class MelFrontEnd:
    """Batched mel extractor: (B, n_samples) → (B, T, n_mels) linear mel,
    or dB with ``log=True``.

    ``use_kernel=False`` makes ``block_kernel`` run the kernel's plain
    PyTorch version even on the card (the path-equality check);
    ``factor_n1`` is the ``factored`` algorithm's N1."""

    def __init__(self, cfg: AudioConfig = AudioConfig(),
                 algorithm: str = "dense", device="cuda",
                 use_kernel: bool = True, factor_n1: int = 32):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown mel algorithm {algorithm}")
        self.cfg = cfg
        self.algorithm = algorithm
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self.factor_n1 = factor_n1
        dev = lambda a: torch.as_tensor(a, device=self.device)
        fb64 = mel_filterbank(cfg.sr, cfg.n_window, cfg.n_mels,
                              cfg.mel_f_min, cfg.mel_f_max, dtype=np.float64)
        if algorithm == "block_kernel":
            from bsed_tpu_torch.ops.mel_kernel import build_mel_kernel_bases
            self.kernel_bases = build_mel_kernel_bases(
                cfg.n_window, cfg.hop_size, fb64, device=self.device)
            return
        if algorithm == "block":
            self.block_bases = tuple(
                None if a is None else dev(a)
                for a in block_dft_bases(cfg.n_window, cfg.hop_size))
        elif algorithm == "factored":
            self.window = dev(hamming_window(cfg.n_window))
            self.factored_bases = tuple(
                (dev(re), dev(im)) for re, im in
                factored_dft_bases(cfg.n_window, factor_n1))
        else:
            self.window = dev(hamming_window(cfg.n_window))
            cos_b, sin_b = dft_basis(cfg.n_window)
            self.cos_basis, self.sin_basis = dev(cos_b), dev(sin_b)
        self.mel_fb = dev(fb64.astype(np.float32))

    def __call__(self, audio: torch.Tensor, log: bool = False) -> torch.Tensor:
        cfg = self.cfg
        if self.algorithm == "block_kernel":
            from bsed_tpu_torch.ops import mel_kernel
            fn = (mel_kernel.fused_block_mel if self.use_kernel
                  else mel_kernel.fused_block_mel_plain)
            mel = fn(audio, self.kernel_bases, cfg.n_window, cfg.hop_size,
                     cfg.n_mels)
        else:
            if self.algorithm == "block":
                mag = block_stft_magnitude(audio, self.block_bases,
                                           cfg.n_window, cfg.hop_size)
            elif self.algorithm == "factored":
                frames = frame_signal(audio.float(), cfg.n_window,
                                      cfg.hop_size)
                mag = factored_dft_magnitude(frames * self.window,
                                             self.factored_bases,
                                             self.factor_n1,
                                             1 + cfg.n_window // 2)
            else:
                mag = stft_magnitude(audio, self.window, self.cos_basis,
                                     self.sin_basis, cfg.n_window,
                                     cfg.hop_size)
            mel = mag @ self.mel_fb
        if log:
            mel = amplitude_to_db(mel)
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
