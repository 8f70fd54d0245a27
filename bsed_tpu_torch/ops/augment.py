"""Data augmentation of the train step, on the batch's device. Port of
``bsed_tpu/ops/augment.py``:

  * SNR-targeted Gaussian noise for the teacher input (reference
    Transforms.py:142-197): per-frequency-bin std over time,
    std_f = sqrt(mean_t(x² · 10^(−snr/10)));
  * ISP time/freq rolls (reference main_baseline.py:229-277): one
    per-sample circular shift of the whole batch, as a gather;
  * ICT mixup (main_baseline.py:132-164): one λ ~ Beta(α, α) a batch and
    one shared permutation mixing the input and every target.

Draws come from the caller's ``torch.Generator``, on the batch's device;
mixup's λ comes from a numpy ``Generator`` (torch's Beta and gamma
samplers take no generator). Tests inject the draws of the JAX side.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bsed_tpu_torch.ops.dropout import draw


def gaussian_snr_noise(gen: Optional[torch.Generator],
                       features: torch.Tensor, snr: Optional[float],
                       normal: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """features: (..., T, F) linear mel; returns features + noise at the
    target SNR, the noise std computed per frequency bin over time.
    ``snr=None`` returns the features unchanged. ``normal`` replaces the
    standard-normal draw (tests feed the JAX draw through it)."""
    if snr is None:
        return features
    std = torch.sqrt(torch.mean(features * features * (10.0 ** (-snr / 10.0)),
                                dim=-2, keepdim=True))
    if normal is None:
        # a RowGenerator draws the global batch's noise (ops/dropout.py)
        normal = draw(gen, features.shape, lambda g, s: torch.randn(
            s, generator=g, device=features.device, dtype=features.dtype))
    return features + normal * std


def sample_isp_shifts(gen: torch.Generator, batch_size: int,
                      time_shift_max: int = 64, freq_shift_max: int = 4,
                      pooling_time_ratio: int = 4, device="cpu"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample shifts with random.randint semantics (inclusive): time
    ∈ [−max, max] pooled frames (× ptr input frames), freq ∈ [−4, 4].
    Returns (input-frame shift, pooled-frame shift, freq shift), int64."""
    pool_shift = torch.randint(-time_shift_max, time_shift_max + 1,
                               (batch_size,), generator=gen, device=device)
    freq_shift = torch.randint(-freq_shift_max, freq_shift_max + 1,
                               (batch_size,), generator=gen, device=device)
    return pool_shift * pooling_time_ratio, pool_shift, freq_shift


def roll_batch(x: torch.Tensor, shifts: torch.Tensor,
               axis: int) -> torch.Tensor:
    """Per-sample circular shift along ``axis`` (counted with the leading
    batch axis): out[b, …, i, …] = x[b, …, (i − shifts[b]) mod n, …], as
    ``jnp.roll`` per sample."""
    n = x.shape[axis]
    shifts = torch.as_tensor(shifts, device=x.device).long()
    src = torch.remainder(torch.arange(n, device=x.device)[None, :]
                          - shifts[:, None], n)               # (B, n)
    view = [x.shape[0]] + [1] * (x.ndim - 1)
    view[axis] = n
    return torch.gather(x, axis, src.reshape(view).expand(x.shape))


def mixup(gen: Optional[torch.Generator], x: torch.Tensor, *targets,
          alpha: float = 1.0, rng: Optional[np.random.Generator] = None,
          lam: Optional[float] = None,
          perm: Optional[torch.Tensor] = None):
    """ICT mixup: ``(mixed_x, *mixed_targets, lam)`` with
    mixed = λ·a + (1 − λ)·a[perm] for the input and every target.

    λ ~ Beta(α, α) from ``rng`` (1 when α ≤ 0), the permutation from
    ``gen`` on x's device; ``lam`` and ``perm`` replace the draws. λ is
    rounded to float32 and 1 − λ taken in float32, as the JAX function
    computes them."""
    if lam is None:
        lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    if perm is None:
        perm = torch.randperm(x.shape[0], generator=gen, device=x.device)
    perm = torch.as_tensor(perm, device=x.device).long()
    lam32 = np.float32(lam)
    a, b = float(lam32), float(np.float32(1.0) - lam32)
    mixed = tuple(a * t + b * t[perm] for t in (x,) + targets)
    return (*mixed, a)
