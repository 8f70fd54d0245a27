"""Data augmentation of the train step, on the batch's device. Port of
``bsed_tpu/ops/augment.py``:

  * SNR-targeted Gaussian noise for the teacher input (reference
    Transforms.py:142-197): per-frequency-bin std over time,
    std_f = sqrt(mean_t(x² · 10^(−snr/10)));
  * ISP time/freq rolls (reference main_baseline.py:229-277): one
    per-sample circular shift of the whole batch, as a gather.

Draws come from the caller's ``torch.Generator``; ICT mixup is not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
        normal = torch.randn(features.shape, generator=gen,
                             device=features.device, dtype=features.dtype)
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
