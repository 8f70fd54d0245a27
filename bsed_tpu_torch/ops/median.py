"""Binary median filtering for event decoding, on the posteriors' device.

Port of ``bsed_tpu/ops/median.py``. It replaces the reference's per-clip,
per-threshold host loop over ``scipy.ndimage.median_filter``
(reference src/evaluation_measures.py:188-201) with torch ops that run
batched for all clips / classes / thresholds at once, on whatever device
the posteriors are on (the card on the eval path). ``bsed_tpu`` runs this
as plain XLA, not as a Pallas kernel, so the port runs plain torch.

Key identity: the median of a 0/1 window of width w equals
``count_of_ones >= w - w//2`` (the sorted window's element at index w//2).
With scipy's default 'reflect' boundary (= np.pad 'symmetric') and window
span [i - w//2, i + (w-1-w//2)], a median filter over binary data is a
windowed moving count — one gather for the padding, one cumulative sum
and one subtraction instead of a rank filter.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _symmetric_index(n: int, left: int, right: int,
                     device) -> torch.Tensor:
    """Source index of each position of ``np.pad(x, (left, right),
    'symmetric')`` along an axis of length ``n``: the edge-repeating
    mirror is periodic with period 2n, so pads wider than n work too."""
    j = torch.arange(-left, n + right, device=device)
    k = torch.remainder(j, 2 * n)
    return torch.where(k >= n, 2 * n - 1 - k, k)


def _moving_count(x: torch.Tensor, window: int, axis: int) -> torch.Tensor:
    """Windowed sum with scipy-compatible symmetric padding along ``axis``."""
    left = window // 2
    right = window - 1 - left
    n = x.shape[axis]
    xp = x.index_select(axis, _symmetric_index(n, left, right, x.device))
    c = torch.cumsum(xp, dim=axis)
    shape = list(c.shape)
    shape[axis] = 1
    c = torch.cat([torch.zeros(shape, dtype=c.dtype, device=c.device), c],
                  dim=axis)
    return c.narrow(axis, window, n) - c.narrow(axis, 0, n)


def binary_median_filter(x: torch.Tensor, window: int,
                         axis: int = -2) -> torch.Tensor:
    """Median-filter binary data along ``axis`` (default: time axis of a
    (..., T, C) posterior). Returns the same dtype as the input."""
    if window <= 1:
        return x
    axis = axis % x.ndim
    count = _moving_count(x, window, axis)
    need = window - window // 2
    return (count >= need).to(x.dtype)


def classwise_median_filter(x: torch.Tensor, windows: Sequence[int],
                            time_axis: int = -2) -> torch.Tensor:
    """Per-class median windows (cfg.median_window, config.py:62-63): class c
    of the last axis is filtered with windows[c]. Distinct window sizes are
    each filtered once over the full tensor and blended with a class mask."""
    windows = tuple(int(w) for w in windows)
    assert x.shape[-1] == len(windows)
    out = x
    for w in sorted(set(windows)):
        if w <= 1:
            continue
        filtered = binary_median_filter(x, w, axis=time_axis)
        mask = torch.tensor([wi == w for wi in windows], dtype=torch.bool,
                            device=x.device)
        out = torch.where(mask, filtered, out)
    return out


def threshold_and_filter(probs: torch.Tensor, thresholds,
                         window: int = 1,
                         windows: Tuple[int, ...] = None) -> torch.Tensor:
    """(B, T, C) posteriors × (K,) thresholds → (K, B, T, C) float32 binary
    events, binarized (in float32, as ``bsed_tpu`` compares) then
    median-filtered on ``probs``' device.
    ``windows`` (per class) overrides the fixed ``window`` when given
    (learned_post mode, evaluation_measures.py:193-201)."""
    thr = torch.as_tensor(thresholds, dtype=torch.float32,
                          device=probs.device).reshape(-1)
    probs = probs.to(torch.float32)
    binary = (probs[None] > thr[:, None, None, None]).to(torch.float32)
    if windows is not None:
        return classwise_median_filter(binary, windows)
    return binary_median_filter(binary, window)
