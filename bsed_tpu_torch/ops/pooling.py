"""Average pooling over (time, freq) of NHWC tensors.

Port of ``bsed_tpu/ops/pooling.py``: VALID padding, stride equal to the
window, floor semantics (1255 → 627 → 313 on the time axis). Power-of-two
windows are summed as strided slices in the same pairwise order as the JAX
version (time pairs first, then frequency pairs, then one division in the
tensor's dtype), so single-axis window-2 pools agree bit for bit.

Autograd differentiates the strided slices into the cotangent the JAX
package writes as its ``custom_vjp``: every input of a window receives
g/(kt·kf), and the VALID-dropped remainder rows receive 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pool_axis(x: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """Non-overlapping k-window SUM along ``axis`` (trailing remainder
    dropped), as k strided slices added pairwise."""
    n = x.shape[axis]
    n2 = n - (n % k)
    parts = [x.narrow(axis, 0, n2)[(slice(None),) * axis
                                   + (slice(r, None, k),)]
             for r in range(k)]
    while len(parts) > 1:
        nxt = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def fast_avg_pool(x: torch.Tensor, window) -> torch.Tensor:
    """Mean pool over axes (1, 2) of an NHWC tensor, stride == window."""
    kt, kf = int(window[0]), int(window[1])
    if kt <= 1 and kf <= 1:
        return x
    y = x
    if kt > 1:
        y = _pool_axis(y, 1, kt)
    if kf > 1:
        y = _pool_axis(y, 2, kf)
    return y / (kt * kf)


def avg_pool(x: torch.Tensor, window) -> torch.Tensor:
    """fast_avg_pool when every extent is a power of two, else
    ``F.avg_pool2d`` on the NCHW view (VALID, floor)."""
    if all(k >= 1 and (k & (k - 1)) == 0 for k in window):
        return fast_avg_pool(x, window)
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), tuple(window), tuple(window))
    return y.permute(0, 2, 3, 1)
