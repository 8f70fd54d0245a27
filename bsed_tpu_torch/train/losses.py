"""Loss primitives with torch's numerics. Port of ``bsed_tpu/train/losses.py``:

  * ``bce``: nn.BCELoss on probabilities — mean of
    −[y·log p + (1−y)·log(1−p)] with each log term clamped at −100;
  * ``mse``: nn.MSELoss (mean);
  * ``entropy``: H(p) = −Σ_c p·log(p + 1e-5) (reference DA/entropy.py:8-30).

``total`` (``bce``, ``mse``): the inputs are this rank's part of a global
tensor of ``total`` elements (default: the inputs' own count), and the
result is this rank's share of the global mean: the sum of its elements,
accumulated in float32 at least, over ``total``, in the inputs' dtype (at
the default, ``mean()`` to the bit on the CPU). The shares of a data
group add up to the mean over the global tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

_LOG_CLAMP = -100.0


def bce(probs: torch.Tensor, targets: torch.Tensor,
        weight: Optional[torch.Tensor] = None,
        total: Optional[int] = None) -> torch.Tensor:
    log_p = torch.clamp(torch.log(torch.clamp(probs, min=0.0) + 1e-45),
                        min=_LOG_CLAMP)
    log_1p = torch.clamp(torch.log(torch.clamp(1.0 - probs, min=0.0)
                                   + 1e-45), min=_LOG_CLAMP)
    loss = -(targets * log_p + (1.0 - targets) * log_1p)
    if weight is not None:
        loss = loss * weight
    return _share(loss, total)


def mse(a: torch.Tensor, b: torch.Tensor,
        total: Optional[int] = None) -> torch.Tensor:
    return _share((a - b) * (a - b), total)


def _share(x: torch.Tensor, total: Optional[int]) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    total = x.numel() if total is None else total
    return (x.sum(dtype=acc) / total).to(x.dtype)


def entropy(p: torch.Tensor, reduction: str = "none") -> torch.Tensor:
    h = -torch.sum(p * torch.log(p + 1e-5), dim=-1)
    if reduction == "mean":
        return h.mean()
    return h
