"""Loss primitives with torch's numerics. Port of ``bsed_tpu/train/losses.py``:

  * ``bce``: nn.BCELoss on probabilities — mean of
    −[y·log p + (1−y)·log(1−p)] with each log term clamped at −100;
  * ``mse``: nn.MSELoss (mean);
  * ``entropy``: H(p) = −Σ_c p·log(p + 1e-5) (reference DA/entropy.py:8-30).
"""
from __future__ import annotations

from typing import Optional

import torch

_LOG_CLAMP = -100.0


def bce(probs: torch.Tensor, targets: torch.Tensor,
        weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    log_p = torch.clamp(torch.log(torch.clamp(probs, min=0.0) + 1e-45),
                        min=_LOG_CLAMP)
    log_1p = torch.clamp(torch.log(torch.clamp(1.0 - probs, min=0.0)
                                   + 1e-45), min=_LOG_CLAMP)
    loss = -(targets * log_p + (1.0 - targets) * log_1p)
    if weight is not None:
        loss = loss * weight
    return loss.mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) * (a - b))


def entropy(p: torch.Tensor, reduction: str = "none") -> torch.Tensor:
    h = -torch.sum(p * torch.log(p + 1e-5), dim=-1)
    if reduction == "mean":
        return h.mean()
    return h
