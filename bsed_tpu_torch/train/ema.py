"""Mean-teacher EMA. Port of ``bsed_tpu/train/ema.py`` (reference
main_baseline.py:91-105): ema ← α·ema + (1−α)·student with
α = min(1 − 1/(step+1), 0.999), applied in place to the teacher's
parameters and, for the state-dict EMA, to its BatchNorm running
statistics too."""
from __future__ import annotations

from typing import Iterable

import torch


def ema_alpha(step: int, alpha: float = 0.999) -> float:
    """The EMA weight at ``step`` (the true-average warm-up)."""
    return min(1.0 - 1.0 / (float(step) + 1.0), alpha)


@torch.no_grad()
def ema_update(ema: Iterable[torch.Tensor], student: Iterable[torch.Tensor],
               step: int, alpha: float = 0.999) -> None:
    """ema ← a·ema + (1−a)·student, tensor by tensor, in place."""
    a = ema_alpha(step, alpha)
    for e, s in zip(ema, student, strict=True):
        e.copy_(a * e + (1.0 - a) * s)
