"""Gradient reversal and its warm-start coefficient. Port of
``bsed_tpu/ops/grl.py`` (reference src/DA/grl.py):

  * ``grad_reverse(x, coeff)``: identity forward, −coeff·g backward, no
    gradient for the coefficient (GradientReverseFunction, grl.py:12-22),
    as a ``torch.autograd.Function``;
  * ``warm_start_lambda(step, …)``: the coefficient schedule of
    WarmStartGradientReverseLayer (grl.py:33-74),
        λ(i) = 2(hi−lo) / (1 + e^(−α·i/N)) − (hi−lo) + lo,
    in float32 as the JAX package computes it; the step count lives in
    the train state.
"""
from __future__ import annotations

import numpy as np
import torch


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coeff):
        ctx.coeff = coeff
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.coeff * g, None


def grad_reverse(x: torch.Tensor, coeff=1.0) -> torch.Tensor:
    return _GradReverse.apply(x, coeff)


def warm_start_lambda(step, alpha: float = 1.0, lo: float = 0.0,
                      hi: float = 1.0, max_iters: int = 1000) -> float:
    """λ at ``step`` (grl.py:58-63), a float32 value as a Python float."""
    step = np.float32(step)
    return float(np.float32(2.0 * (hi - lo))
                 / (np.float32(1.0) + np.exp(np.float32(-alpha) * step
                                             / np.float32(max_iters)))
                 - np.float32(hi - lo) + np.float32(lo))
