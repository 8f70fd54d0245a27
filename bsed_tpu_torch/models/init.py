"""Parameter initializers, the distributions of ``bsed_tpu/models/init.py``
(and so of the reference's ``weights_init``):

  * Conv2d:    Xavier-uniform with gain sqrt(2), bias 0
  * BatchNorm: scale ~ N(1, 0.02), bias 0
  * GRU:       orthogonal weight matrices; biases U(-1/sqrt(H), 1/sqrt(H))
  * Linear:    weight ~ N(0, 0.01), bias 0
  * the taggers' convs and dense layers: flax's default lecun-normal
    (``lecun_normal``), bias 0

Each draws from an explicit ``torch.Generator`` (CPU) and returns a float32
tensor in the JAX layout of the shape it is given (conv kernels HWIO,
dense kernels (in, out)). Same distributions as the JAX initializers, not
the same numbers.
"""
from __future__ import annotations

import math

import torch


def xavier_uniform_gain(gen: torch.Generator, shape,
                        gain: float = math.sqrt(2.0)):
    """Conv kernel (kh, kw, in, out) or dense (in, out)."""
    if len(shape) == 4:
        kh, kw, fan_in, fan_out = shape
        fan_in, fan_out = kh * kw * fan_in, kh * kw * fan_out
    else:
        fan_in, fan_out = shape[0], shape[-1]
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def normal_init(gen: torch.Generator, shape, stddev: float = 0.01,
                mean: float = 0.0):
    return mean + stddev * torch.randn(shape, generator=gen)


def bn_scale_init(gen: torch.Generator, shape):
    return 1.0 + 0.02 * torch.randn(shape, generator=gen)


def orthogonal(gen: torch.Generator, shape):
    """Orthogonal (rows, cols) matrix: QR of a Gaussian, signs fixed by
    R's diagonal (the construction of ``jax.nn.initializers.orthogonal``)."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q[:rows, :cols].float()


def uniform_sqrt_h(gen: torch.Generator, shape, hidden: int):
    """torch RNN default: U(-1/sqrt(H), 1/sqrt(H))."""
    bound = 1.0 / math.sqrt(hidden)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def lecun_normal(gen: torch.Generator, shape):
    """flax's default kernel init, ``variance_scaling(1, 'fan_in',
    'truncated_normal')``: N(0, 1) truncated to [−2, 2] (drawn by the
    inverse CDF), scaled to std sqrt(1 / fan_in) over the truncation's
    std 0.8796; fan_in is every axis but the last (HWIO: kh·kw·in,
    dense: in)."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = lo + (hi - lo) * torch.rand(shape, generator=gen,
                                    dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (z.clamp(-2.0, 2.0) * std).float()
