"""Building-block layers for the CRNN family, eval form.

Port of ``bsed_tpu/models/layers.py``. Public tensors keep the JAX layout,
NHWC (B, T, F, C). A conv runs on the NCHW view of that memory, which is
PyTorch's ``channels_last`` format, so no copy is made on either side.
Parameters are stored in PyTorch layout (conv OIHW, ``nn.Linear`` (out,
in)); ``utils/weights.py`` carries the JAX trees over.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bsed_tpu_torch.ops.pooling import avg_pool


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                padding: int = 1) -> torch.Tensor:
    """3×3 'same' conv of an NHWC tensor with an OIHW weight; returns NHWC
    (contiguous when the backend keeps channels_last, as cuDNN does)."""
    xn = x.permute(0, 3, 1, 2)
    w = weight.contiguous(memory_format=torch.channels_last)
    return F.conv2d(xn, w, bias, padding=padding).permute(0, 2, 3, 1)


def _dt(dtype, x: torch.Tensor) -> torch.dtype:
    """flax's dtype rule for layers with float32 params: the layer dtype if
    set, else float32 (the promotion of the input with the params)."""
    return dtype if dtype is not None else torch.promote_types(
        x.dtype, torch.float32)


class GLU(nn.Module):
    """``Linear(x) * sigmoid(x)`` over the channel axis (CNN.py:5-16)."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear = nn.Linear(features, features)
        self.dtype = dtype

    def forward(self, x):
        dt = _dt(self.dtype, x)
        lin = F.linear(x.to(dt), self.linear.weight.to(dt),
                       self.linear.bias.to(dt))
        return lin * torch.sigmoid(x)


class ContextGating(nn.Module):
    """``x * sigmoid(Linear(x))`` (CNN.py:19-30)."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear = nn.Linear(features, features)
        self.dtype = dtype

    def forward(self, x):
        dt = _dt(self.dtype, x)
        lin = F.linear(x.to(dt), self.linear.weight.to(dt),
                       self.linear.bias.to(dt))
        return x * torch.sigmoid(lin)


class _Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def activation_layer(name: str, features: int, dtype=None) -> nn.Module:
    name = name.lower()
    if name == "glu":
        return GLU(features, dtype=dtype)
    if name == "cg":
        return ContextGating(features, dtype=dtype)
    if name == "relu":
        return _Fn(F.relu)
    if name == "leakyrelu":
        return _Fn(lambda x: F.leaky_relu(x, negative_slope=0.2))
    raise ValueError(f"unknown activation {name}")


class TorchBatchNorm(nn.Module):
    """Eval-mode batch norm over the last axis with running statistics:
    ``(x − mean)·(scale·rsqrt(var + ε)) + bias``, computed in the layer
    dtype (or x's) as ``bsed_tpu``'s TorchBatchNorm does
    (layers.py:145-147)."""

    def __init__(self, features: int, eps: float = 1e-3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or x.dtype
        inv = (torch.rsqrt(self.running_var + self.eps) * self.weight).to(dt)
        return ((x.to(dt) - self.running_mean.to(dt)) * inv
                + self.bias.to(dt))


class ConvBlock(nn.Module):
    """conv3x3(s1, p1) → BatchNorm(ε 1e-3) → activation → (eval dropout) →
    avg-pool: one block of the 7-block stack (CNN.py:43-67), eval form."""

    def __init__(self, in_channels: int, features: int,
                 pooling: Tuple[int, int], activation: str = "glu",
                 kernel: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel,
                              padding=kernel // 2)
        self.bn = TorchBatchNorm(features, eps=1e-3, dtype=dtype)
        self.act = activation_layer(activation, features, dtype)
        self.pooling = tuple(pooling)
        self.dtype = dtype

    def forward(self, x):
        dt = _dt(self.dtype, x)
        x = conv2d_nhwc(x.to(dt), self.conv.weight.to(dt),
                        self.conv.bias.to(dt), padding=self.conv.padding[0])
        x = self.act(self.bn(x))
        if self.pooling != (1, 1):
            x = avg_pool(x, self.pooling)
        return x
