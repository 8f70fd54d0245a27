"""Building-block layers for the CRNN family.

Port of ``bsed_tpu/models/layers.py``. ``TorchBatchNorm`` and ``ConvBlock``
follow the module's mode: ``.eval()`` uses the running statistics and no
dropout; training mode (``.train()``, PyTorch's default) normalises with
the batch statistics, updates the running ones in place, and drops out
with bits drawn from the generator passed to ``forward``. Public tensors keep the JAX layout,
NHWC (B, T, F, C). A conv runs on the NCHW view of that memory, which is
PyTorch's ``channels_last`` format, so no copy is made on either side.
Parameters are stored in PyTorch layout (conv OIHW, ``nn.Linear`` (out,
in)); ``utils/weights.py`` carries the JAX trees over.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bsed_tpu_torch.ops.dropout import FastDropout
from bsed_tpu_torch.ops.pooling import avg_pool

# running-stat momentum in the flax convention ra = m·ra + (1−m)·batch:
# 0.01 here is torch's BatchNorm2d momentum 0.99 of the reference
BN_MOMENTUM = 0.01


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                padding: int = 1, stride: int = 1) -> torch.Tensor:
    """Conv of an NHWC tensor with an OIHW weight (by default 3×3 'same');
    returns NHWC (contiguous when the backend keeps channels_last, as
    cuDNN does)."""
    xn = x.permute(0, 3, 1, 2)
    w = weight.contiguous(memory_format=torch.channels_last)
    return F.conv2d(xn, w, bias, stride=stride,
                    padding=padding).permute(0, 2, 3, 1)


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


class SmallChannelConv3x3(nn.Module):
    """3×3 'same' conv computed as 9 shifted channel matmuls instead of a
    convolution: the port of ``bsed_tpu``'s module of that name, which no
    preset's ``ConvBlock`` runs (its ``use_shift_conv`` is off). Its
    parameters are ``nn.Conv2d``'s, ``weight`` (out, in, 3, 3) and
    ``bias``, so checkpoints are interchangeable. NHWC in and out; the
    matmuls accumulate in float32."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self.padding = (1, 1)

    def forward(self, x):
        w = self.weight.float()
        xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
        h, wd = x.shape[1], x.shape[2]
        out = None
        for dt in range(3):
            for df in range(3):
                contrib = xp[:, dt:dt + h, df:df + wd] @ w[:, :, dt, df].T
                out = contrib if out is None else out + contrib
        return out + self.bias


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


def batch_stats(x: torch.Tensor, groups: int = 1, group=None):
    """(mean, biased var, n) per channel of the last axis in float32, over
    every other axis; ``groups`` > 1 folds the last axis as (groups, C) and
    reduces over the groups too (the folded stem's fold copies).

    ``group`` (a ``parallel.mesh.DataGroup``): ``x`` holds this rank's
    rows of a global batch, and the statistics are the global batch's:
    the sum, the sum of squares and the count are summed over the group
    with their gradient (the backward GSPMD takes through ``bsed_tpu``'s
    global mean), and ``n`` is the global count as a 0-d tensor."""
    x32 = x.float()
    if groups > 1:
        x32 = x32.reshape(*x.shape[:-1], groups, x.shape[-1] // groups)
    dims = tuple(range(x32.ndim - 1))
    if group is not None:
        from bsed_tpu_torch.parallel.mesh import group_sum
        c = x32.shape[-1]
        n_local = x32.new_full((1,), x32.numel() // c)
        tot = group_sum(torch.cat([x32.sum(dims), (x32 * x32).sum(dims),
                                   n_local]), group)
        n = tot[-1]
        mean = tot[:c] / n
        return mean, tot[c:2 * c] / n - mean * mean, n.detach()
    mean = x32.mean(dims)
    var = (x32 * x32).mean(dims) - mean * mean
    return mean, var, x32.numel() // x32.shape[-1]


@torch.no_grad()
def update_running(running_mean, running_var, mean, var, n,
                   momentum: float = BN_MOMENTUM) -> None:
    """ra = m·ra + (1−m)·batch in place with m = ``momentum`` (flax's
    convention), accumulating the UNBIASED variance (× n/(n−1)) as torch
    does while normalising with the biased one. ``n``: an int, or a 0-d
    tensor (a data group's global count)."""
    m = momentum
    if torch.is_tensor(n):
        corr = n / (n - 1).clamp(min=1)
    else:
        corr = n / (n - 1) if n > 1 else 1.0
    running_mean.copy_(m * running_mean + (1.0 - m) * mean)
    running_var.copy_(m * running_var + (1.0 - m) * (var * corr))


class TorchBatchNorm(nn.Module):
    """Batch norm over the last axis: ``(x − mean)·(scale·rsqrt(var + ε))
    + bias``, computed in the layer dtype (or x's) as ``bsed_tpu``'s
    TorchBatchNorm does (layers.py:95-147). Eval mode uses the running
    statistics; training mode the batch statistics, always in float32,
    and updates the running ones (``update_running``, with ``momentum``
    in flax's convention: the conv blocks' 0.01 is torch's 0.99, the
    discriminators' 0.9 torch's 0.1)."""

    def __init__(self, features: int, eps: float = 1e-3,
                 dtype: Optional[torch.dtype] = None,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.dtype = dtype
        self.momentum = momentum
        # a parallel.mesh.DataGroup: training statistics over its global
        # batch (set_batchnorm_group)
        self.group = None

    def forward(self, x):
        dt = self.dtype or x.dtype
        if self.training:
            mean, var, n = batch_stats(x, group=self.group)
            update_running(self.running_mean, self.running_var,
                           mean.detach(), var.detach(), n, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        inv = (torch.rsqrt(var + self.eps) * self.weight).to(dt)
        return (x.to(dt) - mean.to(dt)) * inv + self.bias.to(dt)


def set_batchnorm_group(module: nn.Module, group) -> nn.Module:
    """Make every ``TorchBatchNorm`` in ``module`` normalise by the
    statistics of ``group``'s global batch in training (None: its own
    rows); returns ``module``."""
    for m in module.modules():
        if isinstance(m, TorchBatchNorm):
            m.group = group
    return module


class ConvBlock(nn.Module):
    """conv3x3(s1, p1) → BatchNorm(ε 1e-3) → activation → dropout →
    avg-pool: one block of the 7-block stack (CNN.py:43-67)."""

    def __init__(self, in_channels: int, features: int,
                 pooling: Tuple[int, int], activation: str = "glu",
                 kernel: int = 3, dtype: Optional[torch.dtype] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel,
                              padding=kernel // 2)
        self.bn = TorchBatchNorm(features, eps=1e-3, dtype=dtype)
        self.act = activation_layer(activation, features, dtype)
        self.dropout = FastDropout(dropout)
        self.pooling = tuple(pooling)
        self.dtype = dtype

    def forward(self, x, gen: Optional[torch.Generator] = None):
        dt = _dt(self.dtype, x)
        x = conv2d_nhwc(x.to(dt), self.conv.weight.to(dt),
                        self.conv.bias.to(dt), padding=self.conv.padding[0])
        x = self.dropout(self.act(self.bn(x)), gen)
        if self.pooling != (1, 1):
            x = avg_pool(x, self.pooling)
        return x


def time_interp_matrix(in_len: int, out_len: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """(out_len, in_len) linear-interpolation matrix with
    align_corners=True, torch's ``nn.Upsample(mode='bilinear',
    align_corners=True)`` on a (T, 1) map (reference CRNN.py:280-281):
    upsampling becomes one matmul. Built in float64, then cast."""
    w = np.zeros((out_len, in_len), dtype=np.float64)
    if out_len == 1:
        w[0, 0] = 1.0
    else:
        scale = (in_len - 1) / (out_len - 1)
        for j in range(out_len):
            pos = j * scale
            i0 = int(np.floor(pos))
            i1 = min(i0 + 1, in_len - 1)
            frac = pos - i0
            w[j, i0] += 1.0 - frac
            w[j, i1] += frac
    return torch.as_tensor(w, dtype=dtype, device=device)
