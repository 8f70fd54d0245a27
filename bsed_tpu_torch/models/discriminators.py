"""Domain discriminators for adversarial adaptation. Port of
``bsed_tpu/models/discriminators.py``:

  * ``FrameDiscriminatorGRL``: in_dim → 1024 → 1024 → n_out, ReLU and
    dropout, sigmoid, optional gradient reversal at the input (reference
    CRNN.py:91-112);
  * ``FrameDiscriminator``: 256 → 128 → 32 → 1, LeakyReLU(0.2), sigmoid
    (CRNN_GRL.py:116-140);
  * ``ClipDiscriminatorSoftmax`` (2-way softmax, CRNN.py:16-51) and
    ``ClipDiscriminator`` (1-way sigmoid, CRNN_GRL.py:16-53) over
    ``_ClipConvStack``.

The clip discriminators read the (B, T, C) encoding as a 1-channel image
of C feature rows and T frame columns, (B, 1, C, T) in NCHW, through five
stride-2 VALID 3×3 convs, each followed by BatchNorm (ε 1e-5, momentum
0.9 in flax's convention, torch's 0.1) and LeakyReLU(0.2), then
``adaptive_avg_pool2d`` to (2, 1): torch's row segments
[⌊i·h/2⌋, ⌈(i+1)·h/2⌉) overlap when h is odd (h is 7 at full width). The
pooled (B, 8, 2) is flattened row-major over (row, channel), index
r·8 + c, the JAX module's order, so its dense kernel carries over as is
(``utils/torch_compat._clip_disc_dense_perm`` maps the reference's torch
order c·2 + r, a different one). The stack needs at least 63 feature rows
and 63 frames: below that the map is empty after the fifth conv (the JAX
module then returns nan; ``F.conv2d`` raises).

Parameters are float32; the layers compute in the promotion of their
input with float32, as flax's do, so a bfloat16 input computes in
float32. Module attribute names are the flax names (``dense_d_1``,
``convs.conv_1``, ``convs.bn_1``, ``dense_d``), which
``utils/weights.named_param_map`` turns into flax paths. Dropout draws
from the generator passed to ``forward``; training mode updates the
BatchNorm running statistics on every call, in call order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from bsed_tpu_torch.models.layers import TorchBatchNorm
from bsed_tpu_torch.ops.dropout import FastDropout
from bsed_tpu_torch.ops.grl import grad_reverse

DISC_BN_MOMENTUM = 0.9
CLIP_FEATURES = (128, 64, 32, 16, 8)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


class FrameDiscriminatorGRL(nn.Module):
    """``apply_grl=False`` where the surrounding loss reverses the
    gradient itself (DANN, CDAN) or the updates alternate (ADDA): two
    reversals would cancel."""

    def __init__(self, in_dim: int, dropout: float = 0.5, n_out: int = 2,
                 apply_grl: bool = True):
        super().__init__()
        self.apply_grl = apply_grl
        self.dense_d_1 = nn.Linear(in_dim, 1024)
        self.dense_d_2 = nn.Linear(1024, 1024)
        self.dense_d_3 = nn.Linear(1024, n_out)
        self.dropout = FastDropout(dropout)

    def forward(self, x, gen: Optional[torch.Generator] = None,
                grl_coeff=1.0):
        x = _f32(x)
        if self.apply_grl:
            x = grad_reverse(x, grl_coeff)
        x = self.dropout(F.relu(self.dense_d_1(x)), gen)
        x = self.dropout(F.relu(self.dense_d_2(x)), gen)
        return torch.sigmoid(self.dense_d_3(x))


class FrameDiscriminator(nn.Module):
    """No gradient reversal: used with a loss that reverses it."""

    def __init__(self, in_dim: int = 256, dropout: float = 0.5):
        super().__init__()
        self.dense_d_1 = nn.Linear(in_dim, 128)
        self.dense_d_2 = nn.Linear(128, 32)
        self.dense_d_3 = nn.Linear(32, 1)
        self.dropout = FastDropout(dropout)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x = _f32(x)
        x = self.dropout(F.leaky_relu(self.dense_d_1(x), 0.2), gen)
        x = self.dropout(F.leaky_relu(self.dense_d_2(x), 0.2), gen)
        return torch.sigmoid(self.dense_d_3(x))


class _ClipConvStack(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 1
        for i, feats in enumerate(CLIP_FEATURES, start=1):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, feats, 3, stride=2))
            self.add_module(f"bn_{i}", TorchBatchNorm(
                feats, eps=1e-5, momentum=DISC_BN_MOMENTUM))
            cin = feats

    def forward(self, x):
        """(B, T, C) → (B, 16)."""
        x = _f32(x).transpose(1, 2)[:, None]             # (B, 1, C, T)
        for i in range(1, len(CLIP_FEATURES) + 1):
            x = getattr(self, f"conv_{i}")(x)
            # BatchNorm over the channel axis, on the NHWC view
            x = getattr(self, f"bn_{i}")(x.permute(0, 2, 3, 1))
            x = F.leaky_relu(x, 0.2).permute(0, 3, 1, 2)
        x = F.adaptive_avg_pool2d(x, (2, 1))              # (B, 8, 2, 1)
        return x[..., 0].transpose(1, 2).reshape(x.shape[0], -1)


class ClipDiscriminatorSoftmax(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = _ClipConvStack()
        self.dense_d = nn.Linear(2 * CLIP_FEATURES[-1], 2)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        return torch.softmax(self.dense_d(self.convs(x)), dim=-1)


class ClipDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = _ClipConvStack()
        self.dense_d = nn.Linear(2 * CLIP_FEATURES[-1], 1)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        return torch.sigmoid(self.dense_d(self.convs(x)))
