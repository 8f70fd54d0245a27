"""Weak audio-tagging CNNs: the ResNet-18 and VGG taggers. Port of
``bsed_tpu/models/resnet.py`` (the reference's ``Net_resnet`` and
``Net_vgg``, audio_tagging_system_cnn.py:50-79).

Both take a (B, T, F) dB mel, which ``bsed_tpu`` feeds as (B, T, F, 1),
and return (B, nclass) sigmoid weak posteriors. Tensors between layers
are NHWC, as in ``models/layers.py``: the convs run on the NCHW view of
that memory (``conv2d_nhwc``) and ``TorchBatchNorm`` normalises the last
axis, with ε 1e-5 and momentum 0.9 in flax's convention (torch's 0.1).
Module names are the flax names (``stem_conv``, ``layer3_block0.conv1``,
``downsample_bn``, ``conv{i}`` / ``bn{i}`` at the plan's index, ``fc``,
``fc1``, ``fc2``), which ``utils/weights.named_param_map`` turns into
flax paths; parameters are stored in torch's layout (OIHW, (out, in)).

Training mode normalises with the batch statistics and updates the running
ones in place on every call. VGG's dropout draws its keep mask from the
generator passed to ``forward``, or takes it as ``keep`` (tests feed the
JAX mask through it).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from bsed_tpu_torch.models.layers import TorchBatchNorm, conv2d_nhwc
from bsed_tpu_torch.ops.dropout import FastDropout

BN_MOMENTUM = 0.9                 # flax's convention: torch's 0.1
BN_EPS = 1e-5
VGG11_PLAN = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
              "M")


def _bn(features: int) -> TorchBatchNorm:
    return TorchBatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return conv2d_nhwc(x, conv.weight, conv.bias, padding=conv.padding[0],
                       stride=conv.stride[0])


def _max_pool(x: torch.Tensor, kernel: int, stride: int,
              padding: int = 0) -> torch.Tensor:
    """NHWC max pool; the padding counts as −inf, as flax's does."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride,
                        padding).permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    """Two bias-free 3×3 convs with BatchNorm, and a 1×1 conv + BatchNorm
    downsample of the input where the shapes differ."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, 1,
                               bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = _bn(features)
        # bsed_tpu compares the shapes; with padding 1 they differ exactly
        # when the block strides or changes the width
        self.has_downsample = stride != 1 or in_features != features
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_features, features, 1,
                                             stride, bias=False)
            self.downsample_bn = _bn(features)

    def forward(self, x):
        y = F.relu(self.bn1(_conv(x, self.conv1)))
        y = self.bn2(_conv(y, self.conv2))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(_conv(x, self.downsample_conv))
        return F.relu(y + residual)


class ResNet18Tagger(nn.Module):
    """7×7 stride-2 stem, 3×3 stride-2 max pool, stages (2, 2, 2, 2) ×
    (64, 128, 256, 512) with stride 2 on the first block of stages 2-4,
    global mean over time and frequency, ``fc``, sigmoid."""

    def __init__(self, nclass: int = 20,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_features: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.stem_conv = nn.Conv2d(1, 64, 7, 2, 3, bias=False)
        self.stem_bn = _bn(64)
        self.blocks = []
        cin = 64
        for s, (n_blocks, feats) in enumerate(zip(stage_sizes,
                                                  stage_features)):
            for b in range(n_blocks):
                stride = 2 if (b == 0 and s > 0) else 1
                name = f"layer{s + 1}_block{b}"
                self.add_module(name, BasicBlock(cin, feats, stride))
                self.blocks.append(name)
                cin = feats
        self.fc = nn.Linear(cin, nclass)

    def forward(self, x, gen: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None):
        """x: (B, T, F) dB mel. ``gen`` and ``keep`` are VGG's (this
        tagger has no dropout); they are accepted so both taggers take
        the same call."""
        x = F.relu(self.stem_bn(_conv(x[..., None], self.stem_conv)))
        x = _max_pool(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return torch.sigmoid(self.fc(x.mean(dim=(1, 2))))


class VGGTagger(nn.Module):
    """vgg11-bn plan with a 1-channel stem: 3×3 convs with bias, each
    with BatchNorm and ReLU, 2×2 VALID max pools that floor; global mean,
    ``fc1`` (4096) with ReLU, dropout 0.5, ``fc2``, sigmoid."""

    def __init__(self, nclass: int = 20, plan: Sequence = VGG11_PLAN):
        super().__init__()
        self.plan = tuple(plan)
        cin = 1
        for i, spec in enumerate(self.plan):
            if spec != "M":
                self.add_module(f"conv{i}", nn.Conv2d(cin, spec, 3,
                                                      padding=1))
                self.add_module(f"bn{i}", _bn(spec))
                cin = spec
        self.fc1 = nn.Linear(cin, 4096)
        self.dropout = FastDropout(0.5)
        self.fc2 = nn.Linear(4096, nclass)

    def forward(self, x, gen: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None):
        """x: (B, T, F) dB mel; in training mode the dropout's keep mask
        is ``keep`` when given, else drawn from ``gen``."""
        x = x[..., None]
        for i, spec in enumerate(self.plan):
            if spec == "M":
                x = _max_pool(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"bn{i}")(
                    _conv(x, getattr(self, f"conv{i}"))))
        x = F.relu(self.fc1(x.mean(dim=(1, 2))))
        x = self.dropout(x, gen, keep)
        return torch.sigmoid(self.fc2(x))


def build_tagger(cfg, arch: str = "resnet") -> nn.Module:
    if arch == "resnet":
        return ResNet18Tagger(nclass=cfg.nclass)
    if arch == "vgg":
        return VGGTagger(nclass=cfg.nclass)
    raise ValueError(arch)
