"""CNN backbone (NHWC), eval form. Port of ``bsed_tpu/models/cnn.py:CNN``
(reference CNN.py:33-84)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from bsed_tpu_torch.models.layers import ConvBlock


class CNN(nn.Module):
    """(B, T, F, C_in) → (B, T/4, 1, 128) float32 for the default config:
    filters (16,32,64,128,128,128,128), pooling (2,2),(2,2),(1,2)×5.
    ``start`` skips the leading blocks (the serving stem runs them)."""

    def __init__(self, nb_filters: Tuple[int, ...] = (16, 32, 64, 128, 128,
                                                      128, 128),
                 pooling: Tuple[Tuple[int, int], ...] = (
                     (2, 2), (2, 2), (1, 2), (1, 2), (1, 2), (1, 2), (1, 2)),
                 activation: str = "glu", kernel: int = 3,
                 dtype: Optional[torch.dtype] = None, n_in_channel: int = 1,
                 start: int = 0):
        super().__init__()
        self.start = start
        cins = (n_in_channel,) + tuple(nb_filters[:-1])
        self.blocks = nn.ModuleDict({
            f"block{i}": ConvBlock(cins[i], nb_filters[i], tuple(pooling[i]),
                                   activation, kernel, dtype=dtype)
            for i in range(start, len(nb_filters))})

    def forward(self, x):
        for blk in self.blocks.values():
            x = blk(x)
        return x.float()
