"""CNN backbones (NHWC). Port of ``bsed_tpu/models/cnn.py``: ``CNN``, the
7-block stack (reference CNN.py:33-84), and ``CNNFPN``, the same stack
plus a weight-tied time-pooling block applied twice for a 3-level pyramid
(reference CNN_FPN.py:82-100). In training mode (PyTorch's default)
BatchNorm uses batch statistics and updates its running ones, and dropout
draws from the generator passed to ``forward``; ``.eval()`` runs the
serving form."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from bsed_tpu_torch.models.layers import ConvBlock

_FILTERS = (16, 32, 64, 128, 128, 128, 128)
_POOLING = ((2, 2), (2, 2), (1, 2), (1, 2), (1, 2), (1, 2), (1, 2))


class CNN(nn.Module):
    """(B, T, F, C_in) → (B, T/4, 1, 128) float32 for the default config:
    filters (16,32,64,128,128,128,128), pooling (2,2),(2,2),(1,2)×5.
    ``start`` skips the leading blocks (the serving stem runs them)."""

    def __init__(self, nb_filters: Tuple[int, ...] = _FILTERS,
                 pooling: Tuple[Tuple[int, int], ...] = _POOLING,
                 activation: str = "glu", kernel: int = 3,
                 dtype: Optional[torch.dtype] = None, n_in_channel: int = 1,
                 start: int = 0, dropout: float = 0.0):
        super().__init__()
        self.start = start
        cins = (n_in_channel,) + tuple(nb_filters[:-1])
        self.blocks = nn.ModuleDict({
            f"block{i}": ConvBlock(cins[i], nb_filters[i], tuple(pooling[i]),
                                   activation, kernel, dtype=dtype,
                                   dropout=dropout)
            for i in range(start, len(nb_filters))})

    def forward(self, x, gen: Optional[torch.Generator] = None):
        for blk in self.blocks.values():
            x = blk(x, gen)
        return x.float()


class CNNFPN(CNN):
    """``CNN`` plus ``block_down``, one conv → BN → act → dropout →
    pool(2, 1) block applied twice: returns the (full, /2, /4) time maps,
    float32. The reference reuses one conv/BN/GLU for both pyramid stages
    (CNN_FPN.py:87-97), so its BatchNorm running statistics advance twice
    per training forward, as in ``bsed_tpu``."""

    def __init__(self, nb_filters: Tuple[int, ...] = _FILTERS,
                 pooling: Tuple[Tuple[int, int], ...] = _POOLING,
                 activation: str = "glu", kernel: int = 3,
                 dtype: Optional[torch.dtype] = None, n_in_channel: int = 1,
                 dropout: float = 0.0):
        super().__init__(nb_filters, pooling, activation, kernel, dtype,
                         n_in_channel, dropout=dropout)
        self.block_down = ConvBlock(nb_filters[-1], nb_filters[-1], (2, 1),
                                    activation, kernel, dtype=dtype,
                                    dropout=dropout)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        for blk in self.blocks.values():
            x = blk(x, gen)
        x_2 = self.block_down(x, gen)
        x_4 = self.block_down(x_2, gen)
        return x.float(), x_2.float(), x_4.float()
