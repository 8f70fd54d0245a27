"""Bidirectional multi-layer GRU, eval form. Port of
``bsed_tpu/models/rnn.py:BidirectionalGRU`` (reference RNN.py:7-16).

The JAX module's gate order (r, z, n) with the recurrent bias inside the
reset gate ("linear before reset") is exactly ``torch.nn.GRU``'s, and its
parameter names (``weight_ih_l0``, ``bias_hh_l1_reverse``, …) are
torch's, so the module is an ``nn.GRU``. The JAX package runs this
recurrence in XLA (``lax.scan``), not in a Pallas kernel, so cuDNN runs it
here. Dtype handling follows rnn.py:83-111: the input, the projection and
the carry are in the compute dtype; the output is cast to float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class BidirectionalGRU(nn.Module):
    """(B, T, n_in) → (B, T, 2·n_hidden) float32."""

    def __init__(self, n_in: int, n_hidden: int, num_layers: int = 2,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.gru = nn.GRU(n_in, n_hidden, num_layers=num_layers,
                          batch_first=True, bidirectional=True,
                          dropout=dropout if num_layers > 1 else 0.0)
        self.dtype = dtype or torch.float32
        if dtype is not None:
            self.gru.to(dtype)

    def forward(self, x):
        out, _ = self.gru(x.to(self.dtype))
        return out.float()
