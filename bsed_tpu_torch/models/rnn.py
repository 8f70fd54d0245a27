"""Bidirectional multi-layer GRU. Port of
``bsed_tpu/models/rnn.py:BidirectionalGRU`` (reference RNN.py:7-16).

The JAX module's gate order (r, z, n) with the recurrent bias inside the
reset gate ("linear before reset") is exactly ``torch.nn.GRU``'s, and its
parameter names (``weight_ih_l0``, ``bias_hh_l1_reverse``, …) are
torch's, so the module is an ``nn.GRU``. The JAX package runs this
recurrence in XLA (``lax.scan``), not in a Pallas kernel, so cuDNN runs it
here. Dtype handling follows rnn.py:83-111: the input, the projection and
the carry are in the compute dtype; the output is cast to float32.

Weights: serving casts them to the compute dtype once, at build time
(``cast_weights=True``). Training keeps float32 master weights, as the JAX
train state does, and casts them per call through
``torch.func.functional_call``, so the optimizer updates float32 values and
the gradients flow back through the casts.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn as nn


class BidirectionalGRU(nn.Module):
    """(B, T, n_in) → (B, T, 2·n_hidden) float32."""

    def __init__(self, n_in: int, n_hidden: int, num_layers: int = 2,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 cast_weights: bool = True):
        super().__init__()
        self.gru = nn.GRU(n_in, n_hidden, num_layers=num_layers,
                          batch_first=True, bidirectional=True,
                          dropout=dropout if num_layers > 1 else 0.0)
        self.dtype = dtype or torch.float32
        if dtype is not None and cast_weights:
            self.gru.to(dtype)

    def forward(self, x):
        if self.training and self.gru.dropout > 0:
            raise NotImplementedError(
                "inter-layer GRU dropout in training draws from torch's "
                "global generator; the port's train step does not take it "
                "(model.dropout_recurrent must be 0)")
        x = x.to(self.dtype)
        params = dict(self.gru.named_parameters())
        if all(p.dtype == self.dtype for p in params.values()):
            out, _ = self.gru(x)
        else:
            cast = {n: p.to(self.dtype) for n, p in params.items()}
            with warnings.catch_warnings():
                # the cast weights are separate tensors, so cuDNN compacts
                # them into one buffer per call and says so every time
                warnings.filterwarnings("ignore", message=".*contiguous "
                                        "chunk of memory.*")
                out, _ = torch.func.functional_call(self.gru, cast, (x,))
        return out.float()
