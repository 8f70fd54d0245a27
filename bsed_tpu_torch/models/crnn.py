"""CRNN encoder, eval form. Port of ``bsed_tpu/models/crnn.py:CRNN``
(reference CRNN.py:178-240): CNN → squeeze freq → BiGRU → (eval) dropout;
takes NHWC (B, T, F, 1) and returns ``(encoded, d_input)``, both
(B, T/4, 2·n_rnn_cell)."""
from __future__ import annotations

import torch
import torch.nn as nn

from bsed_tpu_torch.config import ModelConfig
from bsed_tpu_torch.models.cnn import CNN
from bsed_tpu_torch.models.rnn import BidirectionalGRU


def compute_dtype(cfg: ModelConfig):
    """The conv/GRU compute dtype: bfloat16 or None (float32)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


class CRNN(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        if cfg.use_fpn:
            raise NotImplementedError("CRNNFPN is not ported yet")
        dtype = compute_dtype(cfg)
        self.cnn = CNN(tuple(cfg.nb_filters),
                       tuple(tuple(p) for p in cfg.pooling), cfg.activation,
                       cfg.kernel_size, dtype=dtype,
                       n_in_channel=cfg.n_in_channel)
        self.rnn = BidirectionalGRU(cfg.nb_filters[-1],
                                    cfg.n_rnn_cell, cfg.n_layers_rnn,
                                    cfg.dropout_recurrent, dtype=dtype)

    def forward(self, x):
        x = self.cnn(x).squeeze(2)     # (B, T', 1, C) → (B, T', C)
        x = self.rnn(x)
        return x, x
