"""Prediction heads over the (B, 313, 256) encoder output. Port of
``bsed_tpu/models/predictor.py`` (reference CRNN_GRL.py:391-460).

``strong`` is a sigmoid frame posterior (B, T, nclass); ``weak`` is the
attention-pooled clip posterior: softmax over the CLASS axis of a second
dense head, clipped to [1e-7, 1], then sum(strong·sof)/sum(sof) over time.
With ``inference=True`` the strong posterior is gated by (weak > 0.5).
The 'crnn' conv head is ``models/crnn.EncodedCRNNPred``. Every head's
``forward(x, gen, inference)`` takes the step's generator; only the conv
head draws from it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn


def _attention_pool(strong, sof_logits):
    sof = torch.softmax(sof_logits, dim=-1)
    sof = torch.clamp(sof, 1e-7, 1.0)
    return (strong * sof).sum(dim=1) / sof.sum(dim=1)


def _inference_gate(strong, weak):
    return strong * (weak > 0.5).to(strong.dtype)[:, None, :]


class Predictor(nn.Module):
    def __init__(self, n_in: int = 256, nclass: int = 20,
                 attention: bool = True):
        super().__init__()
        self.dense = nn.Linear(n_in, nclass)
        self.dense_softmax = nn.Linear(n_in, nclass) if attention else None

    def forward(self, x, gen=None, inference: bool = False):
        strong = torch.sigmoid(self.dense(x))
        if self.dense_softmax is not None:
            weak = _attention_pool(strong, self.dense_softmax(x))
        else:
            weak = strong.mean(dim=1)
        if inference:
            strong = _inference_gate(strong, weak)
        return strong, weak


class Predictor2(nn.Module):
    """4-layer MLP head; dense1..dense4 are chained linearly, as in the
    reference."""

    def __init__(self, n_in: int = 256, nclass: int = 20,
                 attention: bool = True):
        super().__init__()
        self.dense1 = nn.Linear(n_in, 64)
        self.dense2 = nn.Linear(64, 128)
        self.dense3 = nn.Linear(128, 64)
        self.dense4 = nn.Linear(64, nclass)
        self.dense_softmax = nn.Linear(n_in, nclass) if attention else None

    def forward(self, x, gen=None, inference: bool = False):
        h = self.dense3(self.dense2(self.dense1(x)))
        strong = torch.sigmoid(self.dense4(h))
        if self.dense_softmax is not None:
            weak = _attention_pool(strong, self.dense_softmax(x))
        else:
            weak = strong.mean(dim=1)
        if inference:
            strong = _inference_gate(strong, weak)
        return strong, weak


def make_predictor_head(cfg) -> nn.Module:
    """The head for ``cfg.model.predictor_head``: 'mlp' (Predictor2);
    'crnn', the conv head (``models/crnn.EncodedCRNNPred``) with
    ``bsed_tpu``'s settings
    (train/steps.py:151-156): filters (16, 32, 64, 32, nclass), frequency
    pools 4, 4, 4, 2, 2 and no time pool, with the model's activation,
    dropout, kernel and compute dtype; else 'linear' (Predictor), as
    ``bsed_tpu`` falls through to it."""
    m = cfg.model
    n_in = 2 * m.n_rnn_cell
    if m.predictor_head == "mlp":
        return Predictor2(n_in, cfg.nclass, m.attention)
    if m.predictor_head == "crnn":
        from bsed_tpu_torch.models.crnn import EncodedCRNNPred
        head_cfg = dataclasses.replace(
            m, nb_filters=(16, 32, 64, 32, cfg.nclass),
            pooling=((1, 4), (1, 4), (1, 4), (1, 2), (1, 2)),
            predictor_head="linear")
        return EncodedCRNNPred(head_cfg, n_in)
    return Predictor(n_in, cfg.nclass, m.attention)
