"""CRNN encoders. Port of ``bsed_tpu/models/crnn.py``: ``CRNN`` (reference
CRNN.py:178-240), CNN → squeeze freq → BiGRU → dropout, and ``CRNNFPN``
(CRNN.py:243-337), three BiGRUs over the (313, 156, 78)-frame pyramid of
``CNNFPN`` with the coarse paths upsampled (align_corners=True, as
``time_interp_matrix`` matmuls) and fused by dense layers. Both take NHWC
(B, T, F, 1) and return ``(encoded, d_input)``, both (B, T/4, 2·n_rnn_cell)
float32. ``CRNNPred`` and ``EncodedCRNNPred`` (CRNN_GRL.py:206-290) are
the conv prediction head over that encoding (``predictor_head='crnn'``).

In training mode (PyTorch's default) BatchNorm runs on batch statistics
and dropout draws from the generator passed to ``forward``; ``.eval()`` is
the serving form. ``cast_weights=False`` keeps the GRUs' weights in
float32 and casts them per call (the train form, whose optimizer updates
float32 master weights); serving casts them once (``models/rnn.py``)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch
import torch.nn as nn

from bsed_tpu_torch.config import ModelConfig
from bsed_tpu_torch.models.cnn import CNN, CNNFPN
from bsed_tpu_torch.models.discriminators import FrameDiscriminatorGRL
from bsed_tpu_torch.models.layers import time_interp_matrix
from bsed_tpu_torch.models.predictor import _attention_pool, _inference_gate
from bsed_tpu_torch.models.rnn import BidirectionalGRU
from bsed_tpu_torch.ops.dropout import FastDropout


def compute_dtype(cfg: ModelConfig):
    """The conv/GRU compute dtype: bfloat16 or None (float32)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def _cnn_kwargs(cfg: ModelConfig) -> dict:
    return dict(nb_filters=tuple(cfg.nb_filters),
                pooling=tuple(tuple(p) for p in cfg.pooling),
                activation=cfg.activation, kernel=cfg.kernel_size,
                dtype=compute_dtype(cfg), n_in_channel=cfg.n_in_channel,
                dropout=cfg.dropout)


def _bigru(cfg: ModelConfig, cast_weights: bool) -> BidirectionalGRU:
    return BidirectionalGRU(cfg.nb_filters[-1], cfg.n_rnn_cell,
                            cfg.n_layers_rnn, cfg.dropout_recurrent,
                            dtype=compute_dtype(cfg),
                            cast_weights=cast_weights)


class CRNN(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 cast_weights: bool = True):
        super().__init__()
        if cfg.use_fpn:
            raise ValueError("use_fpn=True: the encoder is CRNNFPN "
                             "(make_encoder)")
        self.cnn = CNN(**_cnn_kwargs(cfg))
        self.rnn = _bigru(cfg, cast_weights)
        self.dropout = FastDropout(cfg.dropout)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x = self.cnn(x, gen).squeeze(2)     # (B, T', 1, C) → (B, T', C)
        x = self.dropout(self.rnn(x, gen), gen)
        return x, x


class CRNNFPN(nn.Module):
    """The feature-pyramid CRNN. ``forward(x, gen, bigrus)``: ``bigrus``
    maps "rnn", "rnn_2" and "rnn_4" to callables that replace those
    modules' forwards (serving runs each hoisted, on kernel K4)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 cast_weights: bool = True):
        super().__init__()
        self.cnn = CNNFPN(**_cnn_kwargs(cfg))
        self.rnn = _bigru(cfg, cast_weights)
        self.rnn_2 = _bigru(cfg, cast_weights)
        self.rnn_4 = _bigru(cfg, cast_weights)
        self.dropout = FastDropout(cfg.dropout)
        d = 2 * cfg.n_rnn_cell
        self.fuse_2 = nn.Linear(2 * d, d)
        self.fuse_4 = nn.Linear(2 * d, d)
        self._interp = {}

    def _up(self, t_in: int, t_out: int, device) -> torch.Tensor:
        key = (t_in, t_out, str(device))
        if key not in self._interp:
            self._interp[key] = time_interp_matrix(t_in, t_out,
                                                   device=device)
        return self._interp[key]

    def forward(self, x, gen: Optional[torch.Generator] = None,
                bigrus: Optional[Mapping[str, Callable]] = None):
        x, x_2, x_4 = self.cnn(x, gen)

        def run_rnn(h, name):
            h = h.squeeze(2)
            h = (bigrus[name](h) if bigrus is not None
                 else getattr(self, name)(h, gen))
            return self.dropout(h, gen)

        x = run_rnn(x, "rnn")            # (B, 313, 2H)
        x_2 = run_rnn(x_2, "rnn_2")      # (B, 156, 2H)
        x_4 = run_rnn(x_4, "rnn_4")      # (B, 78, 2H)
        x_4_up = self._up(x_4.shape[1], x_2.shape[1], x.device) @ x_4
        x_2 = self.fuse_2(torch.cat([x_2, x_4_up], dim=-1))
        x_2_up = self._up(x_2.shape[1], x.shape[1], x.device) @ x_2
        x = self.fuse_4(torch.cat([x, x_2_up], dim=-1))
        return x, x


class CRNNPred(nn.Module):
    """The dual-CRNN second model (CRNN_GRL.py:206-290), the port of
    ``bsed_tpu.models.crnn.CRNNPred``: the conv stack's features are
    sigmoided directly as the strong prediction, and an attention head
    (``dense_softmax`` over all of them, softmax over classes) pools
    ``strong[..., :nclass]`` over time to the weak one. NHWC (B, T, F,
    C_in) → (strong (B, T', F'·C or C), weak (B, nclass)); a frequency
    axis the stack leaves wider than 1 is flattened as (F', C) row-major,
    ``bsed_tpu``'s reshape of its NHWC map. ``inference`` gates
    ``strong[..., :nclass]`` by (weak > 0.5). The stack's BatchNorm and
    dropout follow the module's mode, as ``CNN``'s do."""

    def __init__(self, cfg: ModelConfig, in_width: int):
        super().__init__()
        self.cnn = CNN(**_cnn_kwargs(cfg))
        width = in_width
        for _, pf in cfg.pooling:
            width //= pf
        if width < 1:
            raise ValueError(
                f"the conv head's frequency pools "
                f"({[p[1] for p in cfg.pooling]}) reduce an input "
                f"{in_width} wide to nothing")
        self.nclass = cfg.nclass
        self.dense_softmax = nn.Linear(width * cfg.nb_filters[-1],
                                       cfg.nclass)

    def forward(self, x, gen: Optional[torch.Generator] = None,
                inference: bool = False):
        x = self.cnn(x, gen)
        x = x.reshape(x.shape[0], x.shape[1], -1)       # (B, T', F'·C)
        strong = torch.sigmoid(x)
        weak = _attention_pool(strong[..., :self.nclass],
                               self.dense_softmax(x))
        if inference:
            strong = _inference_gate(strong[..., :self.nclass], weak)
        return strong, weak


class EncodedCRNNPred(nn.Module):
    """``CRNNPred`` as a prediction head over the encoder's (B, T, 2H)
    output (``bsed_tpu.models.crnn.EncodedCRNNPred``): the encoding is the
    head's one-channel NHWC input (B, T, 2H, 1). ``cfg`` is the head's
    model configuration (``models/predictor.make_predictor_head``), whose
    frequency pools (4·4·4·2·2 = 256) must leave at least one bin of the
    2H-wide input."""

    def __init__(self, cfg: ModelConfig, in_width: int):
        super().__init__()
        self.crnn_pred = CRNNPred(dataclasses.replace(cfg, n_in_channel=1),
                                  in_width)

    def forward(self, x, gen: Optional[torch.Generator] = None,
                inference: bool = False):
        return self.crnn_pred(x[..., None], gen, inference=inference)


def make_encoder(cfg: ModelConfig, cast_weights: bool = True) -> nn.Module:
    return (CRNNFPN(cfg, cast_weights) if cfg.use_fpn
            else CRNN(cfg, cast_weights))


class CRNNDA(nn.Module):
    """CRNN with a built-in gradient-reversed frame discriminator
    (``FrameDiscriminatorGRL``, dropout 0.5): ``forward(x, gen,
    grl_coeff) -> (encoded, d_input, domain_pred)``. Port of
    ``bsed_tpu.models.crnn.CRNNDA``; ``utils/weights.load_crnnda`` carries
    its tree ({"crnn": …, "discriminator": …})."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 cast_weights: bool = True):
        super().__init__()
        self.crnn = CRNN(cfg, cast_weights)
        self.discriminator = FrameDiscriminatorGRL(2 * cfg.n_rnn_cell,
                                                   dropout=0.5)

    def forward(self, x, gen: Optional[torch.Generator] = None,
                grl_coeff=1.0):
        x, d_input = self.crnn(x, gen)
        return x, d_input, self.discriminator(d_input, gen, grl_coeff)
