"""Plain CRNN forward in float32 PyTorch: the serving model, eval mode.

The network of the reference recipe (fumchin/bird-sound-event-detecion,
``CRNN.py``, ``CNN.py``, ``RNN.py``, ``CRNN_GRL.py``'s ``Predictor``),
written from its definitions on the flax-layout weight tree the benchmark
makes (``harness/weights.py``):

* 7 blocks of 3×3 'same' conv → BatchNorm (running statistics, ε 1e-3) →
  GLU (``Linear(x)·sigmoid(x)`` over the channels) → average pool (floor);
* the frequency axis (1 bin) squeezed, a 2-layer bidirectional GRU
  (torch's gate order r, z, n; the recurrent bias inside the reset gate),
  walked step by step here;
* the predictor: frame posteriors sigmoid(dense), clip posteriors pooled
  by attention (softmax over classes, clipped to [1e-7, 1], weighted
  mean over time).

Every conv and product takes its operands through ``q``: the identity,
or a rounding to a lower precision for the control (``quant.py``).
Imports nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

Q = Callable[[torch.Tensor], torch.Tensor]


def _ident(x):
    return x


def conv_block(x: torch.Tensor, p: Mapping, s: Mapping, pool, act: str,
               q: Q = _ident) -> torch.Tensor:
    """NHWC (B, T, F, Cin) → (B, T/pt, F/pf, Cout)."""
    w = p["conv"]["kernel"].permute(3, 2, 0, 1)          # HWIO → OIHW
    y = F.conv2d(q(x.permute(0, 3, 1, 2)), q(w), p["conv"]["bias"],
                 padding=w.shape[-1] // 2).permute(0, 2, 3, 1)
    inv = p["bn"]["scale"] * torch.rsqrt(s["bn"]["var"] + 1e-3)
    y = (y - s["bn"]["mean"]) * inv + p["bn"]["bias"]
    if act == "glu":
        g = p["GLU_0"]["linear"]
        y = (q(y) @ q(g["kernel"]) + g["bias"]) * torch.sigmoid(y)
    elif act == "cg":
        g = p["ContextGating_0"]["linear"]
        y = y * torch.sigmoid(q(y) @ q(g["kernel"]) + g["bias"])
    elif act == "relu":
        y = F.relu(y)
    else:
        raise ValueError(f"activation {act}")
    pt, pf = pool
    if (pt, pf) != (1, 1):
        y = F.avg_pool2d(y.permute(0, 3, 1, 2), (pt, pf)).permute(0, 2, 3, 1)
    return y


def cnn(x: torch.Tensor, params: Mapping, stats: Mapping, model: Mapping,
        q: Q = _ident) -> torch.Tensor:
    for i, pool in enumerate(model["pooling"]):
        name = f"block{i}"
        x = conv_block(x, params[name], stats[name], pool,
                       model["activation"], q)
    return x


def gru_layer(x: torch.Tensor, p: Mapping, layer: int,
              q: Q = _ident) -> torch.Tensor:
    """One bidirectional layer: (B, T, n_in) → (B, T, 2H)."""
    outs = []
    for suffix in ("", "_reverse"):
        name = f"l{layer}{suffix}"
        w_ih, w_hh = p[f"weight_ih_{name}"], p[f"weight_hh_{name}"]
        b_ih, b_hh = p[f"bias_ih_{name}"], p[f"bias_hh_{name}"]
        seq = x.flip(1) if suffix else x
        xp = q(seq) @ q(w_ih).T + b_ih                     # (B, T, 3H)
        wq = q(w_hh).T
        h = x.new_zeros(x.shape[0], w_hh.shape[1])
        ys = []
        for t in range(seq.shape[1]):
            hp = q(h) @ wq + b_hh
            xr, xz, xn = xp[:, t].chunk(3, dim=-1)
            hr, hz, hn = hp.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            ys.append(h)
        y = torch.stack(ys, dim=1)
        outs.append(y.flip(1) if suffix else y)
    return torch.cat(outs, dim=-1)


def bigru(x: torch.Tensor, p: Mapping, layers: int,
          q: Q = _ident) -> torch.Tensor:
    for layer in range(layers):
        x = gru_layer(x, p, layer, q)
    return x


def predictor(x: torch.Tensor, p: Mapping) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    strong = torch.sigmoid(x @ p["dense"]["kernel"] + p["dense"]["bias"])
    sof = torch.softmax(x @ p["dense_softmax"]["kernel"]
                        + p["dense_softmax"]["bias"], dim=-1)
    sof = torch.clamp(sof, 1e-7, 1.0)
    weak = (strong * sof).sum(dim=1) / sof.sum(dim=1)
    return strong, weak


def encode(log_mel: torch.Tensor, params: Mapping, stats: Mapping,
           model: Mapping, q: Q = _ident) -> torch.Tensor:
    """(B, T, F) log-mel → (B, T', 2H) for the plain CRNN."""
    enc, est = params["encoder"], stats["encoder"]
    x = cnn(log_mel[..., None], enc["cnn"], est["cnn"], model, q)
    return bigru(x.squeeze(2), enc["rnn"], model["n_layers_rnn"], q)


def forward(log_mel: torch.Tensor, params: Mapping, stats: Mapping,
            model: Mapping, q: Q = _ident) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    return predictor(encode(log_mel, params, stats, model, q),
                     params["predictor"])


def block_input_stats(log_mel: torch.Tensor, params: Mapping,
                      model: Mapping) -> Dict[str, Dict]:
    """Running statistics that make every block's BatchNorm normalise the
    conv outputs of ``log_mel`` (B, T, F): the per-channel mean and biased
    variance of each block's conv output, block by block (the weights'
    statistics of a model trained on such input)."""
    enc = params["encoder"]["cnn"]
    x = log_mel[..., None]
    stats = {}
    for i, pool in enumerate(model["pooling"]):
        name = f"block{i}"
        p = enc[name]
        w = p["conv"]["kernel"].permute(3, 2, 0, 1)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, p["conv"]["bias"],
                     padding=w.shape[-1] // 2)
        s = {"bn": {"mean": y.mean(dim=(0, 2, 3)),
                    "var": y.var(dim=(0, 2, 3), unbiased=False)}}
        stats[name] = s
        x = conv_block(x, p, s, pool, model["activation"])
    return stats
