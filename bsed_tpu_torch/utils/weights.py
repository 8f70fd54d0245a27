"""Weight carry from the JAX parameter trees into the port's modules.

The counterpart of ``bsed_tpu/utils/torch_compat.py``, in the other
direction. The trees are the flax layout, as numpy arrays (or anything
``np.asarray`` takes):

  params["encoder"]["cnn"]["block{i}"] = {"conv": {kernel (3,3,in,out) HWIO,
      bias}, "bn": {scale, bias}, "GLU_0" | "ContextGating_0":
      {"linear": {kernel (in,out), bias}}}
  params["encoder"]["rnn"] = {weight_ih_l0 (3H,in), weight_hh_l0, bias_ih_l0,
      bias_hh_l0, …, *_reverse}          (already torch's layout and names)
  params["predictor"] = {"dense": {kernel, bias}, "dense_softmax": …}
  batch_stats["encoder"]["cnn"]["block{i}"]["bn"] = {mean, var}

Layout changes: HWIO conv kernels become OIHW (torch_compat.py:167-168);
flax Dense (in, out) becomes ``nn.Linear`` (out, in).

``init_params(cfg, seed)`` builds such a tree from a seed with the
initializers of ``models/init.py`` (running stats perturbed away from 0/1),
so the port runs with non-trivial weights and no JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from bsed_tpu_torch.models import init as I
from bsed_tpu_torch.models.layers import ConvBlock


def _set(param: torch.Tensor, value) -> None:
    v = torch.from_numpy(np.array(value, np.float32))
    if tuple(v.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(v.shape)} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(v)


def conv_weight(kernel) -> np.ndarray:
    """HWIO (kt, kf, in, out) → OIHW (out, in, kt, kf)."""
    return np.ascontiguousarray(np.asarray(kernel, np.float32)
                                .transpose(3, 2, 0, 1))


def load_dense(linear: nn.Linear, p: Mapping) -> None:
    _set(linear.weight, np.asarray(p["kernel"], np.float32).T)
    _set(linear.bias, p["bias"])


def load_conv_block(block: ConvBlock, p: Mapping, s: Mapping) -> None:
    _set(block.conv.weight, conv_weight(p["conv"]["kernel"]))
    _set(block.conv.bias, p["conv"]["bias"])
    _set(block.bn.weight, p["bn"]["scale"])
    _set(block.bn.bias, p["bn"]["bias"])
    _set(block.bn.running_mean, s["bn"]["mean"])
    _set(block.bn.running_var, s["bn"]["var"])
    for key in ("GLU_0", "ContextGating_0"):
        if key in p:
            load_dense(block.act.linear, p[key]["linear"])


def load_cnn(cnn, cnn_params: Mapping, cnn_stats: Mapping) -> None:
    for name, blk in cnn.blocks.items():
        load_conv_block(blk, cnn_params[name], cnn_stats[name])


def load_gru(rnn, rnn_params: Mapping) -> None:
    for name, param in rnn.gru.named_parameters():
        _set(param, rnn_params[name])


def load_predictor(pred, pred_params: Mapping) -> None:
    for name, mod in pred.named_children():
        if mod is not None:
            load_dense(mod, pred_params[name])


def load_crnn(crnn, enc_params: Mapping, enc_stats: Mapping) -> None:
    load_cnn(crnn.cnn, enc_params["cnn"], enc_stats["cnn"])
    load_gru(crnn.rnn, enc_params["rnn"])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.float32)


def init_params(cfg, seed: int = 0) -> Tuple[Dict, Dict]:
    """(params, batch_stats) in the flax layout, drawn from ``seed``, for
    the default CRNN + linear/mlp predictor topology of ``cfg``."""
    m = cfg.model
    if m.use_fpn or m.predictor_head == "crnn":
        raise NotImplementedError("init_params covers the CRNN encoder with "
                                  "a linear or mlp head")
    gen = torch.Generator().manual_seed(seed)
    cnn, stats = {}, {}
    cin = m.n_in_channel
    for i, cout in enumerate(m.nb_filters):
        blk = {"conv": {"kernel": _np(I.xavier_uniform_gain(
                            gen, (m.kernel_size, m.kernel_size, cin, cout))),
                        "bias": np.zeros(cout, np.float32)},
               "bn": {"scale": _np(I.bn_scale_init(gen, (cout,))),
                      "bias": np.zeros(cout, np.float32)}}
        if m.activation in ("glu", "cg"):
            key = "GLU_0" if m.activation == "glu" else "ContextGating_0"
            blk[key] = {"linear": {
                "kernel": _np(I.normal_init(gen, (cout, cout))),
                "bias": np.zeros(cout, np.float32)}}
        cnn[f"block{i}"] = blk
        stats[f"block{i}"] = {"bn": {
            "mean": _np(0.1 * torch.randn((cout,), generator=gen)),
            "var": _np(0.5 + torch.rand((cout,), generator=gen))}}
        cin = cout

    h = m.n_rnn_cell
    rnn = {}
    n_in = m.nb_filters[-1]
    for layer in range(m.n_layers_rnn):
        for suffix in ("", "_reverse"):
            name = f"l{layer}{suffix}"
            rnn[f"weight_ih_{name}"] = _np(I.orthogonal(gen, (3 * h, n_in)))
            rnn[f"weight_hh_{name}"] = _np(I.orthogonal(gen, (3 * h, h)))
            rnn[f"bias_ih_{name}"] = _np(I.uniform_sqrt_h(gen, (3 * h,), h))
            rnn[f"bias_hh_{name}"] = _np(I.uniform_sqrt_h(gen, (3 * h,), h))
        n_in = 2 * h

    def dense(n_i, n_o):
        return {"kernel": _np(I.normal_init(gen, (n_i, n_o))),
                "bias": np.zeros(n_o, np.float32)}

    enc_dim, ncls = 2 * h, cfg.nclass
    if m.predictor_head == "mlp":
        pred = {"dense1": dense(enc_dim, 64), "dense2": dense(64, 128),
                "dense3": dense(128, 64), "dense4": dense(64, ncls)}
    else:
        pred = {"dense": dense(enc_dim, ncls)}
    if m.attention:
        pred["dense_softmax"] = dense(enc_dim, ncls)
    params = {"encoder": {"cnn": cnn, "rnn": rnn}, "predictor": pred}
    return params, {"encoder": {"cnn": stats}}
