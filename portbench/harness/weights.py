"""Weights from the seed: the flax-layout trees the port loads
(``bsed_tpu_torch/utils/weights.py`` documents the layout), made by the
benchmark on the device with one ``torch.Generator`` draw and scaled leaf
by leaf. The reference takes the same tensors; the port takes them as
numpy arrays, which its loaders require.

Scales: fan-in normal for convs and dense layers, 1/√H uniform-like
normal for the GRU, BatchNorm scale 1 ± 0.1 and bias ± 0.1; running
statistics 0 and 1 (a fresh model; serving sets its own from the input,
``reference/crnn.block_input_stats``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str]   # (path, shape, kind)


def _conv_block(path, cin, cout, k, act) -> List[Leaf]:
    out = [(path + ("conv", "kernel"), (k, k, cin, cout), f"fan:{k * k * cin}"),
           (path + ("conv", "bias"), (cout,), "small"),
           (path + ("bn", "scale"), (cout,), "one"),
           (path + ("bn", "bias"), (cout,), "small")]
    if act in ("glu", "cg"):
        key = "GLU_0" if act == "glu" else "ContextGating_0"
        out += [(path + (key, "linear", "kernel"), (cout, cout),
                 f"fan:{cout}"),
                (path + (key, "linear", "bias"), (cout,), "small")]
    return out


def _gru(path, n_in, hid, layers) -> List[Leaf]:
    out = []
    for layer in range(layers):
        for suffix in ("", "_reverse"):
            n = f"l{layer}{suffix}"
            out += [(path + (f"weight_ih_{n}",), (3 * hid, n_in), f"gru:{hid}"),
                    (path + (f"weight_hh_{n}",), (3 * hid, hid), f"gru:{hid}"),
                    (path + (f"bias_ih_{n}",), (3 * hid,), f"gru:{hid}"),
                    (path + (f"bias_hh_{n}",), (3 * hid,), f"gru:{hid}")]
        n_in = 2 * hid
    return out


def _dense(path, n_in, n_out) -> List[Leaf]:
    return [(path + ("kernel",), (n_in, n_out), f"fan:{n_in}"),
            (path + ("bias",), (n_out,), "small")]


def leaves(model: Mapping) -> List[Leaf]:
    """Every parameter of the CRNN or CRNNFPN encoder and the linear head
    with attention, in a fixed order."""
    k, act = model["kernel_size"], model["activation"]
    out, cin = [], model["n_in_channel"]
    for i, cout in enumerate(model["nb_filters"]):
        out += _conv_block(("encoder", "cnn", f"block{i}"), cin, cout, k, act)
        cin = cout
    hid, c = model["n_rnn_cell"], model["nb_filters"][-1]
    if model["use_fpn"]:
        out += _conv_block(("encoder", "cnn", "block_down"), c, c, k, act)
    out += _gru(("encoder", "rnn"), c, hid, model["n_layers_rnn"])
    if model["use_fpn"]:
        out += _gru(("encoder", "rnn_2"), c, hid, model["n_layers_rnn"])
        out += _gru(("encoder", "rnn_4"), c, hid, model["n_layers_rnn"])
        out += _dense(("encoder", "fuse_2"), 4 * hid, 2 * hid)
        out += _dense(("encoder", "fuse_4"), 4 * hid, 2 * hid)
    out += _dense(("predictor", "dense"), 2 * hid, model["nclass"])
    out += _dense(("predictor", "dense_softmax"), 2 * hid, model["nclass"])
    return out


def _put(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _scale(kind: str) -> Tuple[float, float]:
    """(offset, std) of a leaf kind."""
    if kind == "one":
        return 1.0, 0.1
    if kind == "small":
        return 0.0, 0.1
    name, _, n = kind.partition(":")
    if name == "fan":
        return 0.0, 1.0 / math.sqrt(float(n))
    return 0.0, 1.0 / math.sqrt(3.0 * float(n))      # gru


def make_params(model: Mapping, seed: int, device) -> Dict:
    """The parameter tree of ``model`` from ``seed``: float32 tensors on
    ``device``, drawn in one call."""
    spec = leaves(model)
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    tree, at = {}, 0
    for (path, shape, kind), n in zip(spec, sizes):
        off, std = _scale(kind)
        _put(tree, path, (flat[at:at + n].reshape(shape) * std + off))
        at += n
    return tree


def fresh_stats(model: Mapping, device) -> Dict:
    """BatchNorm running statistics 0 and 1 of every conv block."""
    names = [f"block{i}" for i in range(len(model["nb_filters"]))]
    if model["use_fpn"]:
        names.append("block_down")
    stats = {}
    for name, c in zip(names, list(model["nb_filters"])
                       + [model["nb_filters"][-1]]):
        stats[name] = {"bn": {"mean": torch.zeros(c, device=device),
                              "var": torch.ones(c, device=device)}}
    return {"encoder": {"cnn": stats}}


def to_numpy(tree):
    """The same tree as float32 numpy arrays (the port's loaders)."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()
