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

The train state (``train/state.py``) travels as a dict of the same trees:
``step``, ``params``, ``batch_stats``, ``ema_params``, ``ema_batch_stats``
and the Adam moments ``mu``, ``nu`` (params' layout) with their ``count``
— ``trees_from_jax_state`` reads them off a ``bsed_tpu`` TrainState
(``opt_state.inner_state[0]`` is optax's ScaleByAdamState) without
importing JAX; ``export_train_state`` writes them back, so tests compare
the two frameworks leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from bsed_tpu_torch.models import init as I
from bsed_tpu_torch.models.layers import ContextGating, ConvBlock, GLU


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


# ---------------------------------------------------------------------------
# Train state carry: the flax-layout trees <-> the port's train modules.

# layout change per leaf kind, flax → torch (conv HWIO → OIHW, dense
# (in, out) → (out, in)) and back
_TO_TORCH = {"conv": lambda a: a.transpose(3, 2, 0, 1),
             "dense": lambda a: a.T, "plain": lambda a: a}
_TO_FLAX = {"conv": lambda a: a.transpose(2, 3, 1, 0),
            "dense": lambda a: a.T, "plain": lambda a: a}


def _train_blocks(model) -> Dict[str, ConvBlock]:
    enc = model.encoder
    return {**dict(enc.stem.items()), **dict(enc.rest.blocks.items())}


def train_param_map(model) -> List[Tuple[Tuple[str, ...], nn.Parameter,
                                         str]]:
    """(flax path, parameter, layout kind) for every parameter of a
    ``train.steps.TrainModel``."""
    out = []
    for name, blk in _train_blocks(model).items():
        base = ("encoder", "cnn", name)
        out += [(base + ("conv", "kernel"), blk.conv.weight, "conv"),
                (base + ("conv", "bias"), blk.conv.bias, "plain"),
                (base + ("bn", "scale"), blk.bn.weight, "plain"),
                (base + ("bn", "bias"), blk.bn.bias, "plain")]
        key = {GLU: "GLU_0", ContextGating: "ContextGating_0"}.get(
            type(blk.act))
        if key is not None:
            out += [(base + (key, "linear", "kernel"),
                     blk.act.linear.weight, "dense"),
                    (base + (key, "linear", "bias"), blk.act.linear.bias,
                     "plain")]
    for name, param in model.encoder.rest.rnn.gru.named_parameters():
        out.append((("encoder", "rnn", name), param, "plain"))
    for name, mod in model.predictor.named_children():
        if mod is not None:
            out += [(("predictor", name, "kernel"), mod.weight, "dense"),
                    (("predictor", name, "bias"), mod.bias, "plain")]
    return out


def train_stat_map(model) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(flax batch_stats path, running-stat buffer) of a TrainModel."""
    out = []
    for name, blk in _train_blocks(model).items():
        base = ("encoder", "cnn", name, "bn")
        out += [(base + ("mean",), blk.bn.running_mean),
                (base + ("var",), blk.bn.running_var)]
    return out


def _get(tree: Mapping, path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def load_train_model(model, params: Mapping, stats: Mapping) -> None:
    for path, param, kind in train_param_map(model):
        _set(param, _TO_TORCH[kind](np.asarray(_get(params, path),
                                               np.float32)))
    for path, buf in train_stat_map(model):
        _set(buf, _get(stats, path))


def export_train_model(model) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of a TrainModel as flax-layout numpy trees."""
    params, stats = {}, {}
    for path, param, kind in train_param_map(model):
        _put(params, path, _TO_FLAX[kind](_np(param.detach().cpu())))
    for path, buf in train_stat_map(model):
        _put(stats, path, _np(buf.detach().cpu()))
    return params, stats


def load_train_state(state, trees: Mapping) -> None:
    """Fill a ``train.state.TrainState`` from flax-layout trees (see the
    module docstring); the Adam moments only where ``mu`` is given."""
    state.step = int(trees["step"])
    load_train_model(state.model, trees["params"], trees["batch_stats"])
    load_train_model(state.ema_model, trees["ema_params"],
                     trees["ema_batch_stats"])
    if trees.get("mu") is None:
        return
    opt = state.optimizer
    count = float(np.asarray(trees["count"]))
    for path, param, kind in train_param_map(state.model):
        as_t = lambda tree: torch.from_numpy(np.array(  # noqa: E731
            _TO_TORCH[kind](np.asarray(_get(tree, path), np.float32)))
        ).to(param.device)
        opt.state[param] = {"step": torch.tensor(count),
                            "exp_avg": as_t(trees["mu"]),
                            "exp_avg_sq": as_t(trees["nu"])}


def export_train_state(state) -> Dict:
    """The train state as flax-layout numpy trees (see the module
    docstring)."""
    params, stats = export_train_model(state.model)
    ema_params, ema_stats = export_train_model(state.ema_model)
    mu, nu, count = {}, {}, 0.0
    for path, param, kind in train_param_map(state.model):
        st = state.optimizer.state.get(param, {})
        if "exp_avg" in st:
            count = float(st["step"])
            _put(mu, path, _TO_FLAX[kind](_np(st["exp_avg"].cpu())))
            _put(nu, path, _TO_FLAX[kind](_np(st["exp_avg_sq"].cpu())))
        else:
            zero = np.zeros(_TO_FLAX[kind](_np(param.detach().cpu())).shape,
                            np.float32)
            _put(mu, path, zero)
            _put(nu, path, zero)
    return {"step": state.step, "params": params, "batch_stats": stats,
            "ema_params": ema_params, "ema_batch_stats": ema_stats,
            "mu": mu, "nu": nu, "count": count}


def _tree_np(tree):
    if isinstance(tree, Mapping):
        return {k: _tree_np(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def trees_from_jax_state(jax_state) -> Dict:
    """A ``bsed_tpu.train.state.TrainState`` (Adam through
    ``optax.inject_hyperparams``) as the trees ``load_train_state`` takes."""
    adam = jax_state.opt_state.inner_state[0]
    return {"step": int(np.asarray(jax_state.step)),
            "params": _tree_np(jax_state.params),
            "batch_stats": _tree_np(jax_state.batch_stats),
            "ema_params": _tree_np(jax_state.ema_params),
            "ema_batch_stats": _tree_np(jax_state.ema_batch_stats),
            "mu": _tree_np(adam.mu), "nu": _tree_np(adam.nu),
            "count": int(np.asarray(adam.count))}
