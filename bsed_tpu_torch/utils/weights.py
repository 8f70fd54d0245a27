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

The 'crnn' head (``models/crnn.EncodedCRNNPred``) has conv blocks and
BatchNorm statistics of its own:

  params["predictor"] = {"crnn_pred": {"cnn": {"block{i}": …},
      "dense_softmax": {kernel, bias}}}
  batch_stats["predictor"] = {"crnn_pred": {"cnn": {"block{i}":
      {"bn": {mean, var}}}}}

Layout changes: HWIO conv kernels become OIHW (torch_compat.py:167-168);
flax Dense (in, out) becomes ``nn.Linear`` (out, in).

``init_params(cfg, seed)`` builds such a tree from a seed with the
initializers of ``models/init.py``, so the port runs with non-trivial
weights and no JAX. Its BatchNorm running statistics are drawn away from
0/1 by default (``perturb_stats=True``: the serving tests and the card's
random-weight serving phases, where 0/1 would leave BatchNorm an identity
map); ``perturb_stats=False`` gives the 0/1 of a fresh BatchNorm, as a
fresh train state needs (``train/steps.create_train_state``).

The feature-pyramid encoder (``use_fpn``) adds ``cnn.block_down`` (a conv
block), ``rnn_2``, ``rnn_4`` (GRUs) and ``fuse_2``, ``fuse_4`` (dense).

The train state (``train/state.py``) travels as a dict of the same trees:
``step``, ``params``, ``batch_stats``, ``ema_params``, ``ema_batch_stats``
(the two ``ema_*`` trees None without a mean teacher), and the
optimizer's state in params' layout: Adam's moments ``mu``, ``nu`` with
their ``count``, or SGD's momentum ``trace`` (optax's TraceState; torch's
``momentum_buffer``, the same quantity for SGD with Nesterov momentum and
the weight decay added to the gradient). ``trees_from_jax_state`` reads
them off a ``bsed_tpu`` TrainState without importing JAX;
``export_train_state`` writes them back, so tests compare the two
frameworks leaf by leaf. A state with a discriminator (the adaptation
stage) adds ``disc_params`` and ``disc_batch_stats`` (the discriminator's
flax trees, ``named_param_map``; {} for the MLP flavours, which have no
BatchNorm), and the aux optimizers' states ``disc_opt_state`` and
``enc_opt_state``, each a dict of the same slots (``mu``, ``nu``,
``count`` or ``trace``) over the discriminator's and the encoder's trees.
``load_crnnda`` carries ``models/crnn.CRNNDA``'s tree.

A configuration with a BEATs encoder (``ModelConfig.beats``) adds
``params["beats"]``, the released checkpoint's state dict under its own
key names (``patch_embedding.weight``, ``encoder.pos_conv.0.weight_g`` /
``weight_v``, ``encoder.layers.{i}.self_attn.q_proj.weight``, …;
``load_beats``), and the fusion ``params["encoder"]["cat_tf"] = {kernel
(C + d, C), bias}``.

A configuration served by HTS-AT (``ModelConfig.htsat``) has
``params["htsat"]``, a state dict under the published module names
(``bn0.weight``, ``patch_embed.proj.weight``,
``layers.{i}.blocks.{j}.attn.relative_position_bias_table``,
``layers.{i}.downsample.reduction.weight``, ``norm.weight``,
``tscam_conv.weight``, …), and ``batch_stats["htsat"]`` with bn0's
``bn0.running_mean`` and ``bn0.running_var`` (``load_htsat``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from bsed_tpu_torch.models import init as I
from bsed_tpu_torch.models.layers import (ContextGating, ConvBlock, GLU,
                                          TorchBatchNorm)


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


def load_predictor(pred, pred_params: Mapping,
                   pred_stats: Mapping = None) -> None:
    """A predictor head from its flax-layout tree; the 'crnn' head
    (``models/crnn.EncodedCRNNPred``) also takes its statistics."""
    if hasattr(pred, "crnn_pred"):
        p, s = pred_params["crnn_pred"], pred_stats["crnn_pred"]
        load_cnn(pred.crnn_pred.cnn, p["cnn"], s["cnn"])
        load_dense(pred.crnn_pred.dense_softmax, p["dense_softmax"])
        return
    for name, mod in pred.named_children():
        if mod is not None:
            load_dense(mod, pred_params[name])


def load_crnn(crnn, enc_params: Mapping, enc_stats: Mapping) -> None:
    """A ``models.crnn.CRNN`` or ``CRNNFPN`` from the encoder's trees."""
    blocks, grus, denses = encoder_parts(crnn)
    for name, blk in blocks.items():
        load_conv_block(blk, enc_params["cnn"][name], enc_stats["cnn"][name])
    for name, rnn in grus.items():
        load_gru(rnn, enc_params[name])
    for name, dense in denses.items():
        load_dense(dense, enc_params[name])


def load_beats(beats, state: Mapping) -> None:
    """A ``models/beats.BEATs`` from a state dict under the released
    checkpoint's key names (arrays or tensors): the position
    convolution's weight norm (``weight_g`` (1, 1, K), ``weight_v``, over
    dim 2) folded into one weight, w = g·v/‖v‖ with the norm over the
    other dims; every other key as it is."""
    sd = {k: torch.as_tensor(np.asarray(v, np.float32))
          for k, v in state.items()}
    g = sd.pop("encoder.pos_conv.0.weight_g", None)
    v = sd.pop("encoder.pos_conv.0.weight_v", None)
    if g is not None:
        sd["encoder.pos_conv.0.weight"] = g * v / v.norm(dim=(0, 1),
                                                        keepdim=True)
    beats.load_state_dict(sd, strict=True)


# keys of a released HTS-AT checkpoint that the port computes itself (the
# front end, the windows' index and shift mask) or does not use (the
# linear head beside the token-semantic one)
_HTSAT_DERIVED = (("spectrogram_extractor.", "logmel_extractor.", "head."),
                  ("relative_position_index", "attn_mask",
                   "num_batches_tracked"))


def load_htsat(htsat, state: Mapping, stats: Mapping) -> None:
    """A ``models/htsat.HTSAT`` from a state dict under the published
    module names (arrays or tensors) and bn0's statistics (``stats``,
    ``bn0.running_mean`` and ``bn0.running_var``); the keys the port
    derives or leaves unused (``_HTSAT_DERIVED``) are skipped, every other
    key must match."""
    sd = {k: torch.as_tensor(np.asarray(v, np.float32))
          for k, v in {**state, **stats}.items()
          if not (k.startswith(_HTSAT_DERIVED[0])
                  or k.endswith(_HTSAT_DERIVED[1]))}
    htsat.load_state_dict(sd, strict=True)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.float32)


def init_params(cfg, seed: int = 0,
                perturb_stats: bool = True) -> Tuple[Dict, Dict]:
    """(params, batch_stats) in the flax layout, drawn from ``seed``, for
    the CRNN or CRNNFPN encoder of ``cfg`` with its linear, mlp or 'crnn'
    head. Running means are 0.1·N(0, 1) and variances 0.5 + U(0, 1), or
    0 and 1 with ``perturb_stats=False``; the draw is made either way, so
    the parameters do not depend on ``perturb_stats``. The 'crnn' head's
    conv blocks draw as the encoder's, its ``dense_softmax`` N(0, 0.01);
    its statistics are ``batch_stats["predictor"]``."""
    from bsed_tpu_torch.models.predictor import make_predictor_head

    m = cfg.model
    gen = torch.Generator().manual_seed(seed)

    def conv_blocks(names, couts, cin):
        """(params, stats) of conv blocks ``names`` with ``couts``
        filters, the first fed ``cin`` channels."""
        cnn, stats = {}, {}
        for name, cout in zip(names, couts):
            blk = {"conv": {"kernel": _np(I.xavier_uniform_gain(
                                gen, (m.kernel_size, m.kernel_size, cin,
                                      cout))),
                            "bias": np.zeros(cout, np.float32)},
                   "bn": {"scale": _np(I.bn_scale_init(gen, (cout,))),
                          "bias": np.zeros(cout, np.float32)}}
            if m.activation in ("glu", "cg"):
                key = "GLU_0" if m.activation == "glu" else \
                    "ContextGating_0"
                blk[key] = {"linear": {
                    "kernel": _np(I.normal_init(gen, (cout, cout))),
                    "bias": np.zeros(cout, np.float32)}}
            cnn[name] = blk
            mean = _np(0.1 * torch.randn((cout,), generator=gen))
            var = _np(0.5 + torch.rand((cout,), generator=gen))
            if not perturb_stats:
                mean, var = np.zeros_like(mean), np.ones_like(var)
            stats[name] = {"bn": {"mean": mean, "var": var}}
            cin = cout
        return cnn, stats

    names = [f"block{i}" for i in range(len(m.nb_filters))]
    couts = list(m.nb_filters)
    if m.use_fpn:
        names.append("block_down")
        couts.append(m.nb_filters[-1])
    cnn, stats = conv_blocks(names, couts, m.n_in_channel)

    h = m.n_rnn_cell

    def gru():
        rnn = {}
        n_in = m.nb_filters[-1]
        for layer in range(m.n_layers_rnn):
            for suffix in ("", "_reverse"):
                name = f"l{layer}{suffix}"
                rnn[f"weight_ih_{name}"] = _np(I.orthogonal(gen,
                                                            (3 * h, n_in)))
                rnn[f"weight_hh_{name}"] = _np(I.orthogonal(gen, (3 * h, h)))
                rnn[f"bias_ih_{name}"] = _np(I.uniform_sqrt_h(gen, (3 * h,),
                                                              h))
                rnn[f"bias_hh_{name}"] = _np(I.uniform_sqrt_h(gen, (3 * h,),
                                                              h))
            n_in = 2 * h
        return rnn

    def dense(n_i, n_o):
        return {"kernel": _np(I.normal_init(gen, (n_i, n_o))),
                "bias": np.zeros(n_o, np.float32)}

    encoder = {"cnn": cnn, "rnn": gru()}
    if m.use_fpn:
        encoder["rnn_2"], encoder["rnn_4"] = gru(), gru()
        encoder["fuse_2"] = dense(4 * h, 2 * h)
        encoder["fuse_4"] = dense(4 * h, 2 * h)
    batch_stats = {"encoder": {"cnn": stats}}

    enc_dim, ncls = 2 * h, cfg.nclass
    if m.predictor_head == "crnn":
        head = make_predictor_head(cfg).crnn_pred
        blocks = dict(head.cnn.blocks.items())
        h_cnn, h_stats = conv_blocks(
            list(blocks), [b.conv.out_channels for b in blocks.values()], 1)
        d = head.dense_softmax
        pred = {"crnn_pred": {"cnn": h_cnn, "dense_softmax": dense(
            d.in_features, d.out_features)}}
        batch_stats["predictor"] = {"crnn_pred": {"cnn": h_stats}}
    else:
        if m.predictor_head == "mlp":
            pred = {"dense1": dense(enc_dim, 64), "dense2": dense(64, 128),
                    "dense3": dense(128, 64), "dense4": dense(64, ncls)}
        else:
            pred = {"dense": dense(enc_dim, ncls)}
        if m.attention:
            pred["dense_softmax"] = dense(enc_dim, ncls)
    params = {"encoder": encoder, "predictor": pred}
    return params, batch_stats


# ---------------------------------------------------------------------------
# Train state carry: the flax-layout trees <-> the port's train modules.

# layout change per leaf kind, flax → torch (conv HWIO → OIHW, dense
# (in, out) → (out, in)) and back
_TO_TORCH = {"conv": lambda a: a.transpose(3, 2, 0, 1),
             "dense": lambda a: a.T, "plain": lambda a: a}
_TO_FLAX = {"conv": lambda a: a.transpose(2, 3, 1, 0),
            "dense": lambda a: a.T, "plain": lambda a: a}


def encoder_parts(encoder):
    """(conv blocks, GRUs, dense layers) of a train encoder, each a dict
    by flax name: the folded encoder (``stem`` and ``rest``), ``CRNN`` or
    ``CRNNFPN``."""
    if hasattr(encoder, "stem"):
        rest = encoder.rest
        return ({**dict(encoder.stem.items()), **dict(rest.blocks.items())},
                {"rnn": rest.rnn}, {})
    blocks = dict(encoder.cnn.blocks.items())
    if hasattr(encoder.cnn, "block_down"):
        blocks["block_down"] = encoder.cnn.block_down
    grus = {n: getattr(encoder, n) for n in ("rnn", "rnn_2", "rnn_4")
            if hasattr(encoder, n)}
    denses = {n: getattr(encoder, n) for n in ("fuse_2", "fuse_4")
              if hasattr(encoder, n)}
    return blocks, grus, denses


def train_param_map(model) -> List[Tuple[Tuple[str, ...], nn.Parameter,
                                         str]]:
    """(flax path, parameter, layout kind) for every parameter of a
    ``train.steps.TrainModel``."""
    out = []
    blocks, grus, denses = encoder_parts(model.encoder)
    for name, blk in blocks.items():
        out += _block_params(("encoder", "cnn", name), blk)
    for gname, rnn in grus.items():
        for name, param in rnn.gru.named_parameters():
            out.append((("encoder", gname, name), param, "plain"))
    for name, mod in denses.items():
        out += [(("encoder", name, "kernel"), mod.weight, "dense"),
                (("encoder", name, "bias"), mod.bias, "plain")]
    head = model.predictor
    if hasattr(head, "crnn_pred"):
        base = ("predictor", "crnn_pred")
        for name, blk in head.crnn_pred.cnn.blocks.items():
            out += _block_params(base + ("cnn", name), blk)
        head = {"dense_softmax": head.crnn_pred.dense_softmax}
    else:
        base = ("predictor",)
        head = dict(head.named_children())
    for name, mod in head.items():
        if mod is not None:
            out += [(base + (name, "kernel"), mod.weight, "dense"),
                    (base + (name, "bias"), mod.bias, "plain")]
    return out


def _block_params(base, blk) -> List[Tuple[Tuple[str, ...], nn.Parameter,
                                          str]]:
    """``train_param_map``'s entries of one conv block at flax path
    ``base``."""
    out = [(base + ("conv", "kernel"), blk.conv.weight, "conv"),
           (base + ("conv", "bias"), blk.conv.bias, "plain"),
           (base + ("bn", "scale"), blk.bn.weight, "plain"),
           (base + ("bn", "bias"), blk.bn.bias, "plain")]
    key = {GLU: "GLU_0", ContextGating: "ContextGating_0"}.get(type(blk.act))
    if key is not None:
        out += [(base + (key, "linear", "kernel"), blk.act.linear.weight,
                 "dense"),
                (base + (key, "linear", "bias"), blk.act.linear.bias,
                 "plain")]
    return out


def train_stat_map(model) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(flax batch_stats path, running-stat buffer) of a TrainModel: the
    encoder's blocks, and the 'crnn' head's under ``predictor``."""
    blocks = [(("encoder", "cnn", name), blk) for name, blk
              in encoder_parts(model.encoder)[0].items()]
    if hasattr(model.predictor, "crnn_pred"):
        blocks += [(("predictor", "crnn_pred", "cnn", name), blk)
                   for name, blk
                   in model.predictor.crnn_pred.cnn.blocks.items()]
    out = []
    for base, blk in blocks:
        out += [(base + ("bn", "mean"), blk.bn.running_mean),
                (base + ("bn", "var"), blk.bn.running_var)]
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


def _opt_kind(opt) -> str:
    return "sgd" if isinstance(opt, torch.optim.SGD) else "adam"


def _load_opt(opt, pmap, trees: Mapping) -> None:
    """An optimizer's state from flax-layout slot trees (Adam: ``mu``,
    ``nu``, ``count``; SGD: ``trace``) over the parameters of ``pmap``;
    nothing where the trees hold no such slot."""
    kind = _opt_kind(opt)
    if trees.get("trace" if kind == "sgd" else "mu") is None:
        return
    count = float(np.asarray(trees.get("count", 0)))
    for path, param, lk in pmap:
        as_t = lambda tree: torch.from_numpy(np.array(  # noqa: E731
            _TO_TORCH[lk](np.asarray(_get(tree, path), np.float32)))
        ).to(param.device)
        if kind == "sgd":
            opt.state[param] = {"momentum_buffer": as_t(trees["trace"])}
        else:
            opt.state[param] = {"step": torch.tensor(count),
                                "exp_avg": as_t(trees["mu"]),
                                "exp_avg_sq": as_t(trees["nu"])}


def _export_opt(opt, pmap) -> Dict:
    """The slot trees of ``_load_opt`` (zeros for a parameter the
    optimizer has not stepped yet)."""
    kind = _opt_kind(opt)
    slots = (("trace", "momentum_buffer"),) if kind == "sgd" else (
        ("mu", "exp_avg"), ("nu", "exp_avg_sq"))
    trees = {name: {} for name, _ in slots}
    count = 0.0
    for path, param, lk in pmap:
        st = opt.state.get(param, {})
        for name, key in slots:
            if st.get(key) is not None:
                value = _np(st[key].cpu())
            else:
                value = np.zeros(tuple(param.shape), np.float32)
            _put(trees[name], path, _TO_FLAX[lk](value))
        if "step" in st:
            count = float(st["step"])
    if kind == "adam":
        trees["count"] = count
    return trees


def encoder_param_map(model):
    """``train_param_map`` of the encoder alone, paths relative to it (the
    encoder's aux optimizer's trees)."""
    return [(path[1:], param, lk) for path, param, lk
            in train_param_map(model) if path[0] == "encoder"]


def named_param_map(module) -> List[Tuple[Tuple[str, ...], nn.Parameter,
                                         str]]:
    """(flax path, parameter, layout kind) of a module whose submodule
    names are the flax names: the discriminators
    (``models/discriminators``) and the taggers (``models/resnet``)."""
    out = []
    for name, mod in module.named_modules():
        base = tuple(name.split(".")) if name else ()
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            kind = "dense" if isinstance(mod, nn.Linear) else "conv"
            out.append((base + ("kernel",), mod.weight, kind))
            if mod.bias is not None:
                out.append((base + ("bias",), mod.bias, "plain"))
        elif isinstance(mod, TorchBatchNorm):
            out += [(base + ("scale",), mod.weight, "plain"),
                    (base + ("bias",), mod.bias, "plain")]
    return out


def named_stat_map(module) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(flax batch_stats path, running-stat buffer) of the same modules."""
    out = []
    for name, mod in module.named_modules():
        if isinstance(mod, TorchBatchNorm):
            base = tuple(name.split("."))
            out += [(base + ("mean",), mod.running_mean),
                    (base + ("var",), mod.running_var)]
    return out


def load_named(module, params: Mapping, stats: Mapping) -> None:
    """A discriminator or a tagger from its flax-layout trees."""
    for path, param, kind in named_param_map(module):
        _set(param, _TO_TORCH[kind](np.asarray(_get(params, path),
                                               np.float32)))
    for path, buf in named_stat_map(module):
        _set(buf, _get(stats, path))


def export_named(module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of a discriminator or a tagger as
    flax-layout numpy trees: the inverse of ``load_named``."""
    params, stats = {}, {}
    for path, param, kind in named_param_map(module):
        _put(params, path, _TO_FLAX[kind](_np(param.detach().cpu())))
    for path, buf in named_stat_map(module):
        _put(stats, path, _np(buf.detach().cpu()))
    return params, stats


def init_disc_params(disc, seed: int = 0) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of a discriminator in the flax layout, drawn
    from ``seed`` with ``bsed_tpu``'s initializers: every dense and conv
    kernel N(0, 0.01), biases 0, BatchNorm scale N(1, 0.02), running
    statistics 0 and 1."""
    gen = torch.Generator().manual_seed(seed)
    params, stats = {}, {}
    for path, param, kind in named_param_map(disc):
        shape = tuple(param.shape)
        if path[-1] == "kernel":
            value = I.normal_init(gen, shape)
        elif path[-1] == "scale":
            value = I.bn_scale_init(gen, shape)
        else:
            value = torch.zeros(shape)
        _put(params, path, _TO_FLAX[kind](_np(value)))
    for path, buf in named_stat_map(disc):
        fill = np.zeros if path[-1] == "mean" else np.ones
        _put(stats, path, fill(tuple(buf.shape), np.float32))
    return params, stats


def init_tagger(cfg, arch: str, gen: torch.Generator
                ) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of a fresh tagger (``models/resnet``) in the
    flax layout, with ``bsed_tpu``'s ``model.init`` distributions drawn
    from ``gen``: conv and dense kernels lecun-normal, biases 0,
    BatchNorm scale 1 and bias 0, running mean 0 and variance 1. Built
    from the module's shapes, with no forward."""
    from bsed_tpu_torch.models.resnet import build_tagger

    model = build_tagger(cfg, arch)
    params, stats = {}, {}
    for path, param, kind in named_param_map(model):
        shape = _TO_FLAX[kind](np.empty(tuple(param.shape))).shape
        if path[-1] == "kernel":
            value = _np(I.lecun_normal(gen, shape))
        elif path[-1] == "scale":
            value = np.ones(shape, np.float32)
        else:
            value = np.zeros(shape, np.float32)
        _put(params, path, value)
    for path, buf in named_stat_map(model):
        fill = np.zeros if path[-1] == "mean" else np.ones
        _put(stats, path, fill(tuple(buf.shape), np.float32))
    return params, stats


def load_crnnda(model, params: Mapping, stats: Mapping) -> None:
    """A ``models.crnn.CRNNDA`` from its trees: {"crnn": CRNN's tree,
    "discriminator": FrameDiscriminatorGRL's}."""
    load_crnn(model.crnn, params["crnn"], stats["crnn"])
    load_named(model.discriminator, params["discriminator"], {})


def load_train_state(state, trees: Mapping) -> None:
    """Fill a ``train.state.TrainState`` from flax-layout trees (see the
    module docstring); the optimizers' states only where the trees hold
    them (Adam: ``mu``; SGD: ``trace``)."""
    state.step = int(trees["step"])
    load_train_model(state.model, trees["params"], trees["batch_stats"])
    if state.ema_model is not None:
        load_train_model(state.ema_model, trees["ema_params"],
                         trees["ema_batch_stats"])
    _load_opt(state.optimizer, train_param_map(state.model), trees)
    if state.discriminator is not None and \
            trees.get("disc_params") is not None:
        load_named(state.discriminator, trees["disc_params"],
                  trees["disc_batch_stats"])
        _load_opt(state.disc_optimizer,
                  named_param_map(state.discriminator),
                  trees.get("disc_opt_state") or {})
        _load_opt(state.enc_optimizer, encoder_param_map(state.model),
                  trees.get("enc_opt_state") or {})


def export_train_state(state) -> Dict:
    """The train state as flax-layout numpy trees (see the module
    docstring)."""
    params, stats = export_train_model(state.model)
    ema_params = ema_stats = None
    if state.ema_model is not None:
        ema_params, ema_stats = export_train_model(state.ema_model)
    out = {"step": state.step, "params": params, "batch_stats": stats,
           "ema_params": ema_params, "ema_batch_stats": ema_stats}
    out.update(_export_opt(state.optimizer, train_param_map(state.model)))
    if state.discriminator is not None:
        out["disc_params"], out["disc_batch_stats"] = export_named(
            state.discriminator)
        out["disc_opt_state"] = _export_opt(
            state.disc_optimizer, named_param_map(state.discriminator))
        out["enc_opt_state"] = _export_opt(state.enc_optimizer,
                                           encoder_param_map(state.model))
    return out


def _tree_np(tree):
    if isinstance(tree, Mapping):
        return {k: _tree_np(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _jax_opt_trees(opt_state) -> Dict:
    """An ``optax.inject_hyperparams`` state's slots: Adam's
    ``inner_state[0]`` is a ScaleByAdamState; SGD's chain (decayed
    weights, (trace, scale)) holds its TraceState at
    ``inner_state[1][0]``."""
    inner = opt_state.inner_state
    if hasattr(inner[0], "mu"):
        return {"mu": _tree_np(inner[0].mu), "nu": _tree_np(inner[0].nu),
                "count": int(np.asarray(inner[0].count))}
    return {"trace": _tree_np(inner[1][0].trace)}


def trees_from_jax_state(jax_state) -> Dict:
    """A ``bsed_tpu.train.state.TrainState`` (optimizers through
    ``optax.inject_hyperparams``) as the trees ``load_train_state``
    takes, the discriminator's and the aux optimizers' where it has
    them."""
    ema = lambda tree: None if tree is None else _tree_np(tree)  # noqa: E731
    out = {"step": int(np.asarray(jax_state.step)),
           "params": _tree_np(jax_state.params),
           "batch_stats": _tree_np(jax_state.batch_stats),
           "ema_params": ema(jax_state.ema_params),
           "ema_batch_stats": ema(jax_state.ema_batch_stats)}
    out.update(_jax_opt_trees(jax_state.opt_state))
    if jax_state.disc_params is not None:
        out.update(disc_params=_tree_np(jax_state.disc_params),
                   disc_batch_stats=_tree_np(jax_state.disc_batch_stats),
                   disc_opt_state=_jax_opt_trees(jax_state.disc_opt_state),
                   enc_opt_state=_jax_opt_trees(jax_state.enc_opt_state))
    return out
