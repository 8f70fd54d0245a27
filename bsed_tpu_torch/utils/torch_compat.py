"""Torch state-dict ↔ flax-layout param-tree conversion.

The port's copy of ``bsed_tpu/utils/torch_compat.py`` (numpy only): the
port's modules load the same flax-layout trees (``utils/weights.py``), so
a reference checkpoint converts the same way for both packages. Loads
reference checkpoints (torch pickles saved by the reference's
src/main_baseline.py:895-971) for the numerics-parity gate (frame
posteriors ≤ 1e-3, BASELINE.md north-star), including the legacy
``cnn.`` → ``cnn.cnn.`` key migration quirk handled by the reference's
own loader (src/TestModel.py:48-52).

Layout conventions:
  * torch Conv2d weight (out, in, kh, kw) → flax (kh, kw, in, out)
  * torch Linear weight (out, in)         → flax kernel (in, out)
  * torch BatchNorm weight/bias/running_* → flax scale/bias + batch_stats
  * torch GRU weight_ih_l{k}[_reverse] …  → identical names/shapes here
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np


def migrate_legacy_cnn_keys(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Old checkpoints store conv weights under ``cnn.conv0.…`` (one ``cnn.``
    level missing); the reference re-prefixes them (TestModel.py:48-52).
    Only applies when the checkpoint actually has the legacy layout (no
    ``cnn.cnn.`` keys at all) so modern FPN keys like ``cnn.cnn_fcn.*`` are
    left untouched."""
    if any(k.startswith("cnn.cnn.") for k in state):
        return dict(state)
    out = {}
    for k, v in state.items():
        if k.startswith("cnn.") and not k.startswith("cnn.cnn."):
            out["cnn." + k] = v
        else:
            out[k] = v
    return out


def _np(t):
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def convert_conv(w, b=None):
    p = {"kernel": _np(w).transpose(2, 3, 1, 0)}
    if b is not None:
        p["bias"] = _np(b)
    return p


def convert_dense(w, b=None):
    p = {"kernel": _np(w).T}
    if b is not None:
        p["bias"] = _np(b)
    return p


def convert_bn(state: Mapping[str, np.ndarray], prefix: str):
    params = {"scale": _np(state[prefix + "weight"]),
              "bias": _np(state[prefix + "bias"])}
    stats = {"mean": _np(state[prefix + "running_mean"]),
             "var": _np(state[prefix + "running_var"])}
    return params, stats


def convert_gru(state: Mapping[str, np.ndarray], prefix: str,
                num_layers: int) -> Dict[str, np.ndarray]:
    """torch nn.GRU params → BidirectionalGRU params (same names)."""
    out = {}
    for layer in range(num_layers):
        for suffix in ("", "_reverse"):
            for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                k = f"{kind}_l{layer}{suffix}"
                out[k] = _np(state[prefix + k])
    return out


def convert_cnn(state: Mapping[str, np.ndarray], prefix: str,
                n_blocks: int, activation: str = "glu"
                ) -> Tuple[Dict, Dict]:
    """Reference CNN sequential (conv{i}/batchnorm{i}/glu{i}) → CNN params."""
    params, stats = {}, {}
    act = activation.lower()
    for i in range(n_blocks):
        block, block_stats = {}, {}
        block["conv"] = convert_conv(state[f"{prefix}conv{i}.weight"],
                                     state[f"{prefix}conv{i}.bias"])
        bn_p, bn_s = convert_bn(state, f"{prefix}batchnorm{i}.")
        block["bn"], block_stats["bn"] = bn_p, bn_s
        if act in ("glu", "cg"):
            lin = convert_dense(state[f"{prefix}{act}{i}.linear.weight"],
                                state[f"{prefix}{act}{i}.linear.bias"])
            # activation module name inside ConvBlock is anonymous; flax
            # auto-names compact submodules GLU_0 / ContextGating_0
            key = "GLU_0" if act == "glu" else "ContextGating_0"
            block[key] = {"linear": lin}
        params[f"block{i}"] = block
        stats[f"block{i}"] = block_stats
    return params, stats


def convert_crnn(state: Mapping[str, np.ndarray], n_blocks: int = 7,
                 num_layers_rnn: int = 2, activation: str = "glu",
                 fpn: bool = False) -> Tuple[Dict, Dict]:
    """Full reference CRNN/CRNN_fpn state_dict → (params, batch_stats)."""
    state = migrate_legacy_cnn_keys(state)
    cnn_params, cnn_stats = convert_cnn(state, "cnn.cnn.", n_blocks, activation)
    if fpn:
        # shared pyramid block: cnn.cnn_fcn / cnn.bn_fcn / cnn.glu
        block = {"conv": convert_conv(state["cnn.cnn_fcn.weight"],
                                      state["cnn.cnn_fcn.bias"])}
        bn_p, bn_s = convert_bn(state, "cnn.bn_fcn.")
        block["bn"] = bn_p
        block["GLU_0"] = {"linear": convert_dense(state["cnn.glu.linear.weight"],
                                                  state["cnn.glu.linear.bias"])}
        cnn_params["block_down"] = block
        cnn_stats["block_down"] = {"bn": bn_s}

    params = {"cnn": cnn_params,
              "rnn": convert_gru(state, "rnn.rnn.", num_layers_rnn)}
    stats = {"cnn": cnn_stats}
    if fpn:
        params["rnn_2"] = convert_gru(state, "rnn_2.rnn.", num_layers_rnn)
        params["rnn_4"] = convert_gru(state, "rnn_4.rnn.", num_layers_rnn)
        # conv1x1_2/conv1x1_4 (torch 1×1 convs) → fuse dense kernels
        for tname, fname in (("conv1x1_2", "fuse_2"), ("conv1x1_4", "fuse_4")):
            w = _np(state[f"{tname}.weight"])  # (out, in, 1, 1)
            params[fname] = {"kernel": w[:, :, 0, 0].T,
                             "bias": _np(state[f"{tname}.bias"])}
    return params, stats


def convert_predictor(state: Mapping[str, np.ndarray]) -> Dict:
    """Predictor head state_dict → flax params. Generic over the two
    reference heads (both use plain ``nn.Linear`` leaves with matching
    flax module names): Predictor's ``dense``(+``dense_softmax``)
    (CRNN_GRL.py:430-460) and Predictor_2's ``dense1..dense4``
    (+``dense_softmax``) (CRNN_GRL.py:391-428)."""
    params = {}
    for k in state:
        if k.endswith(".weight") and "." not in k[:-len(".weight")]:
            name = k[:-len(".weight")]
            params[name] = convert_dense(state[k], state[f"{name}.bias"])
    if not params:
        raise ValueError(
            f"no linear layers found in predictor state_dict: {list(state)}")
    return params


# ---------------------------------------------------------------------------
# Inverse direction: flax param tree → reference torch state_dict. Lets a
# model trained here be consumed by the reference's own tooling
# (TestModel.py loads this exact pickle layout, main_baseline.py:895-971).

def export_crnn(params: Mapping, stats: Mapping, n_blocks: int = 7,
                num_layers_rnn: int = 2, activation: str = "glu",
                fpn: bool = False) -> Dict[str, np.ndarray]:
    """(params, batch_stats) of the CRNN encoder → reference state_dict."""
    act = activation.lower()
    out: Dict[str, np.ndarray] = {}
    cnn_p, cnn_s = params["cnn"], stats["cnn"]
    for i in range(n_blocks):
        blk, blk_s = cnn_p[f"block{i}"], cnn_s[f"block{i}"]
        out[f"cnn.cnn.conv{i}.weight"] = np.transpose(
            np.asarray(blk["conv"]["kernel"]), (3, 2, 0, 1))
        out[f"cnn.cnn.conv{i}.bias"] = np.asarray(blk["conv"]["bias"])
        out[f"cnn.cnn.batchnorm{i}.weight"] = np.asarray(blk["bn"]["scale"])
        out[f"cnn.cnn.batchnorm{i}.bias"] = np.asarray(blk["bn"]["bias"])
        out[f"cnn.cnn.batchnorm{i}.running_mean"] = np.asarray(
            blk_s["bn"]["mean"])
        out[f"cnn.cnn.batchnorm{i}.running_var"] = np.asarray(
            blk_s["bn"]["var"])
        out[f"cnn.cnn.batchnorm{i}.num_batches_tracked"] = np.asarray(
            0, dtype=np.int64)
        if act in ("glu", "cg"):
            key = "GLU_0" if act == "glu" else "ContextGating_0"
            lin = blk[key]["linear"]
            out[f"cnn.cnn.{act}{i}.linear.weight"] = np.asarray(
                lin["kernel"]).T
            out[f"cnn.cnn.{act}{i}.linear.bias"] = np.asarray(lin["bias"])

    def put_gru(prefix, gru_params):
        for layer in range(num_layers_rnn):
            for suffix in ("", "_reverse"):
                for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    k = f"{kind}_l{layer}{suffix}"
                    out[prefix + k] = np.asarray(gru_params[k])

    put_gru("rnn.rnn.", params["rnn"])
    if fpn:
        blk = cnn_p["block_down"]
        out["cnn.cnn_fcn.weight"] = np.transpose(
            np.asarray(blk["conv"]["kernel"]), (3, 2, 0, 1))
        out["cnn.cnn_fcn.bias"] = np.asarray(blk["conv"]["bias"])
        out["cnn.bn_fcn.weight"] = np.asarray(blk["bn"]["scale"])
        out["cnn.bn_fcn.bias"] = np.asarray(blk["bn"]["bias"])
        out["cnn.bn_fcn.running_mean"] = np.asarray(
            cnn_s["block_down"]["bn"]["mean"])
        out["cnn.bn_fcn.running_var"] = np.asarray(
            cnn_s["block_down"]["bn"]["var"])
        out["cnn.bn_fcn.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
        out["cnn.glu.linear.weight"] = np.asarray(
            blk["GLU_0"]["linear"]["kernel"]).T
        out["cnn.glu.linear.bias"] = np.asarray(blk["GLU_0"]["linear"]["bias"])
        put_gru("rnn_2.rnn.", params["rnn_2"])
        put_gru("rnn_4.rnn.", params["rnn_4"])
        for tname, fname in (("conv1x1_2", "fuse_2"), ("conv1x1_4", "fuse_4")):
            w = np.asarray(params[fname]["kernel"]).T  # (out, in)
            out[f"{tname}.weight"] = w[:, :, None, None]
            out[f"{tname}.bias"] = np.asarray(params[fname]["bias"])
    return out


def export_predictor(params: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of convert_predictor: generic over the Predictor and
    Predictor_2 dense-layer trees (every leaf is a flax Dense named after
    its reference ``nn.Linear``)."""
    out: Dict[str, np.ndarray] = {}
    for name, leaf in params.items():
        if not (isinstance(leaf, Mapping) and "kernel" in leaf):
            raise ValueError(
                f"predictor param {name!r} is not a Dense leaf; only the "
                "'linear' and 'mlp' heads have a reference state_dict "
                "layout (the CRNN_pred conv head has none — its reference "
                "wiring is commented out)")
        out[f"{name}.weight"] = np.asarray(leaf["kernel"]).T
        out[f"{name}.bias"] = np.asarray(leaf["bias"])
    return out


def _tree_np(tree):
    """A nested dict of arrays as a new nested dict of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: _tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def convert_resnet18_tagger(state: Mapping[str, np.ndarray], params: Dict,
                            batch_stats: Dict) -> Tuple[Dict, Dict, list]:
    """Map a torchvision-style resnet18 state_dict onto ResNet18Tagger's
    trees (models/resnet.py), the reference's pretrained-weights path
    (audio_tagging_system_cnn.py:50-59: ``models.resnet18(pretrained=True)``
    with the stem conv REBUILT for 1-channel input and ``fc`` REBUILT for
    nclass outputs).

    ``params``/``batch_stats`` are the current (template) trees; entries
    whose torch counterpart is missing or shape-mismatched — the 3-channel
    ImageNet stem conv and the 1000-class fc, exactly the parts the
    reference re-initializes — keep their current values. Accepts both bare
    torchvision keys (``conv1.weight``) and the reference module's
    ``resnet.``-prefixed ones. Returns (params, batch_stats,
    skipped_keys)."""
    state = {k[len("resnet."):] if k.startswith("resnet.") else k: v
             for k, v in state.items()}
    params = _tree_np(params)
    batch_stats = _tree_np(batch_stats)
    skipped = []

    def put(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node[k]
        if node[path[-1]].shape != value.shape:
            skipped.append("/".join(path))
            return
        node[path[-1]] = value.astype(node[path[-1]].dtype)

    def put_conv(name_t, path):
        if name_t + ".weight" in state:
            put(params, path + ["kernel"],
                convert_conv(state[name_t + ".weight"])["kernel"])
        else:
            skipped.append("/".join(path))

    def put_bn(name_t, path):
        if name_t + ".weight" not in state:
            skipped.append("/".join(path))
            return
        p, s = convert_bn(state, name_t + ".")
        put(params, path + ["scale"], p["scale"])
        put(params, path + ["bias"], p["bias"])
        put(batch_stats, path + ["mean"], s["mean"])
        put(batch_stats, path + ["var"], s["var"])

    put_conv("conv1", ["stem_conv"])
    put_bn("bn1", ["stem_bn"])
    for s in range(4):
        for b in range(2):
            t = f"layer{s + 1}.{b}"
            f = f"layer{s + 1}_block{b}"
            put_conv(t + ".conv1", [f, "conv1"])
            put_bn(t + ".bn1", [f, "bn1"])
            put_conv(t + ".conv2", [f, "conv2"])
            put_bn(t + ".bn2", [f, "bn2"])
            if f"{t}.downsample.0.weight" in state and \
                    "downsample_conv" in params.get(f, {}):
                put_conv(t + ".downsample.0", [f, "downsample_conv"])
                put_bn(t + ".downsample.1", [f, "downsample_bn"])
    if "fc.weight" in state:
        d = convert_dense(state["fc.weight"], state.get("fc.bias"))
        put(params, ["fc", "kernel"], d["kernel"])
        if "bias" in d:
            put(params, ["fc", "bias"], d["bias"])
    else:
        skipped.append("fc")
    return params, batch_stats, skipped


def _clip_disc_dense_perm() -> np.ndarray:
    """Input-dim permutation between the two flatten orders of the clip
    discriminator's pooled (8-channel × 2-row) features.

    torch (CRNN_GRL.py:49): ``x.view(-1, C·H·W)`` on (B, 8, 2, 1) flattens
    channel-major — input index = c·2 + r. Ours
    (models/discriminators._ClipConvStack) stacks the two pooled rows then
    reshapes (B, 2, 8) → (B, 16) — index = r·8 + c. perm[ours] = torch."""
    return np.asarray([c * 2 + r for r in range(2) for c in range(8)])


def convert_clip_discriminator(state: Mapping[str, np.ndarray]
                               ) -> Tuple[Dict, Dict]:
    """torch ``Clip_Discriminator`` state_dict (CRNN_GRL.py:16-53) →
    (params, batch_stats) for models/discriminators.ClipDiscriminator."""
    convs_p, convs_s = {}, {}
    for i in range(1, 6):
        convs_p[f"conv_{i}"] = convert_conv(state[f"conv_{i}.weight"],
                                            state[f"conv_{i}.bias"])
        p, s = convert_bn(state, f"bn_{i}.")
        convs_p[f"bn_{i}"] = p
        convs_s[f"bn_{i}"] = s
    d = convert_dense(state["dense_d.weight"], state["dense_d.bias"])
    d["kernel"] = d["kernel"][_clip_disc_dense_perm()]
    return ({"convs": convs_p, "dense_d": d}, {"convs": convs_s})


def convert_frame_discriminator(state: Mapping[str, np.ndarray]) -> Dict:
    """torch ``Frame_Discriminator`` state_dict (the plain 3-dense MLP,
    CRNN_GRL.py:116-140 — also shape-compatible with the CRNN.py:91-112
    GRL flavor and our FrameDiscriminatorGRL) → flax params for
    models/discriminators.FrameDiscriminator: dense kernels transposed,
    names preserved."""
    return {name: convert_dense(state[f"{name}.weight"],
                                state[f"{name}.bias"])
            for name in ("dense_d_1", "dense_d_2", "dense_d_3")}


def export_frame_discriminator(params: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of convert_frame_discriminator (checkpoint contract's
    optional ``model_d`` entry for the frame-MLP flavors)."""
    out: Dict[str, np.ndarray] = {}
    for name in ("dense_d_1", "dense_d_2", "dense_d_3"):
        out[f"{name}.weight"] = np.asarray(params[name]["kernel"]).T
        out[f"{name}.bias"] = np.asarray(params[name]["bias"])
    return out


def export_clip_discriminator(params: Mapping, stats: Mapping
                              ) -> Dict[str, np.ndarray]:
    """Inverse of convert_clip_discriminator (for the checkpoint contract's
    optional ``model_d`` entry, main_baseline.py:914-922)."""
    out: Dict[str, np.ndarray] = {}
    for i in range(1, 6):
        blk = params["convs"][f"conv_{i}"]
        out[f"conv_{i}.weight"] = np.transpose(np.asarray(blk["kernel"]),
                                               (3, 2, 0, 1))
        out[f"conv_{i}.bias"] = np.asarray(blk["bias"])
        bn = params["convs"][f"bn_{i}"]
        out[f"bn_{i}.weight"] = np.asarray(bn["scale"])
        out[f"bn_{i}.bias"] = np.asarray(bn["bias"])
        st = stats["convs"][f"bn_{i}"]
        out[f"bn_{i}.running_mean"] = np.asarray(st["mean"])
        out[f"bn_{i}.running_var"] = np.asarray(st["var"])
        out[f"bn_{i}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    inv = np.argsort(_clip_disc_dense_perm())
    out["dense_d.weight"] = np.asarray(params["dense_d"]["kernel"])[inv].T
    out["dense_d.bias"] = np.asarray(params["dense_d"]["bias"])
    return out
