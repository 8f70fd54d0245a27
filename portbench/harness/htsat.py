"""A configuration's HTS-AT for the benchmark: its weights from the seed,
bn0's statistics from the cell's audio, and its model FLOPs.

Weights: the published state dict's key names
(``bsed_tpu_torch/utils/weights.load_htsat``), float32 on the device from
one ``torch.Generator`` draw, scaled leaf by leaf as ``weights.py``
scales the CRNN's: fan-in normal for the patch convolution, every linear
layer and ``tscam_conv``, biases ± 0.1, LayerNorm and bn0 scales 1 ± 0.1,
and each block's relative-position table unit normal (the size of the
content scores q·kᵀ/√d).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from portbench.harness import weights as Wt
from portbench.harness.beats import Leaf, _linear, _norm


def stages(config: Mapping) -> List[Tuple[int, int, int, int, int]]:
    """(side, dim, heads, depth, window) of each stage: the token map's
    side, the width, the heads, the blocks and the window's side (the
    map's where it is no larger)."""
    h = config["htsat"]
    side = h["spec_size"] // h["patch_stride"]
    out = []
    for i, (depth, heads) in enumerate(zip(h["depths"], h["num_heads"])):
        s = side >> i
        out.append((s, h["embed_dim"] * 2 ** i, heads, depth,
                    min(h["window_size"], s)))
    return out


def leaves(config: Mapping) -> List[Leaf]:
    """Every parameter of HTS-AT, in a fixed order."""
    h, nclass = config["htsat"], config["nclass"]
    p, e, mels = h["patch_size"], h["embed_dim"], config["audio"]["n_mels"]
    out = _norm("bn0", mels)
    out += [("patch_embed.proj.weight", (e, 1, p, p), f"fan:{p * p}"),
            ("patch_embed.proj.bias", (e,), "small")]
    out += _norm("patch_embed.norm", e)
    st = stages(config)
    for i, (side, dim, heads, depth, w) in enumerate(st):
        hidden = int(dim * h["mlp_ratio"])
        for j in range(depth):
            at = f"layers.{i}.blocks.{j}."
            out += _norm(at + "norm1", dim)
            out += [(at + "attn.relative_position_bias_table",
                     ((2 * w - 1) ** 2, heads), "unit")]
            out += _linear(at + "attn.qkv", dim, 3 * dim)
            out += _linear(at + "attn.proj", dim, dim)
            out += _norm(at + "norm2", dim)
            out += _linear(at + "mlp.fc1", dim, hidden)
            out += _linear(at + "mlp.fc2", hidden, dim)
        if i < len(st) - 1:
            at = f"layers.{i}.downsample."
            out += [(at + "reduction.weight", (2 * dim, 4 * dim),
                     f"fan:{4 * dim}")]
            out += _norm(at + "norm", 4 * dim)
    side, c = st[-1][0], st[-1][1]
    rows = side // (h["spec_size"] // mels)
    out += _norm("norm", c)
    out += [("tscam_conv.weight", (nclass, c, rows, 3), f"fan:{c * rows * 3}"),
            ("tscam_conv.bias", (nclass,), "small")]
    return out


def make_params(config: Mapping, seed: int, device) -> Dict:
    """``{"htsat": state dict}``, float32 tensors on ``device``."""
    spec = leaves(config)
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    sd, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        off, std = (0.0, 1.0) if kind == "unit" else Wt._scale(kind)
        sd[name] = flat[at:at + n].reshape(shape) * std + off
        at += n
    return {"htsat": sd}


def bn0_stats(log_mel: torch.Tensor) -> Dict:
    """``{"htsat": bn0's statistics}``: each mel bin's mean and variance
    over the clips and frames of ``log_mel`` (B, T, F)."""
    x = log_mel.double()
    return {"htsat": {"bn0.running_mean": x.mean((0, 1)).float(),
                      "bn0.running_var": x.var((0, 1)).float()}}


# --- model FLOPs ----------------------------------------------------------

def htsat_flops(config: Mapping) -> Dict[str, float]:
    """FLOPs of one clip's HTS-AT by part, 2 FLOP a multiply-add, from the
    configuration file's shapes. At the published widths (256 × 256
    image, patches of 4 to d = 96, stages of 64², 32², 16², 8² tokens at
    96-768 wide, 2/2/6/2 blocks, windows of 64 tokens, MLP 4d):

    * ``patch_embed``: 2·L·p²·E = 0.0126 G;
    * ``blocks``: each 2·L·d·3d (qkv) + 2·L·d² (proj) + 2·2·L·4d² (the
      MLP) + 2·2·L·N·d (q·kᵀ and the weights times v over a window's N
      tokens): 2.01, 1.91, 5.59 and 1.84 G by stage;
    * ``merges``: 2·(L/4)·4d·2d each, 0.151 G × 3;
    * ``head``: ``tscam_conv``, 2·steps·C·rows·3·classes = 0.0059 G;

    11.8 GFLOP a clip. The norms, GELU, softmax, rolls and copies are left
    out, as ``work.forward_flops`` leaves out the CRNN's elementwise
    work."""
    h = config["htsat"]
    p, e = h["patch_size"], h["embed_dim"]
    st = stages(config)
    blocks = merges = 0.0
    for i, (side, d, heads, depth, w) in enumerate(st):
        n = side * side
        hidden = int(d * h["mlp_ratio"])
        blocks += depth * (2.0 * n * d * 3 * d + 2.0 * n * d * d
                           + 2 * 2.0 * n * d * hidden
                           + 2 * 2.0 * n * w * w * d)
        if i < len(st) - 1:
            merges += 2.0 * (n // 4) * 4 * d * 2 * d
    side, c = st[-1][0], st[-1][1]
    r = h["spec_size"] // config["audio"]["n_mels"]
    steps, rows = r * side, side // r
    return {"patch_embed": 2.0 * st[0][0] ** 2 * p * p * e,
            "blocks": blocks, "merges": merges,
            "head": 2.0 * steps * c * rows * 3 * config["nclass"]}


def frontend_flops(config: Mapping) -> float:
    """The dense front end's products a clip: the DFT, 2·T·N·(N/2 + 1)
    twice (cosine and sine), and the mel, 2·T·(N/2 + 1)·F."""
    a = config["audio"]
    n = a["n_window"]
    t = 1 + int(a["sr"] * a["max_len_seconds"]) // a["hop_size"]
    bins = n // 2 + 1
    return 2 * 2.0 * t * n * bins + 2.0 * t * bins * a["n_mels"]
