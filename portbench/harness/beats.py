"""A configuration's BEATs encoder for the benchmark: its weights from the
seed and its model FLOPs.

Weights: the released checkpoint's state dict under its own key names
(``bsed_tpu_torch/utils/weights.load_beats``), float32 on the device from
one ``torch.Generator`` draw, scaled leaf by leaf as ``weights.py``
scales the CRNN's: fan-in normal for the patch convolution, the position
convolution's direction ``weight_v`` and every linear layer, biases ±
0.1, LayerNorm scales and the gates' ``grep_a`` 1 ± 0.1, the relative
position table unit normal (the size of the content scores q·kᵀ/√D),
and the weight norm's ``weight_g`` ‖v‖·(1 ± 0.1), so the folded weight is
fan-in normal too. The fusion's ``cat_tf`` goes into the encoder's tree
(``encoder.cat_tf``), fan-in normal.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from portbench.harness import weights as Wt

Leaf = Tuple[str, Tuple[int, ...], str]     # (state-dict key, shape, kind)


def _linear(name: str, n_in: int, n_out: int) -> List[Leaf]:
    return [(name + ".weight", (n_out, n_in), f"fan:{n_in}"),
            (name + ".bias", (n_out,), "small")]


def _norm(name: str, n: int) -> List[Leaf]:
    return [(name + ".weight", (n,), "one"), (name + ".bias", (n,), "small")]


def leaves(beats: Mapping) -> List[Leaf]:
    """Every parameter of the BEATs encoder, in a fixed order."""
    p, e = beats["input_patch_size"], beats["embed_dim"]
    d, h = beats["encoder_embed_dim"], beats["encoder_attention_heads"]
    k, g = beats["conv_pos"], beats["conv_pos_groups"]
    out = [("patch_embedding.weight", (e, 1, p, p), f"fan:{p * p}")]
    out += _norm("layer_norm", e) + _linear("post_extract_proj", e, d)
    out += [("encoder.pos_conv.0.weight_g", (1, 1, k), "one"),
            ("encoder.pos_conv.0.weight_v", (d, d // g, k),
             f"fan:{d // g * k}"),
            ("encoder.pos_conv.0.bias", (d,), "small")]
    out += _norm("encoder.layer_norm", d)
    for i in range(beats["encoder_layers"]):
        at = f"encoder.layers.{i}."
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            out += _linear(at + "self_attn." + proj, d, d)
        out += _linear(at + "self_attn.grep_linear", d // h, 8)
        out += [(at + "self_attn.grep_a", (1, h, 1, 1), "one")]
        if i == 0:
            out += [(at + "self_attn.relative_attention_bias.weight",
                     (beats["num_buckets"], h), "unit")]
        out += _norm(at + "self_attn_layer_norm", d)
        out += _linear(at + "fc1", d, beats["encoder_ffn_embed_dim"])
        out += _linear(at + "fc2", beats["encoder_ffn_embed_dim"], d)
        out += _norm(at + "final_layer_norm", d)
    return out


def make_params(config: Mapping, seed: int, beats_seed: int,
                device) -> Dict:
    """The CRNN's tree (``weights.make_params``) with ``beats`` (the state
    dict) and ``encoder.cat_tf``, float32 tensors on ``device``."""
    params = Wt.make_params(config["model"], seed, device)
    spec = leaves(config["beats"])
    c = config["model"]["nb_filters"][-1]
    n_in = c + config["beats"]["encoder_embed_dim"]
    spec += [("cat_tf.kernel", (n_in, c), f"fan:{n_in}"),
             ("cat_tf.bias", (c,), "small")]
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(beats_seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    sd, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        off, std = (0.0, 1.0) if kind == "unit" else Wt._scale(kind)
        sd[name] = flat[at:at + n].reshape(shape) * std + off
        at += n
    v = sd["encoder.pos_conv.0.weight_v"]
    sd["encoder.pos_conv.0.weight_g"] *= v.square().sum((0, 1),
                                                        keepdim=True).sqrt()
    params["encoder"]["cat_tf"] = {"kernel": sd.pop("cat_tf.kernel"),
                                   "bias": sd.pop("cat_tf.bias")}
    params["beats"] = sd
    return params


# --- model FLOPs ----------------------------------------------------------

def tokens(config: Mapping) -> Tuple[int, int]:
    """(time patches, frequency patches) of a clip: 10 s at 32 kHz is
    160,000 samples at 16 kHz, 998 fbank frames, 62 × 8 patches of 16."""
    a, b = config["audio"], config["beats"]
    n = (int(a["sr"] * a["max_len_seconds"]) + 1) // 2
    frames = 1 + (n - b["frame_length"]) // b["frame_shift"]
    p = b["input_patch_size"]
    return frames // p, b["num_mel_bins"] // p


def beats_flops(config: Mapping) -> Dict[str, float]:
    """FLOPs of one clip's BEATs encoder by part, 2 FLOP a multiply-add,
    from the configuration file's shapes. At BEATs' widths (L = 496, d =
    768, FFN 3072, 12 layers, E 512, patches 16, position convolution 128
    taps in 16 groups):

    * ``patches``: the patch convolution 2·L·p²·E (0.130 G) and the
      projection 2·L·E·d (0.390 G): 0.52 GFLOP;
    * ``pos_conv``: 2·L·d·(d/groups)·K = 4.68 GFLOP;
    * ``layers``: each 2·L·4d² for q, k, v, o (2.34 G), 2·2·L·d·FFN for
      fc1 and fc2 (4.68 G), 2·2·L²·d for q·kᵀ and the weights times v
      (0.756 G), and the gate's 2·L·d·8 (6 M): 7.78 GFLOP, × 12 = 93.3;

    98.5 GFLOP a clip. The fbank, the norms and the softmax are left out,
    as ``work.forward_flops`` leaves out the CRNN's elementwise work."""
    b = config["beats"]
    tp, fp = tokens(config)
    n, p = tp * fp, b["input_patch_size"]
    e, d = b["embed_dim"], b["encoder_embed_dim"]
    ffn = b["encoder_ffn_embed_dim"]
    layer = (2.0 * n * 4 * d * d + 2 * 2.0 * n * d * ffn
             + 2 * 2.0 * n * n * d + 2.0 * n * d * 8)
    return {"patches": 2.0 * n * p * p * e + 2.0 * n * e * d,
            "pos_conv": 2.0 * n * d * (d // b["conv_pos_groups"])
            * b["conv_pos"],
            "layers": b["encoder_layers"] * layer}


def fusion_flops(config: Mapping) -> float:
    """``cat_tf`` on the CNN's frames: 2·T'·(C + d)·C a clip."""
    from portbench.harness.work import n_frames
    m = config["model"]
    t = n_frames(config["audio"])
    for pt, _ in m["pooling"]:
        t //= pt
    c = m["nb_filters"][-1]
    return 2.0 * t * (c + config["beats"]["encoder_embed_dim"]) * c
