"""Folded-frequency stem, eval form: the leading conv blocks with mel bins
packed into the channel dimension.

Port of ``bsed_tpu/ops/folded_stem.py:build_folded_stem``. Pack ``f``
adjacent mel bins into channels — x[b,t,g*f+r,c] → xf[b,t,g,r*C+c] — and
each block becomes: a 3×3 conv over (T, group) with the folded kernel
(``fold_conv_kernel``), the eval BatchNorm folded into the conv, the
GLU/CG dense as a block-diagonal (f·C, f·C) matmul (``_block_diag``) and
the frequency pool as a lane-averaging matmul (``_freq_pool_matrix``).
Fold factors for the default config are 8 → 4 → 2 → 1 over blocks 0-2.

On NHWC memory the folded (B, T, F/f, f·C) and unfolded (B, T, F, C)
tensors are the same bytes, so fold and unfold are free reshapes. With
``fused_epilogue`` the bias → GLU/CG → time pool → frequency pool chain
after each conv is kernel K2 (``ops/stem_epilogue.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from bsed_tpu_torch.models.layers import conv2d_nhwc
from bsed_tpu_torch.ops.pooling import fast_avg_pool
from bsed_tpu_torch.ops.stem_epilogue import make_fused_epilogue
from bsed_tpu_torch.utils.device import resolve_device
from bsed_tpu_torch.utils.weights import conv_weight


def fold_conv_kernel(kernel: np.ndarray, f: int) -> np.ndarray:
    """(kt, 3, cin, cout) 3-tap-frequency kernel → (kt, 3, f*cin, f*cout)
    group-axis kernel computing the identical map on the folded layout."""
    kt, kf, cin, cout = kernel.shape
    if kf != 3:
        raise ValueError("folded stem supports 3-tap frequency kernels")
    out = np.zeros((kt, 3, f * cin, f * cout), kernel.dtype)
    for r_out in range(f):
        for d in (-1, 0, 1):
            s = r_out + d                       # input sub-position
            g = (s // f) + 1                    # group tap 0/1/2
            r_in = s % f
            out[:, g, r_in * cin:(r_in + 1) * cin,
                r_out * cout:(r_out + 1) * cout] = kernel[:, d + 1]
    return out


def _block_diag(mat: np.ndarray, f: int) -> np.ndarray:
    """(C, C') dense → (f*C, f*C') block-diagonal (per sub-position)."""
    c_in, c_out = mat.shape
    out = np.zeros((f * c_in, f * c_out), mat.dtype)
    for r in range(f):
        out[r * c_in:(r + 1) * c_in, r * c_out:(r + 1) * c_out] = mat
    return out


def _freq_pool_matrix(f: int, pf: int, c: int) -> np.ndarray:
    """((f*C), (f/pf)*C) matrix averaging pf adjacent sub-positions."""
    out = np.zeros((f * c, (f // pf) * c), np.float32)
    for r in range(f):
        q = r // pf
        for ch in range(c):
            out[r * c + ch, q * c + ch] = 1.0 / pf
    return out


def build_folded_stem(cnn_params: Dict, cnn_stats: Dict,
                      nb_filters: Sequence[int],
                      pooling: Sequence[Tuple[int, int]],
                      activation: str = "glu",
                      n_mels: int = 128, fold0: int = 8,
                      bn_eps: float = 1e-3,
                      dtype=None,
                      fused_epilogue: bool = False,
                      device="cuda",
                      use_kernels: bool = True) -> Tuple[Callable, int]:
    """Derive folded parameters for the leading blocks from the flax-layout
    trees and return ``(stem(mel (B,T,F,1)) -> (B,T',F',C'), n_folded)``.

    BatchNorm runs in eval mode (running stats) and dropout is the eval
    identity, so the stem is serving-only. ``use_kernels=False`` makes the
    fused epilogue run its plain version on any device."""
    if activation not in ("glu", "cg", "relu", "leakyrelu"):
        raise ValueError(f"unsupported activation {activation}")
    device = resolve_device(device)
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)

    blocks: List[Dict] = []
    f = fold0
    for i, (cout, (pt, pf)) in enumerate(zip(nb_filters, pooling)):
        if f == 1:
            break
        if f % pf != 0:
            raise ValueError(f"block{i}: pool {pf} does not divide fold {f}")
        p = cnn_params[f"block{i}"]
        s = cnn_stats[f"block{i}"]
        kernel = np.asarray(p["conv"]["kernel"], np.float32)
        bias = np.asarray(p["conv"]["bias"], np.float32)
        # eval-mode BN folded into the conv: y*scale + shift
        scale = (np.asarray(p["bn"]["scale"], np.float32)
                 / np.sqrt(np.asarray(s["bn"]["var"], np.float32) + bn_eps))
        shift = (np.asarray(p["bn"]["bias"], np.float32)
                 - np.asarray(s["bn"]["mean"], np.float32) * scale)
        kernel = kernel * scale[None, None, None, :]
        bias = bias * scale + shift

        blk = {"kernel": dev(conv_weight(fold_conv_kernel(kernel, f))),
               "bias": dev(np.tile(bias, f)),
               "pt": pt}
        if activation in ("glu", "cg"):
            act_key = "GLU_0" if activation == "glu" else "ContextGating_0"
            w = np.asarray(p[act_key]["linear"]["kernel"], np.float32)
            b = np.asarray(p[act_key]["linear"]["bias"], np.float32)
            blk["act_w"] = dev(_block_diag(w, f))
            blk["act_b"] = dev(np.tile(b, f))
        if pf > 1:
            blk["pool_w"] = dev(_freq_pool_matrix(f, pf, cout))
        if (fused_epilogue and activation in ("glu", "cg")
                and pf > 1 and pt in (1, 2)):
            # the eval-mode BN is already folded into the conv, so the
            # kernel's per-lane affine degenerates to inv=1, c=bias
            blk["ep"] = make_fused_epilogue(activation, pt, blk["pool_w"],
                                            use_kernel=use_kernels)
            blk["ones"] = torch.ones_like(blk["bias"])
        blocks.append(blk)
        f //= pf

    n_folded = len(blocks)
    f_rem = f
    c_last = nb_filters[n_folded - 1]

    def stem(mel: torch.Tensor) -> torch.Tensor:
        b, t, n_f, _ = mel.shape
        x = mel.reshape(b, t, n_f // fold0, fold0)
        if dtype is not None:
            x = x.to(dtype)
        for blk in blocks:
            x = conv2d_nhwc(x, blk["kernel"].to(x.dtype)).contiguous()
            if "ep" in blk:
                x = blk["ep"](x, blk["ones"], blk["bias"],
                              blk["act_w"].to(x.dtype), blk["act_b"])
                continue
            x = x + blk["bias"].to(x.dtype)
            if activation in ("glu", "cg"):
                lin = x @ blk["act_w"].to(x.dtype) + blk["act_b"].to(x.dtype)
                x = (lin * torch.sigmoid(x) if activation == "glu"
                     else x * torch.sigmoid(lin))
            elif activation == "relu":
                x = torch.relu(x)
            else:
                x = torch.nn.functional.leaky_relu(x, negative_slope=0.2)
            if blk["pt"] > 1:
                x = fast_avg_pool(x, (blk["pt"], 1))
            if "pool_w" in blk:
                x = x @ blk["pool_w"].to(x.dtype)
        # unfold (B, T', G, f_rem*C) → (B, T', G*f_rem, C)
        b2, t2, g, _ = x.shape
        return x.reshape(b2, t2, g * f_rem, c_last)

    return stem, n_folded
