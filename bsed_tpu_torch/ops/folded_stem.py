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

``make_folded_train_stem`` is the train form (port of the JAX function of
that name): differentiable, on the standard ``ConvBlock`` parameters
(the kernel and the GLU dense are folded on the fly, so gradients land on
the original parameters), BatchNorm on batch statistics grouped over the
fold copies, dropout on the folded layout; with the fused epilogue its
forward is K2's train form and its backward kernel K3.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bsed_tpu_torch.models.layers import (batch_stats, conv2d_nhwc,
                                          update_running)
from bsed_tpu_torch.ops.dropout import _u8_threshold, draw_bits, dropout
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
                      device="cuda") -> Tuple[Callable, int]:
    """Derive folded parameters for the leading blocks from the flax-layout
    trees and return ``(stem(mel (B,T,F,1)) -> (B,T',F',C'), n_folded)``.

    BatchNorm runs in eval mode (running stats) and dropout is the eval
    identity, so the stem is serving-only."""
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
            blk["ep"] = make_fused_epilogue(activation, pt, blk["pool_w"])
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


# ---------------------------------------------------------------------------
# Train form: the same re-layout, differentiable, on the standard parameters.


@functools.lru_cache(maxsize=None)
def _fold_gather_idx(f: int, cin: int, cout: int) -> np.ndarray:
    """Constant index map realising fold_conv_kernel as ONE gather:
    idx[g, fi, fo] selects from the kernel flattened to (kt, 3·cin·cout)
    with a trailing zero slot."""
    idx = np.full((3, f * cin, f * cout), 3 * cin * cout, np.int64)
    for r_out in range(f):
        for d in (-1, 0, 1):
            s = r_out + d
            g = (s // f) + 1
            r_in = s % f
            for ci in range(cin):
                for co in range(cout):
                    idx[g, r_in * cin + ci, r_out * cout + co] = \
                        (d + 1) * cin * cout + ci * cout + co
    return idx.reshape(-1)


def _fold_gather_plan(f: int, cin: int, cout: int, device):
    """(pos, src, by_src) int64 tensors on ``device``: the folded kernel's
    flat positions that hold a tap, the flat index of the original kernel
    each one takes (``_fold_gather_idx`` without its zero slot), and the
    positions again grouped by tap (each tap has exactly ``f`` copies)."""
    idx = _fold_gather_idx(f, cin, cout)
    pos = np.nonzero(idx < 3 * cin * cout)[0]
    by_src = pos[np.argsort(idx[pos], kind="stable")]
    return tuple(torch.as_tensor(a, device=device)
                 for a in (pos, idx[pos], by_src))


class _FoldKernel(torch.autograd.Function):
    """The taps of a flat (kt, 3·cin·cout) kernel gathered into the flat
    folded kernel. Its backward sums each tap's ``f`` copies by a gather
    and a reduction, not by ``index_select``'s scatter-add: on CUDA that
    adds with atomics, in an order that changes from run to run, and two
    runs of one train step would differ in the last bits."""

    @staticmethod
    def forward(ctx, flat, pos, src, by_src, n_out: int):
        ctx.save_for_backward(by_src)
        ctx.n_taps = flat.shape[1]
        taps = flat.index_select(1, src)
        return flat.new_zeros((flat.shape[0], n_out)).index_copy(
            1, pos, taps)

    @staticmethod
    def backward(ctx, grad):
        by_src, = ctx.saved_tensors
        kt = grad.shape[0]
        g = grad.index_select(1, by_src).reshape(kt, ctx.n_taps, -1)
        return g.sum(-1), None, None, None, None


def _fold_kernel_torch(kernel: torch.Tensor, f: int, pos: torch.Tensor,
                       src: torch.Tensor, by_src: torch.Tensor
                       ) -> torch.Tensor:
    """Differentiable fold_conv_kernel on an HWIO (kt, 3, cin, cout)
    kernel → (kt, 3, f·cin, f·cout): one constant-index gather of the taps
    copied into zeros; the backward sums each tap's f fold copies in a
    fixed order (``_FoldKernel``). ``pos``, ``src``, ``by_src``:
    ``_fold_gather_plan(f, cin, cout, device)``."""
    kt, _, cin, cout = kernel.shape
    out = _FoldKernel.apply(kernel.reshape(kt, 3 * cin * cout), pos, src,
                            by_src, 3 * f * cin * f * cout)
    return out.reshape(kt, 3, f * cin, f * cout)


def bn_affine(bn, bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm ``bn`` of h + ``bias`` under statistics (mean, var) as the
    epilogue's per-lane affine h·inv + c: inv = γ·rsqrt(var + ε),
    c = (bias − mean)·inv + β."""
    inv = bn.weight * torch.rsqrt(var + eps)
    return inv, (bias - mean) * inv + bn.bias


def folded_train_eligible(model_cfg, n_mels: int, fold0: int = 8) -> bool:
    """Whether the train-form folded stem can run this topology (non-FPN,
    kernel 3, glu/cg/relu/leakyrelu, each leading frequency pool dividing
    the running fold)."""
    if (model_cfg.use_fpn or model_cfg.kernel_size != 3
            or model_cfg.activation not in ("glu", "cg", "relu", "leakyrelu")
            or n_mels % fold0 != 0):
        return False
    f = fold0
    for _, pf in (tuple(p) for p in model_cfg.pooling):
        if f == 1:
            break
        if pf == 0 or f % pf != 0:
            return False
        f //= pf
    return True


def make_folded_train_stem(model_cfg, n_mels: int, fold0: int = 8,
                           bn_eps: float = 1e-3, device="cuda"):
    """(apply, n_folded) where ``apply(blocks, x, train, gen) -> h`` runs
    the leading foldable blocks on the folded layout from the standard
    ``ConvBlock`` modules ``blocks['block{i}']`` (conv, bn, act.linear).

    BatchNorm matches the JAX stem: in training the batch statistics are
    the biased mean/var per original channel over (batch, time, freq), a
    reduction grouped over the fold copies, in float32, and the blocks'
    running statistics are updated in place (``update_running``). With ``model_cfg.fused_stem_epilogue``
    each eligible block's epilogue is ``make_fused_epilogue``'s (K2/K3 or
    their plain versions); dropout bits are drawn from ``gen`` on the folded
    layout before the epilogue, one (B, T·G, L) uint8 tensor per block."""
    from bsed_tpu_torch.ops.stem_epilogue import make_fused_epilogue

    act = model_cfg.activation
    rate = model_cfg.dropout
    dtype = (torch.bfloat16 if model_cfg.compute_dtype == "bfloat16"
             else torch.float32)

    def _ep_ok(pt):
        return (model_cfg.fused_stem_epilogue and act in ("glu", "cg")
                and pt in (1, 2)
                and (rate == 0 or _u8_threshold(1.0 - rate)))

    plan: List[Tuple] = []
    f = fold0
    cin = 1
    for i, (cout, (pt, pf)) in enumerate(zip(model_cfg.nb_filters,
                                             model_cfg.pooling)):
        if f == 1:
            break
        if f % pf != 0:
            raise ValueError(f"block{i}: pool {pf} does not divide fold {f}")
        pool_w = (torch.as_tensor(_freq_pool_matrix(f, pf, cout),
                                  device=device) if pf > 1 else None)
        eps = None
        if _ep_ok(pt) and pool_w is not None:
            eps = (make_fused_epilogue(act, pt, pool_w, rate=rate),
                   make_fused_epilogue(act, pt, pool_w, rate=0.0))
        plan.append((i, cout, pt, f, pool_w,
                     _fold_gather_plan(f, cin, cout, device), eps))
        f //= pf
        cin = cout
    n_folded = len(plan)
    f_rem = f
    c_last = model_cfg.nb_filters[n_folded - 1]

    def _stats(bn, h, fi, shift, train):
        """(mean, var) for this block's normalisation; the running ones
        are updated in training. ``shift`` (the conv bias, or None) is
        added to the mean of a pre-bias activation."""
        if not train:
            return bn.running_mean, bn.running_var
        mean, var, n = batch_stats(h, groups=fi, group=bn.group)
        if shift is not None:
            mean = mean + shift
        update_running(bn.running_mean, bn.running_var, mean.detach(),
                       var.detach(), n)
        return mean, var

    def apply(blocks: Mapping, x: torch.Tensor, train: bool,
              gen: Optional[torch.Generator]) -> torch.Tensor:
        b, t, n_f, _ = x.shape
        h = x.reshape(b, t, n_f // fold0, fold0).to(dtype)
        for (i, co, pt, fi, pool_w, gather, eps) in plan:
            blk = blocks[f"block{i}"]
            k = _fold_kernel_torch(blk.conv.weight.permute(2, 3, 1, 0)
                                   .to(dtype), fi, *gather)
            h = conv2d_nhwc(h, k.permute(3, 2, 0, 1)).contiguous()
            bn = blk.bn
            if eps is not None:
                # bias stays out of the conv output: it folds into the
                # epilogue's per-lane affine c; the batch mean shifts by
                # it and the variance does not see it
                bias = blk.conv.bias
                mean, var = _stats(bn, h, fi, bias, train)
                inv, cvec = bn_affine(bn, bias, mean, var, bn_eps)
                lin = blk.act.linear
                w = torch.block_diag(*[lin.weight.t().to(dtype)] * fi)
                b_t = lin.bias.repeat(fi)
                if train and rate > 0:
                    bits = draw_bits(gen, (h.shape[0], h.shape[1] * h.shape[2],
                                           h.shape[3]), h.device)
                    h = eps[0](h, inv.repeat(fi), cvec.repeat(fi), w, b_t,
                               bits)
                else:
                    h = eps[1](h, inv.repeat(fi), cvec.repeat(fi), w, b_t)
                continue

            h = h + blk.conv.bias.repeat(fi).to(h.dtype)
            mean, var = _stats(bn, h, fi, None, train)
            inv = bn.weight * torch.rsqrt(var + bn_eps)
            h = ((h - mean.repeat(fi).to(h.dtype)) * inv.repeat(fi).to(h.dtype)
                 + bn.bias.repeat(fi).to(h.dtype))
            if act in ("glu", "cg"):
                lin = blk.act.linear
                w = torch.block_diag(*[lin.weight.t().to(dtype)] * fi)
                z = h @ w + lin.bias.repeat(fi).to(h.dtype)
                h = (z * torch.sigmoid(h) if act == "glu"
                     else h * torch.sigmoid(z))
            elif act == "relu":
                h = torch.relu(h)
            else:
                h = F.leaky_relu(h, negative_slope=0.2)
            if train and rate > 0:
                h = dropout(gen, h, rate)
            if pt > 1:
                h = fast_avg_pool(h, (pt, 1))
            if pool_w is not None:
                h = h @ pool_w.to(h.dtype)

        # unfold (B, T', G, f_rem·C) → (B, T', G·f_rem, C)
        b2, t2, g2, _ = h.shape
        return h.reshape(b2, t2, g2 * f_rem, c_last)

    return apply, n_folded
