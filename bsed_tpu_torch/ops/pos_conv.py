"""BEATs' position convolution with its residual (``models/beats.py``):
y = x + GELU(conv(x) + bias), conv the grouped ``Conv1d(d, d, K,
groups)`` over the tokens, zero-padded K // 2 on each side, output t =
Σ_k w[k]·x[t + k − K // 2] for t < L (SamePad drops the convolution's
last output at even K). x and y are (B, L, d), the model's token-major
layout.

``pos_conv_residual`` is the entry ``BEATs.embed`` calls (looked up at
call time, so a profiler's wrapper or a test can stand in its place).
Where ``kernels.launches_on`` says so (CUDA tensors) it launches one
hand-written kernel (``csrc/pos_conv.cu``: bfloat16 an implicit GEMM on
TMA and ``wgmma`` over overlapping token rows, bias, GELU and the
residual in its epilogue; float32 on FMA), counting each launch on
``pos_conv_residual.launches``. Otherwise it takes
``pos_conv_residual_plain``, the same written out in float32, and counts
no launch. No TPU kernel is replaced: ``bsed_tpu`` has no BEATs.

The bfloat16 body reads the weights re-laid (``pack_weight``): for each
group and chunk of ``chunk_width`` output channels, the K = taps × d/g
inputs in the order k·(d/g) + c, zero-padded to whole stages of
``STAGE_K``, in wgmma's core-matrix layout (a stage is one contiguous
block of ``STAGE_K`` × width). A caller re-lays them once and passes
them in (``BEATs.pos_conv_weight``); without them the entry re-lays on
each call.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from bsed_tpu_torch import kernels
from bsed_tpu_torch.utils.device import float32_precision

TOKENS = 512          # tokens a block of the bfloat16 body
STAGE_K = 128         # K-elements a stage of its weight ring
RING = 6              # stages in the ring
SLAB_BOX = 128        # rows of x a TMA box; the slab is whole boxes
SMEM_MAX = 232448     # dynamic shared memory of a block on the H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pos_conv_residual_plain(x, weight, bias, groups: int) -> torch.Tensor:
    """The same in float32 (TF32 off on the card), cast back to x's
    dtype."""
    with float32_precision("highest"):
        c = F.conv1d(x.float().transpose(1, 2), weight.float(), bias.float(),
                     padding=weight.shape[-1] // 2, groups=groups)
    y = x.float() + F.gelu(c[..., :x.shape[1]]).transpose(1, 2)
    return y.to(x.dtype)


def chunk_width(cg: int) -> int:
    """Output channels a block of the bfloat16 body computes (its wgmma's
    N) for ``cg`` channels a group: 48 where 48 divides it (BEATs' d/g),
    else 16."""
    return 48 if cg % 48 == 0 else 16


def slab_rows(taps: int) -> int:
    """Rows of x a bfloat16 block holds: its tokens and the taps' reach,
    in whole TMA boxes."""
    return -(-(TOKENS + taps - 1) // SLAB_BOX) * SLAB_BOX


def stages(taps: int, cg: int) -> int:
    """Stages of the weight ring a block streams: taps·cg K-elements."""
    return -(-(taps * cg) // STAGE_K)


def shared_bytes(cg: int, taps: int) -> int:
    """Dynamic shared memory of a bfloat16 block: the slab, the ring, its
    barriers and the alignment's slack (``csrc/pos_conv.cu``)."""
    return (cg * slab_rows(taps) * 2 + RING * STAGE_K * chunk_width(cg) * 2
            + (2 * RING + 1) * 8 + 1024)


def pack_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """``weight`` (d, d/g, K) as the kernel of its dtype reads it. float32:
    as it is, contiguous. bfloat16: (groups, d/g / width, Kp / 8, width,
    8), element (g, j, i, n, e) the weight of output channel g·(d/g) +
    j·width + n at K-index 8i + e = k·(d/g) + c, zeros past taps·(d/g) up
    to Kp, whole stages."""
    if weight.dtype != torch.bfloat16:
        return weight.contiguous()
    d, cg, taps = weight.shape
    nc = chunk_width(cg)
    kp = stages(taps, cg) * STAGE_K
    w = weight.reshape(groups, cg, cg, taps).transpose(2, 3)
    w = F.pad(w.reshape(groups, cg, taps * cg), (0, kp - taps * cg))
    return (w.reshape(groups, cg // nc, nc, kp // 8, 8)
            .transpose(2, 3).contiguous())


def packed_shape(weight: torch.Tensor, groups: int) -> torch.Size:
    """The shape of ``pack_weight(weight, groups)``."""
    if weight.dtype != torch.bfloat16:
        return weight.shape
    _, cg, taps = weight.shape
    nc = chunk_width(cg)
    return torch.Size((groups, cg // nc, stages(taps, cg) * STAGE_K // 8,
                       nc, 8))


def _check(x, weight, bias, groups) -> None:
    """Raise on what neither body takes."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"pos_conv_residual's kernel takes float32 or "
                         f"bfloat16, got {x.dtype}")
    if x.ndim != 3 or weight.ndim != 3 or groups <= 0:
        raise ValueError(f"pos_conv_residual: x (B, L, d), weight (d, d/g, "
                         f"K); got {tuple(x.shape)}, {tuple(weight.shape)}")
    d, cg, taps = weight.shape
    if x.shape[-1] != d or d != groups * cg or bias.shape != (d,):
        raise ValueError(f"pos_conv_residual: x (B, L, {d}) for a weight "
                         f"(d, d/{groups}, K) and bias (d,); got "
                         f"{[tuple(t.shape) for t in (x, weight, bias)]}")
    if any(t.device != x.device or t.dtype != x.dtype
           for t in (weight, bias)):
        raise ValueError("pos_conv_residual: the weight and bias must be "
                         "on x's device, in x's dtype")
    if x.dtype == torch.bfloat16:
        if cg % 16:
            raise ValueError(f"pos_conv_residual's bfloat16 kernel takes "
                             f"channels a group in multiples of 16; got "
                             f"{cg}")
        if shared_bytes(cg, taps) > SMEM_MAX:
            raise ValueError(f"pos_conv_residual's bfloat16 kernel holds "
                             f"{cg} channels × {slab_rows(taps)} rows in "
                             f"shared memory: {shared_bytes(cg, taps)} "
                             f"bytes, more than {SMEM_MAX}")


def _bind(lib: ctypes.CDLL):
    """The C entry ``bsed_pos_conv`` of a built library, typed."""
    fn = lib.bsed_pos_conv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return fn


_FN = []


def _bound():
    """The C entry of the kernel, bound once."""
    if not _FN:
        _FN.append(_bind(kernels.load("pos_conv")))
    return _FN[0]


def pos_conv_residual(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, groups: int,
                      packed: torch.Tensor = None) -> torch.Tensor:
    """x (B, L, d), weight (d, d/groups, K), bias (d,) → x + GELU(conv(x)
    + bias), (B, L, d) in x's dtype. ``packed``: ``pack_weight(weight,
    groups)``, where the caller keeps it."""
    if not kernels.launches_on(x.device):
        return pos_conv_residual_plain(x, weight, bias, groups)
    _check(x, weight, bias, groups)
    if packed is None:
        packed = pack_weight(weight, groups)
    elif (packed.device != x.device or packed.dtype != x.dtype
          or not packed.is_contiguous()
          or packed.shape != packed_shape(weight, groups)):
        raise ValueError("pos_conv_residual: packed is not "
                         "pack_weight(weight, groups)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    bias = bias.contiguous()
    b, n, d = x.shape
    out = torch.empty_like(x)
    err = _bound()(x.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), _DTYPES[x.dtype], b, n, d, groups,
                   weight.shape[-1], chunk_width(d // groups),
                   torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "pos_conv_residual kernel")
    pos_conv_residual.launches += 1
    return out


pos_conv_residual.launches = 0
