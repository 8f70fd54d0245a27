"""Kernel K5: the fused eval stem, block 0 (conv3×3 1→16 + BatchNorm + GLU +
2×2 average pool) in one CUDA kernel.

Replaces the TPU kernel ``bsed_tpu/ops/stem_kernel.py:fused_stem_block``
(body ``_stem_kernel``). The CUDA source is ``csrc/stem_kernel.cu``.

With running statistics BatchNorm is affine, so block 0 folds into two
single-input-channel 3×3 convolutions (``fold_block0_params``):

    gate = conv(x, w_gate) + b_gate         (BN folded into the conv)
    lin  = conv(x, w_lin) + b_lin           (BN and the GLU dense folded in)
    out  = avg_pool_2x2(lin · σ(gate))      (floor: an odd last row drops)

Bound on the H100: operations. Per pixel 16 channels × (2 convs × 9 taps
+ a sigmoid) (672 FLOP) against 4 bytes of log-mel in and 4 bytes a
channel of pooled output out (B=64, T=1255: 6.9 GFLOP, 205 MB). Design:
persistent blocks of 512 threads, one an SM, walk over work items of
``ROWS_PER_ITEM`` pooled rows of one clip (``work_items``); an item's halo
tile of log-mel arrives by ``cp.async`` into a 2-deep ring
(``ring_shared_memory``) while the previous item computes, and a thread
keeps the taps and biases of 2 channels in registers, walks down the
item's rows with its 4×4 input window and takes the sigmoid on the MUFU
approximations (``ex2``, ``rcp``). See the source for the layout.

The plain PyTorch version is ``reference_stem_block`` (the port of the
JAX package's XLA reference); the wrapper takes it where
``kernels.launches_on`` says not to launch (CPU tensors).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from bsed_tpu_torch import kernels

N_MELS = 128
N_CH = 16
N_PACKED = 2 * 9 * N_CH + 2 * N_CH     # w_gate, w_lin, b_gate, b_lin
ROWS_PER_ITEM = 16       # pooled rows of a work item (RT, csrc/stem_kernel.cu)
_ROW_FLOATS = 136        # floats of a staged row: f = -1 .. 128 at 3 .. 132


def ring_shared_memory() -> int:
    """Bytes of K5's dynamic shared memory: two stages of an item's halo
    tile, (2·ROWS_PER_ITEM + 2) rows of ``_ROW_FLOATS`` float32 (the C
    entry ``bsed_stem_smem_bytes`` reports the same on the card)."""
    return 2 * (2 * ROWS_PER_ITEM + 2) * _ROW_FLOATS * 4


def work_items(batch: int, frames: int, blocks: int) -> List[List[tuple]]:
    """The walk of K5's persistent blocks, as the kernel computes it: for
    each of ``blocks`` blocks the (clip, first pooled row, rows) of the
    items it takes, item i = block + k·blocks of batch · ⌈(T//2) /
    ROWS_PER_ITEM⌉ items, clip-major."""
    t_out = frames // 2
    tiles = -(-t_out // ROWS_PER_ITEM)
    walk = []
    for blk in range(blocks):
        mine = []
        for item in range(blk, batch * tiles, blocks):
            t0 = (item % tiles) * ROWS_PER_ITEM
            mine.append((item // tiles, t0, min(ROWS_PER_ITEM, t_out - t0)))
        walk.append(mine)
    return walk


def fold_block0_params(block_params: Mapping, block_stats: Mapping,
                       eps: float = 1e-3, device="cpu"
                       ) -> Dict[str, torch.Tensor]:
    """Fold conv bias + BN (eval affine) + GLU dense into two conv kernels.

    ``block_params``/``block_stats`` are block 0 of the flax-layout trees
    (``utils/weights.py``): conv.kernel (3, 3, 1, 16), conv.bias, bn.scale,
    bn.bias, GLU_0.linear.kernel (16, 16) and bias; bn.mean, bn.var.
    Returns float32 tensors on ``device``: w_gate, w_lin (3, 3, 16),
    b_gate, b_lin (16,), and ``packed``, the 320 values in the kernel's
    order (w_gate, w_lin, b_gate, b_lin)."""
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    w = f32(block_params["conv"]["kernel"])[:, :, 0, :]
    b = f32(block_params["conv"]["bias"])
    s = f32(block_params["bn"]["scale"]) / np.sqrt(
        f32(block_stats["bn"]["var"]) + np.float32(eps))
    t = f32(block_params["bn"]["bias"]) - f32(block_stats["bn"]["mean"]) * s
    g_kernel = f32(block_params["GLU_0"]["linear"]["kernel"])
    g_bias = f32(block_params["GLU_0"]["linear"]["bias"])
    w_gate = w * s
    b_gate = b * s + t
    folded = {"w_gate": w_gate, "b_gate": b_gate,
              "w_lin": np.einsum("hwo,op->hwp", w_gate, g_kernel),
              "b_lin": b_gate @ g_kernel + g_bias}
    out = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
           for k, v in folded.items()}
    out["packed"] = torch.cat([out[k].reshape(-1) for k in
                               ("w_gate", "w_lin", "b_gate", "b_lin")])
    return out


def reference_stem_block(x: torch.Tensor,
                         folded: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The plain PyTorch version: (B, T, F, 1) → (B, T//2, F//2, 16), the
    same folded computation as nine shifted multiply-adds per conv."""
    t, f = x.shape[1], x.shape[2]
    xp = F.pad(x[..., 0], (1, 1, 1, 1))
    gate = lin = None
    for dt in range(3):
        for df in range(3):
            win = xp[:, dt:dt + t, df:df + f, None]
            g = win * folded["w_gate"][dt, df]
            l = win * folded["w_lin"][dt, df]
            gate = g if gate is None else gate + g
            lin = l if lin is None else lin + l
    act = (lin + folded["b_lin"]) * torch.sigmoid(gate + folded["b_gate"])
    act = act[:, :(t // 2) * 2, :(f // 2) * 2]
    return 0.25 * (act[:, 0::2, 0::2] + act[:, 0::2, 1::2]
                   + act[:, 1::2, 0::2] + act[:, 1::2, 1::2])


def _bind(lib):
    fn = lib.bsed_stem_block
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return fn


def fused_stem_block(x: torch.Tensor,
                     folded: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, T, 128, 1) log-mel → (B, T//2, 64, 16) block-0 output (eval), in
    x's dtype: kernel K5 (csrc/stem_kernel.cu, float32 only) where
    ``kernels.launches_on`` says so, else the plain version."""
    if not kernels.launches_on(x.device):
        return reference_stem_block(x, folded)
    if x.device.type != "cuda":
        raise ValueError(f"stem kernel runs on CUDA, got {x.device}")
    if (x.ndim != 4 or x.shape[2] != N_MELS or x.shape[3] != 1
            or x.dtype != torch.float32):
        raise ValueError(f"stem kernel is specialised to float32 "
                         f"(B, T, {N_MELS}, 1) log-mel, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if folded["w_gate"].shape != (3, 3, N_CH):
        raise ValueError(f"stem kernel is specialised to {N_CH} channels")
    packed = folded["packed"]
    if packed.device != x.device or packed.dtype != torch.float32:
        raise ValueError("folded stem parameters must be float32 on "
                         f"{x.device}")
    bsz, t = x.shape[:2]
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("stem kernel needs 16-byte aligned log-mel")
    out = torch.empty((bsz, t // 2, N_MELS // 2, N_CH), device=x.device,
                      dtype=torch.float32)
    fn = _bind(kernels.load("stem_kernel"))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), packed.data_ptr(), out.data_ptr(), bsz, t,
             t // 2, stream)
    kernels.check(err, "stem kernel")
    fused_stem_block.launches += 1
    return out


fused_stem_block.launches = 0
