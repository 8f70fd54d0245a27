"""Kernel K5: the fused eval stem, block 0 (conv3×3 1→16 + BatchNorm + GLU +
2×2 average pool) in one CUDA kernel.

Replaces the TPU kernel ``bsed_tpu/ops/stem_kernel.py:fused_stem_block``
(body ``_stem_kernel``). The CUDA source is ``csrc/stem_kernel.cu``.

With running statistics BatchNorm is affine, so block 0 folds into two
single-input-channel 3×3 convolutions (``fold_block0_params``):

    gate = conv(x, w_gate) + b_gate         (BN folded into the conv)
    lin  = conv(x, w_lin) + b_lin           (BN and the GLU dense folded in)
    out  = avg_pool_2x2(lin · σ(gate))      (floor: an odd last row drops)

Bound on the H100: operations. Per pixel 16 channels × 2 convs × 9 taps
(576 FLOP) against 4 bytes of log-mel in and 16 bytes of pooled output out
(B=64, T=1255: 5.9 GFLOP, 205 MB). Design: one thread block owns 4 pooled
rows of one clip; it stages the (2·4+2) × 130 halo tile of log-mel in
shared memory (zeros for the conv's padding) beside the 320 folded
parameters, and each of its 256 threads owns one pooled (t', f') position
for all 16 channels: a 4×4 input window in registers, both convs at the
four positions the pool averages, and one contiguous 64-byte store, so
adjacent threads write adjacent chunks of the channels-last output.

The plain PyTorch version is ``reference_stem_block`` (the port of the
JAX package's XLA reference); the wrapper takes it only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

N_MELS = 128
N_CH = 16


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
    x's dtype. CPU tensors take the plain version; CUDA tensors launch
    kernel K5 (csrc/stem_kernel.cu), which takes float32 only."""
    if x.device.type == "cpu":
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
    out = torch.empty((bsz, t // 2, N_MELS // 2, N_CH), device=x.device,
                      dtype=torch.float32)
    from bsed_tpu_torch import kernels
    fn = _bind(kernels.load("stem_kernel"))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), packed.data_ptr(), out.data_ptr(), bsz, t,
             t // 2, stream)
    kernels.check(err, "stem kernel")
    fused_stem_block.launches += 1
    return out


fused_stem_block.launches = 0
