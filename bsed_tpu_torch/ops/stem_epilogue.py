"""Kernel K2: fused folded-stem epilogue, forward.

Replaces the TPU kernel ``bsed_tpu/ops/stem_epilogue.py:make_fused_epilogue``
(``_run_fwd``, body ``_fwd_kernel``) in its serving form. The CUDA source is
``csrc/stem_epilogue.cu``.

For a conv output h (B, T, G=16, L=128) without bias it computes

    y = h·inv + c;  GLU z = (y@w + b)·σ(y)  or  CG z = y·σ(y@w + b);
    time avg-pool pt ∈ {1, 2} (VALID, the odd last row dropped);
    frequency pool z @ pool_w  → (B, T//pt, G, L/2)

with elementwise math in float32, matmul operands in the input dtype and
float32 accumulation, and the output in the input dtype, as the TPU kernel
does. In the serving stem inv = 1 and c is the conv bias (the eval-mode
BatchNorm is folded into the conv).

Bound on the H100: device memory for the work (h read once, the output
written once; ~0.74 GB per batch-64 bf16 forward over blocks 0-2), but the
first kernel runs its 128×128 product in float32 FMA, which costs more
than the bytes. Design: persistent blocks hold w in shared memory and walk
over contiguous panels of 4 time rows × 16 groups × 128 lanes; each thread
owns 4 time rows of one group and the lane pairs ``pool_w`` averages, so
the time and frequency pools happen in registers and h is read once.

``pool_w`` must be the folded stem's pair-averaging matrix
(``ops/folded_stem._freq_pool_matrix(f, 2, c)``): the kernel computes that
matmul as the pair average it is. The dropout (``bits``) and group-pool
(``pg``) forms of the TPU kernel belong to the training step and are not
ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from bsed_tpu_torch.ops.pooling import fast_avg_pool

L, G = 128, 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"glu": 0, "cg": 1}


def stem_epilogue_plain(h, inv, c, w, b, act: str, pt: int,
                        pool_w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the unfused chain, every op in h's dtype
    (as the unfused folded stem composes it)."""
    dt = h.dtype
    y = h * inv.to(dt) + c.to(dt)
    lin = y @ w.to(dt) + b.to(dt)
    z = lin * torch.sigmoid(y) if act == "glu" else y * torch.sigmoid(lin)
    if pt > 1:
        z = fast_avg_pool(z, (pt, 1))
    return z @ pool_w.to(dt)


def pair_pool_channels(pool_w: np.ndarray) -> int:
    """The channels per fold copy ``c`` for which ``pool_w`` equals the
    pair-averaging matrix ``_freq_pool_matrix(L // c, 2, c)``; raises
    ValueError if it is no such matrix."""
    pool_w = np.asarray(pool_w, np.float32)
    if pool_w.shape == (L, L // 2):
        for c in (4, 8, 16, 32, 64):
            want = np.zeros((L, L // 2), np.float32)
            for r in range(L // c):
                for ch in range(c):
                    want[r * c + ch, (r // 2) * c + ch] = 0.5
            if np.array_equal(pool_w, want):
                return c
    raise ValueError("the CUDA stem epilogue supports only the folded "
                     "stem's (128, 64) pair-averaging pool_w")


def _bind(lib):
    fn = lib.bsed_stem_epilogue
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    return fn


def stem_epilogue_fwd(h, inv, c, w, b, act: str, pt: int,
                      pool_w: torch.Tensor, pool_c: int) -> torch.Tensor:
    """K2's wrapper. CPU tensors take the plain version; CUDA tensors
    launch the kernel (``pool_c`` from ``pair_pool_channels(pool_w)``)."""
    if h.device.type == "cpu":
        return stem_epilogue_plain(h, inv, c, w, b, act, pt, pool_w)
    if h.device.type != "cuda":
        raise ValueError(f"stem epilogue kernel runs on CUDA, got {h.device}")
    if h.dtype not in _DTYPES:
        raise ValueError(f"stem epilogue kernel takes float32/bfloat16, "
                         f"got {h.dtype}")
    if h.ndim != 4 or h.shape[2:] != (G, L) or not h.is_contiguous():
        raise ValueError(f"stem epilogue kernel needs a contiguous "
                         f"(B, T, {G}, {L}) h, got {tuple(h.shape)}")
    if w.shape != (L, L) or w.dtype != h.dtype or not w.is_contiguous():
        raise ValueError("w must be a contiguous (128, 128) tensor in h's "
                         "dtype")
    for name, v in (("inv", inv), ("c", c), ("b", b)):
        if (v.shape != (L,) or v.dtype != torch.float32
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 (128,)")
    if any(t.device != h.device for t in (inv, c, w, b)):
        raise ValueError("stem epilogue inputs must share h's device")
    if act not in _ACTS or pt not in (1, 2):
        raise ValueError(f"unsupported act={act} pt={pt}")
    bsz, t_in = h.shape[:2]
    out = torch.empty((bsz, t_in // pt, G, L // 2), device=h.device,
                      dtype=h.dtype)
    from bsed_tpu_torch import kernels
    fn = _bind(kernels.load("stem_epilogue"))
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(h.data_ptr(), inv.data_ptr(), c.data_ptr(), w.data_ptr(),
             b.data_ptr(), out.data_ptr(), _DTYPES[h.dtype], _ACTS[act], pt,
             bsz, t_in, t_in // pt, pool_c, stream)
    kernels.check(err, "stem epilogue kernel")
    stem_epilogue_fwd.launches += 1
    return out


stem_epilogue_fwd.launches = 0


def make_fused_epilogue(act: str, pt: int, pool_w: torch.Tensor,
                        use_kernel: bool = True) -> Callable:
    """Build ``ep(h, inv, c, w, b) -> out`` for one folded conv-block
    epilogue in its serving form (no dropout), with ``pool_w`` on h's
    device. ``use_kernel=False`` gives the plain version on any device."""
    if act not in _ACTS:
        raise ValueError(f"fused epilogue supports glu/cg, got {act}")
    if pt not in (1, 2):
        raise ValueError(f"fused epilogue supports time pool 1/2, got {pt}")
    pool_c = pair_pool_channels(pool_w.cpu().numpy())

    def ep(h, inv, c, w, b):
        if use_kernel:
            return stem_epilogue_fwd(h, inv, c, w, b, act, pt, pool_w, pool_c)
        return stem_epilogue_plain(h, inv, c, w, b, act, pt, pool_w)

    return ep
