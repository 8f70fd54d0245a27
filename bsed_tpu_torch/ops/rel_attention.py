"""Attention with a gated relative-position bias, BEATs' form
(``models/beats.py``): softmax(q·kᵀ/√d + g ⊙ P)·v, where P (H, L, L) is
the bias table's value at each key's offset from the query, the same for
every layer, and g (B, H, L, 1) each layer's gate, computed from the
query.

``gated_rel_attention`` is the entry every layer calls (looked up at call
time, so a profiler's wrapper or a test can stand in its place). Where
``kernels.launches_on`` says so (CUDA tensors) it launches one
hand-written kernel (``csrc/rel_attention.cu``:
bfloat16 on TMA and ``wgmma`` for up to ``MAX_KEYS`` tokens, float32 on
FMA), which adds g ⊙ P to the scores in float32 registers and writes no
(B, H, L, L) tensor; each launch counts on
``gated_rel_attention.launches``, one a call. Otherwise it takes
``gated_rel_attention_plain``, the same softmax written out in float32,
and counts no launch. No TPU kernel is replaced: ``bsed_tpu`` has no
BEATs.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple

import torch

from bsed_tpu_torch import kernels

HEAD = 64             # head width the kernel takes (csrc/rel_attention.cu)
MAX_KEYS = 512        # tokens a head the bfloat16 body holds in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gated_rel_attention_plain(q, k, v, gate, bias) -> torch.Tensor:
    """The same in float32, the softmax written out: (B, H, L, D)
    float32."""
    q, k, v = q.float(), k.float(), v.float()
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    s = s + gate.float() * bias.float()
    return torch.softmax(s, dim=-1) @ v


class LaunchPlan(NamedTuple):
    """The kernel's arguments: the five inputs, laid out as its tensor maps
    take them, and their 14 element strides in the order of
    ``csrc/rel_attention.cu``'s ``Strides``."""
    tensors: tuple
    strides: List[int]


def _rows_aligned(t: torch.Tensor) -> bool:
    """Last dimension contiguous, every row starting on 16 bytes."""
    per = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % per == 0 for st in t.stride()[:-1]))


def _model_layout(t: torch.Tensor) -> bool:
    """(B, H, L, D) over (B, L, H, D) storage, as ``_SelfAttention``'s
    views of (B, L, H·D): heads inside rows inside the batch, rows on 16
    bytes."""
    return _rows_aligned(t) and t.stride(1) <= t.stride(2) <= t.stride(0)


def launch_plan(q, k, v, gate, bias) -> LaunchPlan:
    """Check the inputs against what the kernel takes and lay them out
    for it; raise on what it does not take. The kernel reads q, k and v
    in the model's layout (views of (B, L, H·D)), which pass without a
    copy; other layouts are copied into it. The bfloat16 body reads P by
    TMA, rows on 16 bytes: the model's contiguous P passes (L = 496, a
    multiple of 8); another L gets one copy with its rows padded, P's
    values as given."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"gated_rel_attention's kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    if q.ndim != 4 or q.shape[-1] != HEAD:
        raise ValueError(f"gated_rel_attention's kernel takes q (B, H, L, "
                         f"{HEAD}); got {tuple(q.shape)}")
    b, h, n, _ = q.shape
    if (k.shape != q.shape or v.shape != q.shape
            or gate.shape != (b, h, n, 1) or bias.shape != (h, n, n)):
        raise ValueError(f"gated_rel_attention: q, k, v (B, H, L, D), gate "
                         f"(B, H, L, 1), bias (H, L, L); got "
                         f"{[tuple(t.shape) for t in (q, k, v, gate, bias)]}")
    if q.dtype == torch.bfloat16 and n > MAX_KEYS:
        raise ValueError(f"gated_rel_attention's bfloat16 kernel holds at "
                         f"most {MAX_KEYS} tokens a head; got {n}")
    if any(t.device != q.device for t in (k, v, gate, bias)):
        raise ValueError("gated_rel_attention's inputs must share q's "
                         "device")
    if any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError("gated_rel_attention: q, k and v must share a "
                         "dtype")
    q, k, v = (t if _model_layout(t)
               else t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v))
    gate = gate.to(q.dtype)
    bias = bias.to(q.dtype)
    if not _rows_aligned(bias):   # P's rows on 16 bytes: padded past L
        wide = -(-n // 8) * 8
        padded = bias.new_zeros((h, n, wide))
        padded[..., :n] = bias
        bias = padded[..., :n]
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *gate.stride()[:3], *bias.stride()[:2]]
    return LaunchPlan((q, k, v, gate, bias), strides)


def _bind(lib: ctypes.CDLL):
    """The C entry ``bsed_rel_attention`` of a built library, typed."""
    fn = lib.bsed_rel_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_void_p])
    return fn


_FN = []


def _bound():
    """The C entry of the kernel, bound once."""
    if not _FN:
        _FN.append(_bind(kernels.load("rel_attention")))
    return _FN[0]


def gated_rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        gate: torch.Tensor, bias: torch.Tensor
                        ) -> torch.Tensor:
    """q, k, v (B, H, L, D), gate (B, H, L, 1), bias (H, L, L) →
    (B, H, L, D) in q's dtype. From the kernel the output lies in (B, L,
    H, D) storage, so ``out.transpose(1, 2)`` is contiguous."""
    if not kernels.launches_on(q.device):
        return gated_rel_attention_plain(q, k, v, gate, bias).to(q.dtype)
    return _launch(launch_plan(q, k, v, gate, bias))


def _launch(plan: LaunchPlan) -> torch.Tensor:
    (q, k, v, gate, bias), strides = plan
    fn = _bound()
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), device=q.device, dtype=q.dtype)
    stride_arg = (ctypes.c_longlong * len(strides))(*strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(),
             bias.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h, n, d,
             stride_arg, stream)
    kernels.check(err, "gated_rel_attention kernel")
    gated_rel_attention.launches += 1
    return out.transpose(1, 2)


gated_rel_attention.launches = 0
