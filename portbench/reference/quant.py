"""Operand rounding for the control: the reference computed one precision
below what a configuration states (fp8 e4m3 below bfloat16, bfloat16
below float32). A product's operands are rounded and the product is taken
in float32, as a lower-precision path with float32 accumulation would."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 and back (a gradient passes as if
    the rounding were the identity)."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (r - x.detach())


def bf16(x: torch.Tensor) -> torch.Tensor:
    r = x.detach().to(torch.bfloat16).to(x.dtype)
    return x + (r - x.detach())


def identity(x: torch.Tensor) -> torch.Tensor:
    return x
