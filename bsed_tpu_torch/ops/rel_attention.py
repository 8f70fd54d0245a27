"""Attention with a gated relative-position bias, BEATs' form
(``models/beats.py``): softmax(q·kᵀ/√d + g ⊙ P)·v, where P (H, L, L) is
the bias table's value at each key's offset from the query, the same for
every layer, and g (B, H, L, 1) each layer's gate, computed from the
query.

``gated_rel_attention`` is the entry every layer calls (looked up at call
time, so a profiler's wrapper or a test can stand in its place); its
calls count on ``gated_rel_attention.launches``. It forms g ⊙ P in the
compute dtype and hands it to ``F.scaled_dot_product_attention`` as the
additive mask, (B, H, L, L) materialised. ``gated_rel_attention_plain``
writes the same softmax out, in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gated_rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        gate: torch.Tensor, bias: torch.Tensor
                        ) -> torch.Tensor:
    """q, k, v (B, H, L, D), gate (B, H, L, 1), bias (H, L, L) →
    (B, H, L, D) in q's dtype."""
    mask = gate.to(q.dtype) * bias.to(q.dtype)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    gated_rel_attention.launches += 1
    return out


gated_rel_attention.launches = 0


def gated_rel_attention_plain(q, k, v, gate, bias) -> torch.Tensor:
    """The same in float32, the softmax written out: (B, H, L, D)
    float32."""
    q, k, v = q.float(), k.float(), v.float()
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    s = s + gate.float() * bias.float()
    return torch.softmax(s, dim=-1) @ v
