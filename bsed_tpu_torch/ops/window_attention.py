"""Window attention, HTS-AT's form (Swin's, ``models/htsat.py``):
softmax(q·kᵀ/√d + bias)·v within each window of a stage's token map,
where bias is the window's relative-position bias (a (2w − 1)² × heads
table gathered at each key's offset from the query) plus, in a shifted
block, −100 between tokens that the cyclic shift brought from different
regions of the map.

``window_attention`` is the entry every block calls (looked up at call
time, so a profiler's wrapper or a test can stand in its place). It is
``F.scaled_dot_product_attention`` with the bias as its additive mask, on
the card and on the CPU alike; no hand-written kernel computes it yet.
Each call counts on the module's ``calls``. ``window_partition`` and
``window_reverse`` cut a (B, H, W, C) map into its (B, nW, w², C) windows,
row-major over windows and within each, and put them back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

calls = 0             # window_attention calls since import


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """q, k, v (B, nW·h, N, d), bias (nW·h, N, N) in q's dtype →
    (B, nW·h, N, d): each window's heads attend over the window's N
    tokens, scaled by 1/√d."""
    global calls
    calls += 1
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) → (B, nW, w·w, C), nW = (H/w)·(W/w)."""
    b, h, wd, c = x.shape
    x = x.view(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // w) * (wd // w), w * w, c)


def window_reverse(x: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    """(B, nW, w·w, C) → (B, H, W, C), the inverse of ``window_partition``."""
    b, c = x.shape[0], x.shape[-1]
    x = x.view(b, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, c)
