"""HTS-AT, the Hierarchical Token-Semantic Audio Transformer (Chen et al.,
"HTS-AT: A Hierarchical Token-Semantic Audio Transformer for Sound
Classification and Detection", ICASSP 2022, arXiv:2202.00874;
RetroCirce/HTS-Audio-Transformer ``model/htsat.py``), eval mode, from its
log-mel (``ops/mel.MelFrontEnd(torchlibrosa=True)``), (B, T, F):

* ``bn0``: a BatchNorm over the F mel bins, in float32;
* the fold (``reshape_wav2img``): T frames resized bicubically
  (align_corners) to ``spec_size · r`` (r = spec_size / F), cut into r
  chunks of time stacked along frequency: a (spec_size, spec_size) image,
  row chunk·F + mel, column the frame within the chunk;
* ``patch_embed``: a p × p stride-p convolution (computed as one product
  of the patches), LayerNorm: (spec_size / p)² tokens, row-major;
* four Swin stages (``layers``) of blocks x = x + attn(LN₁(x)), x = x +
  fc2(GELU(fc1(LN₂(x)))). The attention is over w × w windows of the
  token map (``ops/window_attention``), odd blocks with the map rolled by
  w/2 first and back after, and −100 between tokens from different
  regions of the rolled map; each block adds its (2w − 1)² × heads
  relative-position table at each key's offset from the query. Where the
  map is no larger than the window, the window is the map and nothing
  shifts. The bias of a block, table and mask summed over its windows,
  (nW·h, w², w²), is built once and reused on every call
  (``SwinBlock.bias``);
* after each stage but the last, the patch merge: the 2 × 2 neighbours
  gathered in the order (0, 0), (1, 0), (0, 1), (1, 1) of (row, column),
  LayerNorm(4C), a bias-free Linear(4C → 2C);
* ``norm``, the final LayerNorm: the module's output, (B, L, C);
* the token-semantic head (``HTSAT.head``, its own call): the tokens laid
  back on their (S', S') map, the fold undone into (C, S'/r, r·S') —
  frequency rows by time steps — then ``tscam_conv``, a (S'/r, 3)
  convolution to the classes: framewise posteriors σ(logits) with each
  step repeated to the fold's frame count, clip posteriors σ(the logits'
  mean over the steps).

Module names are the published state dict's (``utils/weights.load_htsat``).
Dropout, drop-path and SpecAugment are training-only and left out.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bsed_tpu_torch.config import HtsatConfig
from bsed_tpu_torch.ops import window_attention as WA

MASKED = -100.0        # Swin's score between tokens of different regions


class _BatchNorm(nn.Module):
    """``bn0``: eval-mode BatchNorm over the last axis, in float32."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        return ((x.float() - self.running_mean.float()) * inv
                * self.weight.float() + self.bias.float())


class PatchEmbed(nn.Module):
    def __init__(self, hc: HtsatConfig):
        super().__init__()
        if hc.patch_size != hc.patch_stride:
            raise ValueError("HTS-AT's patch embedding is served for "
                             "patches that do not overlap (patch_size == "
                             "patch_stride)")
        p = hc.patch_size
        self.p = p
        self.proj = nn.Conv2d(1, hc.embed_dim, p, stride=p)
        self.norm = nn.LayerNorm(hc.embed_dim, eps=hc.layer_norm_eps)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """(B, S, S) → (B, (S/p)², E): the patches do not overlap, so the
        convolution is one product of the (B·L, p²) patches and the (E,
        p²) kernel."""
        w, p = self.proj.weight, self.p
        b, s, _ = img.shape
        x = (img.to(w.dtype).reshape(b, s // p, p, s // p, p).transpose(2, 3)
             .reshape(b, -1, p * p))
        x = x @ w.reshape(w.shape[0], -1).t() + self.proj.bias
        return self.norm(x)


def relative_position_index(w: int) -> torch.Tensor:
    """(w², w²): the table row of each (query, key) pair of a w × w
    window, (Δrow + w − 1)·(2w − 1) + Δcol + w − 1, Δ = query − key."""
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + w - 1
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]


def shift_mask(resolution: Tuple[int, int], w: int, s: int) -> torch.Tensor:
    """(nW, w², w²): 0 between tokens of one region of the map rolled by
    ``s``, ``MASKED`` between tokens of two; regions are cut at −w and −s
    along each axis."""
    h, wd = resolution
    img = torch.zeros(1, h, wd, 1)
    cuts = (slice(0, -w), slice(-w, -s), slice(-s, None))
    region = 0
    for rows in cuts:
        for cols in cuts:
            img[:, rows, cols, :] = region
            region += 1
    win = WA.window_partition(img, w).reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, MASKED, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, w: int, heads: int, qkv_bias: bool):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * w - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(w), persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def relative_bias(self) -> torch.Tensor:
        """(h, w², w²) float32: the table at each pair's offset."""
        idx = self.relative_position_index
        n = idx.shape[0]
        return (self.relative_position_bias_table.float()[idx.view(-1)]
                .view(n, n, -1).permute(2, 0, 1))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """(B, nW, N, C) windows → (B, nW, N, C)."""
        b, nw, n, c = x.shape
        h = self.heads
        qkv = self.qkv(x).view(b, nw, n, 3, h, c // h).permute(3, 0, 1, 4, 2,
                                                               5)
        q, k, v = (t.reshape(b, nw * h, n, c // h) for t in qkv)
        o = WA.window_attention(q, k, v, bias)
        return self.proj(o.reshape(b, nw, h, n, c // h).transpose(2, 3)
                         .reshape(b, nw, n, c))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """One block on an (H, W) token map; ``shift_size`` w/2 for odd
    blocks, 0 where the window covers the map."""

    def __init__(self, dim: int, resolution: Tuple[int, int], heads: int,
                 w: int, shift: int, hc: HtsatConfig):
        super().__init__()
        if min(resolution) <= w:
            w, shift = min(resolution), 0
        self.resolution, self.window, self.shift_size = resolution, w, shift
        eps = hc.layer_norm_eps
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = WindowAttention(dim, w, heads, hc.qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = _Mlp(dim, int(dim * hc.mlp_ratio))
        self.register_buffer(
            "attn_mask", shift_mask(resolution, w, shift) if shift else None,
            persistent=False)
        self._bias = (None, None)           # (what it was built from, bias)

    def bias(self) -> torch.Tensor:
        """(nW·h, w², w²) in the table's dtype: the relative-position bias
        of every window's heads, plus the shift mask where the block
        shifts. Built again only when the table, the mask or the shift
        changes (a load, a cast, a move)."""
        t, m = self.attn.relative_position_bias_table, self.attn_mask
        key = (t.data_ptr(), t._version, t.dtype, self.shift_size,
               None if m is None else (m.data_ptr(), m._version))
        if self._bias[0] != key:
            h, wd = self.resolution
            nw = (h // self.window) * (wd // self.window)
            with torch.no_grad():
                rel = self.attn.relative_bias()[None]
                full = (rel + m.float()[:, None] if self.shift_size
                        and m is not None else rel.expand(nw, -1, -1, -1))
                self._bias = (key, full.reshape(-1, *rel.shape[-2:])
                              .to(t.dtype).contiguous())
        return self._bias[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, wd = self.resolution
        b, n, c = x.shape
        s, w = self.shift_size, self.window
        y = self.norm1(x).view(b, h, wd, c)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = self.attn(WA.window_partition(y, w), self.bias())
        y = WA.window_reverse(y, w, h, wd)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y.reshape(b, n, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, resolution: Tuple[int, int], dim: int, eps: float):
        super().__init__()
        self.resolution = resolution
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, wd = self.resolution
        b, _, c = x.shape
        x = x.view(b, h, wd, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.view(b, -1, 4 * c)))


class _Stage(nn.Module):
    def __init__(self, dim: int, resolution: Tuple[int, int], depth: int,
                 heads: int, hc: HtsatConfig, merge: bool):
        super().__init__()
        w = hc.window_size
        self.blocks = nn.ModuleList(
            SwinBlock(dim, resolution, heads, w, 0 if j % 2 == 0 else w // 2,
                      hc) for j in range(depth))
        self.downsample = (PatchMerging(resolution, dim, hc.layer_norm_eps)
                           if merge else None)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class HTSAT(nn.Module):
    """``forward(log_mel (B, T, F) float32) -> (B, L, C)``, the last
    stage's tokens after ``norm`` in the module's dtype; ``head`` maps
    them to (framewise (B, frames, classes), clipwise (B, classes))
    posteriors, float32."""

    def __init__(self, hc: HtsatConfig, n_mels: int, nclass: int):
        super().__init__()
        if hc.spec_size % n_mels:
            raise ValueError(f"HTS-AT folds {n_mels} mels into a "
                             f"{hc.spec_size}-row image: they must divide it")
        self.hc = hc
        self.freq_ratio = hc.spec_size // n_mels
        self.bn0 = _BatchNorm(n_mels)
        self.patch_embed = PatchEmbed(hc)
        res = hc.spec_size // hc.patch_stride
        n = len(hc.depths)
        self.layers = nn.ModuleList(
            _Stage(hc.embed_dim * 2 ** i, (res >> i, res >> i), depth, heads,
                   hc, merge=i < n - 1)
            for i, (depth, heads) in enumerate(zip(hc.depths, hc.num_heads)))
        c = hc.embed_dim * 2 ** (n - 1)
        self.norm = nn.LayerNorm(c, eps=hc.layer_norm_eps)
        side = res >> (n - 1)
        self.tscam_conv = nn.Conv2d(c, nclass, (side // self.freq_ratio, 3),
                                    padding=(0, 1))
        self.frames_per_step = 2 ** (n - 1) * hc.patch_stride

    def cast(self, dtype) -> "HTSAT":
        """The module in ``dtype``, bn0 kept in float32."""
        self.to(dtype)
        self.bn0.float()
        return self

    def fold(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) → (B, S, S), S = spec_size: T resized to S·r frames
        (bicubic, align_corners, where T is shorter), r chunks of S frames
        stacked along frequency."""
        b, t, f = x.shape
        r, s = self.freq_ratio, self.hc.spec_size
        if t > s * r:
            raise ValueError(f"HTS-AT serves at most {s * r} frames a clip, "
                             f"got {t}")
        if t < s * r:
            x = F.interpolate(x[:, None], (s * r, f), mode="bicubic",
                              align_corners=True)[:, 0]
        return (x.transpose(1, 2).reshape(b, f, r, s).transpose(1, 2)
                .reshape(b, r * f, s))

    def forward(self, log_mel: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(self.fold(self.bn0(log_mel)))
        for stage in self.layers:
            x = stage(x)
        return self.norm(x)

    def head(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L, C) tokens → (framewise (B, frames, classes), clipwise
        (B, classes)) float32: the fold undone, ``tscam_conv``, σ."""
        b, n, c = x.shape
        side, r = int(round(n ** 0.5)), self.freq_ratio
        x = (x.transpose(1, 2).reshape(b, c, r, side // r, side)
             .transpose(2, 3).reshape(b, c, side // r, r * side))
        logits = self.tscam_conv(x).flatten(2).float()  # (B, classes, steps)
        strong = torch.sigmoid(logits).transpose(1, 2).repeat_interleave(
            self.frames_per_step, dim=1)
        return strong, torch.sigmoid(logits.mean(-1))
