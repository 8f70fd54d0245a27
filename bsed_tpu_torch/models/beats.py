"""BEATs (Chen et al., "BEATs: Audio Pre-Training with Acoustic
Tokenizers", arXiv:2212.09058; microsoft/unilm ``beats/``) as a frozen
encoder fused into the CRNN, the DCASE Task 4 baseline's form (DESED_task
``dcase2024_task4_baseline``: the CNN's frames and BEATs' frame embeddings
concatenated, then ``cat_tf``, one linear layer back to the CNN's width,
before the BiGRU).

The encoder, eval mode, from its fbank (``ops/fbank.py``), (B, T, F):

* patches: ``Conv2d(1, embed_dim, p, stride p, bias=False)`` → (B, E,
  T/p, F/p) (computed as a product), flattened to L tokens, index
  t·(F/p) + f, ``LayerNorm``, ``Linear(embed_dim, d)``;
* the position convolution: ``Conv1d(d, d, conv_pos, padding
  conv_pos/2, groups)`` (its weight norm folded at load), the last output
  dropped, GELU, added to x, all through
  ``ops/pos_conv.pos_conv_residual``, then the encoder's ``LayerNorm``;
* each layer, with α = (2·layers)^¼ (DeepNorm) and post-norm residuals:
  x = LN₁(α·x + o(attn)), x = LN₂(α·x + fc2(GELU(fc1(x)))). The attention
  has H heads of D = d/H: softmax(q·kᵀ/√D + g ⊙ P)·v, P[h, i, j] =
  E[bucket(j − i), h] from layer 0's table E (T5's bidirectional buckets),
  shared by every layer, and g = a·(b·A − 1) + 2 per query and head, (a,
  b) = σ(``grep_linear``(q) summed in fours), A (``grep_a``) learned per
  layer and head. It runs through ``ops/rel_attention.gated_rel_attention``.

Module names are the released checkpoint's state-dict keys
(``utils/weights.load_beats``). ``BeatsFusion`` aligns the encoder's
tokens to the CNN's frames (the mean over the frequency patches, then an
adaptive average pool in time) and applies ``cat_tf``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from bsed_tpu_torch.config import BeatsConfig
from bsed_tpu_torch.ops import pos_conv, rel_attention

GATE_WIDTH = 8              # grep_linear: (a, b), each summed over four


def relative_buckets(rel: torch.Tensor, num_buckets: int,
                     max_distance: int) -> torch.Tensor:
    """T5's bidirectional bucket of each offset ``rel`` = key − query:
    half the buckets for rel > 0; |rel| below a quarter of the buckets
    exact, larger ones on a log scale up to ``max_distance``, capped."""
    half = num_buckets // 2
    exact = half // 2
    n = rel.abs()
    large = exact + (torch.log(n.clamp(min=1).float() / exact)
                     / math.log(max_distance / exact)
                     * (half - exact)).long()
    large = large.clamp(max=half - 1)
    return (rel > 0).long() * half + torch.where(n < exact, n, large)


class _SelfAttention(nn.Module):
    def __init__(self, bc: BeatsConfig, with_table: bool):
        super().__init__()
        d, h = bc.encoder_embed_dim, bc.encoder_attention_heads
        self.heads = h
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.q_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.grep_linear = nn.Linear(d // h, GATE_WIDTH)
        self.grep_a = nn.Parameter(torch.ones(1, h, 1, 1))
        if with_table:
            self.relative_attention_bias = nn.Embedding(bc.num_buckets, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape

        def heads(t):
            return t.view(b, n, self.heads, -1).transpose(1, 2)
        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), \
            heads(self.v_proj(x))
        ga, gb = torch.sigmoid(self.grep_linear(q).view(
            b, self.heads, n, 2, GATE_WIDTH // 2).sum(-1)).chunk(2, dim=-1)
        gate = ga * (gb * self.grep_a - 1.0) + 2.0
        o = rel_attention.gated_rel_attention(q, k, v, gate, bias)
        return self.out_proj(o.transpose(1, 2).reshape(b, n, d))


class _Layer(nn.Module):
    def __init__(self, bc: BeatsConfig, with_table: bool):
        super().__init__()
        d, eps = bc.encoder_embed_dim, bc.layer_norm_eps
        self.self_attn = _SelfAttention(bc, with_table)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, bc.encoder_ffn_embed_dim)
        self.fc2 = nn.Linear(bc.encoder_ffn_embed_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, x, bias, alpha: float):
        x = self.self_attn_layer_norm(alpha * x + self.self_attn(x, bias))
        return self.final_layer_norm(
            alpha * x + self.fc2(F.gelu(self.fc1(x))))


class _Encoder(nn.Module):
    def __init__(self, bc: BeatsConfig):
        super().__init__()
        d = bc.encoder_embed_dim
        self.pos_conv = nn.Sequential(nn.Conv1d(
            d, d, bc.conv_pos, padding=bc.conv_pos // 2,
            groups=bc.conv_pos_groups))
        self.layer_norm = nn.LayerNorm(d, eps=bc.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(bc, i == 0)
                                    for i in range(bc.encoder_layers))


class BEATs(nn.Module):
    """``forward(fbank (B, T, F)) -> (B, L, d)`` in the module's dtype:
    L = (T/p)·(F/p) tokens, index t·(F/p) + f."""

    def __init__(self, bc: BeatsConfig):
        super().__init__()
        p = bc.input_patch_size
        self.bc = bc
        self.alpha = (2.0 * bc.encoder_layers) ** 0.25
        self.patch_embedding = nn.Conv2d(1, bc.embed_dim, p, stride=p,
                                         bias=False)
        self.layer_norm = nn.LayerNorm(bc.embed_dim, eps=bc.layer_norm_eps)
        self.post_extract_proj = nn.Linear(bc.embed_dim,
                                           bc.encoder_embed_dim)
        self.encoder = _Encoder(bc)
        self._bias: Dict[int, torch.Tensor] = {}
        self._pos_conv = (None, None)      # (the weight's key, re-laid)

    def position_bias(self, n: int) -> torch.Tensor:
        """P (H, n, n): the shared table at each key's offset from the
        query, built once for each token count."""
        if n not in self._bias:
            table = self.encoder.layers[0].self_attn.relative_attention_bias
            pos = torch.arange(n, device=table.weight.device)
            bucket = relative_buckets(pos[None, :] - pos[:, None],
                                      self.bc.num_buckets,
                                      self.bc.max_distance)
            with torch.no_grad():
                self._bias[n] = table(bucket).permute(2, 0, 1).contiguous()
        return self._bias[n]

    def cast(self, dtype) -> "BEATs":
        """The module in ``dtype``, the position convolution included, its
        weight re-laid for its kernel (``pos_conv_weight``). At its shapes
        (48 channels a group, 128 taps, 496 tokens, 64 clips on an H100)
        cuDNN's bfloat16 grouped convolution took 26.3 ms, its TF32 one
        3.8 and ``ops/pos_conv``'s bfloat16 kernel 0.50."""
        self.to(dtype)
        self.pos_conv_weight()
        return self

    def pos_conv_weight(self) -> torch.Tensor:
        """The position convolution's weight as its kernel reads it
        (``pos_conv.pack_weight``): re-laid when the weight changes (a
        load, a cast, a move), not on every call."""
        w = self.encoder.pos_conv[0].weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if self._pos_conv[0] != key:
            with torch.no_grad():
                self._pos_conv = (key, pos_conv.pack_weight(
                    w.detach(), self.bc.conv_pos_groups))
        return self._pos_conv[1]

    def embed(self, fbank: torch.Tensor) -> torch.Tensor:
        """The tokens before the layers: patches, the position
        convolution, the encoder's LayerNorm. The patches do not overlap,
        so their convolution is one product of the (B·L, p²) patches and
        the (E, p²) kernel (cuDNN's convolution with one input channel
        took 1.18 ms for 64 clips on an H100, the product 0.08)."""
        w = self.patch_embedding.weight
        p = self.bc.input_patch_size
        b, t, f = fbank.shape
        x = (fbank[:, :t // p * p].to(w.dtype)
             .reshape(b, t // p, p, f // p, p).transpose(2, 3)
             .reshape(b, -1, p * p)) @ w.reshape(w.shape[0], -1).t()
        x = self.post_extract_proj(self.layer_norm(x))
        conv = self.encoder.pos_conv[0]
        x = pos_conv.pos_conv_residual(x, conv.weight, conv.bias,
                                       conv.groups, self.pos_conv_weight())
        return self.encoder.layer_norm(x)

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        x = self.embed(fbank)
        bias = self.position_bias(x.shape[1])
        for layer in self.encoder.layers:
            x = layer(x, bias, self.alpha)
        return x


class BeatsFusion:
    """``fuse(h (B, T', C) float32, emb (B, L, d)) -> (B, T', C)``
    float32: the tokens averaged over the ``freq_patches`` of each time
    patch, average-pooled to T' frames (``F.adaptive_avg_pool1d``),
    concatenated after h's channels and mapped by ``cat_tf`` (``kernel``
    (C + d, C), ``bias``) in ``dtype``."""

    def __init__(self, kernel, bias, freq_patches: int, dtype, device):
        self.freq_patches = freq_patches
        self.dtype = dtype
        self.w = torch.as_tensor(kernel, dtype=dtype, device=device)
        self.b = torch.as_tensor(bias, dtype=dtype, device=device)

    def __call__(self, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        b, n, d = emb.shape
        e = emb.view(b, n // self.freq_patches, self.freq_patches, d).mean(2)
        e = F.adaptive_avg_pool1d(e.transpose(1, 2), h.shape[1])
        x = torch.cat([h.to(self.dtype), e.transpose(1, 2).to(self.dtype)],
                      dim=-1)
        return (x @ self.w + self.b).float()
