"""Plain HTS-AT, float32 PyTorch and NumPy: the serving model of the
``htsat`` configuration, eval mode, from raw audio to framewise and
clipwise posteriors.

Written from HTS-AT's definitions (Chen et al., ICASSP 2022,
arXiv:2202.00874; RetroCirce/HTS-Audio-Transformer ``config.py``,
``model/htsat.py``, and the torchlibrosa front end it builds), on the
state dict ``harness/htsat.py`` makes under the published module names:

* the front end: frames of n_fft every hop samples of the clip padded by
  n_fft/2 on each side by reflection, a periodic Hann window, |rfft|²,
  the Slaney mel filterbank (Slaney's scale, each filter scaled to unit
  area) from fmin to fmax, 10·log10(max(·, 1e-10)), no top_db clamp;
* bn0: (x − mean)/√(var + 1e-5)·γ + β over the mel bins;
* the fold: the frames resized to spec_size·r by Keys' cubic (a = −0.75)
  with align_corners and indices clamped at the edges, written as a
  matrix; image row chunk·F + mel, column the frame within the chunk;
* the patches (p × p, stride p) as a product, LayerNorm;
* each block: x + proj(attn(LN₁(x))), then + fc2(GELU(fc1(LN₂(x)))).
  Windows are taken by explicit index: in a shifted block, window token
  (i, j) of window (R, C) is map token ((R·w + i + s) mod H, (C·w + j + s)
  mod W), and its output goes back to the same token; the regions of the
  shifted map are labelled row by row and column by column (below H − w,
  below H − s, the rest) and pairs of different labels get −100. Each
  head's scores q·kᵀ/√d + table[(Δrow + w − 1)(2w − 1) + Δcol + w − 1]
  (+ the mask) go through a softmax written out;
* the patch merge: the neighbours (2r, 2c), (2r + 1, 2c), (2r, 2c + 1),
  (2r + 1, 2c + 1) concatenated, LayerNorm, the bias-free reduction;
* the final LayerNorm (the tokens the check compares, as it compares
  the first stage's output after its patch merge), then the fold
  undone: token (row, col) of the S' × S' map, row = chunk·S'/r + m,
  to frequency m and time chunk·S' + col; ``tscam_conv`` (S'/r × 3,
  zero padding of 1 in time); framewise σ(logits), each step repeated
  2^(stages − 1)·p times; clipwise σ(mean of the logits over time).

Departures from the published code, all of the benchmark's making: the
weights are random from the seed; bn0's statistics are set from the
cell's own audio; the relative-position tables are drawn at unit scale,
not Swin's truncated normal of std 0.02, so that leaving them out shows
with random weights; the head has 20 classes, not AudioSet's 527; no
dropout, drop-path or SpecAugment (training only).

Every product and convolution takes its operands through ``q`` (the
identity, or the control's rounding, ``quant.py``). TF32 is off for every
call of ``forward``. The clips run in blocks of ``block_clips``. Imports
nothing of the program.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

Q = Callable[[torch.Tensor], torch.Tensor]
MASKED = -100.0


def _ident(x):
    return x


class _no_tf32:
    def __enter__(self):
        m, c = torch.backends.cuda.matmul, torch.backends.cudnn
        self.saved = m.allow_tf32, c.allow_tf32
        m.allow_tf32 = c.allow_tf32 = False

    def __exit__(self, *exc):
        m, c = torch.backends.cuda.matmul, torch.backends.cudnn
        m.allow_tf32, c.allow_tf32 = self.saved


# --- front end ------------------------------------------------------------

def _hz_to_mel(f: float) -> float:
    """Slaney's scale: linear below 1 kHz (3 mels per 200 Hz), then 27
    mels per factor of 6.4."""
    if f < 1000.0:
        return 3.0 * f / 200.0
    return 15.0 + 27.0 * math.log(f / 1000.0) / math.log(6.4)


def _mel_to_hz(m: float) -> float:
    if m < 15.0:
        return 200.0 * m / 3.0
    return 1000.0 * 6.4 ** ((m - 15.0) / 27.0)


@functools.lru_cache(maxsize=None)
def slaney_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                      fmax: float) -> np.ndarray:
    """(n_fft/2 + 1, n_mels) float64: triangles between n_mels + 2 points
    equally spaced on Slaney's scale, each of area 1 (height 2 / its
    width in Hz)."""
    lo, hi = _hz_to_mel(fmin), _hz_to_mel(fmax)
    pts = [_mel_to_hz(lo + (hi - lo) * i / (n_mels + 1))
           for i in range(n_mels + 2)]
    out = np.zeros((n_fft // 2 + 1, n_mels))
    for k in range(n_fft // 2 + 1):
        f = k * sr / n_fft
        for m in range(n_mels):
            a, c, b = pts[m], pts[m + 1], pts[m + 2]
            tri = max(0.0, min((f - a) / (c - a), (b - f) / (b - c)))
            out[k, m] = tri * 2.0 / (b - a)
    return out


def log_mel(audio: torch.Tensor, a: Mapping) -> torch.Tensor:
    """(B, samples) → (B, frames, mels), frames = 1 + samples // hop."""
    n_fft, hop = a["n_window"], a["hop_size"]
    x = audio.float()
    pad = n_fft // 2
    n = x.shape[-1]
    left = x[:, 1:pad + 1].flip(-1)
    right = x[:, n - pad - 1:n - 1].flip(-1)
    x = torch.cat([left, x, right], dim=-1)
    frames = 1 + n // hop
    idx = (torch.arange(frames, device=x.device)[:, None] * hop
           + torch.arange(n_fft, device=x.device)[None, :])
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    fr = x[:, idx] * torch.as_tensor(hann, dtype=torch.float32,
                                     device=x.device)
    spec = torch.fft.rfft(fr, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(slaney_filterbank(a["sr"], n_fft, a["n_mels"],
                                           a["mel_f_min"], a["mel_f_max"]),
                         dtype=torch.float32, device=x.device)
    return 10.0 * torch.log10(torch.clamp(power @ fb, min=1e-10))


# --- the fold -------------------------------------------------------------

def _keys(t: float, a: float = -0.75) -> float:
    """Keys' cubic convolution kernel at distance |t|."""
    t = abs(t)
    if t <= 1.0:
        return ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    if t < 2.0:
        return ((a * t - 5.0 * a) * t + 8.0 * a) * t - 4.0 * a
    return 0.0


@functools.lru_cache(maxsize=None)
def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64: output i at source position i·(n_in −
    1)/(n_out − 1), four taps, indices clamped to [0, n_in)."""
    m = np.zeros((n_out, n_in))
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        base = math.floor(src)
        frac = src - base
        for k in range(-1, 3):
            j = min(max(base + k, 0), n_in - 1)
            m[i, j] += _keys(k - frac)
    return m


def fold(x: torch.Tensor, spec_size: int) -> torch.Tensor:
    """(B, T, F) → (B, S, S): time resized to S·r, chunk c's frames
    c·S … (c + 1)·S − 1 to image rows c·F …."""
    b, t, f = x.shape
    r = spec_size // f
    if t < spec_size * r:
        m = torch.as_tensor(bicubic_matrix(t, spec_size * r),
                            dtype=torch.float32, device=x.device)
        x = m @ x
    img = torch.empty(b, spec_size, spec_size, device=x.device)
    for c in range(r):
        img[:, c * f:(c + 1) * f, :] = x[:, c * spec_size:(c + 1) * spec_size,
                                         :].transpose(1, 2)
    return img


# --- the transformer ------------------------------------------------------

def _linear(x, sd, name, q: Q, bias: bool = True):
    y = q(x) @ q(sd[name + ".weight"]).T
    return y + sd[name + ".bias"] if bias else y


def _layer_norm(x, sd, name, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * sd[name + ".weight"] \
        + sd[name + ".bias"]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _softmax(s):
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


@functools.lru_cache(maxsize=None)
def window_index(side: int, w: int, s: int) -> np.ndarray:
    """(nW, w²): the map token of each window's token, the map shifted by
    ``s`` (0: none)."""
    n = side // w
    out = np.empty((n * n, w * w), np.int64)
    for wr in range(n):
        for wc in range(n):
            for i in range(w):
                for j in range(w):
                    out[wr * n + wc, i * w + j] = (
                        ((wr * w + i + s) % side) * side
                        + (wc * w + j + s) % side)
    return out


@functools.lru_cache(maxsize=None)
def window_mask(side: int, w: int, s: int) -> np.ndarray:
    """(nW, w², w²): −100 between tokens of two regions of the shifted
    map, else 0."""
    def region(r):
        return 0 if r < side - w else (1 if r < side - s else 2)
    n = side // w
    lab = np.empty((n * n, w * w), np.int64)
    for wr in range(n):
        for wc in range(n):
            for i in range(w):
                for j in range(w):
                    lab[wr * n + wc, i * w + j] = (
                        3 * region(wr * w + i) + region(wc * w + j))
    return np.where(lab[:, :, None] != lab[:, None, :], MASKED, 0.0)


@functools.lru_cache(maxsize=None)
def table_rows(w: int) -> np.ndarray:
    """(w², w²): table row (Δrow + w − 1)(2w − 1) + Δcol + w − 1 for
    query (r1, c1) and key (r2, c2), Δ = query − key."""
    rows = np.empty((w * w, w * w), np.int64)
    for a in range(w * w):
        for b in range(w * w):
            dr = a // w - b // w
            dc = a % w - b % w
            rows[a, b] = (dr + w - 1) * (2 * w - 1) + dc + w - 1
    return rows


def relative_bias(table: torch.Tensor, w: int) -> torch.Tensor:
    """(h, w², w²): the table at each pair's ``table_rows``."""
    return table[torch.as_tensor(table_rows(w),
                                 device=table.device)].permute(2, 0, 1)


def block(x: torch.Tensor, sd: Mapping, at: str, side: int, w: int, s: int,
          heads: int, eps: float, q: Q) -> torch.Tensor:
    """One block on a side × side map of (B, side², C) tokens."""
    b, n, c = x.shape
    d = c // heads
    idx = torch.as_tensor(window_index(side, w, s), device=x.device)
    nw = idx.shape[0]
    y = _layer_norm(x, sd, at + "norm1", eps)[:, idx]      # (B, nW, N, C)
    qkv = _linear(y, sd, at + "attn.qkv", q).reshape(b, nw, w * w, 3, heads,
                                                     d)
    qh, kh, vh = (qkv[..., i, :, :].permute(0, 1, 3, 2, 4) for i in range(3))
    scores = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(d)
    scores = scores + relative_bias(
        sd[at + "attn.relative_position_bias_table"], w)
    if s:
        scores = scores + torch.as_tensor(
            window_mask(side, w, s), dtype=torch.float32,
            device=x.device)[:, None]
    o = (q(_softmax(scores)) @ q(vh)).permute(0, 1, 3, 2, 4).reshape(
        b, nw, w * w, c)
    o = _linear(o, sd, at + "attn.proj", q)
    back = torch.empty_like(x)
    back[:, idx.reshape(-1)] = o.reshape(b, nw * w * w, c)
    x = x + back
    h = _linear(_gelu(_linear(_layer_norm(x, sd, at + "norm2", eps), sd,
                              at + "mlp.fc1", q)), sd, at + "mlp.fc2", q)
    return x + h


def merge(x: torch.Tensor, sd: Mapping, at: str, side: int, eps: float,
          q: Q) -> torch.Tensor:
    """(B, side², C) → (B, (side/2)², 2C)."""
    b, _, c = x.shape
    half = side // 2
    parts = []
    for dr, dc in ((0, 0), (1, 0), (0, 1), (1, 1)):
        rows = [(2 * r + dr) * side + 2 * cc + dc
                for r in range(half) for cc in range(half)]
        parts.append(x[:, torch.as_tensor(rows, device=x.device)])
    y = _layer_norm(torch.cat(parts, dim=-1), sd, at + "norm", eps)
    return _linear(y, sd, at + "reduction", q, bias=False)


def tokens(log_mel_: torch.Tensor, sd: Mapping, stats: Mapping,
           hc: Mapping, q: Q = _ident) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, F) log-mel → ((B, L, C), the last stage after the final
    LayerNorm; the first stage's output, after its patch merge)."""
    eps = hc["layer_norm_eps"]
    x = ((log_mel_ - stats["bn0.running_mean"])
         / torch.sqrt(stats["bn0.running_var"] + 1e-5)
         * sd["bn0.weight"] + sd["bn0.bias"])
    img = fold(x, hc["spec_size"])
    p = hc["patch_size"]
    b, s, _ = img.shape
    side = s // p
    patches = (img.reshape(b, side, p, side, p).permute(0, 1, 3, 2, 4)
               .reshape(b, side * side, p * p))
    wt = sd["patch_embed.proj.weight"]
    x = q(patches) @ q(wt.reshape(wt.shape[0], -1)).T \
        + sd["patch_embed.proj.bias"]
    x = _layer_norm(x, sd, "patch_embed.norm", eps)
    stages = len(hc["depths"])
    first = None
    for i, (depth, heads) in enumerate(zip(hc["depths"], hc["num_heads"])):
        w = min(hc["window_size"], side)
        for j in range(depth):
            shift = w // 2 if (j % 2 and side > hc["window_size"]) else 0
            x = block(x, sd, f"layers.{i}.blocks.{j}.", side, w, shift,
                      heads, eps, q)
        if i < stages - 1:
            x = merge(x, sd, f"layers.{i}.downsample.", side, eps, q)
            side //= 2
        first = x if first is None else first
    return _layer_norm(x, sd, "norm", eps), first


def head(x: torch.Tensor, sd: Mapping, hc: Mapping, n_mels: int,
         q: Q = _ident) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, C) → (framewise (B, frames, classes), clipwise (B,
    classes))."""
    b, n, c = x.shape
    side = int(round(math.sqrt(n)))
    r = hc["spec_size"] // n_mels
    rows = side // r
    grid = torch.empty(b, c, rows, r * side, device=x.device)
    for chunk in range(r):
        for m in range(rows):
            tok = (chunk * rows + m) * side
            grid[:, :, m, chunk * side:(chunk + 1) * side] = \
                x[:, tok:tok + side].transpose(1, 2)
    wt, bias = sd["tscam_conv.weight"], sd["tscam_conv.bias"]
    steps = r * side
    padded = torch.nn.functional.pad(grid, (1, 1))
    cols = torch.stack([padded[:, :, :, t:t + 3] for t in range(steps)],
                       dim=1).reshape(b, steps, c * rows * 3)
    logits = q(cols) @ q(wt.reshape(wt.shape[0], -1)).T + bias  # (B, T, K)
    per = 2 ** (len(hc["depths"]) - 1) * hc["patch_stride"]
    strong = torch.sigmoid(logits)[:, :, None, :].expand(
        b, steps, per, logits.shape[-1]).reshape(b, steps * per, -1)
    return strong, torch.sigmoid(logits.mean(dim=1))


def forward(audio: torch.Tensor, params: Mapping, stats: Mapping,
            config: Mapping, q: Q = _ident, block_clips: int = 16
            ) -> Tuple[torch.Tensor, ...]:
    """(B, samples) → (framewise, clipwise, tokens, first stage's
    output), float32, in blocks of ``block_clips`` clips."""
    sd, st = params["htsat"], stats["htsat"]
    hc, a = config["htsat"], config["audio"]
    outs: Dict[int, list] = {0: [], 1: [], 2: [], 3: []}
    with _no_tf32():
        for i in range(0, audio.shape[0], block_clips):
            tok, first = tokens(log_mel(audio[i:i + block_clips], a), sd, st,
                                hc, q)
            s, w = head(tok, sd, hc, a["n_mels"], q)
            for k, v in enumerate((s, w, tok, first)):
                outs[k].append(v)
    return tuple(torch.cat(outs[k]) for k in range(4))
