"""Plain BEATs fused into the CRNN, float32 PyTorch and NumPy: the serving
model of the ``crnn_beats`` configuration, eval mode.

Written from BEATs' definitions (Chen et al., arXiv:2212.09058;
microsoft/unilm ``beats/``: ``BEATs.py``, ``backbone.py``) and the DCASE
Task 4 baseline's fusion (DESED_task ``dcase2024_task4_baseline``,
``cat_tf``), on the weights ``harness/beats.py`` makes (the released
checkpoint's state-dict keys):

* the clip decimated 2:1 by a Hann-windowed sinc low-pass (``taps``,
  cutoff × the output's Nyquist rate, unit DC gain, zeros past the ends);
* Kaldi's fbank (``torchaudio.compliance.kaldi.fbank`` at BEATs'
  settings): the waveform × 2^15, frames of 400 every 160 samples, whole
  frames only; per frame the mean removed, pre-emphasis 0.97 with x[−1] =
  x[0], the Povey window (Hann^0.85), zero padding to 512, |rfft|²;
  triangular filters on the mel scale 1127·ln(1 + f/700) from 20 Hz to
  8 kHz over the 256 bins below Nyquist; log(max(·, float32 ε));
  (x − 15.41663) / (2·6.55582);
* 16 × 16 patches (as a product), LayerNorm, a linear layer to d;
* the grouped position convolution (weight norm over dim 2 folded), its
  last output dropped, GELU (erf), added, LayerNorm;
* 12 post-norm layers, α = (2·12)^¼: x = LN(α·x + o(attn(x))), x = LN(α·x
  + fc2(GELU(fc1(x)))); attention per head softmax(q·kᵀ/√D + g·P)·v
  written out, P[h, i, j] = E[bucket(j − i), h] from layer 0's table,
  bucket T5's bidirectional one; g = a·(b·A − 1) + 2 with (a, b) =
  σ(the gate linear of the unscaled q, summed in fours);
* the tokens (index t·F' + f) averaged over the F' frequency patches of
  each time patch, then each of the CNN's T' frames the mean of time
  patches ⌊i·N/T'⌋ … ⌈(i + 1)·N/T'⌉ − 1; concatenated after the CNN's
  channels; ``cat_tf``; then the CRNN's BiGRU and head
  (``reference/crnn.py``).

Every product and convolution takes its operands through ``q`` (the
identity, or the control's rounding, ``quant.py``). TF32 is off for
every call of ``forward`` and ``beats``. Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import crnn as R
from portbench.reference.frontend import log_mel

Q = R.Q
_ident = R._ident


class _no_tf32:
    def __enter__(self):
        m, c = torch.backends.cuda.matmul, torch.backends.cudnn
        self.saved = m.allow_tf32, c.allow_tf32
        m.allow_tf32 = c.allow_tf32 = False

    def __exit__(self, *exc):
        m, c = torch.backends.cuda.matmul, torch.backends.cudnn
        m.allow_tf32, c.allow_tf32 = self.saved


# --- front end ------------------------------------------------------------

def lowpass(taps: int, cutoff: float) -> np.ndarray:
    """float64 (taps,): sinc at cutoff/4 cycles a sample times the
    symmetric Hann window, summing to 1."""
    h = np.empty(taps)
    fc = cutoff / 4.0
    mid = (taps - 1) / 2.0
    for i in range(taps):
        t = i - mid
        s = 2.0 * fc if t == 0 else math.sin(2 * math.pi * fc * t) / (
            math.pi * t)
        h[i] = s * (0.5 - 0.5 * math.cos(2 * math.pi * i / (taps - 1)))
    return h / h.sum()


def decimate(audio: torch.Tensor, beats: Mapping) -> torch.Tensor:
    """(B, n) → (B, ⌈n/2⌉): y[m] = Σ_k h[k]·x[2m + k − taps/2]."""
    taps = beats["decimation_taps"]
    h = torch.as_tensor(lowpass(taps, beats["decimation_cutoff"]),
                        dtype=torch.float32, device=audio.device)
    n = audio.shape[-1]
    x = F.pad(audio.float(), (taps // 2, taps // 2))
    out = (n + 1) // 2
    windows = x.unfold(-1, taps, 2)[:, :out]
    return windows @ h


def mel_banks(beats: Mapping, n_fft: int) -> np.ndarray:
    """(n_fft/2, bins) float64, Kaldi's filters without VTLN."""
    sr, bins = beats["sample_rate"], beats["num_mel_bins"]

    def mel(f):
        return 1127.0 * math.log(1.0 + f / 700.0)
    lo, hi = mel(beats["low_freq"]), mel(sr / 2.0)
    step = (hi - lo) / (bins + 1)
    out = np.zeros((n_fft // 2, bins))
    for j in range(n_fft // 2):
        m = mel(j * sr / n_fft)
        for i in range(bins):
            left, centre, right = (lo + i * step, lo + (i + 1) * step,
                                   lo + (i + 2) * step)
            out[j, i] = max(0.0, min((m - left) / (centre - left),
                                     (right - m) / (right - centre)))
    return out


def fbank(wave: torch.Tensor, beats: Mapping) -> torch.Tensor:
    """(B, n) at ``sample_rate`` → (B, frames, bins) normalised."""
    size, shift = beats["frame_length"], beats["frame_shift"]
    n_fft = 1
    while n_fft < size:
        n_fft *= 2
    x = wave.float() * 2.0 ** 15
    count = 1 + (x.shape[-1] - size) // shift
    idx = (torch.arange(count, device=x.device)[:, None] * shift
           + torch.arange(size, device=x.device)[None, :])
    fr = x[:, idx]
    fr = fr - fr.mean(dim=-1, keepdim=True)
    shifted = torch.cat([fr[..., :1], fr[..., :-1]], dim=-1)
    fr = fr - beats["preemphasis"] * shifted
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(size) / (size - 1))
    fr = fr * torch.as_tensor(hann ** 0.85, dtype=torch.float32,
                              device=x.device)
    fr = F.pad(fr, (0, n_fft - size))
    spec = torch.fft.rfft(fr, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[..., :n_fft // 2]
    banks = torch.as_tensor(mel_banks(beats, n_fft), dtype=torch.float32,
                            device=x.device)
    eps = float(np.finfo(np.float32).eps)
    logmel = torch.log(torch.clamp(power @ banks, min=eps))
    return (logmel - beats["fbank_mean"]) / (2.0 * beats["fbank_std"])


# --- the encoder ----------------------------------------------------------

def bucket(rel: np.ndarray, num_buckets: int, max_distance: int
           ) -> np.ndarray:
    """T5's bidirectional bucket of offsets ``rel`` (key − query), its
    logarithm in float32."""
    rel = np.asarray(rel, np.int64)
    half = num_buckets // 2
    exact = half // 2
    out = np.where(rel > 0, half, 0)
    n = np.abs(rel)
    with np.errstate(divide="ignore"):
        far = (np.log(np.maximum(n, 1).astype(np.float32) / np.float32(exact))
               / np.float32(math.log(max_distance / exact))
               * np.float32(half - exact)).astype(np.int64) + exact
    far = np.minimum(far, half - 1)
    return out + np.where(n < exact, n, far)


def _linear(x, sd, name, q: Q):
    return q(x) @ q(sd[name + ".weight"]).T + sd[name + ".bias"]


def _layer_norm(x, sd, name, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * sd[name + ".weight"] \
        + sd[name + ".bias"]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def position_bias(sd: Mapping, beats: Mapping, n: int) -> torch.Tensor:
    """P (H, n, n)."""
    table = sd["encoder.layers.0.self_attn.relative_attention_bias.weight"]
    pos = np.arange(n)
    b = bucket(pos[None, :] - pos[:, None], beats["num_buckets"],
               beats["max_distance"])
    return table[torch.as_tensor(b, device=table.device)].permute(2, 0, 1)


def attention(x, sd, at: str, bias, heads: int, q: Q = _ident,
              rel_bias: bool = True, gate: bool = True):
    """One layer's attention: (B, L, d) → (B, L, d). ``rel_bias`` and
    ``gate`` False leave out g·P or the gate (g = 1), for the tests."""
    b, n, d = x.shape

    def split(t):
        return t.reshape(b, n, heads, d // heads).permute(0, 2, 1, 3)
    qh = split(_linear(x, sd, at + "q_proj", q))
    kh = split(_linear(x, sd, at + "k_proj", q))
    vh = split(_linear(x, sd, at + "v_proj", q))
    s = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(d // heads)
    if rel_bias:
        g = 1.0
        if gate:
            gl = _linear(qh, sd, at + "grep_linear", q)     # (B, H, L, 8)
            ab = torch.sigmoid(gl.reshape(b, heads, n, 2, 4).sum(-1))
            g = ab[..., :1] * (ab[..., 1:] * sd[at + "grep_a"] - 1.0) + 2.0
        s = s + g * bias
    w = torch.softmax(s, dim=-1)
    o = (q(w) @ q(vh)).permute(0, 2, 1, 3).reshape(b, n, d)
    return _linear(o, sd, at + "out_proj", q)


def embed(fb: torch.Tensor, sd: Mapping, beats: Mapping,
          q: Q = _ident) -> torch.Tensor:
    """(B, frames, bins) fbank → (B, L, d): the patches, the position
    convolution and the encoder's LayerNorm, before the layers."""
    p, e = beats["input_patch_size"], beats["embed_dim"]
    bsz, t, f = fb.shape
    tp, fp = t // p, f // p
    patches = (fb[:, :tp * p].reshape(bsz, tp, p, fp, p)
               .permute(0, 1, 3, 2, 4).reshape(bsz, tp * fp, p * p))
    w = sd["patch_embedding.weight"].reshape(e, p * p)
    x = q(patches) @ q(w).T
    eps = beats["layer_norm_eps"]
    x = _layer_norm(x, sd, "layer_norm", eps)
    x = _linear(x, sd, "post_extract_proj", q)
    v = sd["encoder.pos_conv.0.weight_v"]
    g = sd["encoder.pos_conv.0.weight_g"]
    wc = g * v / torch.sqrt((v ** 2).sum(dim=(0, 1), keepdim=True))
    k = beats["conv_pos"]
    c = F.conv1d(q(x.transpose(1, 2)), q(wc), sd["encoder.pos_conv.0.bias"],
                 padding=k // 2, groups=beats["conv_pos_groups"])
    c = c[..., :x.shape[1]]
    return _layer_norm(x + _gelu(c).transpose(1, 2), sd, "encoder.layer_norm",
                       eps)


def layer(x: torch.Tensor, sd: Mapping, i: int, bias: torch.Tensor,
          beats: Mapping, q: Q = _ident, **attn) -> torch.Tensor:
    """Layer ``i``: (B, L, d) → (B, L, d)."""
    at = f"encoder.layers.{i}."
    eps = beats["layer_norm_eps"]
    alpha = (2.0 * beats["encoder_layers"]) ** 0.25
    a = attention(x, sd, at + "self_attn.", bias,
                  beats["encoder_attention_heads"], q, **attn)
    x = _layer_norm(alpha * x + a, sd, at + "self_attn_layer_norm", eps)
    h = _linear(_gelu(_linear(x, sd, at + "fc1", q)), sd, at + "fc2", q)
    return _layer_norm(alpha * x + h, sd, at + "final_layer_norm", eps)


def beats(fb: torch.Tensor, sd: Mapping, beats: Mapping, q: Q = _ident,
          **attn) -> torch.Tensor:
    """(B, frames, bins) fbank → (B, L, d) embeddings."""
    with _no_tf32():
        x = embed(fb, sd, beats, q)
        bias = position_bias(sd, beats, x.shape[1])
        for i in range(beats["encoder_layers"]):
            x = layer(x, sd, i, bias, beats, q, **attn)
        return x


# --- the fusion and the whole model ---------------------------------------

def align(emb: torch.Tensor, freq_patches: int, frames: int) -> torch.Tensor:
    """(B, N·F', d) → (B, frames, d): the mean over each time patch's F'
    frequency patches, then frame i the mean of time patches
    ⌊i·N/frames⌋ … ⌈(i + 1)·N/frames⌉ − 1."""
    b, n, d = emb.shape
    e = emb.reshape(b, n // freq_patches, freq_patches, d).mean(dim=2)
    n = e.shape[1]
    pool = torch.zeros(frames, n, device=emb.device)
    for i in range(frames):
        lo, hi = (i * n) // frames, -((-(i + 1) * n) // frames)
        pool[i, lo:hi] = 1.0 / (hi - lo)
    return pool @ e


def features(audio: torch.Tensor, params: Mapping, beats_cfg: Mapping,
             q: Q = _ident, **attn) -> torch.Tensor:
    """(B, samples) at twice the sample rate → (B, L, d)."""
    with _no_tf32():
        fb = fbank(decimate(audio, beats_cfg), beats_cfg)
        return beats(fb, params["beats"], beats_cfg, q, **attn)


def encode(audio: torch.Tensor, params: Mapping, stats: Mapping,
           config: Mapping, q: Q = _ident, **attn
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, samples) → ((B, T', 2H) the BiGRU's output, (B, L, d) BEATs'
    embeddings)."""
    with _no_tf32():
        model, bc = config["model"], config["beats"]
        enc, est = params["encoder"], stats["encoder"]
        h = R.cnn(log_mel(audio, config["audio"])[..., None], enc["cnn"],
                  est["cnn"], model, q).squeeze(2)
        emb = features(audio, params, bc, q, **attn)
        e = align(emb, bc["num_mel_bins"] // bc["input_patch_size"],
                  h.shape[1])
        cat = enc["cat_tf"]
        h = q(torch.cat([h, e], dim=-1)) @ q(cat["kernel"]) + cat["bias"]
        return R.bigru(h, enc["rnn"], model["n_layers_rnn"], q), emb


def forward(audio: torch.Tensor, params: Mapping, stats: Mapping,
            config: Mapping, q: Q = _ident, **attn
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, samples) → (strong (B, T', C), weak (B, C))."""
    h, _ = encode(audio, params, stats, config, q, **attn)
    return R.predictor(h, params["predictor"])
