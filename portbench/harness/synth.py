"""Audio made on the device from a seed: background noise under a few
tonal events (chirps with a Hann envelope), the rough shape of a field
recording with calls in it. Every seed gives the same number of clips of
the same length; only the content differs.

``spec`` keys: ``gain_db`` [lo, hi] (the background's level, dBFS),
``events`` (per clip), ``event_s`` [lo, hi] (length), ``freq_hz`` [lo,
hi] (start frequency), ``sweep_hz_per_s`` (largest |slope|),
``event_db`` [lo, hi] (level over the background).
"""
from __future__ import annotations

import math
from typing import Mapping

import torch


def _u(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand((n, 1), generator=gen, device=device)


def clips(seed: int, n: int, audio: Mapping, spec: Mapping, device,
          seconds: float = None) -> torch.Tensor:
    """(n, samples) float32 on ``device``."""
    sr = audio["sr"]
    seconds = audio["max_len_seconds"] if seconds is None else seconds
    samples = int(round(seconds * sr))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t = torch.arange(samples, device=device, dtype=torch.float32) / sr
    gain = 10.0 ** (_u(gen, n, *spec["gain_db"], device) / 20.0)
    x = torch.randn((n, samples), generator=gen, device=device) * gain
    for _ in range(spec["events"]):
        length = _u(gen, n, *spec["event_s"], device)
        on = _u(gen, n, 0.0, 1.0, device) * (seconds - length)
        f0 = _u(gen, n, *spec["freq_hz"], device)
        slope = _u(gen, n, -1.0, 1.0, device) * spec["sweep_hz_per_s"]
        amp = gain * 10.0 ** (_u(gen, n, *spec["event_db"], device) / 20.0)
        u = ((t - on) / length).clamp(0.0, 1.0)
        env = 0.5 - 0.5 * torch.cos(2 * math.pi * u)
        tl = t - on
        x += amp * env * torch.sin(2 * math.pi * (f0 * tl + 0.5 * slope
                                                  * tl * tl))
    return x
