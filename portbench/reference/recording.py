"""Plain reference of raw-audio inference: a WAV file → frame posteriors
on one timeline → events.

* ``read_wav``: 16-bit PCM scaled by 1/32767, channels averaged,
  resampled to the model's rate by a polyphase filter
  (``scipy.signal.resample_poly``) at the reduced ratio of the two rates;
* ``timeline``: the recording cut into clip-long windows every clip
  length, the last window ending at the recording's end, padded to one
  clip when shorter; each window's frame posteriors placed at
  round(start / frame seconds), overlaps averaged, frames no window
  covers left at 0;
* ``events``: posteriors above the threshold, a binary median filter over
  time (``scipy.ndimage.median_filter``, its default 'reflect' edges),
  then every run of ones as (class, onset s, offset s), offsets
  exclusive.

Imports nothing of the program.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Callable, List, Mapping, Tuple

import numpy as np


def read_wav(path: str, sr: int) -> np.ndarray:
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    rate, data = wavfile.read(path)
    if data.dtype != np.int16:
        raise ValueError(f"{path}: expected 16-bit PCM, got {data.dtype}")
    x = data.astype(np.float32) / 32767.0
    if x.ndim == 2:
        x = x.mean(axis=1)
    if rate != sr:
        f = Fraction(sr, rate).limit_denominator(1000)
        x = resample_poly(x, f.numerator, f.denominator).astype(np.float32)
    return x


def frame_seconds(audio: Mapping, model: Mapping) -> float:
    ratio = 1
    for pt, _ in model["pooling"]:
        ratio *= pt
    return ratio * audio["hop_size"] / audio["sr"]


def timeline(x: np.ndarray, forward: Callable, audio: Mapping,
             model: Mapping, frames_per_clip: int,
             batch: int = 64) -> np.ndarray:
    """(frames, classes) float32 posteriors of the recording ``x``;
    ``forward(windows (n, clip samples)) -> (n, frames, classes)``."""
    clip = int(audio["sr"] * audio["max_len_seconds"])
    if len(x) < clip:
        x = np.pad(x, (0, clip - len(x)))
    starts = list(range(0, len(x) - clip + 1, clip))
    if starts[-1] + clip < len(x):
        starts.append(len(x) - clip)
    sec = frame_seconds(audio, model)
    firsts = [int(round(s / audio["sr"] / sec)) for s in starts]
    total = firsts[-1] + frames_per_clip
    acc = np.zeros((total, model["nclass"]))
    cnt = np.zeros((total, 1))
    for i in range(0, len(starts), batch):
        win = np.stack([x[s:s + clip] for s in starts[i:i + batch]])
        out = forward(win)
        for f0, post in zip(firsts[i:i + batch], out):
            acc[f0:f0 + frames_per_clip] += post
            cnt[f0:f0 + frames_per_clip] += 1.0
    # frames no window covers (a clip is 313.7 frames long) stay 0
    return np.where(cnt > 0, acc / np.maximum(cnt, 1.0), 0.0
                    ).astype(np.float32)


def events(post: np.ndarray, threshold: float, window: int,
           sec: float) -> List[Tuple[int, float, float]]:
    """(class, onset s, offset s) of every run of ones, by class then
    onset."""
    from scipy.ndimage import median_filter

    act = (post > threshold).astype(np.int8)
    if window > 1:
        act = median_filter(act, size=(window, 1))
    out = []
    for c in range(act.shape[1]):
        d = np.diff(np.concatenate([[0], act[:, c], [0]]))
        for on, off in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
            out.append((c, on * sec, off * sec))
    return out
