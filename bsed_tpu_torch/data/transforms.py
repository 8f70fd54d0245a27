"""Host-side sample transforms (capability parity with the reference's
src/data/Transforms.py); the port's copy of ``bsed_tpu/data/transforms.py``.

In this framework the hot transforms run ON DEVICE inside the train step
(noise: ops/augment.gaussian_snr_noise; log: ops/mel.amplitude_to_db;
pad/trunc: datasets.pad_or_trunc). These host-side classes exist for the
remaining reference surface: composable pipelines for offline tooling and
the leftover normalization variants.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from bsed_tpu_torch.data.datasets import pad_or_trunc


class Transform:
    """Applies to (data-or-tuple, label) samples (Transforms.py:18-28)."""

    def transform_data(self, data):
        return data

    def transform_label(self, label):
        return label

    def _apply(self, data):
        if isinstance(data, tuple):
            return tuple(self.transform_data(d) for d in data)
        return self.transform_data(data)

    def __call__(self, sample):
        data, label = sample
        return self._apply(data), self.transform_label(label)


class ApplyLog(Transform):
    """librosa.amplitude_to_db semantics (Transforms.py:74-86)."""

    def transform_data(self, data):
        power = np.square(data.astype(np.float64))
        db = 10.0 * np.log10(np.maximum(1e-10, power))
        return np.maximum(db, db.max() - 80.0).astype(np.float32)


class AugmentGaussianNoise(Transform):
    """Returns (clean, noisy) with SNR-targeted noise; clean feeds the
    student and noisy the EMA teacher (Transforms.py:142-197)."""

    def __init__(self, mean: float = 0.0, std: Optional[float] = None,
                 snr: Optional[float] = None, rng=None):
        self.mean = mean
        self.std = std
        self.snr = snr
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        data, label = sample
        if self.std is not None:
            noisy = data + np.abs(
                self.rng.normal(0, 0.5 ** 2, data.shape))
        elif self.snr is not None:
            std = np.sqrt(np.mean(
                (data ** 2) * (10 ** (-self.snr / 10)), axis=-2))
            noisy = data + self.rng.normal(0, 1.0, data.shape) * std
        else:
            raise NotImplementedError("need std or snr")
        return (data, noisy.astype(data.dtype)), label


class PadOrTrunc(Transform):
    def __init__(self, nb_frames: int, apply_to_label: bool = False):
        self.nb_frames = nb_frames
        self.apply_to_label = apply_to_label

    def transform_data(self, data):
        return pad_or_trunc(data, self.nb_frames)

    def transform_label(self, label):
        if self.apply_to_label:
            return pad_or_trunc(label, self.nb_frames)
        return label


class Normalize(Transform):
    def __init__(self, scaler):
        self.scaler = scaler

    def transform_data(self, data):
        return self.scaler.normalize(data)


class MinMaxNormalization(Transform):
    """Transforms.py:286-301."""

    def transform_data(self, data):
        rng = data.max() - data.min()
        return (data - data.min()) / (rng if rng else 1.0)


class CombineChannels(Transform):
    """Source-separation leftover (Transforms.py:253-283): combine the
    mixture channel with the mean of the separated-source channels."""

    def __init__(self, combine_on: str = "max", n_channel_mix: int = 2):
        self.combine_on = combine_on
        self.n_channel_mix = n_channel_mix

    def transform_data(self, data):
        if data.ndim < 3:
            return data
        mix = data[:1]
        sources = data[1:]
        if self.combine_on == "max":
            comb = sources.max(axis=0, keepdims=True)
        else:
            comb = sources.mean(axis=0, keepdims=True)
        return np.concatenate([mix, comb], axis=0)


class Compose:
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def add_transform(self, t: Transform) -> "Compose":
        return Compose(self.transforms + [t])

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def get_transforms(frames: int, scaler=None, noise_snr: Optional[float] = None,
                   rng=None) -> Compose:
    """Active reference pipeline (Transforms.py:304-322):
    [AugmentGaussianNoise?, ApplyLog, PadOrTrunc, (Normalize?)]."""
    ts: List[Transform] = []
    if noise_snr is not None:
        ts.append(AugmentGaussianNoise(snr=noise_snr, rng=rng))
    ts.extend([ApplyLog(), PadOrTrunc(frames)])
    if scaler is not None:
        ts.append(Normalize(scaler))
    return Compose(ts)
