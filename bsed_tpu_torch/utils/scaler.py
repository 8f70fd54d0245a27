"""Feature normalization statistics.

The port's copy of ``bsed_tpu/utils/scaler.py``. Reference:
src/utilities/Scaler.py — a dataset-level
streaming mean/std scaler (:97-135, JSON-serializable) and per-audio
normalizers (:138-198). Whether normalization is LIVE splits by lineage:

* main_baseline / *_weak* / pseudo_labeling: ``calculate_scaler`` is
  commented out and transforms get ``scaler=None`` (main_baseline.py:700-713)
  — normalization OFF.
* main.py fits a scaler on ConcatDataset([ENA train, SYN]) (:681-686,
  ``cfg.only_syn=True`` branch) and PASSES it to the train transforms
  (:689-690); per-epoch validation uses a SEPARATE scaler fit on the val
  set (:696-699). Normalization is ON for that script → the repo's
  ``TrainConfig.normalize`` / "origin" preset.
* main_scmt.py:783 / main_origin.py:620 / main_scmt_ada_origin.py:907
  reference the UNDEFINED ``cfg.syn_or_not`` → AttributeError at startup
  (bit-rot; those scripts cannot reach training at HEAD). The repo's
  presets for them run with normalize=False and note the crash.
* main_scmt_ada.py:748-754 fits a scaler but passes None to every
  transform (:756-768) — dead work; OFF.
* TestModel.py:225-231 fits a scaler on the val set and never applies it —
  the standalone checkpoint-eval CLI does NOT normalize, so neither does
  ``cli eval``.
"""
from __future__ import annotations

import json
from typing import Iterable

import numpy as np


class Scaler:
    """Dataset-level mean/std over the time axis, accumulated streaming as
    mean-of-means and mean-of-mean-squares (Scaler.py:97-110)."""

    def __init__(self):
        self.mean_ = None
        self.std_ = None

    def calculate_scaler(self, dataset: Iterable) -> None:
        s1 = None
        s2 = None
        n = 0
        for item in dataset:
            x = np.asarray(item[0], dtype=np.float64)
            m1 = x.mean(axis=-2)
            m2 = (x ** 2).mean(axis=-2)
            s1 = m1 if s1 is None else s1 + m1
            s2 = m2 if s2 is None else s2 + m2
            n += 1
        self.mean_ = s1 / n
        self.std_ = np.sqrt(np.maximum(s2 / n - self.mean_ ** 2, 0.0))

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean_) / np.where(self.std_ == 0, 1.0, self.std_)

    def state_dict(self) -> dict:
        return {"mean": np.asarray(self.mean_).tolist(),
                "std": np.asarray(self.std_).tolist()}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.state_dict(), f)

    def load(self, path: str) -> "Scaler":
        with open(path) as f:
            state = json.load(f)
        self.mean_ = np.asarray(state["mean"])
        self.std_ = np.asarray(state["std"])
        return self


class ScalerPerAudio:
    """Per-sample normalization: 'standard' | 'max' | 'min-max', with the
    reference's NaN guard (Scaler.py:138-198)."""

    def __init__(self, normalization: str = "standard"):
        self.normalization = normalization

    def normalize(self, x: np.ndarray) -> np.ndarray:
        if self.normalization == "standard":
            std = x.std()
            out = (x - x.mean()) / (std if std else 1.0)
        elif self.normalization == "max":
            peak = np.abs(x).max()
            out = x / (peak if peak else 1.0)
        elif self.normalization == "min-max":
            rng = x.max() - x.min()
            out = (x - x.min()) / (rng if rng else 1.0)
        else:
            raise ValueError(self.normalization)
        return np.nan_to_num(out)


def fit_log_mel_stats(datasets, chunk: int = 256):
    """Per-mel-bin (mean, std) of the LOG-mel features over the union of
    ``datasets`` — the statistics main.py's live scaler computes: samples
    are ApplyLog'd before the fit (ENA_Dataset(compute_log=True) +
    get_transforms' ApplyLog, Scaler.means averages per-SAMPLE means with
    equal weight per sample, Scaler.py:48-80).

    Datasets store LINEAR mel (the reference defers the log to the
    transform); the log here is ops.mel.amplitude_to_db — the same
    function the train step applies — so train-time normalization sees
    exactly these statistics. It runs on the CPU in float32. Returns
    float32 numpy arrays of shape (F,).
    """
    import torch

    from bsed_tpu_torch.ops.mel import amplitude_to_db

    s1 = s2 = None
    n = 0
    for ds in datasets:
        if ds is None:
            continue
        fn = getattr(ds, "as_arrays", None)
        if fn is not None:
            feats = fn()[0]
            batches = (feats[i:i + chunk] for i in range(0, len(feats),
                                                         chunk))
        else:
            batches = (np.stack([np.asarray(ds[i][0])
                                 for i in range(j, min(j + chunk, len(ds)))])
                       for j in range(0, len(ds), chunk))
        for x in batches:
            log = amplitude_to_db(torch.as_tensor(
                np.asarray(x, np.float32))).numpy().astype(np.float64)
            s1 = log.mean(1).sum(0) + (0.0 if s1 is None else s1)
            s2 = (log ** 2).mean(1).sum(0) + (0.0 if s2 is None else s2)
            n += log.shape[0]
    if n == 0:
        raise ValueError("fit_log_mel_stats: no samples in any dataset")
    mean = s1 / n
    std = np.sqrt(np.maximum(s2 / n - mean ** 2, 0.0))
    return (mean.astype(np.float32),
            np.where(std == 0, 1.0, std).astype(np.float32))
