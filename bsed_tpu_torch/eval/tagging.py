"""Clip-level (weak) tagging metrics.

Port of ``bsed_tpu/eval/tagging.py`` (reference
src/evaluation_measures.py:346-502
(``get_f_measure_by_class`` / ``intermediate_at_measures`` /
``macro_f_measure`` / ``audio_tagging_results``). Pure-numpy accumulation —
the model forward lives elsewhere; these operate on arrays of weak
predictions/targets (tensors are copied to the host first).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _host(a) -> np.ndarray:
    """A numpy array of ``a``; a tensor is copied to the host."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def binarize(probs: np.ndarray, threshold=0.5) -> np.ndarray:
    """Global or per-class threshold (ProbabilityEncoder semantics)."""
    thr = np.asarray(threshold)
    return (probs > thr).astype(probs.dtype)


def intermediate_at_measures(encoded_ref: np.ndarray, encoded_est: np.ndarray
                             ) -> Tuple[np.ndarray, ...]:
    """(tp, fp, fn, tn) per class (evaluation_measures.py:430-446)."""
    tp = ((encoded_est + encoded_ref) == 2).sum(axis=0)
    fp = ((encoded_est - encoded_ref) == 1).sum(axis=0)
    fn = ((encoded_ref - encoded_est) == 1).sum(axis=0)
    tn = ((encoded_est + encoded_ref) == 0).sum(axis=0)
    return tp, fp, fn, tn


def macro_f_measure(tp, fp, fn) -> np.ndarray:
    """Per-class F1 with zero for empty classes
    (evaluation_measures.py:449-464)."""
    tp = np.asarray(tp, dtype=np.float64)
    denom = 2 * tp + np.asarray(fp) + np.asarray(fn)
    out = np.zeros(tp.shape[-1] if tp.ndim else 1)
    mask = denom != 0
    out[mask] = 2 * tp[mask] / denom[mask]
    return out


class TaggingF1Accumulator:
    """Streaming per-class counts over batches, replacing the dataloader loop
    of get_f_measure_by_class (evaluation_measures.py:363-427)."""

    def __init__(self, n_tags: int):
        self.tp = np.zeros(n_tags)
        self.fp = np.zeros(n_tags)
        self.fn = np.zeros(n_tags)
        self.tn = np.zeros(n_tags)

    def update(self, weak_probs: np.ndarray, weak_targets: np.ndarray,
               threshold=0.5):
        weak_probs, weak_targets = _host(weak_probs), _host(weak_targets)
        if weak_probs.ndim == 3:       # strong-only model: max over time
            weak_probs = weak_probs.max(axis=1)
        if weak_targets.ndim == 3:
            weak_targets = binarize(weak_targets.max(axis=1))
        pred = binarize(weak_probs, threshold)
        tp, fp, fn, tn = intermediate_at_measures(weak_targets, pred)
        self.tp += tp
        self.fp += fp
        self.fn += fn
        self.tn += tn

    def per_class_f1(self) -> np.ndarray:
        return macro_f_measure(self.tp, self.fp, self.fn)

    def macro_f1(self) -> float:
        return float(self.per_class_f1().mean())
