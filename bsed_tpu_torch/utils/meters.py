"""Epoch metric aggregation + best-model / early-stop trackers.

The port's copy of ``bsed_tpu/utils/meters.py``. Reference:
src/utilities/utils.py:84-232 (SaveBest,
EarlyStopping, AverageMeter/AverageMeterSet).
"""
from __future__ import annotations

from typing import Dict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class AverageMeterSet:
    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}

    def update(self, name: str, value: float, n: int = 1):
        self.meters.setdefault(name, AverageMeter()).update(value, n)

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def __str__(self):
        return " ".join(f"{k}={m.avg:.4f}" for k, m in self.meters.items())


class SaveBest:
    """Track the best validation score ('sup' = higher is better)."""

    def __init__(self, compare: str = "sup"):
        assert compare in ("sup", "inf")
        self.compare = compare
        self.best_val = None
        self.best_epoch = None

    def apply(self, value: float, epoch: int = None) -> bool:
        better = (self.best_val is None
                  or (self.compare == "sup" and value > self.best_val)
                  or (self.compare == "inf" and value < self.best_val))
        if better:
            self.best_val = value
            self.best_epoch = epoch
        return better


class EarlyStopping:
    """Patience-based stopping with an initial grace period
    (utils.py:125-172: es_init_wait)."""

    def __init__(self, patience: int, init_wait: int = 0,
                 compare: str = "sup"):
        self.patience = patience
        self.init_wait = init_wait
        self.saver = SaveBest(compare)
        self.epochs_since_best = 0

    def apply(self, value: float, epoch: int) -> bool:
        """Returns True when training should STOP."""
        if self.saver.apply(value, epoch):
            self.epochs_since_best = 0
        else:
            self.epochs_since_best += 1
        if epoch < self.init_wait:
            return False
        return self.epochs_since_best >= self.patience
