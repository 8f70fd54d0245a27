"""Learning-rate schedule. Port of ``bsed_tpu/train/schedule.py``
(reference main_baseline.py:53-88): lr = sigmoid_rampdown(epoch, 30) ·
max_lr, halved every 20 epochs past epoch 100; with ``adjust=False`` the
constant max_lr."""
from __future__ import annotations

import math

from bsed_tpu_torch.train.ramps import sigmoid_rampdown


def learning_rate(epoch, max_lr: float = 5e-4, adjust: bool = False,
                  rampdown_epochs: int = 30) -> float:
    if not adjust:
        return float(max_lr)
    epoch = float(epoch)
    lr = sigmoid_rampdown(epoch, rampdown_epochs) * max_lr
    if epoch > 100:
        lr *= 0.5 ** (1.0 + math.floor((epoch - 100.0) / 20.0))
    return lr
