"""Train state. Port of ``bsed_tpu/train/state.py``: what the JAX package
keeps as one immutable pytree is here the student and teacher modules and
the optimizer, which the step updates in place, plus the step count."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module             # student: encoder + predictor
    ema_model: torch.nn.Module         # mean teacher (no gradients)
    optimizer: torch.optim.Optimizer   # Adam over the student's parameters
