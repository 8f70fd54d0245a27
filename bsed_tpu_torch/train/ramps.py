"""Ramp schedules. Port of ``bsed_tpu/train/ramps.py`` (reference
utilities/ramps.py:4-31), as Python floats: the port computes them on the
host once per step (the step count is a host integer in the port's train
state)."""
from __future__ import annotations

import math


def _phase(current, length: int) -> float:
    current = min(max(float(current), 0.0), float(length))
    return 1.0 - current / length


def exp_rampup(current, rampup_length) -> float:
    """exp(−5 (1−t)²) ramp-up (Laine & Aila 2016): the per-step
    consistency-cost ramp of the exp_step lineage (main_scmt.py:261,515)."""
    if rampup_length == 0:
        return 1.0
    p = _phase(current, rampup_length)
    return math.exp(-5.0 * p * p)


def sigmoid_rampdown(current, rampup_length: int) -> float:
    """exp(−12.5 (1−t)²): despite the reference's name this ramps UP to 1
    at ``rampup_length``; the lr warm-up and the consistency-cost ramp
    (main_baseline.py:285)."""
    if rampup_length == 0:
        return 1.0
    p = _phase(current, rampup_length)
    return math.exp(-12.5 * p * p)


def sigmoid_rampup(current, rampup_length) -> float:
    """The mean teacher's standard sigmoid ramp-up
    (get_current_consistency_weight, main_baseline.py:126-130)."""
    return exp_rampup(current, rampup_length)


def cosine_rampdown(current, rampdown_length) -> float:
    return 0.5 * (math.cos(math.pi * float(current) / rampdown_length) + 1.0)
