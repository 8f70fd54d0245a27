"""Ramp schedules. Port of ``bsed_tpu/train/ramps.py`` (reference
utilities/ramps.py:4-31), as Python floats: the port computes them on the
host once per step. Only the ramp of the ported step is here; the
exp_step ramp comes with its lineages (ROADMAP item 8)."""
from __future__ import annotations

import math


def _phase(current, length: int) -> float:
    current = min(max(float(current), 0.0), float(length))
    return 1.0 - current / length


def sigmoid_rampdown(current, rampup_length: int) -> float:
    """exp(−12.5 (1−t)²): despite the reference's name this ramps UP to 1
    at ``rampup_length``; the lr warm-up and the consistency-cost ramp
    (main_baseline.py:285)."""
    if rampup_length == 0:
        return 1.0
    p = _phase(current, rampup_length)
    return math.exp(-12.5 * p * p)
