"""Scheduled values and loss-weight ramps, as plain functions of the step.

Counterpart of `semi_detr_tpu/train/schedules.py`: the reference's
`Weighter` hook (`detr_ssod/utils/hooks/weight_adjust.py:7-35`, named
values set at given steps) and the warm-up ramp of `weighted_loss`
(`detr_ssod/utils/structure_utils.py:127-153`). Values are float32, as
the JAX package computes them.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def step_schedule(values: Sequence[float], boundaries: Sequence[int]):
    """values[i] applies from boundaries[i-1] (0 for i = 0) to
    boundaries[i]; len(values) == len(boundaries) + 1."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("need one more value than boundaries")

    def fn(step: int) -> np.float32:
        out = np.float32(values[0])
        for v, b in zip(values[1:], boundaries):
            if step >= b:
                out = np.float32(v)
        return out

    return fn


def linear_warmup(target: float, warmup_steps: int):
    """Ramp 0 -> target over the first `warmup_steps` steps, then hold."""
    def fn(step: int) -> np.float32:
        if warmup_steps <= 0:
            return np.float32(target)
        frac = np.clip(np.float32(step) / np.float32(warmup_steps),
                       np.float32(0), np.float32(1))
        return np.float32(target) * frac

    return fn


def constant(value: float):
    return lambda step: np.float32(value)
