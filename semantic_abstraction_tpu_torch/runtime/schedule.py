"""LR schedules with HF transformers' ``get_scheduler`` semantics.

Counterpart of ``semantic_abstraction_tpu/runtime/schedule.py``: the
reference trains with ``get_scheduler("cosine_with_restarts",
num_warmup_steps=1024, ...)`` (reference utils.py:267-274). Each schedule
is a plain ``step -> scale`` float function; the optimizer multiplies the
base lr by it.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def warmup_cosine_with_restarts(num_warmup_steps: int, num_training_steps: int,
                                num_cycles: int = 1) -> Schedule:
    def schedule(step):
        if step < num_warmup_steps:
            return step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(
            1.0, num_training_steps - num_warmup_steps)
        if progress >= 1.0:
            return 0.0
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((num_cycles * progress) % 1.0))))

    return schedule


def warmup_linear(num_warmup_steps: int, num_training_steps: int) -> Schedule:
    def schedule(step):
        if step < num_warmup_steps:
            return step / max(1.0, num_warmup_steps)
        return max(0.0, (num_training_steps - step)
                   / max(1.0, num_training_steps - num_warmup_steps))

    return schedule


def warmup_constant(num_warmup_steps: int) -> Schedule:
    return lambda step: min(1.0, step / max(1.0, num_warmup_steps))


def warmup_cosine(num_warmup_steps: int, num_training_steps: int,
                  num_cycles: float = 0.5) -> Schedule:
    def schedule(step):
        if step < num_warmup_steps:
            return step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(
            1.0, num_training_steps - num_warmup_steps)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return schedule


def constant() -> Schedule:
    return lambda step: 1.0


def make_schedule(name: str, num_warmup_steps: int,
                  num_training_steps: int) -> Schedule:
    """The reference's --lr_scheduler_type choices (utils.py:101-110)."""
    if name == "constant":
        return constant()
    if name == "constant_with_warmup":
        return warmup_constant(num_warmup_steps)
    if name == "linear":
        return warmup_linear(num_warmup_steps, num_training_steps)
    if name == "cosine":
        return warmup_cosine(num_warmup_steps, num_training_steps)
    if name == "cosine_with_restarts":
        return warmup_cosine_with_restarts(num_warmup_steps, num_training_steps)
    raise ValueError(f"unknown scheduler {name!r}")
