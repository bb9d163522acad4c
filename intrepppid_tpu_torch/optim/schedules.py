"""LR schedules matching the reference's torch schedulers
(`intrepppid_tpu/optim/schedules.py`), as functions of the 0-based step.

* ``onecycle``: ``OneCycleLR`` defaults (pct_start=0.3, cosine anneal,
  div_factor=25, final_div_factor=1e4);
* ``cosine_warm_restarts``: ``CosineAnnealingWarmRestarts(T_0=10,
  T_mult=2, eta_min=1e-6)`` stepped per epoch.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def onecycle(max_lr: float, total_steps: int, pct_start: float = 0.3,
             div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """Phase boundaries at ``pct_start*total - 1`` and ``total - 1``, each
    phase a cosine from its start to its end value."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_steps = float(pct_start * total_steps) - 1.0
    down_steps = float(total_steps - 1) - up_steps

    def cos(start, end, pct):
        return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))

    def schedule(step: int) -> float:
        step = float(step)
        if step <= up_steps:
            return cos(initial_lr, max_lr, min(max(step / max(up_steps, 1e-9), 0.0), 1.0))
        pct = min(max((step - up_steps) / max(down_steps, 1e-9), 0.0), 1.0)
        return cos(max_lr, min_lr, pct)

    return schedule


def cosine_warm_restarts(base_lr: float, steps_per_epoch: int, t_0: int = 10,
                         t_mult: int = 2, eta_min: float = 1e-6) -> Schedule:
    """Per-epoch SGDR schedule as a function of the global step."""

    def schedule(step: int) -> float:
        epoch = math.floor(step / steps_per_epoch)
        if t_mult == 1:
            t_cur, t_i = epoch % t_0, float(t_0)
        else:
            n = math.floor(math.log(epoch * (t_mult - 1) / t_0 + 1.0) / math.log(t_mult))
            t_cur = epoch - t_0 * (t_mult ** n - 1.0) / (t_mult - 1.0)
            t_i = t_0 * t_mult ** n
        return eta_min + (base_lr - eta_min) * (1.0 + math.cos(math.pi * t_cur / t_i)) / 2.0

    return schedule
