"""Optimizer factory — the five ``optimizer_type`` variants of the
reference's ``configure_optimizers`` (`intrepppid_tpu/optim/factory.py`):

* ``ranger21``     — Ranger21, no warmup, no warmdown, weight_decay=1e-2
* ``ranger21_xx``  — Ranger21 with warmup + warmdown (start 0.72)
* ``adamw``        — torch-default AdamW (betas .9/.999, eps 1e-8, wd 1e-2)
* ``adamw_1cycle`` — AdamW + OneCycleLR over the full run
* ``adamw_cosine`` — AdamW + CosineAnnealingWarmRestarts (per epoch)

Ranger21 applies its own warmup/warmdown. The AdamW variants take their
learning rate per step from :func:`get_lr_schedule`, set on the param
groups by the caller (``train/trainer.py``) before each ``step()``.
"""
from __future__ import annotations

import torch

from intrepppid_tpu_torch.optim.ranger21 import Ranger21, ranger21_lr_schedule
from intrepppid_tpu_torch.optim.schedules import Schedule, cosine_warm_restarts, onecycle

OPTIMIZER_TYPES = ("ranger21", "ranger21_xx", "adamw", "adamw_1cycle", "adamw_cosine")


def _check(optimizer_type: str) -> None:
    if optimizer_type not in OPTIMIZER_TYPES:
        raise ValueError(
            'Expected one of "ranger21", "adamw", "ranger21_xx", "adamw_1cycle", '
            f'or "adamw_cosine" as the optimizer type, got {optimizer_type!r}.'
        )


def make_optimizer(optimizer_type: str, params, lr: float, steps_per_epoch: int,
                   num_epochs: int) -> torch.optim.Optimizer:
    """The optimizer over ``params`` (tensors or param groups; a group may
    carry ``direction_stacked``, see ``Ranger21``)."""
    _check(optimizer_type)
    total_steps = max(steps_per_epoch * num_epochs, 1)
    if optimizer_type.startswith("ranger21"):
        xx = optimizer_type == "ranger21_xx"
        return Ranger21(params, lr, num_iterations=total_steps, weight_decay=1e-2,
                        use_warmup=xx, warmdown_active=xx, warmdown_start_pct=0.72)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)


def get_lr_schedule(optimizer_type: str, lr: float, steps_per_epoch: int,
                    num_epochs: int) -> Schedule:
    """The LR-vs-step curve (the reference's LearningRateMonitor); for the
    AdamW variants also the rate each step runs at (step = number of
    earlier updates)."""
    _check(optimizer_type)
    total_steps = max(steps_per_epoch * num_epochs, 1)
    if optimizer_type == "ranger21_xx":
        return ranger21_lr_schedule(lr, total_steps, True, True)
    if optimizer_type == "adamw_1cycle":
        return onecycle(lr, total_steps)
    if optimizer_type == "adamw_cosine":
        return cosine_warm_restarts(lr, steps_per_epoch)
    return lambda step: lr
