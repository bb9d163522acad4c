"""Optimizers and learning-rate schedules (`intrepppid_tpu/optim`)."""
from intrepppid_tpu_torch.optim.factory import (
    OPTIMIZER_TYPES,
    get_lr_schedule,
    make_optimizer,
)
from intrepppid_tpu_torch.optim.ranger21 import Ranger21, ranger21_lr_schedule

__all__ = ["OPTIMIZER_TYPES", "Ranger21", "get_lr_schedule", "make_optimizer",
           "ranger21_lr_schedule"]
