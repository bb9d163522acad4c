"""Optimizers, learning-rate schedules and SWA (`intrepppid_tpu/optim`)."""
from intrepppid_tpu_torch.optim.factory import (
    OPTIMIZER_TYPES,
    get_lr_schedule,
    make_optimizer,
)
from intrepppid_tpu_torch.optim.ranger21 import Ranger21, ranger21_lr_schedule
from intrepppid_tpu_torch.optim.swa import SWAConfig, SWAState

__all__ = ["OPTIMIZER_TYPES", "Ranger21", "SWAConfig", "SWAState", "get_lr_schedule",
           "make_optimizer", "ranger21_lr_schedule"]
