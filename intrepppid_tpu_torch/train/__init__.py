"""Training (`intrepppid_tpu/train`): the train loop, its steps, checkpoints."""
from intrepppid_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_params_from_checkpoint,
)
from intrepppid_tpu_torch.train.trainer import EpochAccumulator, Trainer

__all__ = ["CheckpointManager", "EpochAccumulator", "Trainer", "load_params_from_checkpoint"]
