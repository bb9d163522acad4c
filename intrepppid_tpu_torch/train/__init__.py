"""Training (`intrepppid_tpu/train`, partial): the train step and its bookkeeping."""
from intrepppid_tpu_torch.train.trainer import EpochAccumulator, Trainer

__all__ = ["EpochAccumulator", "Trainer"]
