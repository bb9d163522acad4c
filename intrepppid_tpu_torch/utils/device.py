"""Device selection shared by the entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, raising when a CUDA device is asked for on a
    machine without one: the entry points run on the card unless the caller
    asks for the CPU, and never drop to the CPU on their own. Inside a
    process group, ``cuda`` without an index is this process's card,
    ``cuda:{LOCAL_RANK}`` (raising where the machine has no such card); an
    explicit ``cuda:N`` is taken as given."""
    from intrepppid_tpu_torch.parallel.mesh import is_initialized, local_rank

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and is_initialized():
        index, count = local_rank(), torch.cuda.device_count()
        if index >= count:
            raise RuntimeError(f"LOCAL_RANK {index} has no card: this machine has {count}")
        dev = torch.device("cuda", index)
    return dev
