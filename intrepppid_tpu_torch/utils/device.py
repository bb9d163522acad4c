"""Device selection shared by the entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, raising when a CUDA device is asked for on a
    machine without one: the entry points run on the card unless the caller
    asks for the CPU, and never drop to the CPU on their own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev
