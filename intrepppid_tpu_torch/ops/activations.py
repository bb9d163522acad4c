"""Activation functions (`intrepppid_tpu/ops/activations.py` counterpart)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation: ``x * tanh(softplus(x))`` (``torch.nn.Mish``)."""
    return x * torch.tanh(F.softplus(x))
