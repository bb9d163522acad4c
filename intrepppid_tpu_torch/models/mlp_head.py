"""MLP pair-classifier head (`intrepppid_tpu/models/mlp_head.py:22-56`).

Averages the two sequence embeddings, then ``Mish -> DropConnect(Linear(E,
E/2)) -> Mish -> Dropout -> Mish -> Dropout -> DropConnect(Linear(E/2,
1))``. The back-to-back Mish with no Linear between is a reference quirk.
Both weights take per-element DropConnect in training (biases are not
dropped); every dropout is the identity at eval. The linears run in f32
whatever the encoder's compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from intrepppid_tpu_torch.models.awd_lstm import new_linear
from intrepppid_tpu_torch.ops.activations import mish
from intrepppid_tpu_torch.ops.dropout import dropconnect_weight, dropout


class MLPHead(nn.Module):
    def __init__(self, embedding_size: int, gen: torch.Generator):
        super().__init__()
        self.fc1 = new_linear(embedding_size, embedding_size // 2, gen)
        self.fc2 = new_linear(embedding_size // 2, 1, gen)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor, do_rate: float = 0.0,
                train: bool = False, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """One logit per pair, shape ``(B, 1)``; ``train`` turns the
        dropouts (rate ``do_rate``) on, drawing from ``gen``."""
        def fc(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
            w = dropconnect_weight(layer.weight, do_rate, train, gen)
            return F.linear(x.float(), w.float(), layer.bias.float())

        x = mish((z1 + z2) / 2.0)
        x = mish(fc(self.fc1, x))
        x = mish(dropout(x, do_rate, train, gen))
        x = dropout(x, do_rate, train, gen)
        return fc(self.fc2, x)
