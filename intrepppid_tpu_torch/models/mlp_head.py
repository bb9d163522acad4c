"""MLP pair-classifier head (`intrepppid_tpu/models/mlp_head.py:22-56`).

Averages the two sequence embeddings, then ``Mish -> Linear(E, E/2) ->
Mish -> Mish -> Linear(E/2, 1)``. The back-to-back Mish with no Linear
between is a reference quirk. The dropouts and DropConnect between them
are the identity at eval, which is all this slice ports. The linears run
in f32 whatever the encoder's compute dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from intrepppid_tpu_torch.models.awd_lstm import linear, new_linear
from intrepppid_tpu_torch.ops.activations import mish


class MLPHead(nn.Module):
    def __init__(self, embedding_size: int, gen: torch.Generator):
        super().__init__()
        self.fc1 = new_linear(embedding_size, embedding_size // 2, gen)
        self.fc2 = new_linear(embedding_size // 2, 1, gen)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        """One logit per pair, shape ``(B, 1)``."""
        x = mish((z1 + z2) / 2.0)
        x = mish(linear(self.fc1, x))
        x = mish(x)
        return linear(self.fc2, x)
