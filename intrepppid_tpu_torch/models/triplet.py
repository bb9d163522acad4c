"""The quintuplet end-to-end network (`intrepppid_tpu/models/triplet.py:42-92`).

Only the pair forward is ported: the two encoder calls are stacked into one
``groups=2`` batch, so each call keeps its own truncation length. ``step``,
the losses and the metrics come with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from intrepppid_tpu_torch.models.awd_lstm import AWDLSTMEncoder, EncoderConfig, new_linear
from intrepppid_tpu_torch.models.mlp_head import MLPHead


@dataclass(frozen=True)
class TripletE2EConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    do_rate: float = 0.3
    beta_classifier: float = 2.0
    use_projection: bool = False
    triplet_margin: float = 1.0

    @property
    def embedding_size(self) -> int:
        return self.encoder.embedding_size


class TripletE2ENet(nn.Module):
    def __init__(self, cfg: TripletE2EConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.encoder = AWDLSTMEncoder(cfg.encoder, gen)
        self.head = MLPHead(cfg.embedding_size, gen)
        if cfg.use_projection:
            # triplet_projection = Mish -> Linear(E, E); used only by the
            # training step, kept so checkpoints map one to one
            self.triplet_projection = new_linear(
                cfg.embedding_size, cfg.embedding_size, gen
            )

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """Pair logits ``(B, 1)`` for token ids ``x1``, ``x2`` ``(B, T)``."""
        if train:
            raise NotImplementedError(
                "the training forward (dropout, weight drop) is not ported yet: "
                "ROADMAP.md, queue A, item 1 (training slice)"
            )
        B = x1.shape[0]
        z = self.encoder(torch.cat([x1, x2]), groups=2)
        return self.head(z[:B], z[B:])
