"""The quintuplet end-to-end network (`intrepppid_tpu/models/triplet.py:42-144`).

One shared encoder runs five times per step: on the interaction pair (BCE
loss) and on the anchor/positive/negative orthologue triplet (triplet
margin loss); the total is their β-weighted sum. The five encoder calls are
stacked group-major into one ``groups=5`` batch, so each call keeps its own
truncation length and its own dropout masks; ``forward`` stacks the pair
the same way with ``groups=2``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from intrepppid_tpu_torch.models.awd_lstm import (
    AWDLSTMEncoder,
    EncoderConfig,
    linear,
    new_linear,
)
from intrepppid_tpu_torch.models.mlp_head import MLPHead
from intrepppid_tpu_torch.ops.activations import mish
from intrepppid_tpu_torch.ops.losses import (
    bce_with_logits,
    combined_triplet_loss,
    triplet_margin_loss,
)
from intrepppid_tpu_torch.ops.metrics import all_binary_metrics

TOKEN_KEYS = ("anchor", "positive", "negative", "p1", "p2")


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
            # triplet_projection = Mish -> Linear(E, E), applied by ``step``
            # to the triplet's three embeddings
            self.triplet_projection = new_linear(
                cfg.embedding_size, cfg.embedding_size, gen
            )

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Pair logits ``(B, 1)`` for token ids ``x1``, ``x2`` ``(B, T)``."""
        B = x1.shape[0]
        z = self.encoder(torch.cat([x1, x2]), groups=2, train=train, gen=gen)
        return self.head(z[:B], z[B:], self.cfg.do_rate, train, gen)

    def step(self, batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator] = None,
             train: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One quintuplet step: ``(loss, aux)`` with the reference's logged
        quantities (losses and the five batch metrics).

        ``batch`` holds ``anchor, positive, negative, p1, p2`` token ids
        ``(B, T)`` and ``label (B,)``; an optional ``weight (B,)`` masks rows
        out of the losses and metrics (0 for padding rows).
        """
        cfg = self.cfg
        ids = torch.cat([batch[k] for k in TOKEN_KEYS])
        z = self.encoder(ids, groups=5, train=train, gen=gen)
        z_anchor, z_positive, z_negative, z1, z2 = z.chunk(5)
        if cfg.use_projection:
            proj = self.triplet_projection
            z_anchor, z_positive, z_negative = (
                linear(proj, mish(t)) for t in (z_anchor, z_positive, z_negative)
            )
        weights = batch.get("weight")
        triplet_loss = triplet_margin_loss(
            z_anchor, z_positive, z_negative, margin=cfg.triplet_margin, weights=weights
        )
        logits = self.head(z1, z2, cfg.do_rate, train, gen).squeeze(-1)
        y = batch["label"].float()
        classifier_loss = bce_with_logits(logits, y, weights)
        loss = combined_triplet_loss(classifier_loss, triplet_loss, cfg.beta_classifier)
        aux = {"loss": loss.detach(), "classifier_loss": classifier_loss.detach(),
               "triplet_loss": triplet_loss.detach()}
        aux.update(all_binary_metrics(logits.detach(), y, weights))
        return loss, aux
