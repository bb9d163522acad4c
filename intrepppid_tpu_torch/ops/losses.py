"""Losses of the quintuplet step (`intrepppid_tpu/ops/losses.py`).

* ``bce_with_logits`` — ``nn.BCEWithLogitsLoss`` (mean reduction);
* ``pairwise_distance`` — ``F.pairwise_distance``: ``eps`` is added to the
  difference before the norm;
* ``triplet_margin_loss`` — ``nn.TripletMarginLoss(margin=1.0, p=2)``;
* ``combined_triplet_loss`` — the β-weighted sum as the reference codes it
  (classifier ``1 - 1/β``, triplet ``1/β``; its docstrings say the
  opposite).

Optional per-row ``weights`` turn each mean into a weighted mean, so rows
of weight 0 (padding) drop out; all-ones weights give the plain mean.
"""
from __future__ import annotations

from typing import Optional

import torch


def _mean(loss: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return loss.mean()
    w = weights.float()
    return (loss * w).sum() / w.sum().clamp_min(1e-9)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross-entropy on logits, ``max(x,0) - x*y +
    log1p(exp(-|x|))`` as torch computes it."""
    x, y = logits.float(), targets.float()
    loss = x.clamp_min(0.0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return _mean(loss, weights)


def pairwise_distance(x1: torch.Tensor, x2: torch.Tensor, p: float = 2.0,
                      eps: float = 1e-6) -> torch.Tensor:
    """``||x1 - x2 + eps||_p`` row-wise."""
    diff = x1 - x2 + eps
    return (diff.abs() ** p).sum(dim=-1) ** (1.0 / p)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                        margin: float = 1.0, p: float = 2.0, eps: float = 1e-6,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    a, pos, neg = anchor.float(), positive.float(), negative.float()
    hinge = (pairwise_distance(a, pos, p, eps) - pairwise_distance(a, neg, p, eps)
             + margin).clamp_min(0.0)
    return _mean(hinge, weights)


def combined_triplet_loss(classifier_loss: torch.Tensor, triplet_loss: torch.Tensor,
                          beta_classifier: float) -> torch.Tensor:
    norm_beta_ssl = 1.0 / beta_classifier
    return (1.0 - norm_beta_ssl) * classifier_loss + norm_beta_ssl * triplet_loss
