"""Batch-level binary metrics (`intrepppid_tpu/ops/metrics.py:23-135`).

The reference logs torchmetrics ``AUROC``, ``AveragePrecision``,
``MatthewsCorrCoef(threshold=0.5)``, ``Precision`` and ``Recall`` per batch
and averages them over the epoch; these functions compute the batch values
from raw logits (thresholded metrics use ``logit > 0``). AUROC is the
tie-averaged Mann-Whitney statistic; AP steps through tie groups as sklearn
does. Optional per-row ``weights`` (padding rows at 0) weight every count.
Degenerate batches (no positives or no negatives) give 0.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def _weights(y: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.ones_like(y) if weights is None else weights.float()


def binary_auroc(logits: torch.Tensor, targets: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact ROC AUC with ties counted half: for each positive, the negative
    weight strictly below it plus half the tied negative weight."""
    s_all = logits.float()
    y = targets.float()
    w = _weights(y, weights)
    order = torch.argsort(s_all, stable=True)
    s, ws, ys = s_all[order], w[order], y[order]
    wneg = ws * (1.0 - ys)
    prefix = torch.cat([wneg.new_zeros(1), torch.cumsum(wneg, 0)])
    lo = torch.searchsorted(s, s, right=False)
    hi = torch.searchsorted(s, s, right=True)
    contrib = ws * ys * (prefix[lo] + 0.5 * (prefix[hi] - prefix[lo]))
    denom = (w * y).sum() * (w * (1.0 - y)).sum()
    return torch.where(denom > 0, contrib.sum() / denom.clamp_min(1e-12), 0.0)


def binary_average_precision(logits: torch.Tensor, targets: torch.Tensor,
                             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Area under the PR curve, step interpolation, precision taken at the
    end of each tie group of the descending scores."""
    s_all = logits.float()
    y = targets.float()
    w = _weights(y, weights)
    order = torch.argsort(-s_all, stable=True)
    s_desc, y_desc, w_desc = s_all[order], y[order], w[order]
    tps = torch.cumsum(w_desc * y_desc, 0)
    fps = torch.cumsum(w_desc * (1.0 - y_desc), 0)
    precision = tps / (tps + fps).clamp_min(1e-12)
    neg = -s_desc
    group_end = torch.searchsorted(neg, neg, right=True) - 1
    w_pos = (w * y).sum()
    ap = (w_desc * y_desc / w_pos.clamp_min(1e-12) * precision[group_end]).sum()
    return torch.where(w_pos > 0, ap, 0.0)


def _confusion(logits, targets, weights):
    pred = (logits.float() > 0.0).float()
    y = targets.float()
    w = _weights(y, weights)
    tp = (w * pred * y).sum()
    fp = (w * pred * (1.0 - y)).sum()
    fn = (w * (1.0 - pred) * y).sum()
    tn = (w * (1.0 - pred) * (1.0 - y)).sum()
    return tp, fp, fn, tn


def binary_mcc(logits, targets, weights=None) -> torch.Tensor:
    tp, fp, fn, tn = _confusion(logits, targets, weights)
    denom = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return torch.where(denom > 0, (tp * tn - fp * fn) / denom.clamp_min(1e-38), 0.0)


def binary_precision(logits, targets, weights=None) -> torch.Tensor:
    tp, fp, _, _ = _confusion(logits, targets, weights)
    return torch.where(tp + fp > 0, tp / (tp + fp).clamp_min(1e-12), 0.0)


def binary_recall(logits, targets, weights=None) -> torch.Tensor:
    tp, _, fn, _ = _confusion(logits, targets, weights)
    return torch.where(tp + fn > 0, tp / (tp + fn).clamp_min(1e-12), 0.0)


def all_binary_metrics(logits: torch.Tensor, targets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The reference's five metrics of one batch."""
    return {
        "auroc": binary_auroc(logits, targets, weights),
        "ap": binary_average_precision(logits, targets, weights),
        "mcc": binary_mcc(logits, targets, weights),
        "precision": binary_precision(logits, targets, weights),
        "rec": binary_recall(logits, targets, weights),
    }
