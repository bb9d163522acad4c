"""Stochastic Weight Averaging (`intrepppid_tpu/optim/swa.py`).

The reference attaches Lightning's ``StochasticWeightAveraging(swa_lrs=1e-2)``
callback (`intrepppid/e2e/e2e_triplet.py:390`): from 80% of training, a
running average of the weights accumulates each epoch and replaces the model
at fit end, while the LR anneals toward ``swa_lr`` (cosine, 10 epochs).

Here the weights are a dict of parameters keyed by name (the network's
``named_parameters``); the average is a dict of f32 tensors with the same
keys, which ``final_params`` casts back to each parameter's dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch


@dataclass
class SWAConfig:
    swa_lr: float = 1e-2
    swa_epoch_start: float = 0.8
    annealing_epochs: int = 10


def _snapshot(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An f32 copy of each parameter. ``.float()`` of an f32 tensor is the
    same storage, which the optimizer's in-place update would rewrite."""
    return {k: p.detach().float().clone() for k, p in params.items()}


class SWAState:
    """Lightning-parity SWA arithmetic, re-indexed to end-of-epoch hooks.

    Lightning 1.9's ``StochasticWeightAveraging`` resolves a float
    ``swa_epoch_start`` to ``int(max_epochs * swa_epoch_start)`` and
    averages the module weights in ``on_train_epoch_start`` for 0-based
    epochs ``swa_start .. max_epochs-1`` where ``swa_start =
    max(int(...) - 1, 0)``. The trainer's hook runs at epoch *ends*; the
    weights at the end of epoch ``e`` are those at the start of ``e+1``, so
    the end-of-epoch window is ``swa_start-1 .. max_epochs-2``: the final
    epoch's weights never enter the average, as in Lightning. If
    ``swa_start == 0`` (num_epochs <= 2 at the 0.8 default) Lightning
    averages the *initial* weights at the start of epoch 0, which an
    end-of-epoch hook cannot observe: the trainer calls
    :meth:`seed_initial` before the first epoch so that term is not lost.

    The SWALR annealing (``lr_scale``) keys on ``swa_start`` directly: the
    LR used *during* epoch ``e`` corresponds to Lightning's epoch ``e``.
    """

    def __init__(self, cfg: SWAConfig, num_epochs: int):
        self.cfg = cfg
        # Lightning: 0-based first epoch whose START is averaged
        self.swa_start = max(int(cfg.swa_epoch_start * num_epochs) - 1, 0)
        # the end-of-epoch update window [update_start, update_end]
        self.update_start = self.swa_start - 1
        self.update_end = num_epochs - 2
        self.num_epochs = num_epochs
        self.n_averaged = 0
        self.avg_params: Optional[Dict[str, torch.Tensor]] = None

    def seed_initial(self, params: Mapping[str, torch.Tensor]) -> None:
        """Seed the average with the *initial* weights when ``swa_start ==
        0``. Call once, before the first epoch of a fresh (not resumed)
        fit; a no-op in every other configuration."""
        if self.swa_start != 0 or self.avg_params is not None:
            return
        self.avg_params = _snapshot(params)
        self.n_averaged = 1

    def active(self, epoch: int) -> bool:
        """Whether the end-of-epoch hook at 0-based ``epoch`` averages."""
        return self.update_start <= epoch <= self.update_end

    @torch.no_grad()
    def update(self, epoch: int, params: Mapping[str, torch.Tensor]) -> None:
        """Call at the end of each epoch with the current weights."""
        if not self.active(epoch):
            return
        if self.avg_params is None:
            self.avg_params = _snapshot(params)
            self.n_averaged = 1
            return
        n = self.n_averaged
        self.avg_params = {k: avg + (params[k].float() - avg) / (n + 1)
                           for k, avg in self.avg_params.items()}
        self.n_averaged = n + 1

    def lr_scale(self, epoch: int, base_lr: float) -> float:
        """Cosine annealing multiplier from base_lr toward swa_lr."""
        if epoch < self.swa_start:
            return 1.0
        t = min((epoch - self.swa_start) / max(self.cfg.annealing_epochs, 1), 1.0)
        target = self.cfg.swa_lr
        lr = target + (base_lr - target) * (1 + math.cos(math.pi * t)) / 2
        return lr / base_lr if base_lr > 0 else 1.0

    def final_params(self, params: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
        """The averaged weights, each in its parameter's dtype, if any were
        accumulated, else ``params``."""
        if self.avg_params is None:
            return params
        return {k: self.avg_params[k].to(p.dtype) for k, p in params.items()}
