"""The train step and its bookkeeping (`intrepppid_tpu/train/trainer.py`,
partial).

Ported: the counterparts of ``Trainer.__init__``, ``init_state``,
``_build_train_step`` (`:344-371`: loss and gradients, the optimizer
update, ``lr_scale``), ``_build_eval_step`` (`:422-434`) and
``EpochAccumulator`` (`:240-276`). Each step's dropout masks come from a
generator on the model's device seeded from ``(seed, step)``, in the role
of ``jax.random.fold_in(base_key, step)``; eval steps draw from ``(seed +
17, i)`` as the JAX trainer's eval key does.

Not ported yet: ``fit`` with the HDF5 data module, checkpoints, SWA and the
``train`` CLI (ROADMAP.md). TPU-only machinery is not carried over: the
bit-plane wire format of token ids, ``steps_per_dispatch``, the mesh
sharding and the prefetch threads.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from intrepppid_tpu_torch.models.factory import IntrepppidNetwork
from intrepppid_tpu_torch.models.triplet import TOKEN_KEYS
from intrepppid_tpu_torch.optim import Ranger21, get_lr_schedule, make_optimizer

def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)``: one stream per
    step, the same stream for the same pair."""
    mixed = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


class EpochAccumulator:
    """Batch-size-weighted mean of per-batch metric values. ``add`` keeps
    the device scalars as they are; ``means`` moves each key's values to the
    host in one transfer, so no step waits on the device."""

    def __init__(self):
        self.items: list = []
        self.weight = 0.0

    def add(self, aux: Mapping[str, Any], batch_size) -> None:
        w = np.atleast_1d(np.asarray(batch_size, np.float64))
        self.items.append((dict(aux), w))
        self.weight += float(w.sum())

    def means(self) -> Dict[str, float]:
        if not self.items:
            return {}
        w = np.concatenate([wi for _, wi in self.items])
        out: Dict[str, float] = {}
        for k in self.items[0][0]:
            vec = torch.cat([torch.as_tensor(a[k], dtype=torch.float32).reshape(-1).cpu()
                             for a, _ in self.items]).double().numpy()
            out[k] = float((vec * w).sum() / w.sum())
        return out


class Trainer:
    """Drives ``net.step`` with its optimizer on the model's device."""

    def __init__(self, net: IntrepppidNetwork, seed: int = 0):
        self.net = net
        self.seed = seed
        self.device = next(net.parameters()).device
        self.lr_schedule = get_lr_schedule(
            net.optimizer_type, net.lr, net.steps_per_epoch, net.num_epochs
        )
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.global_step = 0

    def init_state(self) -> None:
        """A fresh optimizer state over the network's current weights (the
        weights themselves come from ``intrepppid_network(seed=...)`` or a
        loaded ``state_dict``)."""
        net = self.net
        self.optimizer = make_optimizer(
            net.optimizer_type, net.param_groups(), net.lr, net.steps_per_epoch, net.num_epochs
        )
        self.global_step = 0

    def to_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Numpy or tensor batch -> tensors on the model's device (token ids
        as int64, pinned for the copy when the device is a card)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if k in TOKEN_KEYS:
                t = t.long()
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def train_step(self, batch: Mapping[str, Any], lr_scale: float = 1.0) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; returns the step's aux values
        (device scalars, not synchronised)."""
        if self.optimizer is None:
            self.init_state()
        net = self.net.train()
        batch = self.to_device(batch)
        gen = step_generator(self.device, self.seed, self.global_step)
        loss, aux = net.step(batch, gen, train=True)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        for p in net.parameters():
            # parameters the step never reads (the reference's dead
            # projection) get a zero gradient, as jax.grad gives them, so
            # weight decay still reaches them
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in self.optimizer.param_groups:
            if isinstance(self.optimizer, Ranger21):
                group["update_scale"] = lr_scale
            else:
                group["lr"] = self.lr_schedule(self.global_step) * lr_scale
        self.optimizer.step()
        self.global_step += 1
        return aux

    @torch.no_grad()
    def eval_step(self, batch: Mapping[str, Any], i: int = 0) -> Dict[str, torch.Tensor]:
        """``net.step(train=False)`` on ``batch``: losses and metrics. No
        gradient is taken, so the LSTM runs its eval forward."""
        net = self.net.eval()
        gen = step_generator(self.device, self.seed + 17, i)
        with torch.no_grad():
            _, aux = net.step(self.to_device(batch), gen, train=False)
        return aux
