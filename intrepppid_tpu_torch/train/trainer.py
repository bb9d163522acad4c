"""The training loop (`intrepppid_tpu/train/trainer.py`): the train and eval
steps, ``fit`` with per-epoch checkpoints, SWA and logs, ``resume`` and
``test``.

* one train step computes the loss, the gradients, the optimizer update and
  the batch metrics on the model's device (``train_step``; the counterpart
  of ``_build_train_step``, `:344-371`); each step's dropout masks come from
  a generator on the device seeded from ``(seed, step)``, in the role of
  ``jax.random.fold_in(base_key, step)``; eval steps draw from ``(seed +
  17, i)`` as the JAX trainer's eval key does;
* epoch aggregation is the batch-size-weighted mean of batch-level metrics
  (``EpochAccumulator``), matching Lightning's ``on_epoch=True`` reduction;
* per-epoch checkpoints monitoring ``val_loss`` (``train/checkpoint.py``),
  the best checkpoint's test, and resume from a checkpoint path;
* StochasticWeightAveraging from 80% of epochs (``optim/swa.py``),
  parameter averaging only unless ``use_swa_lr_scale``;
* ``DictLogger`` plus an optional TensorBoard-style writer (anything with
  ``add_scalar``) and a per-step LR monitor, logging train step losses
  every ``log_every_n_steps`` (default 2, `e2e_triplet.py:399`).

The step loop never waits on the device: step losses and batch metrics stay
device scalars until the epoch's end, where each moves to the host once. A
short last batch runs at its own size (the JAX trainer pads it with
weight-0 rows to keep one compiled shape; the losses, gradients and metrics
are the same). TPU-only machinery is not carried over: the bit-plane wire
format of token ids, ``steps_per_dispatch``, the mesh sharding and the
prefetch threads. ``profile_dir`` comes with ``utils/profiling.py``.
"""
from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from intrepppid_tpu_torch.models.factory import IntrepppidNetwork
from intrepppid_tpu_torch.models.triplet import TOKEN_KEYS
from intrepppid_tpu_torch.optim import Ranger21, get_lr_schedule, make_optimizer
from intrepppid_tpu_torch.optim.swa import SWAConfig, SWAState
from intrepppid_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_params_from_checkpoint,
)
from intrepppid_tpu_torch.utils.dictlogger import DictLogger

STEP_LOSSES = ("loss", "classifier_loss", "triplet_loss")


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)``: one stream per
    step, the same stream for the same pair."""
    mixed = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def batch_rows(batch: Mapping[str, Any]) -> int:
    return int(next(iter(batch.values())).shape[0])


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
            vec = torch.cat([torch.as_tensor(a[k], dtype=torch.float32).reshape(-1)
                             for a, _ in self.items]).cpu().double().numpy()
            out[k] = float((vec * w).sum() / w.sum())
        return out


class Trainer:
    """Drives ``net.step`` with its optimizer on the model's device.

    ``chkpt_dir`` is where ``fit`` writes its checkpoints (required by
    ``fit``; the steps alone need none). ``swa=None`` turns SWA off."""

    def __init__(
        self,
        net: IntrepppidNetwork,
        chkpt_dir=None,
        model_name: str = "intrepppid",
        seed: int = 0,
        loggers: Optional[list] = None,
        tb_writer=None,
        log_every_n_steps: int = 2,
        swa: Optional[SWAConfig] = SWAConfig(),
        use_swa_lr_scale: bool = False,
        keep_all_checkpoints: bool = False,
    ):
        self.net = net
        self.seed = seed
        self.device = next(net.parameters()).device
        self.loggers = loggers if loggers is not None else [DictLogger()]
        self.tb_writer = tb_writer
        self.log_every_n_steps = log_every_n_steps
        self.checkpoints = (
            CheckpointManager(chkpt_dir, model_name, keep_all=keep_all_checkpoints)
            if chkpt_dir is not None else None
        )
        self.swa = SWAState(swa, net.num_epochs) if swa is not None else None
        self.use_swa_lr_scale = use_swa_lr_scale
        self.lr_schedule = get_lr_schedule(
            net.optimizer_type, net.lr, net.steps_per_epoch, net.num_epochs
        )
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.global_step = 0
        self.start_epoch = 0

    # ------------------------------------------------------------- steps
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
    def eval_step(self, batch: Mapping[str, Any], i: int = 0,
                  net: Optional[IntrepppidNetwork] = None) -> Dict[str, torch.Tensor]:
        """``net.step(train=False)`` on ``batch`` (by default the trainer's
        network): losses and metrics. No gradient is taken, so the LSTM runs
        its eval forward."""
        net = (net if net is not None else self.net).eval()
        gen = step_generator(self.device, self.seed + 17, i)
        _, aux = net.step(self.to_device(batch), gen, train=False)
        return aux

    # ----------------------------------------------------------- logging
    def _log(self, metrics: Mapping[str, float], step: int) -> None:
        for logger in self.loggers:
            logger.log_metrics(metrics, step)
        if self.tb_writer is not None:
            for k, v in metrics.items():
                self.tb_writer.add_scalar(k, v, step)

    # --------------------------------------------------------- lifecycle
    def resume(self, checkpoint_path) -> None:
        """Full Lightning-style resume: weights, optimizer, step, epoch and
        the SWA average."""
        if self.optimizer is None:
            self.init_state()
        state = CheckpointManager.restore(checkpoint_path, self.device)
        self.net.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.global_step = int(state["global_step"])
        self.start_epoch = int(state["epoch"]) + 1
        if self.swa is not None and state.get("swa_n", 0):
            self.swa.n_averaged = int(state["swa_n"])
            self.swa.avg_params = state["swa_avg"]

    def _save_epoch(self, epoch: int, val_loss: float) -> Path:
        state = {
            "params": self.net.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "global_step": self.global_step,
            "epoch": epoch,
        }
        if self.swa is not None and self.swa.avg_params is not None:
            state["swa_avg"] = self.swa.avg_params
            state["swa_n"] = self.swa.n_averaged
        return self.checkpoints.save(state, epoch, val_loss)

    # ----------------------------------------------------------- running
    def _run_eval(self, net: IntrepppidNetwork, batches: Iterable, stage: str,
                  step: int) -> Dict[str, float]:
        """Eval pass over a split: batch ``i`` draws from ``(seed + 17,
        i)``; the means are logged as ``{stage}_{k}`` at ``step``."""
        acc = EpochAccumulator()
        for i, batch in enumerate(batches):
            acc.add(self.eval_step(batch, i, net), batch_rows(batch))
        metrics = {f"{stage}_{k}": v for k, v in acc.means().items()}
        self._log(metrics, step)
        return metrics

    def _flush_step_logs(self, pending: list, lr_scale: float) -> None:
        """Log the deferred step losses: one host transfer for the epoch."""
        if not pending:
            return
        cols = torch.stack([torch.stack([aux[k].float() for k in STEP_LOSSES])
                            for aux, _ in pending]).cpu().numpy()
        for (_, step), row in zip(pending, cols):
            self._log({"train_loss_step": float(row[0]),
                       "train_classifier_loss_step": float(row[1]),
                       "train_triplet_loss_step": float(row[2]),
                       "lr": self.lr_schedule(step) * lr_scale}, step)

    def fit(self, data_module, checkpoint_path=None) -> Dict[str, float]:
        """Train ``net.num_epochs`` epochs over ``data_module.train_batches
        (epoch)``, each followed by a val pass, the SWA update and a
        checkpoint; from ``checkpoint_path`` if given. Returns the last val
        metrics."""
        if self.checkpoints is None:
            raise ValueError("fit writes a checkpoint each epoch: pass chkpt_dir")
        if checkpoint_path is not None:
            self.resume(checkpoint_path)
        elif self.optimizer is None:
            self.init_state()
        params = dict(self.net.named_parameters())
        if self.swa is not None and self.start_epoch == 0:
            # swa_start == 0 corner: Lightning averages the initial weights
            # at the start of epoch 0 (see SWAState.seed_initial)
            self.swa.seed_initial(params)

        last_val: Dict[str, float] = {}
        for epoch in range(self.start_epoch, self.net.num_epochs):
            lr_scale = 1.0
            if self.swa is not None and self.use_swa_lr_scale:
                lr_scale = self.swa.lr_scale(epoch, self.net.lr)
            t0 = time.perf_counter()
            acc = EpochAccumulator()
            n_samples = 0
            pending: list = []  # (aux, step) of the logged steps
            for batch in data_module.train_batches(epoch):
                rows = batch_rows(batch)
                aux = self.train_step(batch, lr_scale)
                n_samples += rows
                acc.add(aux, rows)
                if self.global_step % self.log_every_n_steps == 0:
                    pending.append((aux, self.global_step))
            # the epoch's one wait on the device: the step logs, then the
            # weighted means (where the epoch clock stops)
            self._flush_step_logs(pending, lr_scale)
            train_metrics = {f"train_{k}": v for k, v in acc.means().items()}
            epoch_time = time.perf_counter() - t0
            train_metrics["epoch_time_s"] = epoch_time
            train_metrics["seq_pairs_per_s"] = n_samples / max(epoch_time, 1e-9)
            self._log(train_metrics, self.global_step)

            last_val = self._run_eval(self.net, data_module.val_batches(), "val",
                                      self.global_step)
            if self.swa is not None:
                self.swa.update(epoch, params)
            self._save_epoch(epoch, last_val.get("val_loss", float("nan")))

        # SWA final swap (Lightning swaps the averaged weights in at fit end)
        if self.swa is not None and self.swa.avg_params is not None:
            final = self.swa.final_params(params)
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(final[name])
        return last_val

    def test(self, data_module, ckpt: Optional[str] = "best") -> Dict[str, float]:
        """Test pass with the best checkpoint's weights (``"best"``, or the
        live weights where there is none), the live weights (``"last"``) or
        a checkpoint directory's. The live weights stay as they are."""
        net = self.net
        path = None
        if ckpt == "best":
            path = self.checkpoints.best_checkpoint() if self.checkpoints is not None else None
        elif ckpt is not None and ckpt != "last":
            path = ckpt
        if path is not None:
            net = copy.deepcopy(self.net)
            net.load_state_dict(load_params_from_checkpoint(path, self.device))
        return self._run_eval(net, data_module.test_batches(), "test", self.global_step)
