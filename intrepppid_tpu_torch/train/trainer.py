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
training epoch's batches come through the input pipeline
(``data/pipeline.py``), as in the JAX trainer: a tokenising thread
(``host_prefetch``, where more than one CPU is available) feeding pinned
copies on a side stream (``prefetch_to_device``), ``prefetch`` batches
ahead; val and test passes are not prefetched. A short last batch runs at
its own size (the JAX trainer pads it with weight-0 rows to keep one
compiled shape; the losses, gradients and metrics are the same). TPU-only
machinery is not carried over: the bit-plane wire format of token ids and
``steps_per_dispatch``.

Data parallelism (a trainer built inside a process group, ``parallel/``;
the JAX trainer's mesh): each process steps on its rows of the global
batch, and a step computes the global batch's step, as the JAX trainer's
jitted step over the mesh does. Per step, one all-reduce of the widest
token window and each encoder call's longest length (the processes pad
their token arrays to it; a host read); the head's row masks drawn for the
global batch (``BatchShard``); the logits, labels and weights gathered for
the metrics, which need every row (AUROC and AP do not decompose); each
process's weighted-mean loss scaled by its share of the global weight, so
that the gradients **summed** over the processes, in one all-reduce with
the losses, are those of the global weighted mean on uneven splits too. A
hand all-reduce after the zero fill of unused parameters, where DDP's
reducer would trip over the dead projection. Epoch means weight each
batch by its ``_global_rows``; logs and checkpoint files are rank zero's,
and every save ends at a barrier. ``profile_dir`` traces the first
trained epoch on rank zero with ``torch.profiler`` (``utils/profiling.py``),
up to the epoch's sync.
"""
from __future__ import annotations

import copy
import os
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from intrepppid_tpu_torch.data.pipeline import host_prefetch, prefetch_to_device
from intrepppid_tpu_torch.models.factory import IntrepppidNetwork
from intrepppid_tpu_torch.models.triplet import TOKEN_KEYS, BatchShard
from intrepppid_tpu_torch.ops.losses import combined_triplet_loss
from intrepppid_tpu_torch.ops.metrics import all_binary_metrics
from intrepppid_tpu_torch.optim import Ranger21, get_lr_schedule, make_optimizer
from intrepppid_tpu_torch.optim.swa import SWAConfig, SWAState
from intrepppid_tpu_torch.parallel import (
    all_reduce_max,
    all_reduce_sum_,
    barrier,
    gather_rows,
    is_initialized,
    process_count,
    process_index,
)
from intrepppid_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_params_from_checkpoint,
)
from intrepppid_tpu_torch.utils.dictlogger import DictLogger
from intrepppid_tpu_torch.utils.profiling import start_trace

STEP_LOSSES = ("loss", "classifier_loss", "triplet_loss")


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)``: one stream per
    step, the same stream for the same pair."""
    mixed = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def _available_cpus() -> int:
    """CPUs available to this process (sched affinity), not the machine."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def _use_host_prefetch() -> bool:
    """Whether tokenisation gets its own pipeline thread: only with more
    than one CPU available (`intrepppid_tpu/train/trainer.py:162-174`)."""
    return _available_cpus() > 1


def batch_rows(batch: Mapping[str, Any]) -> int:
    return int(next(iter(batch.values())).shape[0])


def global_rows(batch: Mapping[str, Any], world: int) -> int:
    """The batch's real rows over the ``world`` processes: its
    ``_global_rows`` where the data module split it, else all of every
    process's rows."""
    rows = batch.get("_global_rows")
    return batch_rows(batch) * world if rows is None else int(rows)


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
    ``fit``; the steps alone need none). ``swa=None`` turns SWA off.
    ``prefetch`` is the input pipeline's depth in a training epoch.
    ``profile_dir`` traces ``fit``'s first trained epoch there. A trainer
    built inside a process group steps data-parallel (module notes)."""

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
        prefetch: int = 2,
        profile_dir=None,
    ):
        self.net = net
        self.seed = seed
        self.device = next(net.parameters()).device
        self.profile_dir = profile_dir
        self.data_parallel = is_initialized()
        self.rank = process_index()
        self.world = process_count()
        self.loggers = loggers if loggers is not None else [DictLogger()]
        self.tb_writer = tb_writer
        self.log_every_n_steps = log_every_n_steps
        self.checkpoints = (
            CheckpointManager(chkpt_dir, model_name, keep_all=keep_all_checkpoints)
            if chkpt_dir is not None else None
        )
        self.swa = SWAState(swa, net.num_epochs) if swa is not None else None
        self.use_swa_lr_scale = use_swa_lr_scale
        self.prefetch = prefetch
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
        as int64, pinned for the copy when the device is a card). Tensors
        already on the device (``prefetch_to_device``'s) pass through; ``_``
        keys (host metadata) are left out."""
        out = {}
        for k, v in batch.items():
            if k.startswith("_"):
                continue
            t = torch.as_tensor(v)
            if k in TOKEN_KEYS:
                t = t.long()  # no copy when it is int64 already
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
        rows = global_rows(batch, self.world)
        batch = self.to_device(batch)
        gen = step_generator(self.device, self.seed, self.global_step)
        if self.data_parallel:
            loss, aux = self._shard_step(net, batch, gen, True, rows)
        else:
            loss, aux = net.step(batch, gen, train=True)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        for p in net.parameters():
            # parameters the step never reads (the reference's dead
            # projection) get a zero gradient, as jax.grad gives them, so
            # weight decay still reaches them
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.data_parallel:
            # the global weighted mean's gradients and losses: each
            # process's are scaled by its share of the weight (_shard_step)
            all_reduce_sum_([p.grad for p in net.parameters()]
                            + [aux[k] for k in STEP_LOSSES])
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
                  net: Optional[IntrepppidNetwork] = None,
                  gen: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``net.step(train=False)`` on ``batch`` (by default the trainer's
        network): losses and metrics. No gradient is taken, so the LSTM runs
        its eval forward. Its variational masks, where the network has
        them, come from ``gen``, by default the stream ``(seed + 17, i)``
        (the JAX trainer's ``fold_in(PRNGKey(seed + 17), i)``)."""
        net = (net if net is not None else self.net).eval()
        if gen is None:
            gen = step_generator(self.device, self.seed + 17, i)
        if not self.data_parallel:
            _, aux = net.step(self.to_device(batch), gen, train=False)
            return aux
        _, aux = self._shard_step(net, self.to_device(batch), gen, False,
                                  global_rows(batch, self.world))
        all_reduce_sum_([aux[k] for k in STEP_LOSSES])
        return aux

    def _shard_step(self, net: IntrepppidNetwork, batch: Dict[str, torch.Tensor],
                    gen: torch.Generator, train: bool, rows: int):
        """``net.step`` on this process's rows of a global batch of ``rows``
        real rows (every process holds as many rows): the loss to
        differentiate, this process's share of the global one, and the aux
        values, the losses as shares still to be summed over the processes
        and the metrics the global batch's."""
        B = batch_rows(batch)
        ids = torch.stack([batch[k] for k in TOKEN_KEYS])  # (5, B, T)
        widths = torch.cat([torch.tensor([ids.shape[-1]], device=ids.device),
                            (ids != 0).sum(-1).amax(-1)])
        widths = all_reduce_max(widths).tolist()  # the step's one host read
        T = int(widths[0])
        if T > ids.shape[-1]:  # another process's bucket is wider
            batch = {k: torch.nn.functional.pad(v, (0, T - v.shape[-1])) if k in TOKEN_KEYS
                     else v for k, v in batch.items()}
        shard = BatchShard(self.rank * B, rows, torch.tensor(widths[1:], dtype=torch.int32))
        cls_loss, trip_loss, logits, y, weights = net.step_outputs(batch, gen, train, shard)
        w = torch.ones_like(y) if weights is None else weights.float()
        logits, y, w_all = gather_rows(torch.stack([logits.detach().float(), y, w], 1)).unbind(1)
        share = w.sum() / w_all.sum()
        loss = combined_triplet_loss(cls_loss, trip_loss, net.cfg.beta_classifier) * share
        aux = {"loss": loss.detach(), "classifier_loss": cls_loss.detach() * share,
               "triplet_loss": trip_loss.detach() * share}
        aux.update(all_binary_metrics(logits, y, w_all))
        return loss, aux

    # ----------------------------------------------------------- logging
    def _log(self, metrics: Mapping[str, float], step: int) -> None:
        # rank zero's alone: every process holds the same global values
        if self.rank != 0:
            return
        for logger in self.loggers:
            logger.log_metrics(metrics, step)
        if self.tb_writer is not None:
            for k, v in metrics.items():
                self.tb_writer.add_scalar(k, v, step)

    # --------------------------------------------------------- lifecycle
    def resume(self, checkpoint_path) -> None:
        """Full Lightning-style resume: weights, optimizer, step, epoch and
        the SWA average, from a checkpoint directory of the port or of the
        JAX package (`intrepppid_tpu/train/trainer.py:488-513`), whose
        optimizer state must be the network's ``optimizer_type``'s."""
        if self.optimizer is None:
            self.init_state()
        state = CheckpointManager.restore(checkpoint_path, self.device, self.net, self.optimizer)
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
        path = self.checkpoints.save(state, epoch, val_loss)
        # no process reads a checkpoint (test, resume) before rank zero
        # has written it
        barrier()
        return path

    # ----------------------------------------------------------- running
    def _run_eval(self, net: IntrepppidNetwork, batches: Iterable, stage: str,
                  step: int) -> Dict[str, float]:
        """Eval pass over a split: batch ``i`` draws from ``(seed + 17,
        i)``; the means are logged as ``{stage}_{k}`` at ``step``."""
        acc = EpochAccumulator()
        for i, batch in enumerate(batches):
            acc.add(self.eval_step(batch, i, net), global_rows(batch, self.world))
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
        profiler = None
        for epoch in range(self.start_epoch, self.net.num_epochs):
            if self.profile_dir and epoch == self.start_epoch and self.rank == 0:
                profiler = start_trace(self.profile_dir)
            lr_scale = 1.0
            if self.swa is not None and self.use_swa_lr_scale:
                lr_scale = self.swa.lr_scale(epoch, self.net.lr)
            t0 = time.perf_counter()
            acc = EpochAccumulator()
            n_samples = 0
            pending: list = []  # (aux, step) of the logged steps
            host_iter = data_module.train_batches(epoch)
            if _use_host_prefetch():
                host_iter = host_prefetch(host_iter, size=self.prefetch)
            batches = prefetch_to_device(host_iter, self.device, size=self.prefetch)
            try:
                for batch in batches:
                    rows = global_rows(batch, self.world)
                    aux = self.train_step(batch, lr_scale)
                    n_samples += rows
                    acc.add(aux, rows)
                    if self.global_step % self.log_every_n_steps == 0:
                        pending.append((aux, self.global_step))
            finally:
                batches.close()  # an abandoned epoch stops its threads
            # the epoch's one wait on the device: the step logs, then the
            # weighted means (where the epoch clock stops)
            self._flush_step_logs(pending, lr_scale)
            train_metrics = {f"train_{k}": v for k, v in acc.means().items()}
            epoch_time = time.perf_counter() - t0
            train_metrics["epoch_time_s"] = epoch_time
            train_metrics["seq_pairs_per_s"] = n_samples / max(epoch_time, 1e-9)
            self._log(train_metrics, self.global_step)
            if profiler is not None:
                # the means above waited on every step: the trace holds
                # the whole epoch
                profiler.stop()
                profiler = None

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
