"""Per-epoch checkpoints (`intrepppid_tpu/train/checkpoint.py`).

The counterpart of the reference's Lightning ``ModelCheckpoint``
(monitor="val_loss", filename "{model_name}-{epoch}-{val_loss}") plus
``trainer.fit(ckpt_path=...)`` resume and ``trainer.test(ckpt_path="best")``
(`intrepppid/e2e/e2e_triplet.py:381-385,424-426`). The layout is the JAX
package's: one directory per epoch holding ``intrepppid_meta.json`` and the
state, here one ``state.pt`` written by ``torch.save`` (the JAX package
writes an orbax tree). The state holds only tensors, numbers, strings and
containers of them, so it loads with ``weights_only=True``. Under data
parallelism every process calls ``save`` and tracks the best and last
paths; rank zero alone writes and prunes.

Every reader of a checkpoint directory (``restore``, the weight loaders,
``resume``, ``test``, ``export``, ``infer``, ``serve``, ``eval``) takes
the port's and the JAX package's alike: ``checkpoint_kind`` tells them
apart, and the JAX state comes through ``train/orbax_read.py`` and
``utils/convert.py:from_jax_state`` into the layout ``save`` writes.
Any other directory is refused with ``orbax_read.refusal``'s error.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from intrepppid_tpu_torch.parallel import process_index
from intrepppid_tpu_torch.train.orbax_read import is_orbax_checkpoint, refusal, restore_orbax

STATE_FILE = "state.pt"


class CheckpointManager:
    """Per-epoch checkpoints monitoring ``val_loss``.

    Like Lightning's ``ModelCheckpoint(save_top_k=1)`` (the reference's
    configuration) only the best checkpoint is kept, plus the most recent
    one for resume; older checkpoints that are not the best are pruned.
    ``keep_all=True`` keeps every epoch. The best checkpoint is recorded in
    ``best.json``, which a new manager on the same directory reads back.
    """

    def __init__(self, chkpt_dir, model_name: str, keep_all: bool = False):
        self.chkpt_dir = Path(chkpt_dir)
        self.chkpt_dir.mkdir(parents=True, exist_ok=True)
        self.model_name = model_name
        self.keep_all = keep_all
        self.best_val_loss = float("inf")
        self.best_path: Optional[Path] = None
        self.last_path: Optional[Path] = None
        marker = self.chkpt_dir / "best.json"
        if marker.exists():
            with open(marker) as f:
                data = json.load(f)
            self.best_val_loss = data.get("val_loss", float("inf"))
            self.best_path = Path(data["best"])

    @staticmethod
    def _write_json(path, obj) -> None:
        with open(path, "w") as f:
            json.dump(obj, f)

    def save(self, state: Dict[str, Any], epoch: int, val_loss: float) -> Path:
        """Write one epoch's checkpoint directory (rank zero alone); returns
        its path."""
        name = f"{self.model_name}-epoch={epoch:02d}-val_loss={val_loss:.2f}"
        path = (self.chkpt_dir / name).absolute()
        primary = process_index() == 0
        if primary:
            if path.exists():
                shutil.rmtree(path)
            path.mkdir()
            torch.save(state, path / STATE_FILE)
        prev_best = self.best_path
        prev_last = self.last_path
        self.last_path = path
        is_best = val_loss < self.best_val_loss
        if is_best:
            self.best_val_loss = val_loss
            self.best_path = path
        if not primary:
            return path
        meta = {"epoch": epoch, "val_loss": val_loss, "model_name": self.model_name}
        self._write_json(path / "intrepppid_meta.json", meta)
        if is_best:
            self._write_json(
                self.chkpt_dir / "best.json",
                {"best": str(path), "val_loss": val_loss},
            )
            if not self.keep_all and prev_best is not None and prev_best.exists():
                if prev_best != prev_last:
                    shutil.rmtree(prev_best, ignore_errors=True)
        if (
            not self.keep_all
            and prev_last is not None
            and prev_last not in (self.best_path, path)
            and prev_last.exists()
        ):
            shutil.rmtree(prev_last, ignore_errors=True)
        return path

    @staticmethod
    def restore(path, map_location: Union[str, torch.device, None] = "cpu",
                net=None, optimizer=None) -> Dict[str, Any]:
        """A checkpoint's state in the layout ``save`` writes, its tensors
        on ``map_location``. From a JAX directory the optimizer state comes
        only given the network and its live optimizer
        (``utils/convert.py:from_jax_state``)."""
        path = Path(path).absolute()
        if checkpoint_kind(path) == "port":
            return torch.load(path / STATE_FILE, map_location=map_location, weights_only=True)
        from intrepppid_tpu_torch.utils.convert import from_jax_state

        select = None if optimizer is not None else (
            "params", "global_step", "epoch", "swa_avg", "swa_n")
        return _to(from_jax_state(restore_orbax(path, select), net, optimizer), map_location)

    def best_checkpoint(self) -> Optional[Path]:
        if self.best_path is not None:
            return self.best_path
        marker = self.chkpt_dir / "best.json"
        if marker.exists():
            with open(marker) as f:
                return Path(json.load(f)["best"])
        return None


def checkpoint_kind(path) -> str:
    """``"port"`` for a directory ``save`` wrote (a ``state.pt`` inside),
    ``"orbax"`` for one of the JAX package's (``_METADATA`` inside); any
    other path is refused."""
    path = Path(path)
    if (path / STATE_FILE).is_file():
        return "port"
    if is_orbax_checkpoint(path):
        return "orbax"
    raise refusal(path, f"not a checkpoint directory (no {STATE_FILE}, no orbax _METADATA)")


def _to(tree, device):
    """``tree`` with every tensor on ``device``, as ``torch.load``'s
    ``map_location`` puts them."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree


def load_params_from_checkpoint(path, map_location: Union[str, torch.device, None] = "cpu"):
    """The model's ``state_dict`` alone from a training checkpoint of
    either kind: the inference path (`intrepppid/cli/infer.py:173-175`
    analogue)."""
    if checkpoint_kind(path) == "port":
        return CheckpointManager.restore(path, map_location)["params"]
    from intrepppid_tpu_torch.utils.convert import from_jax_params

    return _to(from_jax_params(restore_orbax(path, ("params",))["params"]), map_location)
