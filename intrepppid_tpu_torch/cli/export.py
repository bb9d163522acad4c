"""``export`` CLI group (`intrepppid_tpu/cli/export.py` counterpart): take
weights trained by the port back to the reference's PyTorch ecosystem.

The reference distributes and consumes weights as PyTorch Lightning
``.ckpt`` pickles loaded with a strict ``load_state_dict``
(`intrepppid/cli/infer.py:170-175`). ``export torch_ckpt`` writes one from
a checkpoint directory of the port's ``fit`` or of the JAX package's:

    python -m intrepppid_tpu_torch export torch_ckpt \
        --checkpoint_path logs/<run>/chkpt/<name>-epoch=..-val_loss=.. \
        --out_path intrepppid_export.ckpt

The file holds the same ``state_dict`` entries, bit for bit, as the JAX
package's ``save_torch_checkpoint`` writes for the same weights. Reading
needs no card. A checkpoint directory of the JAX package (an orbax tree)
is read without JAX (``train/orbax_read.py``), and the export writes what
the JAX package's ``export torch_ckpt`` writes from it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional


class Export:
    @staticmethod
    def torch_ckpt(
        checkpoint_path: Path,
        out_path: Path,
        hyperparams_path: Optional[Path] = None,
    ):
        """Export a training checkpoint of the port as a reference ``.ckpt``.

        ``checkpoint_path`` is a checkpoint directory written by the port's
        training or the JAX package's
        (``<log_path>/<run>/chkpt/<model>-epoch=..-val_loss=..``).
        ``hyperparams_path`` defaults to the run directory's
        ``hyperparams.json`` (two levels above the checkpoint) when present;
        the dict is embedded as the ckpt's ``hyper_parameters`` entry for
        Lightning-style consumers. Epoch and global step are carried over
        from the training state.
        """
        from intrepppid_tpu_torch.train.checkpoint import CheckpointManager
        from intrepppid_tpu_torch.utils.convert import save_reference_checkpoint, to_jax_params

        checkpoint_path = Path(checkpoint_path)
        out_path = Path(out_path)
        state = CheckpointManager.restore(checkpoint_path)

        if hyperparams_path is None:
            candidate = checkpoint_path.parent.parent / "hyperparams.json"
            if candidate.exists():
                hyperparams_path = candidate
        hyper_parameters = None
        if hyperparams_path is not None:
            with open(hyperparams_path) as f:
                hyper_parameters = json.load(f)

        out_path.parent.mkdir(parents=True, exist_ok=True)
        n_keys = save_reference_checkpoint(
            to_jax_params(state["params"]),
            out_path,
            hyper_parameters=hyper_parameters,
            epoch=state.get("epoch"),
            global_step=state.get("global_step"),
        )
        print(f"exported {checkpoint_path} -> {out_path} ({n_keys} state_dict entries)")
        return out_path
