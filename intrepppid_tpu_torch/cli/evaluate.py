"""Evaluation CLI: score a trained checkpoint on any INTREPPPID dataset
(`intrepppid_tpu/cli/evaluate.py` counterpart).

The paper's benchmark protocol, train on one species and evaluate
zero-shot on another species' split, without retraining:

    python -m intrepppid_tpu_torch eval e2e_rnn_triplet \
        --checkpoint_path logs/<run>/chkpt/<best> \
        --ppi_dataset_path mouse.h5 --sentencepiece_path spm.model \
        --c_type 3 --out_path mouse_metrics.json [--device cuda]

The checkpoint is a checkpoint directory of the port's ``fit`` or of the
JAX package's (orbax), or a reference-layout ``.ckpt`` (the loader
``infer`` uses). It runs on
``--device`` (default ``cuda``). Under ``torchrun --nproc_per_node N``
(``--n_data_parallel`` N or unset) each process scores its rows of every
batch and the metrics are the whole batch's, in the trainer's scheme; rank
zero writes ``out_path``. The JAX CLI's ``steps_per_dispatch`` stacking
answered the TPU host link and is left out.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional


class Eval:
    @staticmethod
    def e2e_rnn_triplet(
        checkpoint_path: Path,
        ppi_dataset_path: Path,
        sentencepiece_path: Path,
        c_type: int,
        out_path: Optional[Path] = None,
        split: str = "test",
        batch_size: int = 80,
        workers: int = 0,
        vocab_size: Optional[int] = None,
        trunc_len: Optional[int] = None,
        embedding_size: Optional[int] = None,
        rnn_num_layers: Optional[int] = None,
        bi_reduce: Optional[str] = None,
        use_projection: Optional[bool] = None,
        beta_classifier: Optional[float] = None,
        seed: int = 8675309,
        precision: str = "bf16",
        n_data_parallel: Optional[int] = None,
        device: str = "cuda",
    ):
        """Evaluate a checkpoint on a dataset split; prints and optionally
        writes the metric dict (AUROC/AP/MCC/precision/recall + losses).

        Architecture hyperparameters default to the values recorded in the
        run's ``hyperparams.json`` (found two directories above the
        checkpoint, the training layout) when available, else to the
        manuscript defaults; explicit flags always win. Unlike the JAX CLI,
        which builds the network without variational dropout whatever the
        run recorded, ``variational_dropout`` and ``rnn_dropout_rate`` come
        from the run's ``hyperparams.json`` too: the reference keeps
        variational dropout active at eval, so a model trained with it is
        scored with its row masks, every batch's drawn from a generator
        seeded 0.
        """
        import torch

        from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataModule
        from intrepppid_tpu_torch.models.factory import intrepppid_network
        from intrepppid_tpu_torch.parallel import (
            check_data_parallel,
            initialize_distributed,
            process_index,
        )
        from intrepppid_tpu_torch.train.trainer import EpochAccumulator, Trainer, global_rows
        from intrepppid_tpu_torch.utils.convert import load_reference_checkpoint, load_weights
        from intrepppid_tpu_torch.utils.device import resolve_device

        # a no-op without torchrun's environment
        initialize_distributed(device)
        # before any file is read: a process count other than
        # --n_data_parallel, or a machine without a card, refuses here
        check_data_parallel(n_data_parallel, "eval e2e_rnn_triplet")
        dev = resolve_device(device)

        hp = {}
        hp_path = Path(checkpoint_path).parent.parent / "hyperparams.json"
        if hp_path.exists():
            with open(hp_path) as f:
                hp = json.load(f)

        def pick(explicit, key, default):
            if explicit is not None:
                return explicit
            return hp.get(key, default)

        vocab_size = pick(vocab_size, "vocab_size", 250)
        trunc_len = pick(trunc_len, "trunc_len", 1500)
        embedding_size = pick(embedding_size, "embedding_size", 64)
        rnn_num_layers = pick(rnn_num_layers, "rnn_num_layers", 2)
        bi_reduce = pick(bi_reduce, "bi_reduce", "last")
        use_projection = pick(use_projection, "use_projection", False)
        beta_classifier = pick(beta_classifier, "beta_classifier", 2.0)

        dm = IntrepppidDataModule(
            batch_size=batch_size,
            dataset_path=ppi_dataset_path,
            c_type=c_type,
            trunc_len=trunc_len,
            workers=workers,
            vocab_size=vocab_size,
            model_file=sentencepiece_path,
            seed=seed,
            sos=False,
            eos=False,
            negative_omid=True,
        )
        dm.setup()

        net = intrepppid_network(
            steps_per_epoch=0,
            vocab_size=vocab_size,
            embedding_size=embedding_size,
            rnn_num_layers=rnn_num_layers,
            rnn_dropout_rate=hp.get("rnn_dropout_rate", 0.3),
            variational_dropout=hp.get("variational_dropout", False),
            bi_reduce=bi_reduce,
            use_projection=use_projection,
            beta_classifier=beta_classifier,
            compute_dtype=torch.bfloat16 if precision == "bf16" else torch.float32,
            device=dev,
        )
        state = load_reference_checkpoint(checkpoint_path, rnn_num_layers)
        if any(k.startswith("triplet_projection.") for k in state) and not use_projection:
            print(
                "WARNING: checkpoint contains triplet_projection weights but "
                "use_projection=False — triplet metrics will differ from the "
                "training run. Pass --use_projection true to match."
            )
            state = {k: v for k, v in state.items() if not k.startswith("triplet_projection.")}
        load_weights(net, state)

        batches = {
            # eval semantics even on the train split: deterministic
            # tokenisation, no shuffle (metrics reproducible across runs)
            "train": dm.train_eval_batches,
            "val": dm.val_batches,
            "test": dm.test_batches,
        }[split]()
        trainer = Trainer(net, seed=seed, swa=None)
        acc = EpochAccumulator()
        for i, batch in enumerate(batches):
            # every batch's variational masks from one seed, as the JAX
            # CLI's PRNGKey(0) for every batch
            gen = torch.Generator(dev).manual_seed(0)
            acc.add(trainer.eval_step(batch, i, gen=gen), global_rows(batch, trainer.world))
        metrics = {f"{split}_{k}": float(v) for k, v in acc.means().items()}
        print(json.dumps(metrics, indent=2))
        # every process holds the global batches' metrics: one file
        if out_path is not None and process_index() == 0:
            Path(out_path).parent.mkdir(parents=True, exist_ok=True)
            with open(out_path, "w") as f:
                json.dump(metrics, f, indent=2)
        return metrics
