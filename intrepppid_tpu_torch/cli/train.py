"""Train CLI: ``python -m intrepppid_tpu_torch train e2e_rnn_triplet``
(`intrepppid_tpu/cli/train.py` counterpart; the reference's
`intrepppid/cli/train.py:25-121`).

The JAX CLI's flags and defaults, its run-name scheme
``YY.DDD-HH.MM-<word>-<word>`` and artifact layout
(``log_path/<run>/{hyperparams.json,metrics.json,chkpt/}``), plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels). ``--precision bf16|fp32`` picks the compute dtype.

Data parallelism runs one process a card:

    torchrun --nproc_per_node N -m intrepppid_tpu_torch train e2e_rnn_triplet ...

Each process joins the group from torchrun's environment, takes
``cuda:{LOCAL_RANK}`` and process 0's run name and seed; ``--n_data_parallel``
must then be N (or unset), and other values raise before anything is
written. ``--profile_dir`` traces the first trained epoch with
``torch.profiler``. The JAX CLI's ``steps_per_dispatch`` answered the TPU
host link and is left out.
"""
from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Optional, Union

from intrepppid_tpu_torch.utils.run_name import generate_passphrase


class Train:
    @staticmethod
    def e2e_rnn_triplet(
        ppi_dataset_path: Path,
        sentencepiece_path: Path,
        c_type: int,
        num_epochs: int,
        batch_size: int,
        seed: Optional[int] = None,
        vocab_size: int = 250,
        trunc_len: int = 1500,
        embedding_size: int = 64,
        rnn_num_layers: int = 2,
        rnn_dropout_rate: float = 0.3,
        variational_dropout: bool = False,
        bi_reduce: str = "last",
        workers: int = 4,
        embedding_droprate: float = 0.3,
        do_rate: float = 0.3,
        log_path: Path = Path("./logs/e2e_rnn_triplet"),
        encoder_only_steps: int = -1,
        classifier_warm_up: int = -1,
        beta_classifier: float = 4.0,
        lr: Union[float, str] = 1e-2,
        use_projection: bool = False,
        checkpoint_path: Optional[Path] = None,
        optimizer_type: str = "ranger21",
        precision: str = "bf16",
        n_data_parallel: Optional[int] = None,
        cache_eval_tokens: bool = False,
        profile_dir: Optional[Path] = None,
        device: str = "cuda",
    ):
        """Train INTREPPPID end-to-end: AWD-LSTM encoder + MLP classifier
        with the orthologue triplet task, on ``--device`` (the card by
        default). ``--checkpoint_path`` resumes from a checkpoint directory
        of an earlier run, the port's or the JAX package's."""
        from intrepppid_tpu_torch.parallel import (
            broadcast_from_primary_str,
            check_data_parallel,
            initialize_distributed,
        )
        from intrepppid_tpu_torch.train.e2e_triplet import train_e2e_rnn_triplet
        from intrepppid_tpu_torch.utils.device import resolve_device

        # a no-op without torchrun's environment
        initialize_distributed(device)
        # before any file is read or written: a process count other than
        # --n_data_parallel, or a machine without a card, refuses here
        check_data_parallel(n_data_parallel, "train e2e_rnn_triplet")
        dev = resolve_device(device)

        dt = datetime.now().strftime("%y.%j-%H.%M")
        # every process writes under process 0's run name
        model_name = broadcast_from_primary_str(f"{dt}-{generate_passphrase(2, '-')}")

        log_path = Path(log_path)
        chkpt_dir = log_path / model_name / "chkpt"
        hyperparams_path = log_path / model_name / "hyperparams.json"

        return train_e2e_rnn_triplet(
            vocab_size=vocab_size,
            trunc_len=trunc_len,
            embedding_size=embedding_size,
            rnn_num_layers=rnn_num_layers,
            rnn_dropout_rate=rnn_dropout_rate,
            variational_dropout=variational_dropout,
            bi_reduce=bi_reduce,
            ppi_dataset_path=ppi_dataset_path,
            sentencepiece_path=sentencepiece_path,
            log_path=log_path,
            hyperparams_path=hyperparams_path,
            chkpt_dir=chkpt_dir,
            c_type=c_type,
            model_name=model_name,
            workers=workers,
            embedding_droprate=embedding_droprate,
            do_rate=do_rate,
            num_epochs=num_epochs,
            batch_size=batch_size,
            encoder_only_steps=encoder_only_steps,
            classifier_warm_up=classifier_warm_up,
            beta_classifier=beta_classifier,
            lr=lr,
            checkpoint_path=checkpoint_path,
            use_projection=use_projection,
            optimizer_type=optimizer_type,
            seed=seed,
            precision=precision,
            cache_eval_tokens=cache_eval_tokens,
            device=dev,
            profile_dir=profile_dir,
        )
