"""End-to-end quintuplet training driver (`intrepppid_tpu/train/e2e_triplet.py`
counterpart; the reference's ``train_e2e_rnn_triplet``,
`intrepppid/e2e/e2e_triplet.py:258-431`).

It creates the run directories, draws the fallback seed, writes the full
hyperparameter dict to ``hyperparams.json`` (with the reference's stale
``"architecture": "ClassifierBarlow"`` label, kept for artifact parity),
builds the data module (sos=False, eos=False, negative_omid=True), the
network on ``device`` and the trainer (val_loss-monitored checkpoints, SWA,
LR monitor, ``DictLogger`` plus an optional tensorboardX writer,
log_every_n_steps=2), fits with optional resume, tests the best
checkpoint, and writes ``metrics.json``.

Quirk parity: ``encoder_only_steps`` / ``classifier_warm_up`` are accepted
and written but unused; ``lr == "auto"`` is overwritten to 1e-2.

Under torchrun it joins the process group (``parallel/``), takes process
0's seed, and leaves ``hyperparams.json``, ``metrics.json`` and the
TensorBoard writer to rank zero; ``profile_dir`` traces the first trained
epoch there (``Trainer``).
"""
from __future__ import annotations

import json
import random
from os import makedirs
from pathlib import Path
from typing import Optional, Union

import torch

from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataModule
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.optim.swa import SWAConfig
from intrepppid_tpu_torch.parallel import (
    broadcast_from_primary_int,
    initialize_distributed,
    process_index,
)
from intrepppid_tpu_torch.train.trainer import Trainer
from intrepppid_tpu_torch.utils.device import resolve_device
from intrepppid_tpu_torch.utils.dictlogger import DictLogger


def train_e2e_rnn_triplet(
    vocab_size: int,
    trunc_len: int,
    embedding_size: int,
    rnn_num_layers: int,
    rnn_dropout_rate: float,
    variational_dropout: bool,
    bi_reduce: str,
    ppi_dataset_path: Path,
    sentencepiece_path: Path,
    log_path: Path,
    hyperparams_path: Path,
    chkpt_dir: Path,
    c_type: int,
    model_name: str,
    workers: int,
    embedding_droprate: float,
    do_rate: float,
    num_epochs: int,
    batch_size: int,
    encoder_only_steps: int,
    classifier_warm_up: int,
    beta_classifier: float,
    lr: Union[float, str] = 1e-2,
    checkpoint_path: Optional[Path] = None,
    use_projection: bool = True,
    optimizer_type: str = "ranger21",
    seed: Optional[int] = None,
    precision: str = "bf16",
    cache_eval_tokens: bool = False,
    device: Union[str, torch.device] = "cuda",
    profile_dir: Optional[Path] = None,
):
    """Train, test the best checkpoint and write the run's artifacts;
    returns ``(trainer, test_results)``."""
    # a no-op without torchrun's environment (the CLI has already joined)
    initialize_distributed(device)
    dev = resolve_device(device)
    primary = process_index() == 0
    log_path = Path(log_path)
    hyperparams_path = Path(hyperparams_path)
    chkpt_dir = Path(chkpt_dir)
    makedirs(chkpt_dir, exist_ok=True)
    makedirs(log_path, exist_ok=True)
    makedirs(hyperparams_path.parent, exist_ok=True)

    # the reference draws a random fallback seed (`e2e_triplet.py:291-293`)
    seed = random.randint(0, 99999) if seed is None else seed
    # every process builds the same initial weights from process 0's seed
    seed = broadcast_from_primary_int(seed)

    hyperparameters = {
        "architecture": "ClassifierBarlow",
        "vocab_size": vocab_size,
        "lr": lr,
        "trunc_len": trunc_len,
        "embedding_size": embedding_size,
        "rnn_num_layers": rnn_num_layers,
        "rnn_dropout_rate": rnn_dropout_rate,
        "variational_dropout": variational_dropout,
        "bi_reduce": bi_reduce,
        "ppi_dataset_path": str(ppi_dataset_path),
        "sentencepiece_path": str(sentencepiece_path),
        "log_path": str(log_path),
        "hyperparams_path": str(hyperparams_path),
        "chkpt_dir": str(chkpt_dir),
        "model_name": model_name,
        "workers": workers,
        "embedding_droprate": embedding_droprate,
        "do_rate": do_rate,
        "num_epochs": num_epochs,
        "batch_size": batch_size,
        "encoder_only_steps": encoder_only_steps,
        "classifier_warm_up": classifier_warm_up,
        "beta_classifier": beta_classifier,
        "checkpoint_path": str(checkpoint_path) if checkpoint_path else None,
        "use_projection": use_projection,
        "seed": seed,
        "optimizer_type": optimizer_type,
        "precision": precision,
    }
    if primary:
        with open(hyperparams_path, "w") as f:
            json.dump(hyperparameters, f)

    data_module = IntrepppidDataModule(
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
        cache_eval_tokens=cache_eval_tokens,
    )
    data_module.setup("training")
    steps_per_epoch = data_module.steps_per_epoch

    if lr == "auto":
        lr = 1e-2  # reference overwrite (`e2e_triplet.py:359-360`)

    net = intrepppid_network(
        steps_per_epoch=steps_per_epoch,
        vocab_size=vocab_size,
        embedding_size=embedding_size,
        rnn_num_layers=rnn_num_layers,
        rnn_dropout_rate=rnn_dropout_rate,
        variational_dropout=variational_dropout,
        bi_reduce=bi_reduce,
        embedding_droprate=embedding_droprate,
        num_epochs=num_epochs,
        do_rate=do_rate,
        beta_classifier=beta_classifier,
        lr=lr,
        use_projection=use_projection,
        optimizer_type=optimizer_type,
        compute_dtype=torch.bfloat16 if precision == "bf16" else torch.float32,
        device=dev,
        seed=seed,
    )

    dict_logger = DictLogger()
    dict_logger.log_hyperparams(hyperparameters)
    tb_writer = None
    # rank zero's alone: the writer makes its event file when it is built
    if primary:
        try:
            from tensorboardX import SummaryWriter

            tb_writer = SummaryWriter(str(log_path / "tensorboard" / model_name))
        except ImportError:
            pass

    trainer = Trainer(
        net=net,
        chkpt_dir=chkpt_dir,
        model_name=model_name,
        seed=seed,
        loggers=[dict_logger],
        tb_writer=tb_writer,
        log_every_n_steps=2,
        swa=SWAConfig(swa_lr=1e-2),
        profile_dir=profile_dir,
    )
    trainer.init_state()

    print("######")
    print(f"NUM PARAMS:{net.num_params()}")
    print("######")

    trainer.fit(data_module, checkpoint_path=checkpoint_path)
    test_results = trainer.test(data_module, ckpt="best")

    dict_logger.metrics["test_results"] = [test_results]
    if primary:
        makedirs(log_path / model_name, exist_ok=True)
        dict_logger.save_json(log_path / model_name / "metrics.json")
    if tb_writer is not None:
        tb_writer.close()
    return trainer, test_results
