"""One rank of the port's data-parallel tests, and the helpers that launch
ranks (``tests/test_torch_port_ddp.py``, and the ``cuda`` tests of
``tests/test_torch_port_kernel.py``). Imports no JAX.

    python tests/torch_port_ddp_worker.py MODE RANK WORLD PORT WORKDIR

Each rank joins a process group through torchrun's environment variables
at one torch thread and writes its results under ``WORKDIR``:

* ``steps``: the train steps of ``WORKDIR/setup.pt`` on this rank's rows
  of each global batch (``run_steps``), on the gloo backend (or NCCL where
  the setup says so) -> ``steps_rank{R}.pt``;
* ``nccl1``: the steps without a group, then in an NCCL group of one ->
  ``nccl1.pt`` with both;
* ``cli``: ``train e2e_rnn_triplet --n_data_parallel WORLD --device cpu`` on
  ``tests/fixtures/tiny.h5`` with every file this rank opens for writing
  recorded, then ``eval`` on the run's best checkpoint ->
  ``cli_rank{R}.json`` and ``cli_rank{R}.pt`` (the final weights).
"""
import builtins
import io
import json
import os
import shutil
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
H5 = HERE / "fixtures" / "tiny.h5"
SPM = HERE / "fixtures" / "tiny_spm.model"
TOKEN_KEYS = ("p1", "p2", "anchor", "positive", "negative")
CLI_FLAGS = ["--vocab_size", "38", "--trunc_len", "64", "--embedding_size", "16", "--workers",
             "0", "--precision", "fp32", "--optimizer_type", "adamw_1cycle"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(mode: str, world: int, workdir: Path, timeout: float = 300.0) -> None:
    """Run ``world`` ranks of ``mode`` and wait for them, each at most
    ``timeout`` seconds; raise with a rank's errors if one fails or hangs."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    # each rank's output to a file: a full pipe would stall a rank that
    # the others wait for
    logs = [open(workdir / f"{mode}_rank{rank}.log", "w") for rank in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), mode, str(rank),
                               str(world), str(port), str(workdir)],
                              env=env, cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT)
             for rank, log in enumerate(logs)]
    failed = []
    try:
        for rank, proc in enumerate(procs):
            if proc.wait(timeout=timeout) != 0:
                failed.append(f"rank {rank} exited {proc.returncode}")
    except subprocess.TimeoutExpired:
        failed.append(f"a rank of {mode} ran past {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    if failed:
        tails = [(workdir / f"{mode}_rank{r}.log").read_text()[-4000:] for r in range(world)]
        raise RuntimeError("\n".join(failed + tails))


def join(rank: int, world: int, port: int, device: str, backend=None) -> None:
    from intrepppid_tpu_torch.parallel import initialize_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    assert initialize_distributed(device, backend=backend, timeout=timedelta(seconds=120))


def local_batch(batch: dict, rank: int, world: int, trim: bool) -> dict:
    """This rank's rows of a global numpy batch, as the data module makes
    them (``shard_batch_rows``, ``weight``, ``_global_rows``); with
    ``trim`` its token arrays cut to its own longest row, as its own length
    bucket would cut them."""
    from intrepppid_tpu_torch.data.ppi_oma import shard_batch_rows

    n = len(batch["label"])
    idx, weight = shard_batch_rows(np.arange(n), world, rank)
    out = {k: np.asarray(v)[idx] for k, v in batch.items()}
    if weight is not None:
        out["weight"] = weight
    out["_global_rows"] = np.int64(n)
    if trim:
        T = max(1, int(max((out[k] != 0).sum(1).max() for k in TOKEN_KEYS)))
        out.update({k: out[k][:, :T] for k in TOKEN_KEYS})
    return out


def run_steps(setup: dict, rank: int = 0, world: int = 1) -> dict:
    """``Trainer.train_step`` on this rank's rows of each global batch of
    ``setup`` (one process: the whole batches); the final weights and each
    step's aux values."""
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.train import Trainer

    device = setup.get("device", "cpu")
    net = intrepppid_network(device=device, **setup["network"])
    net.load_state_dict(setup["weights"])
    trainer = Trainer(net, seed=0)
    auxes = []
    for batch in setup["batches"]:
        if world > 1:
            batch = local_batch(batch, rank, world, setup.get("trim", True))
        aux = trainer.train_step(batch)
        auxes.append({k: float(v) for k, v in aux.items()})
    return {"weights": {k: v.detach().cpu() for k, v in net.state_dict().items()},
            "aux": auxes}


def record_writes(root: Path) -> list:
    """Every file under ``root`` this process opens for writing (``torch.save``
    writes through its own C++ file, so it is recorded too), and every tree
    it removes there, from now on."""
    writes = []
    real_open, real_rmtree, real_save = builtins.open, shutil.rmtree, torch.save

    def under(path):
        try:
            return Path(os.path.abspath(path)).is_relative_to(root)
        except TypeError:  # a file descriptor
            return False

    def open_(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+") and under(file):
            writes.append(str(Path(os.path.abspath(file)).relative_to(root)))
        return real_open(file, mode, *args, **kwargs)

    def rmtree(path, *args, **kwargs):
        if under(path):
            writes.append("rmtree " + str(Path(os.path.abspath(path)).relative_to(root)))
        return real_rmtree(path, *args, **kwargs)

    def save(obj, f, *args, **kwargs):
        if isinstance(f, (str, os.PathLike)) and under(f):
            writes.append(str(Path(os.path.abspath(f)).relative_to(root)))
        return real_save(obj, f, *args, **kwargs)

    builtins.open = io.open = open_
    shutil.rmtree = rmtree
    torch.save = save
    return writes


def run_cli(rank: int, world: int, workdir: Path) -> None:
    from intrepppid_tpu_torch.__main__ import main

    logs = (workdir / "logs").resolve()
    writes = record_writes(logs)
    trainer, test = main(["train", "e2e_rnn_triplet", str(H5), str(SPM), "3", "2", "8",
                          *CLI_FLAGS, "--log_path", str(logs), "--device", "cpu",
                          "--n_data_parallel", str(world)])
    best = trainer.checkpoints.best_checkpoint()
    evaluated = main(["eval", "e2e_rnn_triplet", "--checkpoint_path", str(best),
                      "--ppi_dataset_path", str(H5), "--sentencepiece_path", str(SPM),
                      "--c_type", "3", "--batch_size", "8", "--precision", "fp32",
                      "--seed", "7", "--device", "cpu", "--n_data_parallel", str(world),
                      "--out_path", str(logs / "eval.json")])
    torch.save({k: v.detach() for k, v in trainer.net.state_dict().items()},
               workdir / f"cli_rank{rank}.pt")
    (workdir / f"cli_rank{rank}.json").write_text(json.dumps({
        "model_name": trainer.checkpoints.model_name, "seed": trainer.seed,
        "best": str(best), "test": test, "eval": evaluated, "writes": writes,
        "steps": trainer.global_step}))


def main(argv) -> None:
    mode, rank, world, port, workdir = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), \
        Path(argv[4])
    torch.set_num_threads(1)
    if mode == "cli":
        join(rank, world, port, "cpu")
        run_cli(rank, world, workdir)
        return
    setup = torch.load(workdir / "setup.pt", weights_only=False)
    if mode == "steps":
        join(rank, world, port, setup.get("device", "cpu"), setup.get("backend"))
        torch.save(run_steps(setup, rank, world), workdir / f"steps_rank{rank}.pt")
    elif mode == "nccl1":
        alone = run_steps(setup)
        join(rank, 1, port, setup["device"], "nccl")
        torch.save({"alone": alone, "group": run_steps(setup, 0, 1)}, workdir / "nccl1.pt")
    else:
        raise ValueError(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
