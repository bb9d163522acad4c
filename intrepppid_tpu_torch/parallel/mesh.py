"""Data parallelism over ``torch.distributed``
(`intrepppid_tpu/parallel/mesh.py` counterpart).

The JAX package shards each global batch over a mesh's ``data`` axis and
lets XLA insert the gradient all-reduce. Here one process runs a card
(``torchrun --nproc_per_node N -m intrepppid_tpu_torch train ...``), holds a
replica of the network and its contiguous rows of every global batch
(``data/ppi_oma.py:shard_batch_rows``), and the trainer sums the gradients
and gathers the rows its metrics read with the collectives below. Every
collective here is an all-reduce or a broadcast, the two that the gloo
backend also takes on CUDA tensors, so no helper stages a tensor through
the host.

Serving needs no process group: the engine and ``infer`` keep one replica
of the network per local card (``replica_devices``, ``replicate``) and
split each dispatch's rows across them.

Not carried over, having no PyTorch meaning: ``make_mesh``,
``batch_sharding``, ``stacked_batch_sharding``, ``replicated_sharding``,
``shard_batch`` and ``put_global_batch``.
"""
from __future__ import annotations

import copy
import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

# what torchrun sets for every process it starts
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
DEFAULT_TIMEOUT = timedelta(minutes=30)


def is_initialized() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """This process's index among the processes of its machine
    (``LOCAL_RANK``; 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(
    device: Union[str, torch.device, None] = "cuda",
    backend: Optional[str] = None,
    timeout: Optional[timedelta] = None,
) -> bool:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``). Without that environment it does nothing and returns
    False; an environment with only part of it raises. Idempotent: True
    once this process is in a group.

    ``backend`` defaults to NCCL where ``device`` is a card (each process
    then takes ``cuda:{LOCAL_RANK}``, or the index ``device`` names) and to
    gloo on the CPU. Naming gloo for a card lets several processes share
    one card, which NCCL refuses."""
    if is_initialized():
        return True
    present = [k for k in LAUNCH_ENV if k in os.environ]
    if not present:
        return False
    if len(present) < len(LAUNCH_ENV):
        missing = [k for k in LAUNCH_ENV if k not in os.environ]
        raise ValueError(f"a process group needs {', '.join(LAUNCH_ENV)}; {missing} unset "
                         "(launch with torchrun)")
    dev = torch.device(device if device is not None else "cuda")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(dev.index if dev.index is not None else local_rank())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=timeout or DEFAULT_TIMEOUT,
    )
    return True


def check_data_parallel(n_data_parallel: Optional[int], command: str) -> None:
    """Raise unless ``n_data_parallel`` (None: any) is this run's process
    count: a process drives one card, so N cards take N processes."""
    world = process_count()
    if n_data_parallel is not None and int(n_data_parallel) != world:
        n = int(n_data_parallel)
        raise ValueError(
            f"n_data_parallel={n} needs {n} processes, one a card, and this run has {world}: "
            f"launch `torchrun --nproc_per_node {n} -m intrepppid_tpu_torch {command} ...`")


def _comm_device() -> torch.device:
    """Where a host value goes for a collective: NCCL takes CUDA tensors
    alone, gloo takes CPU ones."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_primary_int(value: int) -> int:
    """Process 0's integer on every process (the identity alone). Every
    process calls it, in the same order as the other collectives. It syncs
    the run seed: each process would otherwise draw its own fallback seed
    and build other initial weights."""
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
    dist.broadcast(t, 0)
    return int(t.item())


def broadcast_from_primary_str(value: str, max_len: int = 128) -> str:
    """Process 0's string (its first ``max_len`` UTF-8 bytes) on every
    process; the identity alone. It syncs the generated run name, so every
    process writes under one run directory."""
    if process_count() == 1:
        return value
    buf = torch.zeros(max_len, dtype=torch.uint8)
    raw = value.encode("utf-8")[:max_len]
    buf[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    buf = buf.to(_comm_device())
    dist.broadcast(buf, 0)
    # a cut inside a multibyte character drops the fragment
    return bytes(buf.cpu().tolist()).rstrip(b"\x00").decode("utf-8", errors="ignore")


def barrier() -> None:
    """Wait for every process of the group (nothing alone)."""
    if is_initialized():
        dist.barrier()


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the group, in place, in one collective over one
    flat buffer (every tensor of one dtype and device)."""
    if not is_initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the group (a new tensor)."""
    out = t.clone()
    if is_initialized():
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` stacked along dim 0 in rank order (each
    process passes the same shape). Each process writes its rows into a
    zero buffer of the whole and the buffers are summed: every element has
    one writer and adds only zeros, so the rows arrive exactly as written."""
    world = process_count()
    if world == 1:
        return t
    out = t.new_zeros((world * t.shape[0],) + tuple(t.shape[1:]))
    rank = process_index()
    out[rank * t.shape[0]:(rank + 1) * t.shape[0]] = t
    dist.all_reduce(out)
    return out


# ------------------------------------------------------------ batch padding
def pad_batch_to_multiple(batch: Dict[str, np.ndarray], multiple: int):
    """Pad the batch dim up to a multiple by repeating the final row;
    returns ``(padded_batch, true_size)``. Padded rows get a ``weight`` of
    0 (real rows 1), which the step uses to mask them out of losses,
    gradients and metrics."""
    n = next(iter(batch.values())).shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, n
    return _pad_batch_rows(batch, n, multiple - rem), n


def pad_batch_to_size(batch: Dict[str, np.ndarray], size: int):
    """Pad the batch dim up to exactly ``size`` rows, with the weight-0
    masking of :func:`pad_batch_to_multiple`; returns ``(padded_batch,
    true_size)``."""
    n = next(iter(batch.values())).shape[0]
    if n >= size:
        return batch, n
    return _pad_batch_rows(batch, n, size - n), n


def _pad_batch_rows(batch: Dict[str, np.ndarray], n: int, pad: int) -> Dict[str, np.ndarray]:
    # imported here: the data package imports this module
    from intrepppid_tpu_torch.data.utils import repeat_pad_rows

    out = {k: repeat_pad_rows(np.asarray(v), n + pad) for k, v in batch.items()}
    weight = out.get("weight")
    if weight is None:
        weight = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    else:
        weight = np.concatenate([weight[:n], np.zeros(pad, weight.dtype)])
    out["weight"] = weight
    return out


# ------------------------------------------------------ serving's replicas
def replica_devices(device: Union[str, torch.device], n_data_parallel: int) -> List[torch.device]:
    """The devices of ``n_data_parallel`` scoring replicas: one a local card
    (``cuda:0`` to ``cuda:N-1``; ``device`` itself where N is 1), or N on
    the one CPU. More replicas than cards raises."""
    device = torch.device(device)
    n = int(n_data_parallel)
    if n < 1:
        raise ValueError(f"n_data_parallel must be at least 1, got {n}")
    if device.type != "cuda":
        return [device] * n
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"n_data_parallel={n} exceeds the {count} cards of this machine")
    if n == 1:
        return [device]
    return [torch.device("cuda", i) for i in range(n)]


def replicate(net: torch.nn.Module, n_data_parallel: int) -> List[torch.nn.Module]:
    """``net`` and its copies, one on each of ``replica_devices``; ``net``
    itself serves where it already lies on one of them."""
    home = next(net.parameters()).device
    replicas, used = [], False
    for dev in replica_devices(home, n_data_parallel):
        if dev == home and not used:
            replicas.append(net)
            used = True
        else:
            replicas.append(copy.deepcopy(net).to(dev))
    return replicas
