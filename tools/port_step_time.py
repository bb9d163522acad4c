#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's train step on one NVIDIA card for one model
configuration, from a given checkout of the repository, so that two commits
can be compared in turns on the same card:

    python3 tools/port_step_time.py --repo DIR --embedding_size 72 \\
        --dtype bfloat16 [--layers 2] [--backend recurrence] [--steps 4] [--warmup 2]

It imports ``intrepppid_tpu_torch`` from DIR (never JAX), builds the model
(two layers unless ``--layers`` says otherwise; the scaled configuration is
``--embedding_size 256 --layers 3``) with seeded weights and
``ranger21_xx``, and runs synthetic
quintuplet batches of 80 pairs at T = 1500 (dropout on), built as
``chip_smoke.py`` builds them. It prints one JSON line: each timed train
step's wall ms (synced on the loss), their median, the kernel launches of
the timed steps, the device ms and idle share of one profiled step
(``torch.profiler``; the kernels' and copies' durations, one stream), and
the card's name and power limit. Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PAIRS, T = 80, 1500


def quintuplet_batch(rng, B, T, vocab=250) -> dict:
    """ids in [1, vocab), lengths uniform in [T/2, T] with the first row at
    full length, random labels (``chip_smoke.py:quintuplet_batch``)."""
    def ids():
        a = rng.integers(1, vocab, size=(B, T))
        lens = rng.integers(T // 2, T + 1, size=B)
        lens[0] = T
        for i, n in enumerate(lens):
            a[i, n:] = 0
        return a.astype(np.int32)

    batch = {k: ids() for k in ("p1", "p2", "anchor", "positive", "negative")}
    batch["label"] = (rng.random(B) > 0.5).astype(np.int32)
    return batch


def device_ms(fn) -> tuple:
    """(wall ms, device ms) of ``fn()`` under ``torch.profiler``: the sum of
    the kernels' and copies' durations, user annotations left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    dev = sum(e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not (getattr(e, "is_user_annotation", False)
                       or e.name.startswith("Optimizer."))) / 1e3
    return wall, dev


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, required=True)
    ap.add_argument("--embedding_size", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--backend", choices=("auto", "recurrence"), default="auto")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_step_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.repo.resolve()))
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.ops import lstm
    from intrepppid_tpu_torch.ops import lstm_cuda
    from intrepppid_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lstm.DEFAULT_BACKEND = args.backend
    dev = torch.device("cuda:0")
    net = intrepppid_network(steps_per_epoch=100, compute_dtype=getattr(torch, args.dtype),
                             optimizer_type="ranger21_xx", device=dev, seed=0,
                             embedding_size=args.embedding_size,
                             rnn_num_layers=args.layers)
    trainer = Trainer(net, seed=0)
    rng = np.random.default_rng(0)
    batches = [quintuplet_batch(rng, PAIRS, T) for _ in range(2)]
    for i in range(args.warmup):
        trainer.train_step(batches[i % 2])["loss"].item()
    counters = {n: f for n, f in vars(lstm_cuda).items()
                if callable(f) and isinstance(getattr(f, "launches", None), int)}
    for f in counters.values():
        f.launches = 0
    step_ms = []
    for i in range(args.steps):
        t = time.perf_counter()
        trainer.train_step(batches[i % 2])["loss"].item()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = {n: f.launches for n, f in counters.items() if f.launches}
    wall, dev_ms = device_ms(lambda: trainer.train_step(batches[0])["loss"].item())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"repo": str(args.repo), "embedding_size": args.embedding_size,
                      "layers": args.layers,
                      "dtype": args.dtype, "backend": args.backend, "pairs": PAIRS, "T": T,
                      "step_ms": step_ms, "median_step_ms": float(np.median(step_ms)),
                      "launches": launches, "profiled_wall_ms": wall, "device_ms": dev_ms,
                      "idle_share": 1.0 - dev_ms / wall, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
