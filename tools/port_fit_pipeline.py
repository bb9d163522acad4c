#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's ``Trainer.fit`` epochs on one NVIDIA card
with and without the input pipeline, in turns, in one process:

    python3 tools/port_fit_pipeline.py [--epochs 3] [--rounds 2]

The manuscript network in bf16 (``ranger21_xx``, dropout on, SWA on) fits
two data modules at the train shape (80 pairs, T = 1500): ``chip_smoke.py``'s
``FitModule`` (pre-tokenised batches, 5 x 80 pairs + 40 an epoch) and the
HDF5 data module over ``chip_smoke.py``'s ``synthetic_tables`` (440 pairs
an epoch tokenised batch by batch with ``golden_spm.model``, sampling on, 4
threads). Each fit runs either as ``fit`` does (``pipeline``: the
tokenising thread, then pinned copies on a side stream) or with both stages
taken out (``plain``: each batch tokenised in the loop and copied by
``Trainer.to_device``), in turns (pipeline, plain, plain, pipeline) after
one untimed warm-up fit of each. It prints one JSON line: each fit's epoch
seconds and pairs/s, the first and a later ``pin_memory`` of one batch's
ids, and the card's name and power limit. Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_fit_pipeline: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from intrepppid_tpu_torch.data import ppi_oma
    from intrepppid_tpu_torch.train import trainer as trainer_module

    dev = torch.device("cuda:0")
    ids = torch.zeros(5 * smoke.PAIRS_TRAIN * smoke.T_TRAIN, dtype=torch.long)
    pin_ms = []
    for _ in range(2):
        t = time.perf_counter()
        ids.pin_memory()
        pin_ms.append((time.perf_counter() - t) * 1e3)

    tables, sequences, members = smoke.synthetic_tables()
    ppi_oma.read_split = lambda path, c_type, split: (list(tables[split]), sequences, members)
    pretokenised = smoke.FitModule(np.random.default_rng(smoke.SEED + 29))

    def tokenising():
        dm = ppi_oma.IntrepppidDataModule(
            smoke.PAIRS_TRAIN, "synthetic.h5", 3, smoke.T_TRAIN, 4, 258,
            ROOT / "tests" / "fixtures" / "golden_spm.model", smoke.SEED, False, False, True)
        dm.setup()
        return dm

    modules = {"pretokenised": lambda: pretokenised, "tokenising": tokenising}
    pipeline = (trainer_module.prefetch_to_device, trainer_module._use_host_prefetch)

    def fit(module, variant):
        if variant == "plain":
            trainer_module.prefetch_to_device = lambda batches, device, size: (b for b in batches)
            trainer_module._use_host_prefetch = lambda: False
        try:
            dm = modules[module]()
            with tempfile.TemporaryDirectory() as tmp:
                steps = getattr(dm, "steps_per_epoch", None) or len(dm.train)
                tr = smoke.fit_trainer(dev, tmp, steps, args.epochs)
                tr.fit(dm)
                torch.cuda.synchronize()
            logs = tr.loggers[0].metrics
            return {k: [e["value"] for e in logs[k]] for k in ("epoch_time_s", "seq_pairs_per_s")}
        finally:
            trainer_module.prefetch_to_device, trainer_module._use_host_prefetch = pipeline

    out = {"epochs": args.epochs, "pin_memory_ms": pin_ms, "warmup": {}, "fits": {}}
    for module in modules:
        out["warmup"][module] = {v: fit(module, v) for v in ("pipeline", "plain")}
        runs = []
        for _ in range(args.rounds):
            for variant in ("pipeline", "plain", "plain", "pipeline"):
                runs.append({"variant": variant, **fit(module, variant)})
        out["fits"][module] = runs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["card"] = smi.stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
