#!/usr/bin/env python3
"""Hold the port's ``Trainer.fit`` against the JAX package's on the CPU,
at the sizes of ``tests/test_torch_port_fit.py``, for one optimizer:

    JAX_PLATFORMS=cpu python3 tools/fit_parity.py [--optimizer ranger21_xx]

Both trainers start from the same seeded weights (dropout off, SWA on) and
run 3 epochs of 3 batches of 4 pairs and a tail of 2 (T = 24, vocab 38,
embedding 16), 2 val batches an epoch, then ``test("best")``. It prints one
JSON line: the largest relative difference of any logged value (the epoch
clock's two left out), the largest absolute difference of the final
weights and of the SWA average, and per parameter the final weights'
largest absolute difference, the largest |w| and the median of
port / JAX - 1 over the weights with |w| > 1e-3 (a drift that scales every
weight alike shows as the same median everywhere).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from intrepppid_tpu.models.factory import intrepppid_network as jax_network  # noqa: E402
from intrepppid_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from intrepppid_tpu_torch.models.factory import intrepppid_network  # noqa: E402
from intrepppid_tpu_torch.train import Trainer  # noqa: E402
from intrepppid_tpu_torch.utils.convert import from_jax_params  # noqa: E402

VOCAB, EMBED, T, EPOCHS, STEPS = 38, 16, 24, 3, 4
CLOCK_KEYS = ("epoch_time_s", "seq_pairs_per_s")


def quintuplet_batch(seed, B=4):
    """Seeded batch as ``tests/test_torch_port_train.py`` builds it."""
    rng = np.random.default_rng(seed)

    def ids():
        a = rng.integers(1, VOCAB, (B, T)).astype(np.int32)
        lens = rng.integers(0, T + 1, B)
        lens[0] = T
        for i, n in enumerate(lens):
            a[i, n:] = 0
        return a

    batch = {k: ids() for k in ("p1", "p2", "anchor", "positive", "negative")}
    batch["label"] = np.array([1, 0, 1, 0][:B] + [1] * max(0, B - 4), np.int32)
    return batch


class Module:
    def __init__(self, seed=100):
        self.seed = seed

    def train_batches(self, epoch):
        s = self.seed + 10 * epoch
        return iter([quintuplet_batch(s + j) for j in range(3)] + [quintuplet_batch(s + 3, 2)])

    def val_batches(self):
        return iter([quintuplet_batch(self.seed + 50 + j) for j in range(2)])

    def test_batches(self):
        return iter([quintuplet_batch(self.seed + 60 + j) for j in range(2)])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--optimizer", default="ranger21_xx")
    args = ap.parse_args()
    torch.set_num_threads(1)
    kw = dict(vocab_size=VOCAB, embedding_size=EMBED, num_epochs=EPOCHS,
              optimizer_type=args.optimizer, rnn_dropout_rate=0.0, embedding_droprate=0.0,
              do_rate=0.0)
    jnet = jax_network(STEPS, **kw)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(0)))
    net = intrepppid_network(STEPS, device="cpu", **kw)
    net.load_state_dict(from_jax_params(params))
    with tempfile.TemporaryDirectory() as tmp:
        jtr = JaxTrainer(jnet, Path(tmp) / "jax", "m", seed=0)
        jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
        jtr.opt_state = jtr.optimizer.init(jtr.params)
        jtr.fit(Module())
        jtr.test(Module(), "best")
        tr = Trainer(net, Path(tmp) / "port", "m", seed=0)
        tr.fit(Module())
        tr.test(Module(), "best")
    jlogs, logs = jtr.loggers[0].metrics, tr.loggers[0].metrics
    log_rel = max(abs(a["value"] - b["value"]) / max(abs(b["value"]), 1e-7)
                  for k in jlogs if k not in CLOCK_KEYS for a, b in zip(logs[k], jlogs[k]))
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    want_avg = from_jax_params(jax.tree_util.tree_map(np.asarray, jtr.swa.avg_params))
    per_param = {}
    for name, p in net.named_parameters():
        got, ref = p.detach(), want[name]
        big = ref.abs() > 1e-3
        per_param[name] = {
            "max_abs_diff": float((got - ref).abs().max()),
            "max_abs_w": float(ref.abs().max()),
            "median_rel": float((got[big] / ref[big] - 1).median()) if big.any() else None,
        }
    print(json.dumps({
        "optimizer": args.optimizer,
        "log_max_rel_diff": log_rel,
        "weights_max_abs_diff": max(v["max_abs_diff"] for v in per_param.values()),
        "swa_max_abs_diff": max(float((tr.swa.avg_params[n] - want_avg[n]).abs().max())
                                for n in want_avg),
        "per_param": per_param,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
