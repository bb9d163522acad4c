#!/usr/bin/env python3
"""Write ``tests/fixtures/jax_orbax_manuscript/``: a checkpoint directory of
the JAX package's training run at the manuscript width, for the port's
reader of orbax directories (``intrepppid_tpu_torch/train/orbax_read.py``),
which must score, export and resume it where no JAX is installed.

    JAX_PLATFORMS=cpu python3 tools/make_jax_orbax_fixture.py

It needs the JAX package (it runs on the CPU, in a few minutes) and writes:

* ``tests/fixtures/jax_orbax_manuscript_spm.model``: a 250-piece unigram
  tokenizer trained by the JAX package's ``data train_spm`` on 300 seeded
  random protein sequences of 50-1,500 residues (the manuscript's vocab;
  the repository's other models have 38, 258 and 506 pieces);
* ``tests/fixtures/jax_orbax_manuscript/``: the last checkpoint directory
  ``CheckpointManager`` wrote in the JAX ``Trainer.fit`` of the manuscript
  network (vocab 250, E = H = 64, 2 layers, dropout on, f32), with the
  train CLI's ``ranger21`` and SWA on, over 2 epochs of 3 batches of 8
  seeded random token pairs (T = 64) and one val batch, at lr 1e-3: at the
  CLI's 1e-2, Ranger21's stable weight decay (its rate over the RMS of the
  pooled second moment, tiny on such gradients) takes every weight under
  0.02 in 6 steps, and the network gives every pair one probability, so
  the scores would check nothing;
* ``tests/fixtures/jax_orbax_manuscript.json``: the run's hyperparameters,
  its ``epoch``, ``global_step``, ``swa_n`` and Ranger21's ``count``, and
  64 seeded sequence pairs of 50-300 residues with the probabilities the
  JAX package's scoring engine gives them from this checkpoint (f32, CPU,
  the tokenizer above, ``trunc_len`` 1500).
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from intrepppid_tpu.cli.data import Data  # noqa: E402
from intrepppid_tpu.data.tokenizer import SentencePieceTokenizer  # noqa: E402
from intrepppid_tpu.models.factory import intrepppid_network  # noqa: E402
from intrepppid_tpu.serve.engine import ScoringEngine  # noqa: E402
from intrepppid_tpu.train.checkpoint import CheckpointManager, load_params_from_checkpoint  # noqa: E402
from intrepppid_tpu.train.trainer import Trainer  # noqa: E402

FIXTURES = ROOT / "tests" / "fixtures"
OUT = FIXTURES / "jax_orbax_manuscript"
SPM = FIXTURES / "jax_orbax_manuscript_spm.model"
EXPECTED = FIXTURES / "jax_orbax_manuscript.json"
SEED = 0
AAS = "ACDEFGHIKLMNPQRSTVWY"
HP = dict(vocab_size=250, embedding_size=64, rnn_num_layers=2, num_epochs=2,
          optimizer_type="ranger21", lr=1e-3, use_projection=False, bi_reduce="last")
STEPS, PAIRS, T = 3, 8, 64
N_SCORED, SCORE_SEED = 64, SEED + 64


def sequences(rng, n, lo, hi):
    return ["".join(rng.choice(list(AAS), int(rng.integers(lo, hi + 1)))) for _ in range(n)]


def scored_pairs(seed=SCORE_SEED, n=N_SCORED):
    """``n`` pairs of random protein sequences of 50-300 residues."""
    seqs = sequences(np.random.default_rng(seed), 2 * n, 50, 300)
    return [[seqs[2 * i], seqs[2 * i + 1]] for i in range(n)]


def batch(rng, B=PAIRS):
    """A quintuplet batch of random ids in [1, vocab), each row's length in
    [T/2, T], random labels."""
    def ids():
        a = rng.integers(1, HP["vocab_size"], size=(B, T))
        for i, n in enumerate(rng.integers(T // 2, T + 1, size=B)):
            a[i, n:] = 0
        return a.astype(np.int32)

    out = {k: ids() for k in ("p1", "p2", "anchor", "positive", "negative")}
    out["label"] = (rng.random(B) > 0.5).astype(np.int32)
    return out


class Module:
    def __init__(self, rng):
        self.train = [batch(rng) for _ in range(STEPS)]
        self.val = [batch(rng)]

    def train_batches(self, epoch):
        return iter(self.train)

    def val_batches(self):
        return iter(self.val)

    def test_batches(self):
        return iter(self.val)


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        corpus = tmp / "corpus.txt"
        corpus.write_text("\n".join(sequences(np.random.default_rng(SEED + 1), 300, 50, 1500)))
        Data().train_spm(corpus, SPM, vocab_size=HP["vocab_size"])

        net = intrepppid_network(STEPS, **HP)
        trainer = Trainer(net, tmp / "chkpt", "intrepppid", seed=SEED)
        trainer.fit(Module(np.random.default_rng(SEED + 2)))
        if OUT.exists():
            shutil.rmtree(OUT)
        shutil.copytree(trainer.checkpoints.last_path, OUT)

    restored = CheckpointManager.restore(OUT)
    scorer = intrepppid_network(0, **{**HP, "use_projection": True})
    pairs = scored_pairs()
    engine = ScoringEngine(scorer, load_params_from_checkpoint(OUT), SentencePieceTokenizer(SPM),
                           trunc_len=1500, batch_size=N_SCORED, bulk_batch_size=0)
    probs = np.asarray(engine.score_pairs([tuple(p) for p in pairs]), np.float32)
    expected = {
        "hyperparameters": {**HP, "steps_per_epoch": STEPS, "seed": SEED, "swa": True,
                            "dropout": 0.3, "compute_dtype": "float32"},
        "epoch": int(restored["epoch"]), "global_step": int(restored["global_step"]),
        "swa_n": int(restored["swa_n"]), "count": int(np.asarray(restored["opt_state"][0])),
        "scored": {"seed": SCORE_SEED, "residues": [50, 300], "trunc_len": 1500,
                   "tokenizer": SPM.name, "pairs": pairs,
                   "probabilities": [float(p) for p in probs]},
    }
    EXPECTED.write_text(json.dumps(expected, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(json.dumps({"fixture": str(OUT.relative_to(ROOT)), "bytes": size,
                      "epoch": expected["epoch"], "global_step": expected["global_step"],
                      "swa_n": expected["swa_n"], "count": expected["count"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
