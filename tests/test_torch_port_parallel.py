"""The port's ``parallel/`` helpers, the data module's per-process batches,
the scoring replicas and ``utils/profiling.py`` against the JAX package, on
the CPU (the JAX side on the conftest's virtual CPU devices).

* ``shard_batch_rows``, ``pad_batch_to_multiple`` and ``pad_batch_to_size``
  equal JAX's over (rows, processes, index), empty slices included;
* the HDF5 data module's batches as process r of 2 (``_process_info``
  patched on both sides) equal JAX's token for token, ``weight`` and
  ``_global_rows`` included (JAX pins the top length bucket where the port
  keeps each batch's own: the columns past the port's are JAX's zeros), and
  one process's are unchanged;
* the engine and ``infer from_csv`` at ``n_data_parallel`` 2 and 4 on CPU
  replicas score as one replica, with JAX's rounded batch shapes;
* ``StepTimer`` against JAX's; ``trace`` and ``Trainer(profile_dir=...)``
  write one ``*.pt.trace.json``, of the first trained epoch alone.
"""
import csv
import json
import os
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from intrepppid_tpu.data import ppi_oma as jax_ppi_oma
from intrepppid_tpu.data.tokenizer import SentencePieceTokenizer as JaxTokenizer
from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.parallel import mesh as jax_mesh
from intrepppid_tpu.serve import ScoringEngine as JaxEngine
from intrepppid_tpu.utils.profiling import StepTimer as JaxStepTimer
from intrepppid_tpu.utils.torch_convert import save_torch_checkpoint
from intrepppid_tpu_torch.cli.infer import Infer
from intrepppid_tpu_torch.data import ppi_oma
from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.parallel import mesh
from intrepppid_tpu_torch.serve import ScoringEngine
from intrepppid_tpu_torch.train import Trainer
from intrepppid_tpu_torch.utils.convert import from_jax_params
from intrepppid_tpu_torch.utils.profiling import StepTimer, trace
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
H5, SPM = FIXTURES / "tiny.h5", FIXTURES / "tiny_spm.model"
TOKEN_KEYS = ("p1", "p2", "anchor", "positive", "negative")
AAS = "ACDEFGHIKLMNPQRSTVWY"
VOCAB, EMBED, TRUNC = 38, 16, 64


# ------------------------------------------------------------ the helpers
@pytest.mark.parametrize("rows,processes", [(8, 2), (7, 2), (5, 4), (3, 4), (1, 2), (9, 3)])
def test_shard_batch_rows_matches_jax(rows, processes):
    """Every process index, empty slices included (3 rows over 4, 1 over 2)."""
    indices = np.arange(100, 100 + rows)
    for index in range(processes):
        got, gw = ppi_oma.shard_batch_rows(indices, processes, index)
        want, ww = jax_ppi_oma.shard_batch_rows(indices, processes, index)
        assert np.array_equal(got, want)
        assert (gw is None and ww is None) or np.array_equal(gw, ww)


@pytest.mark.parametrize("rows,multiple,size,weighted", [(5, 2, 8, False), (6, 3, 6, True),
                                                         (7, 4, 9, True), (4, 4, 3, False)])
def test_batch_padding_matches_jax(rows, multiple, size, weighted):
    rng = np.random.default_rng(rows)
    batch = {"p1": rng.integers(0, VOCAB, (rows, 6)).astype(np.int32),
             "label": (np.arange(rows) % 2).astype(np.int32)}
    if weighted:
        batch["weight"] = rng.random(rows).astype(np.float32)
    for port, ref in ((mesh.pad_batch_to_multiple(batch, multiple),
                       jax_mesh.pad_batch_to_multiple(batch, multiple)),
                      (mesh.pad_batch_to_size(batch, size), jax_mesh.pad_batch_to_size(batch, size))):
        assert port[1] == ref[1] and sorted(port[0]) == sorted(ref[0])
        for k, v in ref[0].items():
            assert port[0][k].dtype == v.dtype and np.array_equal(port[0][k], v), k


def test_alone_the_collectives_are_identities(monkeypatch):
    for k in mesh.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not mesh.initialize_distributed("cpu") and not mesh.is_initialized()
    assert (mesh.process_count(), mesh.process_index()) == (1, 0)
    assert mesh.broadcast_from_primary_int(7) == 7
    assert mesh.broadcast_from_primary_str("25.230-01.02-a-b") == "25.230-01.02-a-b"
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.gather_rows(t) is t and torch.equal(mesh.all_reduce_max(t), t)
    grads = [t.clone()]
    mesh.all_reduce_sum_(grads)
    assert torch.equal(grads[0], t)
    mesh.barrier()
    mesh.check_data_parallel(None, "train e2e_rnn_triplet")
    mesh.check_data_parallel(1, "train e2e_rnn_triplet")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4 -m intrepppid_tpu_torch eval"):
        mesh.check_data_parallel(4, "eval e2e_rnn_triplet")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_PORT"):
        mesh.initialize_distributed("cpu")


# ------------------------------------------------------------ data module
def data_modules(monkeypatch, info, batch_size=5, seed=3):
    monkeypatch.setattr(ppi_oma, "_process_info", lambda: info)
    monkeypatch.setattr(jax_ppi_oma, "_process_info", lambda: info)
    kw = dict(batch_size=batch_size, dataset_path=H5, c_type=3, trunc_len=TRUNC, workers=0,
              vocab_size=VOCAB, model_file=SPM, seed=seed, sos=False, eos=False,
              negative_omid=True)
    port, ref = ppi_oma.IntrepppidDataModule(**kw), jax_ppi_oma.IntrepppidDataModule(**kw)
    port.setup()
    ref.setup()
    return port, ref


def splits(dm):
    return [("train0", dm.train_batches(0)), ("train1", dm.train_batches(1)),
            ("val", dm.val_batches()), ("test", dm.test_batches()),
            ("train_eval", dm.train_eval_batches())]


@pytest.mark.parametrize("info", [(2, 0), (2, 1), (1, 0)])
def test_data_module_batches_as_a_process_match_jax(monkeypatch, info):
    """Batches of 5 (24 train pairs: the last global batch 4; val and test
    8: 5 and 3), so every split but the last train batch shards unevenly
    over two processes."""
    port, ref = data_modules(monkeypatch, info)
    for (name, got_it), (_, want_it) in zip(splits(port), splits(ref)):
        got, want = list(got_it), list(want_it)
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w), name
            for k, v in w.items():
                if k in TOKEN_KEYS:
                    T = g[k].shape[1]
                    assert np.array_equal(g[k], v[:, :T]) and not v[:, T:].any(), (name, k)
                else:
                    assert np.asarray(g[k]).dtype == np.asarray(v).dtype, (name, k)
                    assert np.array_equal(g[k], v), (name, k)
            if info[0] > 1:
                assert g["_global_rows"] == w["_global_rows"]
                assert len(g["label"]) == -(-int(g["_global_rows"]) // 2)


# -------------------------------------------------------- serving replicas
def pairs(seed, n):
    rng = np.random.default_rng(seed)
    return [("".join(rng.choice(list(AAS), int(rng.integers(8, 190)))),
             "".join(rng.choice(list(AAS), int(rng.integers(8, 120))))) for _ in range(n)]


@pytest.fixture(scope="module")
def weights():
    jnet = jax_network(0, vocab_size=VOCAB, embedding_size=EMBED, use_projection=True)
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(3)))
    other = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(4)))
    return jnet, params, other


def port_engine(params, n, batch, bulk):
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED, use_projection=True,
                             device="cpu")
    return ScoringEngine(net, from_jax_params(params), SentencePieceTokenizer(SPM),
                         trunc_len=200, batch_size=batch, bulk_batch_size=bulk,
                         n_data_parallel=n)


@pytest.mark.parametrize("n", [2, 4])
def test_engine_replicas_score_as_one(weights, n):
    """11 pairs through batch 3 and bulk 7, rounded up to the replica count
    as JAX's engine rounds them (2: 4 and 8; 4: 4 and 8), score as one
    replica at those shapes; a swap reaches every replica."""
    jnet, params, other = weights
    ref = JaxEngine(jnet, params, JaxTokenizer(SPM), trunc_len=200, batch_size=3,
                    bulk_batch_size=7, n_data_parallel=n)
    dp = port_engine(params, n, 3, 7)
    assert (dp.batch_size, dp.bulk_batch_size, dp.n_data_parallel) == (
        ref.batch_size, ref.bulk_batch_size, ref.n_data_parallel)
    assert len(dp.replicas) == n and len({id(r) for r in dp.replicas}) == n
    one = port_engine(params, 1, dp.batch_size, dp.bulk_batch_size)
    batch = pairs(5, 11)
    np.testing.assert_allclose(dp.score_pairs(batch), one.score_pairs(batch), rtol=2e-6,
                               atol=1e-7)
    dp.swap_params(from_jax_params(other))
    np.testing.assert_allclose(dp.score_pairs(batch),
                               port_engine(other, 1, 4, 8).score_pairs(batch),
                               rtol=2e-6, atol=1e-7)


@pytest.fixture(scope="module")
def infer_files(tmp_path_factory, weights):
    tmp = tmp_path_factory.mktemp("infer_dp")
    rng = np.random.default_rng(8)
    seqs = {f"P{i:02d}": "".join(rng.choice(list(AAS), int(rng.integers(5, 90))))
            for i in range(9)}
    (tmp / "seqs.fasta").write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    names = list(seqs)
    (tmp / "pairs.csv").write_text("".join(
        f"itx{i},{names[int(rng.integers(9))]},{names[int(rng.integers(9))]}\n"
        for i in range(11)))
    save_torch_checkpoint(weights[1], tmp / "model.ckpt")
    return tmp


def infer_scores(files, n, batch):
    out = files / f"out_{n}_{batch}.csv"
    done = Infer.from_csv(files / "pairs.csv", files / "seqs.fasta", files / "model.ckpt", SPM,
                          out, trunc_len=TRUNC, batch_size=batch, vocab_size=VOCAB,
                          embedding_size=EMBED, n_data_parallel=n, device="cpu")
    assert done == 11
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    return [r[0] for r in rows], np.array([float(r[1]) for r in rows])


@pytest.mark.parametrize("n", [2, 4])
def test_infer_from_csv_on_replicas_scores_as_one(infer_files, n):
    """Batch 3 rounds up to 4 over 2 or 4 replicas: the same rows and
    scores as one replica at batch 4."""
    ids, got = infer_scores(infer_files, n, 3)
    want_ids, want = infer_scores(infer_files, 1, 4)
    assert ids == want_ids
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


# -------------------------------------------------------------- profiling
def test_step_timer_matches_jax(monkeypatch):
    def drive(timer):
        clock = iter([0.0, 0.25, 1.25, 1.75, 3.75, 3.875])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer.start()
        out = []
        for n in (8, 3):
            out.append(timer.stop(n))
            timer.start()
        return out

    port, ref = StepTimer(), JaxStepTimer()
    assert drive(port) == drive(ref) == [0.25, 0.5]
    for name in ("steps", "total_items", "total_time", "mean_step_s", "items_per_s"):
        assert getattr(port, name) == getattr(ref, name), name
    port.reset()
    assert (port.steps, port.total_time, port.mean_step_s) == (0, 0.0, 0.0)


def test_trace_writes_a_pt_trace_json(tmp_path):
    with trace(tmp_path / "prof"):
        with torch.profiler.record_function("marked_region"):
            torch.ones(4, 4).sum()
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "marked_region" in names and "aten::sum" in names


class TinyModule:
    """Seeded quintuplet batches at the tiny width: 3 train batches of 4
    pairs an epoch and one val batch."""

    def __init__(self):
        rng = np.random.default_rng(0)

        def batch():
            b = {k: rng.integers(1, VOCAB, (4, 12)).astype(np.int32) for k in TOKEN_KEYS}
            b["label"] = np.array([1, 0, 1, 0], np.int32)
            return b

        self.train, self.val = [batch() for _ in range(3)], [batch()]

    def train_batches(self, epoch):
        return iter(self.train)

    def val_batches(self):
        return iter(self.val)


def test_profile_dir_traces_the_first_trained_epoch(tmp_path):
    """``fit`` over 2 epochs traces epoch 0's 3 steps and nothing of its val
    pass (no ``no_grad`` eval forward in the trace); a resumed ``fit``
    traces its own first epoch, epoch 1."""
    def trainer(chkpt, prof):
        net = intrepppid_network(3, vocab_size=VOCAB, embedding_size=EMBED, num_epochs=2,
                                 device="cpu", seed=0)
        return Trainer(net, chkpt, "m", seed=0, swa=None, keep_all_checkpoints=True,
                       profile_dir=prof)

    straight = trainer(tmp_path / "a", tmp_path / "prof_a")
    straight.fit(TinyModule())
    resumed = trainer(tmp_path / "a", tmp_path / "prof_b")
    epoch0 = next((tmp_path / "a").glob("m-epoch=00-*"))
    resumed.fit(TinyModule(), checkpoint_path=epoch0)
    for prof in ("prof_a", "prof_b"):
        (path,) = (tmp_path / prof).glob("*.pt.trace.json")
        names = [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]]
        assert sum(n.startswith("Optimizer.step#") for n in names) == 3, prof
    assert os.listdir(tmp_path / "prof_a") != os.listdir(tmp_path / "prof_b")
