"""Data parallelism on the CPU: two gloo ranks (``tests/torch_port_ddp_worker.py``,
spawned once for this module, each at one torch thread and with its own
timeout) against the JAX trainer's 2-device mesh and the port's own
one-process step.

* Two train steps on fixed global batches of 7 pairs, an uneven split (4
  rows and 3 plus a weight-0 filler), each rank's token arrays cut to its
  own longest row: with dropout 0 and ``adamw_1cycle`` the weights, losses
  and metrics within 1e-5 x max(1, |w|) of JAX's ``Trainer`` step on a
  2-device mesh over the same batches padded to 8 rows; with dropout on and
  ``ranger21_xx`` within 1e-6 of the port's one-process step on the whole
  batches, and the ranks bit-equal.
* ``train e2e_rnn_triplet --n_data_parallel 2 --device cpu`` on
  ``tests/fixtures/tiny.h5``: the ranks end on the same weights with the
  same run name and seed, and rank zero alone wrote files; ``eval
  --n_data_parallel 2`` on its best checkpoint equals the one-process
  ``eval`` in the classifier's metrics (the triplet's orthologue draws are
  each rank's own).
"""
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.parallel import make_mesh, pad_batch_to_multiple
from intrepppid_tpu.train.trainer import Trainer as JaxTrainer
from intrepppid_tpu_torch.__main__ import main as port_main
from intrepppid_tpu_torch.utils.convert import from_jax_params
from torch_port_ddp_worker import H5, SPM, launch, run_steps
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

VOCAB, EMBED, PAIRS, T = 38, 16, 7, 24
NETWORK = dict(steps_per_epoch=4, vocab_size=VOCAB, embedding_size=EMBED, num_epochs=5)
NO_DROPOUT = dict(rnn_dropout_rate=0.0, embedding_droprate=0.0, do_rate=0.0)
CLASSIFIER = ("classifier_loss", "auroc", "ap", "mcc", "precision", "rec")


def global_batches(seed, n=2, B=PAIRS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {}
        for k in ("p1", "p2", "anchor", "positive", "negative"):
            ids = rng.integers(1, VOCAB, (B, T)).astype(np.int32)
            for i, length in enumerate(rng.integers(1, T + 1, B)):
                ids[i, length:] = 0
            batch[k] = ids
        batch["label"] = (np.arange(B) % 2).astype(np.int32)
        out.append(batch)
    return out


def jax_init(seed, **kw):
    jnet = jax_network(**NETWORK, **kw)
    return jnet, jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    _, plain = jax_init(3, optimizer_type="adamw_1cycle", **NO_DROPOUT)
    _, dropped = jax_init(4, optimizer_type="ranger21_xx")
    setups = {
        "plain": dict(network=dict(NETWORK, optimizer_type="adamw_1cycle", **NO_DROPOUT),
                      weights=from_jax_params(plain), batches=global_batches(11)),
        "dropout": dict(network=dict(NETWORK, optimizer_type="ranger21_xx"),
                        weights=from_jax_params(dropped), batches=global_batches(12)),
    }
    for name, setup in setups.items():
        (tmp / name).mkdir()
        torch.save(setup, tmp / name / "setup.pt")
    (tmp / "cli").mkdir()
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(launch, "steps", 2, tmp / name) for name in setups]
        jobs.append(pool.submit(launch, "cli", 2, tmp / "cli"))
        for job in jobs:
            job.result()
    steps = {name: [torch.load(tmp / name / f"steps_rank{r}.pt") for r in range(2)]
             for name in setups}
    return {"tmp": tmp, "setups": setups, "steps": steps, "params": plain}


def scaled_err(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def test_two_ranks_match_the_jax_mesh_with_dropout_off(runs):
    """The 2-rank step against the JAX trainer's jitted step over a 2-device
    mesh: the same global batches (padded to 8 rows, the filler at weight 0),
    the same weights, losses and global-batch metrics."""
    jnet = jax_network(**NETWORK, optimizer_type="adamw_1cycle", **NO_DROPOUT)
    jtr = JaxTrainer(jnet, runs["tmp"] / "jax", "m", seed=0, swa=None, mesh=make_mesh(n_data=2))
    jtr.init_state()
    jp = jax.tree_util.tree_map(jnp.asarray, runs["params"])
    jstate = jtr.optimizer.init(jp)
    want_aux = []
    for step, batch in enumerate(runs["setups"]["plain"]["batches"]):
        padded, _ = pad_batch_to_multiple(batch, 2)
        jp, jstate, jaux = jtr._train_step(
            jp, jstate, {k: jnp.asarray(v) for k, v in padded.items()}, jtr._base_key,
            jnp.int32(step), jnp.float32(1.0))
        want_aux.append({k: float(v) for k, v in jaux.items()})
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    for rank in runs["steps"]["plain"]:
        for name, w in want.items():
            assert scaled_err(rank["weights"][name], w) <= 1e-5, name
        for got, wa in zip(rank["aux"], want_aux):
            assert sorted(got) == sorted(wa)
            for k, v in wa.items():
                assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), k


def test_two_ranks_match_one_process_with_dropout_on(runs):
    """With every dropout on, the 2-rank step is the one-process step on the
    whole batches (the head's row masks drawn for the global batch, each
    encoder call run to the global batch's longest length), and the two
    ranks hold the same bits."""
    alone = run_steps(runs["setups"]["dropout"])
    r0, r1 = runs["steps"]["dropout"]
    for name, w in alone["weights"].items():
        assert torch.equal(r0["weights"][name], r1["weights"][name]), name
        assert scaled_err(r0["weights"][name], w) <= 1e-6, name
    assert r0["aux"] == r1["aux"]
    for got, want in zip(r0["aux"], alone["aux"]):
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-6 * max(1.0, abs(v)), k
    r0p, r1p = runs["steps"]["plain"]
    assert all(torch.equal(r0p["weights"][n], r1p["weights"][n]) for n in r0p["weights"])


def cli_result(runs, rank):
    return json.loads((runs["tmp"] / "cli" / f"cli_rank{rank}.json").read_text())


def test_train_cli_ranks_agree_and_rank_zero_alone_writes(runs):
    r0, r1 = cli_result(runs, 0), cli_result(runs, 1)
    assert r0["model_name"] == r1["model_name"] and r0["seed"] == r1["seed"]
    assert r0["steps"] == r1["steps"] == 6  # 24 pairs in global batches of 8, 2 epochs
    w0, w1 = (torch.load(runs["tmp"] / "cli" / f"cli_rank{r}.pt") for r in range(2))
    assert all(torch.equal(w0[n], w1[n]) for n in w0)
    assert r0["test"] == r1["test"] and r0["eval"] == r1["eval"]
    assert r1["writes"] == []
    run = r0["model_name"]
    wrote = set(r0["writes"])
    assert {f"{run}/hyperparams.json", f"{run}/metrics.json", f"{run}/chkpt/best.json",
            "eval.json"} <= wrote
    assert any(w.endswith("/state.pt") for w in wrote)
    hp = json.loads((runs["tmp"] / "cli" / "logs" / run / "hyperparams.json").read_text())
    assert hp["seed"] == r0["seed"]


def test_eval_on_two_ranks_equals_one_process(runs):
    r0 = cli_result(runs, 0)
    alone = port_main(["eval", "e2e_rnn_triplet", "--checkpoint_path", r0["best"],
                       "--ppi_dataset_path", str(H5), "--sentencepiece_path", str(SPM),
                       "--c_type", "3", "--batch_size", "8", "--precision", "fp32",
                       "--seed", "7", "--device", "cpu"])
    assert sorted(alone) == sorted(r0["eval"])
    for k in CLASSIFIER:
        v = alone[f"test_{k}"]
        assert abs(r0["eval"][f"test_{k}"] - v) <= 1e-5 * max(1.0, abs(v)), k
