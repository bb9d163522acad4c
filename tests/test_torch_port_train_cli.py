"""The port's run driver and CLIs (``train/e2e_triplet.py``,
``cli/train.py``, ``cli/evaluate.py``) against the JAX package's, on the
CPU, on ``tests/fixtures/tiny.h5`` (3 steps an epoch of 8 pairs, T = 64).

Both ``train e2e_rnn_triplet`` commands run 2 epochs from the same initial
weights (the port driver's network factory patched to load the JAX
trainer's ``init_state`` parameters), dropout off, ``adamw_1cycle`` in f32
(XLA's build of the Ranger21 step would take the file past its time; the
Ranger21 update is held in ``test_torch_port_train.py``): every value of
``metrics.json`` but the epoch clock's agrees to rtol 1e-5, and the same
epoch is best. The port's ``eval`` on that run's best checkpoint equals its
own ``test_results`` and matches the JAX ``eval`` on the JAX run's best
checkpoint, on the test and the train split. A ``python -m`` run of each
command shows the module entry point; ``--checkpoint_path`` resumes;
``--n_data_parallel`` past the process count is refused with the torchrun
launch that runs it, and ``--profile_dir`` traces the first epoch;
variational dropout trains as the JAX CLI trains it.

The batch metrics AUROC and AP are step functions of the logits' order.
``tiny.h5`` holds the pair (P00003, P00012) and its swap with opposite
labels; the head is symmetric in the pair, so the port's two logits are
equal, while JAX's differ by a rounding (its encoder rounds a sequence
differently in the p1 and the p2 slot), and a batch holding both gives
AUROC values a tie's worth apart (seed 5 puts them in one batch of epoch
0). At the seed used here, 8675309, no batch holds both:
``test_no_batch_holds_a_pair_and_its_swap`` checks that, and
``test_a_pair_and_its_swap_tie`` the tie itself.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from intrepppid_tpu.__main__ import main as jax_main
from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu_torch.__main__ import main as port_main
from intrepppid_tpu_torch.models import factory
from intrepppid_tpu_torch.train import e2e_triplet
from intrepppid_tpu_torch.utils.convert import from_jax_params
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
H5 = ROOT / "tests" / "fixtures" / "tiny.h5"
SPM = ROOT / "tests" / "fixtures" / "tiny_spm.model"
SEED = 8675309
FLAGS = ["--seed", str(SEED), "--vocab_size", "38", "--trunc_len", "64",
         "--embedding_size", "16", "--workers", "0", "--precision", "fp32",
         "--optimizer_type", "adamw_1cycle", "--rnn_dropout_rate", "0",
         "--embedding_droprate", "0", "--do_rate", "0"]
CLOCK_KEYS = ("epoch_time_s", "seq_pairs_per_s")
PATH_KEYS = ("ppi_dataset_path", "sentencepiece_path", "log_path", "hyperparams_path",
             "chkpt_dir", "model_name", "checkpoint_path")


def train_args(log_path, epochs=2):
    return ["train", "e2e_rnn_triplet", str(H5), str(SPM), "3", str(epochs), "8",
            *FLAGS, "--log_path", str(log_path)]


def eval_args(checkpoint, split="test"):
    return ["eval", "e2e_rnn_triplet", "--checkpoint_path", str(checkpoint),
            "--ppi_dataset_path", str(H5), "--sentencepiece_path", str(SPM), "--c_type", "3",
            "--seed", str(SEED), "--batch_size", "8", "--precision", "fp32", "--split", split]


def run_dir(log_path):
    (run,) = [d for d in Path(log_path).iterdir() if d.name != "tensorboard"]
    return run


def best_checkpoint(run):
    return Path(json.loads((run / "chkpt" / "best.json").read_text())["best"])


def from_jax_init(**kw):
    """The port's network with the JAX trainer's initial weights
    (``net.init(PRNGKey(seed))``) for the same configuration."""
    net = factory.intrepppid_network(**kw)
    jkw = {k: v for k, v in kw.items() if k not in ("device", "seed", "compute_dtype")}
    params = jax_network(**jkw).init(jax.random.PRNGKey(kw["seed"]))
    net.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return net


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cli")
    jax_main(train_args(tmp / "jax") + ["--n_data_parallel", "1", "--steps_per_dispatch", "1"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(e2e_triplet, "intrepppid_network", from_jax_init)
        trainer, test = port_main(train_args(tmp / "port") + ["--device", "cpu"])
    return {"tmp": tmp, "jax": run_dir(tmp / "jax"), "port": run_dir(tmp / "port"),
            "trainer": trainer, "test": test}


def metrics(run):
    return json.loads((run / "metrics.json").read_text())


# ------------------------------------------------------------------ train
def test_metrics_match_jax(runs):
    want, got = metrics(runs["jax"]), metrics(runs["port"])
    assert sorted(got) == sorted(want)
    assert len(got["train_loss"]) == 2 and [e["step"] for e in got["train_loss"]] == [3, 6]
    for k, entries in want.items():
        if k == "test_results":
            (w,), (g,) = entries, got[k]
            assert sorted(g) == sorted(w) and g == runs["test"]
            np.testing.assert_allclose([g[n] for n in w], [w[n] for n in w], rtol=1e-5,
                                       atol=1e-7)
            continue
        assert [e["step"] for e in got[k]] == [e["step"] for e in entries], k
        if k not in CLOCK_KEYS:
            np.testing.assert_allclose([e["value"] for e in got[k]],
                                       [e["value"] for e in entries], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    # the same epoch is best
    jbest, best = best_checkpoint(runs["jax"]), best_checkpoint(runs["port"])
    assert best.name.split("-epoch=")[1] == jbest.name.split("-epoch=")[1]
    assert best.parent == runs["port"] / "chkpt"


def test_hyperparams_match_jax(runs):
    want = json.loads((runs["jax"] / "hyperparams.json").read_text())
    got = json.loads((runs["port"] / "hyperparams.json").read_text())
    assert sorted(got) == sorted(want)
    assert got["architecture"] == "ClassifierBarlow" and got["seed"] == SEED
    assert {k: v for k, v in got.items() if k not in PATH_KEYS} == {
        k: v for k, v in want.items() if k not in PATH_KEYS}
    assert got["model_name"] == runs["port"].name
    assert got["chkpt_dir"] == str(runs["port"] / "chkpt")


def test_python_m_train_and_eval(runs, tmp_path):
    """``python -m intrepppid_tpu_torch train`` and ``eval`` on the CPU: the
    run's artifacts, and its best checkpoint scored again equal to its own
    ``test_results`` (the architecture from ``hyperparams.json``)."""
    # one intra-op thread, as the test modules run torch (the commands
    # inherit this worker's CPUs and scheduling policy)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "intrepppid_tpu_torch",
                          *train_args(tmp_path / "logs"), "--device", "cpu"],
                         capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "NUM PARAMS:13570" in out.stdout
    run = run_dir(tmp_path / "logs")
    assert json.loads((run / "hyperparams.json").read_text()).keys() == json.loads(
        (runs["jax"] / "hyperparams.json").read_text()).keys()
    m = metrics(run)
    assert len(m["train_loss"]) == 2 and len(m["test_results"]) == 1
    chkpt = sorted(p.name for p in (run / "chkpt").iterdir())
    assert "best.json" in chkpt and 1 <= len(chkpt) - 1 <= 2
    assert (tmp_path / "logs" / "tensorboard" / run.name).is_dir()
    out = subprocess.run([sys.executable, "-m", "intrepppid_tpu_torch",
                          *eval_args(best_checkpoint(run)), "--device", "cpu",
                          "--out_path", str(tmp_path / "eval.json")],
                         capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads((tmp_path / "eval.json").read_text())
    (want,) = m["test_results"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-7), k


# ------------------------------------------------------------------- eval
@pytest.mark.parametrize("split", ["test", "train"])
def test_eval_matches_jax(runs, split):
    got = port_main(eval_args(best_checkpoint(runs["port"]), split) + ["--device", "cpu"])
    want = jax_main(eval_args(best_checkpoint(runs["jax"]), split)
                    + ["--n_data_parallel", "1", "--steps_per_dispatch", "1"])
    assert sorted(got) == sorted(want) and all(k.startswith(f"{split}_") for k in got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    if split == "test":
        # the same checkpoint, batches and kernels as the run's own test pass
        (own,) = metrics(runs["port"])["test_results"]
        for k, v in own.items():
            assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-7), k


def test_eval_takes_the_architecture_from_hyperparams(runs, monkeypatch):
    built, build = [], factory.intrepppid_network

    def spy(*a, **kw):
        built.append(kw)
        return build(*a, **kw)

    monkeypatch.setattr(factory, "intrepppid_network", spy)
    port_main(eval_args(best_checkpoint(runs["port"])) + ["--device", "cpu"])
    (kw,) = built
    assert (kw["vocab_size"], kw["embedding_size"], kw["rnn_num_layers"]) == (38, 16, 2)
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_main(eval_args(best_checkpoint(runs["port"])) + ["--device", "cpu",
                                                              "--embedding_size", "8"])


def test_no_batch_holds_a_pair_and_its_swap():
    """At ``SEED`` no batch the runs read (3 training epochs, val, test and
    the train split under eval semantics) holds a pair and its swap with
    opposite labels, so the rank metrics compare at rtol 1e-5."""
    from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataModule

    dm = IntrepppidDataModule(8, H5, 3, 64, 0, 38, SPM, SEED, False, False, True)
    dm.setup()
    splits = [(dm.dataset_train, e) for e in range(3)] + [
        (dm.dataset_train, None), (dm.dataset_val, None), (dm.dataset_test, None)]
    for ds, epoch in splits:
        order = np.arange(len(ds))
        if epoch is not None:
            np.random.default_rng(SEED + 1000 * (epoch + 1)).shuffle(order)
        for start in range(0, len(ds), 8):
            labels = {(r[0], r[1]): r[4] for r in (ds.interactions[i]
                                                   for i in order[start:start + 8])}
            assert all(labels.get((b, a), label) == label for (a, b), label in labels.items())


def test_a_pair_and_its_swap_tie():
    """The head is symmetric in the pair: the port's logits of (a, b) and
    (b, a) are equal."""
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(1, 38, (1, 24))) for _ in range(2))
    net = factory.intrepppid_network(0, vocab_size=38, embedding_size=16, device="cpu")
    with torch.no_grad():
        logits = net(torch.cat([a, b]), torch.cat([b, a])).reshape(-1)
    assert logits[0] == logits[1]


def test_eval_warns_of_and_drops_an_unused_triplet_projection(runs, tmp_path, capsys):
    """A checkpoint with ``triplet_projection`` weights scored with
    ``use_projection`` false (from ``hyperparams.json``): the JAX CLI's
    warning, and the same metrics as without those weights."""
    import shutil

    best = best_checkpoint(runs["port"])
    ckpt = tmp_path / "run" / "chkpt" / best.name
    shutil.copytree(best, ckpt)
    shutil.copy(runs["port"] / "hyperparams.json", tmp_path / "run")
    state = torch.load(ckpt / "state.pt", weights_only=True)
    state["params"]["triplet_projection.weight"] = torch.ones(16, 16)
    state["params"]["triplet_projection.bias"] = torch.ones(16)
    torch.save(state, ckpt / "state.pt")
    got = port_main(eval_args(ckpt) + ["--device", "cpu"])
    assert "WARNING: checkpoint contains triplet_projection" in capsys.readouterr().out
    (want,) = metrics(runs["port"])["test_results"]
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


# ----------------------------------------------------------------- resume
def test_checkpoint_path_resumes(runs, tmp_path):
    """A 3-epoch run from the 2-epoch run's last checkpoint trains epoch 2
    alone, from that checkpoint's weights, optimizer step and SWA state."""
    last = runs["trainer"].checkpoints.last_path
    trainer, _ = port_main(train_args(tmp_path, epochs=3)
                           + ["--device", "cpu", "--checkpoint_path", str(last)])
    assert trainer.start_epoch == 2 and trainer.global_step == 9
    m = metrics(run_dir(tmp_path))
    assert [e["step"] for e in m["train_loss"]] == [9]
    assert [e["step"] for e in m["lr"]] == [8]
    names = [p.name for p in (run_dir(tmp_path) / "chkpt").iterdir() if p.is_dir()]
    assert [n.split("-epoch=")[1][:2] for n in names] == ["02"]
    state = torch.load(last / "state.pt", weights_only=True)
    assert state["global_step"] == 6 and state["epoch"] == 1


# ------------------------------------------------------ variational dropout
ABLATION = ["--variational_dropout", "true", "--use_projection", "true", "--bi_reduce", "mean"]


def test_variational_dropout_trains_as_jax(tmp_path):
    """``train --variational_dropout true --use_projection true --bi_reduce
    mean`` (the ablation configuration's switches) on the CPU against the
    JAX CLI from the same weights, at ``--rnn_dropout_rate 0`` (the row
    masks the identity, the calls still on grouped weights): one epoch's
    metrics agree to rtol 1e-5, and ``hyperparams.json`` records the
    switches as JAX's does. The port's ``eval`` of the run's best
    checkpoint (the switches from ``hyperparams.json``) equals its own
    ``test_results``."""
    jax_main(train_args(tmp_path / "jax", epochs=1) + ABLATION
             + ["--n_data_parallel", "1", "--steps_per_dispatch", "1"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(e2e_triplet, "intrepppid_network", from_jax_init)
        _, test = port_main(train_args(tmp_path / "port", epochs=1) + ABLATION
                            + ["--device", "cpu"])
    jrun, run = run_dir(tmp_path / "jax"), run_dir(tmp_path / "port")
    want, got = metrics(jrun), metrics(run)
    assert sorted(got) == sorted(want)
    for k, entries in want.items():
        if k == "test_results":
            (w,), (g,) = entries, got[k]
            np.testing.assert_allclose([g[n] for n in w], [w[n] for n in w], rtol=1e-5,
                                       atol=1e-7)
        elif k not in CLOCK_KEYS:
            np.testing.assert_allclose([e["value"] for e in got[k]],
                                       [e["value"] for e in entries], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    hp = json.loads((run / "hyperparams.json").read_text())
    jhp = json.loads((jrun / "hyperparams.json").read_text())
    assert (hp["variational_dropout"], hp["use_projection"], hp["bi_reduce"]) == (
        True, True, "mean")
    assert {k: v for k, v in hp.items() if k not in PATH_KEYS} == {
        k: v for k, v in jhp.items() if k not in PATH_KEYS}
    evaluated = port_main(eval_args(best_checkpoint(run)) + ["--device", "cpu"])
    assert evaluated == pytest.approx(test, rel=1e-6, abs=1e-7)


# ------------------------------------------------- data parallel, profile
def test_n_data_parallel_past_the_process_count_is_refused(tmp_path):
    """One process asked for two: the ValueError names the torchrun
    launch, and nothing is written."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2 -m intrepppid_tpu_torch"):
        port_main(train_args(tmp_path) + ["--device", "cpu", "--n_data_parallel", "2"])
    assert not any(tmp_path.iterdir())


def test_profile_dir_writes_a_trace_of_the_first_epoch(tmp_path):
    """``--profile_dir`` traces epoch 0 of 2 with ``torch.profiler``: one
    ``*.pt.trace.json`` holding its 3 optimizer steps, and no other
    epoch's."""
    port_main(train_args(tmp_path / "logs") + ["--device", "cpu", "--profile_dir",
                                               str(tmp_path / "prof")])
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    steps = [e for e in events if e.get("name", "").startswith("Optimizer.step#")
             and e.get("cat") == "user_annotation"]
    assert len(steps) == 3


def test_the_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(train_args(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(eval_args(tmp_path / "none"))
    with pytest.raises(ValueError, match="torchrun"):
        port_main(eval_args(tmp_path / "none") + ["--n_data_parallel", "2"])
    assert not any(tmp_path.iterdir())
