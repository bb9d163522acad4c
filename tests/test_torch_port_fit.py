"""The port's training loop (``train/trainer.py``: ``fit``, ``resume``,
``test``; ``train/checkpoint.py``; ``optim/swa.py``) against the JAX
package's ``Trainer``, on the CPU.

A small in-memory data module (3 epochs of 3 train batches of 4 pairs and a
tail of 2, 2 val and 2 test batches, T = 24) runs through both trainers
from the same weights, dropout off, SWA on, ``adamw_1cycle``. Every logged
value agrees to rtol 1e-5 (the epoch clock's two only in key and step),
the checkpoint directories are named alike and the same one is best, and
the SWA average and the final weights agree to 1e-5. The JAX side runs
AdamW because XLA's build of the Ranger21 step takes the file past its
~30 s (``ranger21_xx`` is held update by update in
``test_torch_port_train.py``). Under ``ranger21_xx`` the 12 steps end
1.1e-5 apart on the embedding (|w| 1.24), every parameter of the port the
same ~9e-6 of its value nearer 0 than JAX's: the stable weight decay's
rate, set by the pooled second moment, compounds the two packages'
rounding (``tools/fit_parity.py`` prints both runs' differences). A
resume from the epoch-0 checkpoint is bit-equal to the straight run, with
dropout on, for both optimizers.
"""
import copy
import io
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.optim import SWAConfig as JaxSWAConfig
from intrepppid_tpu.optim import SWAState as JaxSWAState
from intrepppid_tpu.train.trainer import Trainer as JaxTrainer
from intrepppid_tpu_torch.__main__ import main as port_main
from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataset
from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.optim import SWAConfig, SWAState, make_optimizer
from intrepppid_tpu_torch.train import CheckpointManager, Trainer, load_params_from_checkpoint
from intrepppid_tpu_torch.utils.convert import from_jax_params
from test_torch_port_train import EMBED, NO_DROPOUT, VOCAB, quintuplet_batch
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

EPOCHS, STEPS_PER_EPOCH = 3, 4
CLOCK_KEYS = ("epoch_time_s", "seq_pairs_per_s")
SPM = Path(__file__).parent / "fixtures" / "tiny_spm.model"


class Module:
    """The three iterators ``fit`` and ``test`` read: per epoch 3 batches
    of 4 pairs and a tail of 2, then 2 val and 2 test batches."""

    def __init__(self, seed=100):
        self.seed = seed

    def train_batches(self, epoch):
        s = self.seed + 10 * epoch
        return iter([quintuplet_batch(s + j) for j in range(3)]
                    + [quintuplet_batch(s + 3, B=2)])

    def val_batches(self):
        return iter([quintuplet_batch(self.seed + 50 + j) for j in range(2)])

    def test_batches(self):
        return iter([quintuplet_batch(self.seed + 60 + j) for j in range(2)])


def networks(optimizer_type="ranger21_xx", dropout=False, seed=0):
    kw = dict(vocab_size=VOCAB, embedding_size=EMBED, num_epochs=EPOCHS,
              optimizer_type=optimizer_type, **({} if dropout else NO_DROPOUT))
    jnet = jax_network(STEPS_PER_EPOCH, **kw)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(seed)))
    net = intrepppid_network(STEPS_PER_EPOCH, device="cpu", **kw)
    net.load_state_dict(from_jax_params(params))
    return jnet, params, net


def weights(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainer's and the port's ``fit`` and ``test("best")`` from
    the same weights; their loggers' metrics as they stood after that."""
    tmp = tmp_path_factory.mktemp("fit")
    jnet, params, net = networks("adamw_1cycle")
    jtr = JaxTrainer(jnet, tmp / "jax", "m", seed=0)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jval = jtr.fit(Module())
    jtest = jtr.test(Module(), "best")
    tr = Trainer(net, tmp / "port", "m", seed=0, tb_writer=Scalars())
    val = tr.fit(Module())
    test = tr.test(Module(), "best")
    return {"jax": jtr, "port": tr, "tmp": tmp, "jval": jval, "val": val,
            "jtest": jtest, "test": test,
            "jlogs": copy.deepcopy(dict(jtr.loggers[0].metrics)),
            "logs": copy.deepcopy(dict(tr.loggers[0].metrics))}


class Scalars:
    """A TensorBoard-style writer that keeps what it is given."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, key, value, step):
        self.rows.append((key, value, step))


def to_port(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


# ------------------------------------------------------------ fit against JAX
def test_fit_logs_match_jax(runs):
    jlogs, logs = runs["jlogs"], runs["logs"]
    assert sorted(logs) == sorted(jlogs)
    assert [e["step"] for e in logs["lr"]] == [2, 4, 6, 8, 10, 12]
    assert [e["step"] for e in logs["train_loss"]] == [4, 8, 12]
    for k, want in jlogs.items():
        got = logs[k]
        assert [e["step"] for e in got] == [e["step"] for e in want], k
        if k not in CLOCK_KEYS:
            np.testing.assert_allclose([e["value"] for e in got], [e["value"] for e in want],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    for a, b in ((runs["val"], runs["jval"]), (runs["test"], runs["jtest"])):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # the epoch rate counts the tail's true rows: 14 pairs an epoch
    for t, r in zip(logs["epoch_time_s"], logs["seq_pairs_per_s"]):
        assert t["value"] > 0 and r["value"] == pytest.approx(14 / t["value"])


def test_fit_writes_every_logged_value_to_the_writer(runs):
    rows = runs["port"].tb_writer.rows
    logged = {(k, e["value"], e["step"]) for k, entries in runs["logs"].items()
              for e in entries}
    assert len(rows) == len(logged) and set(rows) == logged


def test_fit_with_the_swa_lr_scale_logs_the_scaled_rate(tmp_path):
    """``use_swa_lr_scale``: from SWA's start the epoch's updates and its
    logged ``lr`` take ``SWAState.lr_scale`` (annealing 1e-2 toward 1e-3)."""
    _, _, net = networks()
    tr = Trainer(net, tmp_path, "m", seed=0, swa=SWAConfig(swa_lr=1e-3),
                 use_swa_lr_scale=True)
    tr.fit(Module())
    _, _, plain_net = networks()
    plain = Trainer(plain_net, tmp_path / "plain", "m", seed=0, swa=SWAConfig(swa_lr=1e-3))
    plain.fit(Module())
    scales = [tr.swa.lr_scale(e, 1e-2) for e in range(EPOCHS)]
    assert scales[0] == 1.0 and scales[2] < 0.99  # the anneal starts at swa_start = 1
    for e in tr.loggers[0].metrics["lr"]:
        epoch = (e["step"] - 1) // STEPS_PER_EPOCH
        assert e["value"] == pytest.approx(tr.lr_schedule(e["step"]) * scales[epoch], rel=1e-12)
    # epoch 2's updates were scaled; its weights enter no average, so the
    # last checkpoint shows them (the SWA weights are the same in both runs)
    last, last_plain = (CheckpointManager.restore(t.checkpoints.last_path)["params"]
                        for t in (tr, plain))
    assert any(not torch.equal(v, last_plain[k]) for k, v in last.items())
    for p, q in zip(net.parameters(), plain_net.parameters()):
        assert torch.equal(p, q)


def test_fit_checkpoints_match_jax(runs):
    jdir, pdir = runs["tmp"] / "jax", runs["tmp"] / "port"
    names = sorted(p.name for p in pdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir())
    assert "best.json" in names and len(names) >= 2
    jbest, best = (json.loads((d / "best.json").read_text()) for d in (jdir, pdir))
    assert Path(best["best"]).name == Path(jbest["best"]).name
    assert Path(best["best"]).is_absolute() and Path(best["best"]).parent == pdir.absolute()
    np.testing.assert_allclose(best["val_loss"], jbest["val_loss"], rtol=1e-5)
    for d in pdir.iterdir():
        if d.is_dir():
            meta = json.loads((d / "intrepppid_meta.json").read_text())
            assert meta["model_name"] == "m" and d.name.startswith(f"m-epoch={meta['epoch']:02d}")


def test_fit_swa_average_and_final_weights_match_jax(runs):
    jtr, tr = runs["jax"], runs["port"]
    assert tr.swa.n_averaged == jtr.swa.n_averaged == 2 and tr.global_step == 12
    want_avg, want = to_port(jtr.swa.avg_params), to_port(jtr.params)
    for name, p in tr.net.named_parameters():
        np.testing.assert_allclose(tr.swa.avg_params[name].numpy(), want_avg[name].numpy(),
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)
        # the final weights are the average, in the parameter's dtype
        assert torch.equal(p.detach(), tr.swa.avg_params[name].to(p.dtype))


# ---------------------------------------------------------------- resume
@pytest.mark.parametrize("optimizer_type", ["ranger21_xx", "adamw_1cycle"])
def test_resume_from_epoch_0_is_bit_equal(tmp_path, optimizer_type):
    """Dropout on, every checkpoint kept: ``fit`` from the epoch-0
    checkpoint (in a copy of the run's directory) ends at the straight run's
    weights, SWA state and step, bit for bit, and logs the same epochs 1-2."""
    _, _, net = networks(optimizer_type, dropout=True)
    straight = Trainer(net, tmp_path / "a", "m", seed=0, keep_all_checkpoints=True)
    straight.fit(Module())
    names = sorted(p.name for p in (tmp_path / "a").iterdir() if p.is_dir())
    assert [n[:len("m-epoch=00")] for n in names] == ["m-epoch=00", "m-epoch=01", "m-epoch=02"]
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    _, _, net2 = networks(optimizer_type, dropout=True, seed=1)
    resumed = Trainer(net2, tmp_path / "b", "m", seed=0, keep_all_checkpoints=True)
    resumed.fit(Module(), checkpoint_path=tmp_path / "b" / names[0])
    assert resumed.start_epoch == 1 and resumed.global_step == straight.global_step == 12
    for name, p in straight.net.named_parameters():
        assert torch.equal(dict(resumed.net.named_parameters())[name], p), name
        assert torch.equal(resumed.swa.avg_params[name], straight.swa.avg_params[name]), name
    assert resumed.swa.n_averaged == straight.swa.n_averaged == 2
    state, want = (CheckpointManager.restore(d / names[2])
                   for d in (tmp_path / "b", tmp_path / "a"))
    for k, v in want["params"].items():
        assert torch.equal(state["params"][k], v), k
    logs, full = resumed.loggers[0].metrics, straight.loggers[0].metrics
    assert sorted(logs) == sorted(full)
    for k, entries in full.items():
        later = [e for e in entries if e["step"] > STEPS_PER_EPOCH]
        assert [e["step"] for e in logs[k]] == [e["step"] for e in later], k
        if k not in CLOCK_KEYS:
            assert logs[k] == later, k


# ------------------------------------------------------------------ test
def test_test_leaves_the_live_weights_and_matches_a_hand_loaded_eval(runs):
    tr = runs["port"]
    live = weights(tr.net)
    best = tr.checkpoints.best_checkpoint()
    by_path = tr.test(Module(), str(best))
    last = tr.test(Module(), "last")
    again = tr.test(Module(), "best")
    for k, v in weights(tr.net).items():
        assert torch.equal(v, live[k]), k
    # "best" and its path: a fresh network loaded from the best state.pt
    _, _, fresh = networks(seed=2)
    fresh.load_state_dict(torch.load(best / "state.pt", weights_only=True)["params"])
    for metrics, net in ((again, fresh), (by_path, fresh), (last, tr.net)):
        acc = {}
        rows = 0
        for i, batch in enumerate(Module().test_batches()):
            aux = tr.eval_step(batch, i, net)
            n = batch["label"].shape[0]
            rows += n
            for k, v in aux.items():
                acc[k] = acc.get(k, 0.0) + float(v) * n
        assert sorted(metrics) == sorted(f"test_{k}" for k in acc)
        for k, v in acc.items():
            assert metrics[f"test_{k}"] == pytest.approx(v / rows, rel=1e-12, abs=1e-12), k
    assert runs["test"] == again


def test_fit_needs_a_checkpoint_directory():
    _, _, net = networks()
    with pytest.raises(ValueError, match="chkpt_dir"):
        Trainer(net, seed=0).fit(Module())


# ------------------------------------------------------- checkpoint manager
def test_checkpoint_manager_keeps_best_and_last(tmp_path):
    m = CheckpointManager(tmp_path, "m")
    state = {"params": {"w": torch.arange(3.0)}, "global_step": 7, "epoch": 0}
    for epoch, val_loss, kept in ((0, 2.0, {0}), (1, 1.0, {1}), (2, 1.5, {1, 2}),
                                  (3, 3.0, {1, 3}), (4, 0.5, {4})):
        path = m.save(dict(state, epoch=epoch), epoch, val_loss)
        assert path.name == f"m-epoch={epoch:02d}-val_loss={val_loss:.2f}" and path.is_absolute()
        assert {int(p.name[8:10]) for p in tmp_path.iterdir() if p.is_dir()} == kept
    again = CheckpointManager(tmp_path, "m")
    assert again.best_checkpoint() == m.best_path == path and again.best_val_loss == 0.5
    assert json.loads((tmp_path / "best.json").read_text()) == {"best": str(path),
                                                                "val_loss": 0.5}
    restored = CheckpointManager.restore(path)
    assert restored["epoch"] == 4 and restored["global_step"] == 7
    assert torch.equal(load_params_from_checkpoint(path)["w"], torch.arange(3.0))
    assert not CheckpointManager(tmp_path / "new", "m").best_checkpoint()
    keep = CheckpointManager(tmp_path / "all", "m", keep_all=True)
    for epoch, val_loss in ((0, 2.0), (1, 1.0), (2, 1.5), (3, 3.0)):
        keep.save(state, epoch, val_loss)
    assert len([p for p in (tmp_path / "all").iterdir() if p.is_dir()]) == 4


# ------------------------------------------------------------- optimizer
def test_ranger21_step_count_survives_a_checkpoint():
    """3 steps, the state through ``torch.save`` / ``torch.load
    (weights_only=True)`` into a fresh optimizer, 4 more: the same bits as
    7 steps without the round trip (warmup, lookahead sync at 5)."""
    rng = np.random.default_rng(9)
    _, _, net = networks()
    grads = [{n: torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32))
              for n, p in net.named_parameters()} for _ in range(7)]

    def run(round_trip):
        _, _, net = networks()
        opt = make_optimizer("ranger21_xx", net.param_groups(), 1e-2, STEPS_PER_EPOCH, EPOCHS)
        for t, g in enumerate(grads):
            if round_trip and t == 3:
                buf = io.BytesIO()
                torch.save(opt.state_dict(), buf)
                buf.seek(0)
                state = torch.load(buf, weights_only=True)
                assert state["count"] == 3
                opt = make_optimizer("ranger21_xx", net.param_groups(), 1e-2,
                                     STEPS_PER_EPOCH, EPOCHS)
                opt.load_state_dict(state)
                assert opt.count == 3
            for n, p in net.named_parameters():
                p.grad = g[n].clone()
            opt.step()
        assert opt.count == 7
        return weights(net)

    straight, resumed = run(False), run(True)
    for k, v in straight.items():
        assert torch.equal(resumed[k], v), k


@pytest.mark.parametrize("num_epochs", [2, 3, 10])
def test_swa_state_matches_jax(num_epochs):
    """``SWAState`` number for number with the JAX package's: its window,
    the ``swa_start == 0`` corner's initial weights, the running average
    (which must not alias a parameter the optimizer updates in place), the
    LR scale, and the cast back to each parameter's dtype."""
    rng = np.random.default_rng(num_epochs)
    shapes = {"a": (3, 4), "b": (5,)}
    port, ref = SWAState(SWAConfig(), num_epochs), JaxSWAState(JaxSWAConfig(), num_epochs)
    assert (port.swa_start, port.update_start, port.update_end) == (
        ref.swa_start, ref.update_start, ref.update_end)

    def draw():
        return {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}

    init = draw()
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    port.seed_initial(params)
    ref.seed_initial({k: jnp.asarray(v) for k, v in init.items()})
    for epoch in range(num_epochs):
        assert port.active(epoch) == ref.active(epoch)
        for base in (1e-2, 3e-3):
            assert port.lr_scale(epoch, base) == ref.lr_scale(epoch, base)
        new = draw()
        for k, p in params.items():
            p.copy_(torch.from_numpy(new[k]))
        port.update(epoch, params)
        ref.update(epoch, {k: jnp.asarray(v) for k, v in new.items()})
        for p in params.values():
            p.add_(1.0)  # an in-place optimizer step must not reach the average
        assert port.n_averaged == ref.n_averaged
        if ref.avg_params is not None:
            for k in shapes:
                np.testing.assert_array_equal(port.avg_params[k].numpy(),
                                              np.asarray(ref.avg_params[k]), err_msg=k)
    assert port.n_averaged > 0
    half = {"a": torch.zeros(3, 4, dtype=torch.bfloat16), "b": torch.zeros(5)}
    final = port.final_params(half)
    assert final["a"].dtype == torch.bfloat16 and final["b"].dtype == torch.float32
    assert torch.equal(final["a"], port.avg_params["a"].to(torch.bfloat16))
    assert SWAState(SWAConfig(), num_epochs).final_params(half) is half


# ------------------------------------------------------ the weight loader
def test_infer_loads_a_fit_checkpoint_directory(runs, tmp_path):
    """``infer from_csv --device cpu --weights_path <best checkpoint>``
    scores as the trained network does when loaded by hand; a directory
    without ``state.pt`` (an orbax one) is still refused."""
    seqs = {"A": "MKTAYIAKQRQISFVKSHFSRQ", "B": "GSHMLEDPVDAFQ", "C": "MSTNPKPQRKTKRNTNRRPQDVKFPGG"}
    fasta, pairs, out = tmp_path / "s.fasta", tmp_path / "p.csv", tmp_path / "o.csv"
    fasta.write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    rows = [("i0", "A", "B"), ("i1", "C", "A"), ("i2", "B", "B")]
    pairs.write_text("".join(",".join(r) + "\n" for r in rows))
    best = runs["port"].checkpoints.best_checkpoint()
    n = port_main(["infer", "from_csv", "--interactions_path", str(pairs), "--sequences_path",
                   str(fasta), "--weights_path", str(best), "--spm_path", str(SPM),
                   "--out_path", str(out), "--trunc_len", "32", "--batch_size", "2",
                   "--vocab_size", str(VOCAB), "--embedding_size", str(EMBED),
                   "--device", "cpu"])
    assert n == 3
    got = [line.split(",") for line in out.read_text().split()]
    assert [r[0] for r in got] == ["i0", "i1", "i2"]
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED, device="cpu")
    net.load_state_dict(torch.load(best / "state.pt", weights_only=True)["params"])
    spp = SentencePieceTokenizer(SPM)

    def ids(name):
        return torch.as_tensor(IntrepppidDataset.static_encode(32, spp, seqs[name],
                                                              sampling=False))[None].long()

    with torch.no_grad():
        want = [float(torch.sigmoid(net.eval()(ids(a), ids(b)))) for _, a, b in rows]
    np.testing.assert_allclose([float(r[1]) for r in got], want, rtol=1e-5, atol=1e-6)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="export torch_ckpt"):
        port_main(["infer", "from_csv", "--interactions_path", str(pairs), "--sequences_path",
                   str(fasta), "--weights_path", str(tmp_path / "orbax"), "--spm_path",
                   str(SPM), "--out_path", str(tmp_path / "never.csv"), "--vocab_size",
                   str(VOCAB), "--embedding_size", str(EMBED), "--device", "cpu"])
