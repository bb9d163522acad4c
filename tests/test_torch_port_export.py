"""The port's ``export torch_ckpt`` (``cli/export.py``) and its weight maps
(``utils/convert.py``: ``to_jax_params``, ``save_reference_checkpoint``)
against the JAX package's exporter (``utils/torch_convert.py``), on the CPU.

These are the cases of ``tests/test_torch_export.py`` that need no orbax,
run against the port: the export strict-loads into the reference's module
tree, with and without ``triplet_projection`` and at three layers; the
reference replica loaded from it scores as the port does; it reads back
into the port bit for bit; and ``python -m intrepppid_tpu_torch export
torch_ckpt`` on a checkpoint directory of the port's ``fit`` writes the
same ``state_dict`` entries, bit for bit, as JAX's ``save_torch_checkpoint``
on the same weights, with ``hyper_parameters``, ``epoch`` and
``global_step``.
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

from intrepppid_tpu.utils.torch_convert import (
    load_torch_checkpoint,
    save_torch_checkpoint,
    torch_state_dict_to_params,
)
from intrepppid_tpu_torch.cli.export import Export
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.train import Trainer
from intrepppid_tpu_torch.utils.convert import (
    from_jax_params,
    load_reference_checkpoint,
    params_to_reference,
    save_reference_checkpoint,
    to_jax_params,
)
from test_utils import build_reference_like_module
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)
from torch_reference import TorchTripletReplica

ROOT = Path(__file__).resolve().parent.parent
E, V = 16, 30


def port_net(use_projection=True, layers=2, seed=1, **kw):
    return intrepppid_network(2, vocab_size=V, embedding_size=E, rnn_num_layers=layers,
                              use_projection=use_projection, device="cpu", seed=seed, **kw)


def reference_state(net):
    return params_to_reference(to_jax_params(net.state_dict()))


def jax_read(sd, layers=2):
    """A reference ``state_dict`` read by the JAX package's importer, as
    numpy leaves."""
    return jax.tree_util.tree_map(np.asarray, torch_state_dict_to_params(sd, layers))


def assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("use_projection", [True, False])
def test_strict_load_into_reference_module_tree(use_projection):
    """Every key of the reference's module tree and no other: the LSTM under
    ``rnn`` and ``rnn_dp.module``, layer 0's forward ``W_hh`` as ``_raw``;
    ``triplet_projection`` only where the network has one."""
    sd = reference_state(port_net(use_projection))
    assert any(k.startswith("triplet_projection.") for k in sd) == use_projection
    net, _ = build_reference_like_module(E, V, use_projection=use_projection)
    net.load_state_dict(sd, strict=True)


def test_three_layers_strict_load_and_round_trip():
    net = port_net(use_projection=False, layers=3)
    sd = reference_state(net)
    ref, _ = build_reference_like_module(E, V, use_projection=False, num_layers=3)
    ref.load_state_dict(sd, strict=True)
    assert_same_state(from_jax_params(jax_read(sd, layers=3)),
                      net.state_dict())


@pytest.mark.parametrize("use_projection", [True, False])
def test_round_trip_back_into_the_port(tmp_path, use_projection):
    """The port's weights -> a reference ``.ckpt`` -> the port's loader:
    bit for bit; ``to_jax_params`` is the exact inverse of
    ``from_jax_params``."""
    net = port_net(use_projection)
    sd = net.state_dict()
    assert_same_state(from_jax_params(to_jax_params(sd)), sd)
    path = tmp_path / "m.ckpt"
    save_reference_checkpoint(to_jax_params(sd), path)
    assert set(torch.load(path, weights_only=True)) == {"state_dict"}
    back = load_reference_checkpoint(path)
    if not use_projection:
        assert not any(k.startswith("triplet_projection.") for k in back)
    assert_same_state(back, sd)


def test_reference_replica_from_the_export_scores_as_the_port(tmp_path):
    """The reference replica loaded from the export computes the port's
    eval logits (per-call truncation, ragged rows)."""
    net = port_net(True)
    sd = reference_state(net)
    replica = TorchTripletReplica(embedding_size=E, vocab_size=V, use_projection=True)
    own_to_ref = dict(zip(replica.state_dict(), replica.reference_state_dict()))
    replica.load_state_dict({own: sd[ref] for own, ref in own_to_ref.items()}, strict=True)
    replica.eval()
    rng = np.random.default_rng(0)
    ids1, ids2 = (rng.integers(1, V, size=(4, 14)) for _ in range(2))
    ids1[0, 9:] = 0
    ids2[2, 6:] = 0
    with torch.no_grad():
        want = replica.head(replica.encode(torch.from_numpy(ids1)),
                            replica.encode(torch.from_numpy(ids2))).squeeze(-1)
        got = net(torch.from_numpy(ids1), torch.from_numpy(ids2)).squeeze(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=0)


def test_missing_dead_projection_rejected():
    """The reference's strict load needs ``encoder.projection.*``: weights of
    an encoder built without it are refused, as JAX's exporter refuses
    them."""
    from intrepppid_tpu_torch.models.awd_lstm import EncoderConfig
    from intrepppid_tpu_torch.models.triplet import TripletE2EConfig, TripletE2ENet

    cfg = TripletE2EConfig(encoder=EncoderConfig(vocab_size=V, embedding_size=E,
                                                 include_dead_projection=False))
    net = TripletE2ENet(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="include_dead_projection"):
        params_to_reference(to_jax_params(net.state_dict()))


def test_an_orbax_directory_is_refused(tmp_path):
    orbax = tmp_path / "run" / "chkpt" / "m-epoch=00-val_loss=0.50"
    orbax.mkdir(parents=True)
    (orbax / "intrepppid_meta.json").write_text("{}")
    with pytest.raises(ValueError, match="intrepppid_tpu export torch_ckpt"):
        Export.torch_ckpt(orbax, tmp_path / "out.ckpt")
    assert not (tmp_path / "out.ckpt").exists()


class Module:
    """Two training batches of 3 pairs, one val and one test batch."""

    @staticmethod
    def batch(seed, B=3, T=20):
        rng = np.random.default_rng(seed)
        b = {k: rng.integers(1, V, (B, T)).astype(np.int32)
             for k in ("p1", "p2", "anchor", "positive", "negative")}
        b["p1"][0, 7:] = 0
        b["label"] = np.array([1, 0, 1][:B], np.int32)
        return b

    def train_batches(self, epoch):
        return iter([self.batch(10 * epoch), self.batch(10 * epoch + 1)])

    def val_batches(self):
        return iter([self.batch(50)])

    def test_batches(self):
        return iter([self.batch(60)])


def test_python_m_export_of_a_fit_checkpoint_matches_jax(tmp_path):
    """``fit`` (2 epochs, ``use_projection``) writes its checkpoints into a
    run directory with ``hyperparams.json``; ``python -m
    intrepppid_tpu_torch export torch_ckpt`` on the best one: JAX's
    ``save_torch_checkpoint`` on the same weights writes the same entries,
    bit for bit; ``hyper_parameters`` (found two levels up), ``epoch`` and
    ``global_step`` are the checkpoint's; JAX's reader gives back the
    checkpoint's weights."""
    run = tmp_path / "run"
    net = port_net(True, num_epochs=2, optimizer_type="adamw")
    trainer = Trainer(net, run / "chkpt", "tiny", seed=0)
    trainer.fit(Module())
    hp = {"vocab_size": V, "embedding_size": E, "use_projection": True}
    (run / "hyperparams.json").write_text(json.dumps(hp))
    best = trainer.checkpoints.best_checkpoint()
    state = torch.load(best / "state.pt", weights_only=True)

    out = tmp_path / "exported.ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "intrepppid_tpu_torch", "export", "torch_ckpt",
                           "--checkpoint_path", str(best), "--out_path", str(out)],
                          capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = torch.load(out, weights_only=True)
    n = len(got["state_dict"])
    assert proc.stdout.strip().endswith(f"-> {out} ({n} state_dict entries)")
    assert got["hyper_parameters"] == hp
    assert (got["epoch"], got["global_step"]) == (state["epoch"], state["global_step"])
    assert got["global_step"] == 2 * (got["epoch"] + 1)  # two steps an epoch

    jax_out = tmp_path / "jax.ckpt"
    save_torch_checkpoint(to_jax_params(state["params"]), jax_out,
                          hyper_parameters=hp, epoch=state["epoch"],
                          global_step=state["global_step"])
    want = torch.load(jax_out, weights_only=True)
    assert sorted(got) == sorted(want)
    assert_same_state(got["state_dict"], want["state_dict"])
    ref, _ = build_reference_like_module(E, V, use_projection=True)
    ref.load_state_dict(got["state_dict"], strict=True)
    back = from_jax_params(jax.tree_util.tree_map(np.asarray, load_torch_checkpoint(out)))
    assert_same_state(back, state["params"])
