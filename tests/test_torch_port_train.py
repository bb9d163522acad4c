"""The port's train step (``models/triplet.py:step``, ``train/trainer.py``,
``optim/``, ``ops/losses.py``, ``ops/metrics.py``, ``ops/dropout.py``)
against the JAX package with the same params and inputs, on the CPU.

With every dropout rate at 0 the two must agree in value and gradient;
with dropout on their random bits differ by construction, so the masks are
held to their distribution (rate, scale, independence between encoder
calls, the zero padding row).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.ops import losses as jlosses
from intrepppid_tpu.ops import metrics as jmetrics
from intrepppid_tpu.ops.dropout import embedding_dropout as jax_embedding_dropout
from intrepppid_tpu.optim import make_optimizer as jax_make_optimizer
from intrepppid_tpu.train.trainer import Trainer as JaxTrainer
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.ops import losses, metrics
from intrepppid_tpu_torch.ops.dropout import dropconnect_weight, dropout, embedding_dropout
from intrepppid_tpu_torch.optim import Ranger21, make_optimizer
from intrepppid_tpu_torch.train import EpochAccumulator, Trainer
from intrepppid_tpu_torch.utils.convert import from_jax_params
from ranger21_oracle import Ranger21Oracle
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

VOCAB, EMBED, PAIRS, T = 38, 16, 4, 24
NO_DROPOUT = dict(rnn_dropout_rate=0.0, embedding_droprate=0.0, do_rate=0.0)


def quintuplet_batch(seed, B=PAIRS, T=T, weight=None):
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
    if weight is not None:
        batch["weight"] = np.asarray(weight, np.float32)
    return batch


def both_networks(seed=0, **kw):
    jnet = jax_network(4, vocab_size=VOCAB, embedding_size=EMBED, num_epochs=5, **kw)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(seed)))
    net = intrepppid_network(4, vocab_size=VOCAB, embedding_size=EMBED, num_epochs=5,
                             device="cpu", **kw)
    net.load_state_dict(from_jax_params(params))
    return jnet, params, net


# ------------------------------------------------------------ losses, metrics
def test_losses_match_jax_with_zero_weight_rows():
    rng = np.random.default_rng(0)
    a, p, n = (rng.standard_normal((6, 5)).astype(np.float32) for _ in range(3))
    logits = rng.standard_normal(6).astype(np.float32) * 3
    y = np.array([1, 0, 1, 1, 0, 0], np.float32)
    w = np.array([1, 1, 0, 1, 0, 1], np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        np.testing.assert_allclose(
            float(losses.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(y), tw)),
            float(jlosses.bce_with_logits(jnp.asarray(logits), jnp.asarray(y), jw)), rtol=1e-6)
        np.testing.assert_allclose(
            float(losses.triplet_margin_loss(*map(torch.from_numpy, (a, p, n)), weights=tw)),
            float(jlosses.triplet_margin_loss(*map(jnp.asarray, (a, p, n)), weights=jw)),
            rtol=1e-6)
    np.testing.assert_allclose(
        losses.pairwise_distance(torch.from_numpy(a), torch.from_numpy(p)).numpy(),
        np.asarray(jlosses.pairwise_distance(jnp.asarray(a), jnp.asarray(p))), rtol=1e-6)
    assert float(losses.combined_triplet_loss(torch.tensor(1.0), torch.tensor(3.0), 2.0)) == 2.0


@pytest.mark.parametrize("case", ["ties", "weighted", "one_class"])
def test_metrics_match_jax(case):
    rng = np.random.default_rng(1)
    logits = np.round(rng.standard_normal(16), 1).astype(np.float32)  # ties
    y = (rng.random(16) > 0.5).astype(np.float32)
    w = None
    if case == "weighted":
        w = (rng.random(16) > 0.3).astype(np.float32)
    if case == "one_class":
        y[:] = 1.0
    got = metrics.all_binary_metrics(torch.from_numpy(logits), torch.from_numpy(y),
                                     None if w is None else torch.from_numpy(w))
    want = jmetrics.all_binary_metrics(jnp.asarray(logits), jnp.asarray(y),
                                       None if w is None else jnp.asarray(w))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


# ------------------------------------------------------------------ Ranger21
def _oracle_shapes():
    return [(7,), (5, 3), (2, 3, 4, 2), (3, 4, 2)]


@pytest.mark.parametrize("variant,n_epochs", [("ranger21", 3), ("ranger21_xx", 5)])
def test_ranger21_update_by_update_matches_oracle(variant, n_epochs):
    """f64, rtol 1e-9, across warmup, plateau, warmdown, lookahead syncs and
    both PNM parities (the pattern of tests/test_ranger21_oracle.py)."""
    steps_per_epoch = 4
    rng = np.random.default_rng(42)
    params_np = [rng.normal(0, 0.5, s) for s in _oracle_shapes()]
    grads_np = [[rng.normal(0, m, s) for s, m in zip(_oracle_shapes(), (2.0, 1e-3, 0.5, 1e-2))]
                for _ in range(steps_per_epoch * n_epochs)]
    xx = variant == "ranger21_xx"
    oracle = Ranger21Oracle(params_np, lr=1e-3, num_batches_per_epoch=steps_per_epoch,
                            num_epochs=n_epochs, use_warmup=xx, warmdown_active=xx,
                            weight_decay=1e-2, warmdown_start_pct=0.72)
    params = [torch.tensor(p, dtype=torch.float64) for p in params_np]
    opt = make_optimizer(variant, params, 1e-3, steps_per_epoch, n_epochs)
    assert isinstance(opt, Ranger21)
    for t, g_np in enumerate(grads_np):
        for p, g in zip(params, g_np):
            p.grad = torch.tensor(g)
        opt.step()
        oracle.step(g_np)
        for i, (ours, ref) in enumerate(zip(params, oracle.params)):
            np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-9, atol=1e-12,
                                       err_msg=f"{variant}: param {i} at step {t + 1}")


def test_ranger21_direction_stacked_group_treats_each_slice_alone():
    """A stacked (2, 5, 3) tensor in a ``direction_stacked`` group moves as
    the oracle moves its two (5, 3) slices."""
    rng = np.random.default_rng(3)
    slices = [rng.normal(0, 0.5, (5, 3)) for _ in range(2)]
    grads = [[rng.normal(0, 0.3, (5, 3)) for _ in range(2)] for _ in range(7)]
    oracle = Ranger21Oracle(slices, lr=1e-3, num_batches_per_epoch=7, num_epochs=1,
                            use_warmup=True, warmdown_active=True, weight_decay=1e-2)
    p = torch.tensor(np.stack(slices))
    opt = make_optimizer("ranger21_xx", [{"params": [p], "direction_stacked": True}],
                         1e-3, 7, 1)
    for g in grads:
        p.grad = torch.tensor(np.stack(g))
        opt.step()
        oracle.step(g)
    np.testing.assert_allclose(p.numpy(), np.stack(oracle.params), rtol=1e-9, atol=1e-12)


def test_ranger21_matches_jax_optimizer_on_model_params():
    """Five updates of every model parameter (the LSTM's per-direction
    tensors stacked in the port) with the same gradients, f32."""
    _, params, net = both_networks(1)
    rng = np.random.default_rng(5)
    jopt = jax_make_optimizer("ranger21_xx", 1e-2, 4, 5)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jopt.init(jparams)
    opt = make_optimizer("ranger21_xx", net.param_groups(), 1e-2, 4, 5)
    jupdate = jax.jit(jopt.update)
    for _ in range(5):
        jgrads = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 0.05, a.shape).astype(np.float32), params)
        updates, state = jupdate(jax.tree_util.tree_map(jnp.asarray, jgrads), state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        grads = from_jax_params(jgrads)
        for name, p in net.named_parameters():
            p.grad = grads[name].clone()
        opt.step()
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=name)


# ------------------------------------------------------------- the train step
def test_step_loss_aux_and_every_gradient_match_jax():
    jnet, params, net = both_networks(2, **NO_DROPOUT)
    batch = quintuplet_batch(3, weight=[1, 1, 0, 1])

    def jloss(p):
        return jnet.step(p, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(0), train=True)

    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = net.step(tb, torch.Generator().manual_seed(0), train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in net.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("optimizer_type", ["ranger21_xx", "adamw_1cycle"])
def test_three_trainer_steps_match_jax_train_step(tmp_path, optimizer_type):
    """The port's ``Trainer.train_step`` against the JAX trainer's jitted
    ``_build_train_step`` (loss and grads, the optimizer with its warmup or
    schedule, lr_scale): the same params after three steps, to 1e-5."""
    jnet, params, net = both_networks(4, optimizer_type=optimizer_type, **NO_DROPOUT)
    jtr = JaxTrainer(jnet, tmp_path / "chkpt", "m", seed=0, swa=None)
    jtr.init_state()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtr.optimizer.init(jp)
    tr = Trainer(net, seed=0)
    for step in range(3):
        batch = quintuplet_batch(10 + step)
        jp, jstate, jaux = jtr._train_step(
            jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jtr._base_key,
            jnp.int32(step), jnp.float32(1.0))
        aux = tr.train_step(batch)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)
    assert tr.global_step == 3


def test_eval_step_matches_jax_eval_step():
    """``Trainer.eval_step`` against JAX ``step(train=False)``: dropout rates
    at their defaults, which eval turns off."""
    jnet, params, net = both_networks(6)
    batch = quintuplet_batch(7, weight=[1, 0, 1, 1])
    _, jaux = jax.jit(lambda p, b: jnet.step(p, b, jax.random.PRNGKey(0), train=False))(
        jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    aux = Trainer(net, seed=0).eval_step(batch)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_epoch_accumulator_weights_by_batch_size():
    acc = EpochAccumulator()
    acc.add({"loss": torch.tensor(1.0)}, 1)
    acc.add({"loss": torch.tensor([2.0, 4.0])}, [1, 2])
    assert acc.means() == {"loss": (1.0 + 2.0 + 8.0) / 4.0}
    assert EpochAccumulator().means() == {}


# ---------------------------------------------------------- dropout, on
def test_dropout_masks_match_jax_in_distribution():
    """Rate and 1/(1-p) scale of every mask, the five encoder calls' masks
    independent of each other, and the padding row zero — for the port and
    for the JAX package's own mechanism on the same table and ids."""
    p, V, E, G = 0.3, 4000, 8, 5
    table = np.ones((V, E), np.float32)
    ids = np.tile(np.arange(V, dtype=np.int32), (G, 1))  # every row once per call
    gen = torch.Generator().manual_seed(0)
    rows = embedding_dropout(torch.from_numpy(table), torch.from_numpy(ids), p, True, gen,
                             torch.bfloat16, groups=G).float().numpy()
    jrows = np.stack([np.asarray(jax_embedding_dropout(k, jnp.asarray(table), jnp.asarray(i),
                                                       p, True))
                      for k, i in zip(jax.random.split(jax.random.PRNGKey(0), G), ids)])
    sd = np.sqrt(p * (1 - p) / (G * (V - 1)))
    for out in (rows, jrows):
        assert np.all(out[:, 0] == 0)  # the padding id
        kept = out[:, 1:, 0] != 0
        assert abs(1 - kept.mean() - p) < 5 * sd
        np.testing.assert_allclose(out[:, 1:][kept.nonzero()], 1 / (1 - p), rtol=4e-3)
        both = (~kept[0] & ~kept[1]).mean()
        assert abs(both - p * p) < 5 * np.sqrt(p * p * (1 - p * p) / (V - 1))
        assert not np.array_equal(kept[0], kept[1])
    # DropConnect and activation dropout: rate and scale
    w = torch.ones(200, 100)
    for fn in (dropconnect_weight, dropout):
        out = fn(w, p, True, gen)
        assert abs(float((out == 0).float().mean()) - p) < 5 * np.sqrt(p * (1 - p) / w.numel())
        assert torch.allclose(out[out != 0], torch.tensor(1 / (1 - p)))
        assert fn(w, p, False, gen) is w


def test_weight_drop_draws_one_mask_per_call():
    net = intrepppid_network(4, vocab_size=VOCAB, embedding_size=EMBED, device="cpu")
    layers = net.encoder.lstm_weights(True, 5, torch.Generator().manual_seed(1))
    w_hh = layers[0]["w_hh"]
    raw = net.encoder.lstm[0]["w_hh"]
    assert w_hh.shape == (2, 5) + raw.shape[1:]
    dropped = (w_hh[0] == 0)
    assert all(not torch.equal(dropped[0], dropped[g]) for g in range(1, 5))
    assert torch.equal(w_hh[1], raw[1].expand_as(w_hh[1]))  # reverse undropped
    assert torch.allclose(w_hh[0][~dropped], (raw[0] / 0.7).expand_as(w_hh[0])[~dropped])
    assert layers[1]["w_hh"] is net.encoder.lstm[1]["w_hh"]
    assert net.encoder.lstm_weights(False, 5, None)[0]["w_hh"] is raw
