"""Variational dropout in the port (``ops/dropout.py:variational_weight``,
``models/awd_lstm.py:lstm_weights``) and Ranger21's f32 bias corrections
(``optim/ranger21.py``), against the JAX package on the CPU.

Variational dropout draws one row mask of the layer-0 forward ``W_hh`` per
encoder call, at eval too (the reference applies it with
``training=True``). At ``rnn_dropout_rate=0`` the masks are the identity,
so the port must equal JAX in value and gradient on the grouped weights
(G = 2 in ``forward``, 5 in ``step``); at 0.3 the two packages' random
bits differ by construction, so the eval outputs are held to their
distribution over many generators and keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrepppid_tpu.models.awd_lstm import apply_encoder
from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.ops.dropout import variational_weight as jax_variational_weight
from intrepppid_tpu.optim import make_optimizer as jax_make_optimizer
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.ops.dropout import variational_weight
from intrepppid_tpu_torch.optim import make_optimizer
from intrepppid_tpu_torch.serve import ScoringEngine
from intrepppid_tpu_torch.utils.convert import from_jax_params
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

VOCAB, EMBED, T = 38, 16, 24
# the ablation configuration's switches (BASELINE.json configs[2])
ABLATION = dict(vocab_size=VOCAB, embedding_size=EMBED, variational_dropout=True,
                use_projection=True, bi_reduce="mean")
NO_OTHER_DROPOUT = dict(embedding_droprate=0.0, do_rate=0.0)


def networks(p, seed=0, **kw):
    """The JAX network, its params (numpy) and the port's network on the CPU
    with the same weights, variational dropout at rate ``p``."""
    kw = {**ABLATION, **kw}
    jnet = jax_network(4, rnn_dropout_rate=p, num_epochs=5, **kw)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(seed)))
    net = intrepppid_network(4, rnn_dropout_rate=p, num_epochs=5, device="cpu", **kw)
    net.load_state_dict(from_jax_params(params))
    return jnet, params, net


def token_ids(seed, B, T=T):
    """``(B, T)`` ids with rows of length 0, 1, 5 and T."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, VOCAB, (B, T)).astype(np.int32)
    for i, n in enumerate([0, 1, 5, T, *rng.integers(0, T + 1, max(0, B - 4))][:B]):
        a[i, n:] = 0
    return a


def quintuplet(seed, B=4):
    batch = {k: token_ids(seed + i, B) for i, k in enumerate(
        ("p1", "p2", "anchor", "positive", "negative"))}
    batch["label"] = np.array([1, 0, 1, 0][:B], np.int32)
    return batch


# -------------------------------------------------------- variational_weight
def test_variational_weight_drops_whole_rows():
    """Each row is kept whole, scaled by 1/(1-p), or zero; the identity at
    p = 0; not gated on training (there is no ``train`` argument)."""
    w = torch.randn(64, 16, generator=torch.Generator().manual_seed(0)) + 3.0
    out = variational_weight(w, 0.3, torch.Generator().manual_seed(1))
    kept = (out != 0).all(dim=1)
    dropped = (out == 0).all(dim=1)
    assert torch.all(kept | dropped) and kept.any() and dropped.any()
    torch.testing.assert_close(out[kept], w[kept] / 0.7, rtol=0, atol=0)
    assert variational_weight(w, 0.0, torch.Generator()) is w


def test_variational_keep_rate_matches_jax():
    """The keep rate over 4000 masks of 50 rows (200,000 draws each, binomial
    standard error 0.001): both packages within 0.005 of 1 - p = 0.7, and
    within 0.006 of each other."""
    n, rows, p = 4000, 50, 0.3
    w = np.ones((rows, 3), np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jax_masks = np.asarray(jax.vmap(lambda k: jax_variational_weight(k, jnp.asarray(w), p))(keys))
    gen = torch.Generator().manual_seed(0)
    port_masks = torch.stack([variational_weight(torch.from_numpy(w), p, gen)
                              for _ in range(n)]).numpy()
    for masks in (jax_masks, port_masks):
        # whole rows, each kept one scaled by 1 / (1 - p)
        assert np.all((masks == 0).all(-1) | np.isclose(masks, 1 / (1 - p)).all(-1))
    jax_rate, port_rate = (float((m[..., 0] != 0).mean()) for m in (jax_masks, port_masks))
    assert abs(jax_rate - 0.7) < 0.005 and abs(port_rate - 0.7) < 0.005
    assert abs(jax_rate - port_rate) < 0.006


# ------------------------------------------------------ exact at rate zero
def test_forward_at_rate_zero_matches_jax():
    """``forward`` (G = 2) with variational dropout on at p = 0: grouped
    weights on both sides, equal to JAX's, at eval with a generator."""
    jnet, params, net = networks(0.0, seed=1)
    x1, x2 = token_ids(3, 5), token_ids(4, 5)
    want = np.asarray(jax.jit(jnet.forward)(params, jnp.asarray(x1), jnp.asarray(x2)))
    with torch.no_grad():
        got = net(torch.from_numpy(x1), torch.from_numpy(x2),
                  gen=torch.Generator().manual_seed(0)).numpy()
    assert got.shape == want.shape == (5, 1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("train", [True, False])
def test_step_at_rate_zero_matches_jax_with_gradients(train):
    """``step`` (G = 5) with variational dropout on at p = 0, the other
    dropouts off: the loss, its aux and (in training) every gradient equal
    JAX's; the reverse direction's gradient sums over the five calls."""
    jnet, params, net = networks(0.0, seed=2, **NO_OTHER_DROPOUT)
    batch = quintuplet(5)

    def jloss(p):
        return jnet.step(p, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(0), train=train)

    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.set_grad_enabled(train):
        loss, aux = net.step(tb, torch.Generator().manual_seed(0), train=train)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=2e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, atol=2e-5, err_msg=k)
    if not train:
        return
    loss.backward()
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in net.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


# ------------------------------------------------ in distribution at 0.3
def test_eval_encoder_at_rate_03_matches_jax_in_distribution():
    """The eval encoder (G = 2, no training) at p = 0.3 over 200 generators
    and 200 JAX keys: each of the 16 x 16 outputs' mean and spread over the
    draws. Measured: mean |z| 0.77 (z the difference of the means over its
    standard error), the median ratio of the spreads 1.007. A wrong rate
    shows in the spread: the port at p = 0.25 gives a median ratio of 0.89,
    at 0.5 1.54; the bands are mean |z| < 1.2 and a median ratio in
    [0.93, 1.07]."""
    K, B = 200, 8
    ids = np.concatenate([token_ids(6, B), token_ids(7, B)])
    jnet, params, net = networks(0.3)
    encode = jax.jit(lambda k: apply_encoder(params["encoder"], jnet.cfg.encoder,
                                             jnp.asarray(ids), k, False, groups=2))
    want = np.stack([np.asarray(encode(jax.random.PRNGKey(s))) for s in range(K)])
    with torch.no_grad():
        got = np.stack([net.encoder(torch.from_numpy(ids), groups=2,
                                    gen=torch.Generator().manual_seed(s)).numpy()
                        for s in range(K)])
    want, got = want.astype(np.float64), got.astype(np.float64)
    assert want.std(0).min() > 0 and got.std(0).min() > 0  # the masks act at eval
    z = (got.mean(0) - want.mean(0)) / np.sqrt(got.var(0) / K + want.var(0) / K)
    ratio = np.median(got.std(0) / want.std(0))
    assert np.abs(z).mean() < 1.2, np.abs(z).mean()
    assert 0.93 <= ratio <= 1.07, ratio


# ------------------------------------------------------------- generators
def test_eval_needs_a_generator_and_is_deterministic_with_one():
    """At eval the masks come from the caller's generator: the same seed
    gives the same scores, another seed others, none raises; the scorers'
    ``eval_generator`` is seeded 0 and absent without variational dropout."""
    _, _, net = networks(0.3)
    x1, x2 = (torch.from_numpy(token_ids(s, 6)) for s in (8, 9))
    with torch.no_grad():
        a = net(x1, x2, gen=torch.Generator().manual_seed(0))
        b = net(x1, x2, gen=torch.Generator().manual_seed(0))
        c = net(x1, x2, gen=torch.Generator().manual_seed(1))
        d = net(x1, x2, gen=net.eval_generator())
        with pytest.raises(ValueError, match="generator"):
            net(x1, x2)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(a, d)
    plain = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED, device="cpu")
    assert plain.eval_generator() is None


def test_engine_scores_alike_on_every_call():
    """A variational network behind the scoring engine: the same request
    scored twice gives bit-equal probabilities (a fresh generator seeded 0
    on every dispatch), and the row masks act (they differ from the scores
    without variational dropout)."""
    from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
    from pathlib import Path

    spm = SentencePieceTokenizer(Path(__file__).parent / "fixtures" / "tiny_spm.model")
    rng = np.random.default_rng(0)
    pairs = [("".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), int(rng.integers(5, 60)))),
              "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), int(rng.integers(5, 60)))))
             for _ in range(7)]
    _, params, net = networks(0.5)
    engine = ScoringEngine(net, None, spm, trunc_len=64, batch_size=4, bulk_batch_size=8)
    first, second = engine.score_pairs(pairs), engine.score_pairs(pairs)
    np.testing.assert_array_equal(first, second)
    plain = intrepppid_network(0, device="cpu", **{**ABLATION, "variational_dropout": False})
    plain.load_state_dict(from_jax_params(params))
    without = ScoringEngine(plain, None, spm, trunc_len=64, batch_size=4,
                            bulk_batch_size=8).score_pairs(pairs)
    assert not np.array_equal(first, without)


# ------------------------------------------------------------ Ranger21 (C9)
def test_ranger21_twelve_steps_match_jax_within_1e6():
    """Twelve ``ranger21_xx`` updates of every model parameter with the same
    seeded gradients: the weights within 1e-6 of JAX's. The bias
    corrections ``1 - beta ** step`` in f32, as JAX computes them from an
    f32 step count (``1 - 0.999`` is 0.00099998713 there): computed in f64
    the weights drift 4.1e-6 apart here, in f32 2.4e-7."""
    jnet = jax_network(4, vocab_size=VOCAB, embedding_size=EMBED, num_epochs=3)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(1)))
    net = intrepppid_network(4, vocab_size=VOCAB, embedding_size=EMBED, num_epochs=3,
                             device="cpu")
    net.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(5)
    jopt = jax_make_optimizer("ranger21_xx", 1e-2, 4, 3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jopt.init(jparams)
    opt = make_optimizer("ranger21_xx", net.param_groups(), 1e-2, 4, 3)
    jupdate = jax.jit(jopt.update)
    for _ in range(12):
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
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
