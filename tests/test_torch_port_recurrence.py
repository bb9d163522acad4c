"""The port's time-major recurrence op (``ops/lstm_recurrence.py``) and the
``bilstm`` backend over it against the JAX package, on the CPU, where the
op runs its kernels' plain twins.

* ``fused_lstm_recurrence`` against
  ``intrepppid_tpu.ops.lstm_pallas.fused_lstm_recurrence`` in interpret
  mode (as ``tests/test_lstm_pallas.py`` runs it): the same seeded numpy
  ``xg``, ``valid`` and ``w`` through both, masks built from lengths (a
  prefix for direction 0, a suffix for direction 1) and masks with holes,
  an all-zero and an all-one row; values and gradients of a loss linear
  in ``hs``, ``hn`` and ``cn`` with seeded coefficients.
* ``bilstm(backend="recurrence")`` against JAX ``bilstm(backend="scan")``:
  values and every gradient, 1 and 2 layers, shared and grouped ``w_hh``.
* a model ``step`` under ``DEFAULT_BACKEND = "recurrence"`` against the JAX
  ``step`` under ``lstm.DEFAULT_BACKEND = "scan"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import intrepppid_tpu.ops.lstm as jax_lstm
import intrepppid_tpu_torch.ops.lstm as port_lstm
from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.ops.lstm_pallas import fused_lstm_recurrence as jax_recurrence
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.ops import bilstm, fused_lstm_recurrence
from intrepppid_tpu_torch.utils.convert import from_jax_params
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: both sides sum the same products in f32, in another order. bf16: h,
# h_prev and dgates are rounded to bf16 at the same places on both sides, but
# a value that lands within an f32 ulp of a bf16 tie may round the other way
# (one bf16 ulp, 2^-8 relative, on one operand of a sum of H = 8 products);
# gradients sum T x B such terms.
VALUE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def op_case(seed, T, D, B, H, G, mask):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((T, D, B, 4 * H)).astype(np.float32)
    w = (rng.standard_normal((D, G, H, 4 * H)) * H ** -0.5).astype(np.float32)
    if mask == "lengths":
        lengths = np.array(([0, 1, T] + list(rng.integers(0, T + 1, B)))[:B])
        steps = np.arange(T)
        fwd = steps[:, None] < lengths[None, :]
        rev = (T - 1 - steps)[:, None] < lengths[None, :]
        valid = np.stack([fwd] + [rev] * (D - 1), axis=1)
    else:
        valid = rng.random((T, D, B)) < 0.7
        valid[:, :, 0] = False
        valid[:, :, 1] = True
    coef = [rng.standard_normal(s).astype(np.float32)
            for s in ((T, D, B, H), (D, B, H), (D, B, H))]
    return xg, valid, w, coef


@pytest.mark.parametrize("mask", ["lengths", "holes"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_recurrence_matches_jax(dtype, G, mask):
    T, D, B, H = 8, 2, 8, 8
    jdt, tdt = DTYPES[dtype]
    xg, valid, w, coef = op_case(11 + G, T, D, B, H, G, mask)

    def jloss(xg, w):
        out = jax_recurrence(xg, jnp.asarray(valid), w, G, jdt)
        return sum(jnp.sum(o * c) for o, c in zip(out, coef)), out

    (_, jout), (jdxg, jdw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(xg), jnp.asarray(w).astype(jdt))

    txg = torch.from_numpy(xg).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    out = fused_lstm_recurrence(txg, torch.from_numpy(valid), tw, G, tdt)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, coef)).backward()

    vt, gt = VALUE_TOL[dtype], GRAD_TOL[dtype]
    for name, got, want in zip(("hs", "hn", "cn"), out, jout):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=vt, err_msg=name)
    assert txg.grad.dtype == torch.float32 and tw.grad.dtype == tdt
    np.testing.assert_allclose(txg.grad.numpy(), np.asarray(jdxg), atol=gt, err_msg="dxg")
    jdw = np.asarray(jdw.astype(jnp.float32))
    np.testing.assert_allclose(tw.grad.float().numpy(), jdw,
                               atol=gt * max(1.0, float(np.abs(jdw).max())), err_msg="dw")
    # a masked step takes no gate gradient
    assert torch.all(txg.grad[torch.from_numpy(~valid)] == 0)


@pytest.mark.parametrize("H", [288, 320])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_recurrence_matches_jax_past_256(dtype, H):
    """The op at H = 288 (the kernels' 288-thread instance on the card) and
    320 (padded to 320's global-weight instance there: on the CPU the plain
    twins at the same padded width) against JAX's op, which takes them in
    interpret mode: values and gradients at the tolerances above."""
    T, D, B, G = 3, 2, 2, 1
    jdt, tdt = DTYPES[dtype]
    xg, valid, w, coef = op_case(H, T, D, B, H, G, "holes")

    def jloss(xg, w):
        out = jax_recurrence(xg, jnp.asarray(valid), w, G, jdt)
        return sum(jnp.sum(o * c) for o, c in zip(out, coef)), out

    (_, jout), (jdxg, jdw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(xg), jnp.asarray(w).astype(jdt))
    txg = torch.from_numpy(xg).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    out = fused_lstm_recurrence(txg, torch.from_numpy(valid), tw, G, tdt)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, coef)).backward()
    vt, gt = VALUE_TOL[dtype], GRAD_TOL[dtype]
    for name, got, want in zip(("hs", "hn", "cn"), out, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=vt, err_msg=name)
    np.testing.assert_allclose(txg.grad.numpy(), np.asarray(jdxg), atol=gt, err_msg="dxg")
    jdw = np.asarray(jdw.astype(jnp.float32))
    np.testing.assert_allclose(tw.grad.float().numpy(), jdw,
                               atol=gt * max(1.0, float(np.abs(jdw).max())), err_msg="dw")


def test_fused_recurrence_one_direction_and_three():
    """The twins take any D >= 1 (the JAX op too): D = 1 and D = 3."""
    for D in (1, 3):
        T, B, H, G = 5, 4, 8, 2
        xg, valid, w, coef = op_case(5 + D, T, D, B, H, G, "holes")
        jout = jax_recurrence(jnp.asarray(xg), jnp.asarray(valid), jnp.asarray(w), G, jnp.float32)
        out = fused_lstm_recurrence(torch.from_numpy(xg), torch.from_numpy(valid),
                                    torch.from_numpy(w), G, torch.float32)
        for got, want in zip(out, jout):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_fused_recurrence_rejects_bad_shapes():
    xg, valid, w, _ = op_case(0, 4, 2, 6, 8, 2, "holes")
    t = torch.from_numpy
    with pytest.raises(ValueError, match="weight groups"):
        fused_lstm_recurrence(t(xg[:, :, :5]), t(valid[:, :, :5]), t(w), 2, torch.float32)
    with pytest.raises(ValueError, match=r"\(D, G, H, 4H\)"):
        fused_lstm_recurrence(t(xg), t(valid), t(w[:, :1]), 2, torch.float32)
    with pytest.raises(ValueError, match=r"\(T, D, B\)"):
        fused_lstm_recurrence(t(xg), t(valid[:-1]), t(w), 2, torch.float32)


# ------------------------------------------------------------ the backend
def port_layers(layers):
    return [
        {k: torch.stack([torch.from_numpy(np.array(lp[d][k])) for d in ("fwd", "bwd")])
         .requires_grad_() for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
        for lp in layers
    ]


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrence_backend_matches_jax_scan(dtype, G, n_layers):
    jdt, tdt = DTYPES[dtype]
    B, T, H = 8, 12, 8
    rng = np.random.default_rng(20 + G)
    layers = jax.tree_util.tree_map(
        np.asarray, jax_lstm.init_lstm_params(jax.random.PRNGKey(G), H, H, n_layers))
    if G > 1:  # per-call recurrent weights on layer 0, both directions
        layers[0] = {d: dict(lp, w_hh=np.stack([lp["w_hh"] * (1.0 + 0.1 * g) for g in range(G)]))
                     for d, lp in layers[0].items()}
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    lengths = np.array([0, 1, T, 5, 9, T, 3, 7], np.int32)
    cy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    ch = rng.standard_normal((2 * n_layers, B, H)).astype(np.float32)
    cc = rng.standard_normal((2 * n_layers, B, H)).astype(np.float32)

    def jloss(layers, x):
        y, hn, cn = jax_lstm.bilstm(layers, x, jnp.asarray(lengths), jdt, backend="scan")
        return jnp.sum(y * cy) + jnp.sum(hn * ch) + jnp.sum(cn * cc), (y, hn, cn)

    (_, jout), (jg_layers, jg_x) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, layers), jnp.asarray(x))

    tl = port_layers(layers)
    tx = torch.from_numpy(x).requires_grad_()
    out = bilstm(tl, tx, torch.from_numpy(lengths), tdt, backend="recurrence")
    (sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, (cy, ch, cc)))).backward()

    vt, gt = VALUE_TOL[dtype], GRAD_TOL[dtype]
    for name, got, want in zip(("y", "hn", "cn"), out, jout):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=vt, err_msg=name)

    def check(name, got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, err_msg=name,
                                   atol=gt * max(1.0, float(np.abs(want).max())))

    check("dx", tx.grad, jg_x)
    for l, (lp, jg) in enumerate(zip(tl, jg_layers)):
        for k, p in lp.items():
            check(f"layer {l} {k}", p.grad, np.stack([jg["fwd"][k], jg["bwd"][k]]))
    # the layer backend computes the same function
    ref = bilstm([{k: p.detach() for k, p in lp.items()} for lp in tl], tx.detach(),
                 torch.from_numpy(lengths), tdt, backend="layer")
    for got, want in zip(out, ref):
        assert float((got.detach() - want.float()).abs().max()) <= 2 * vt


def test_backend_names():
    assert port_lstm.DEFAULT_BACKEND == "auto" and port_lstm.resolve_backend("auto") == "layer"
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="backend"):
        bilstm([], x, None, torch.float32, backend="scan")


def test_model_step_on_the_recurrence_backend_matches_jax(monkeypatch):
    """A 2-layer net's train step (f32, dropout 0) with the global backend
    set to the recurrence op, against JAX ``step(train=True)`` on its scan
    backend: the loss, the aux values and every gradient to 1e-5; the eval
    forward too."""
    monkeypatch.setattr(port_lstm, "DEFAULT_BACKEND", "recurrence")
    monkeypatch.setattr(jax_lstm, "DEFAULT_BACKEND", "scan")
    vocab, embed, pairs, T = 30, 16, 4, 12
    kw = dict(vocab_size=vocab, embedding_size=embed, rnn_num_layers=2, num_epochs=5,
              rnn_dropout_rate=0.0, embedding_droprate=0.0, do_rate=0.0)
    jnet = jax_network(4, **kw)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(4)))
    net = intrepppid_network(4, device="cpu", **kw)
    net.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(6)

    def ids():
        a = rng.integers(1, vocab, (pairs, T)).astype(np.int32)
        for i, n in enumerate([T, 0, 5, 9]):
            a[i, n:] = 0
        return a

    batch = {k: ids() for k in ("p1", "p2", "anchor", "positive", "negative")}
    batch["label"] = np.array([1, 0, 1, 0], np.int32)

    def jloss(p):
        return jnet.step(p, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(0), train=True)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    calls = []
    real = port_lstm.bidir_layer_recurrence
    monkeypatch.setattr(port_lstm, "bidir_layer_recurrence",
                        lambda *a: calls.append(1) or real(*a))
    loss, aux = net.step({k: torch.from_numpy(v) for k, v in batch.items()},
                         torch.Generator().manual_seed(0), train=True)
    loss.backward()
    assert len(calls) == 2  # one per layer: the step went through the op
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in net.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    with torch.no_grad():
        logits = net.eval()(torch.from_numpy(batch["p1"]), torch.from_numpy(batch["p2"]))
    jlogits = jnet.forward(jparams, jnp.asarray(batch["p1"]), jnp.asarray(batch["p2"]),
                           train=False)
    np.testing.assert_allclose(logits.numpy().reshape(-1), np.asarray(jlogits).reshape(-1),
                               atol=1e-5)
