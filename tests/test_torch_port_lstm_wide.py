"""The port's two LSTM routes (``ops/lstm_cuda.py:layer_route``) against the
JAX package, on the CPU, where each route runs its kernels' plain twins.

* The wide route (input gates, the recurrence over them, the lite sweep,
  ``input_grads`` and wgrad) against ``_bilstm_pallas`` with ``pick_plan``
  pinned to the lite plan ``(B, 1, T, False)``: the v5 forward (kernel row
  3, train variant) and the lite backward (row 5), in interpret mode, as
  ``tests/test_lstm_pallas.py::test_lite_backward_mode_matches_scan`` runs
  them.
* The resident route against the same function pinned to ``True``: the v5
  forward and the fused backward (rows 3 and 4), at 2H != 128.
* The lite sweep against autograd, and a 3-layer train step on the wide
  route against JAX ``step(train=True)``.

The route is pinned with ``monkeypatch``, as the JAX tests pin
``pick_plan``. The loss of the stack tests is linear in ``y``, ``hn`` and
``cn`` with seeded random coefficients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import intrepppid_tpu.ops.lstm_pallas_layer as LPL
from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.ops.lstm import _bilstm_pallas, init_lstm_params
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.ops import lstm_cuda
from intrepppid_tpu_torch.ops.lstm import (
    bidir_layer_sweep_lite,
    bidir_recurrence,
    bilstm,
    input_gates,
)
from intrepppid_tpu_torch.utils.convert import from_jax_params
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ROUTE_PLAN = {"wide": False, "resident": True}


def pin(monkeypatch, route):
    """The port's route and JAX's matching plan, for every layer."""
    plan = ROUTE_PLAN[route]
    monkeypatch.setattr(LPL, "pick_plan",
                        lambda B, T, H, G, cd=jnp.float32, E=0, **kw: (B, 1, T, plan))
    monkeypatch.setattr(lstm_cuda, "layer_route", lambda E_parts, H, dtype: route)


def port_layers(layers):
    return [
        {k: torch.stack([torch.from_numpy(np.array(lp[d][k])) for d in ("fwd", "bwd")])
         .requires_grad_() for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
        for lp in layers
    ]


def run_both(monkeypatch, route, dtype, G, seed, H=8):
    pin(monkeypatch, route)
    jdt, tdt = DTYPES[dtype]
    B, T = 8, 12
    rng = np.random.default_rng(seed)
    layers = jax.tree_util.tree_map(np.asarray, init_lstm_params(jax.random.PRNGKey(seed), H, H, 2))
    if G > 1:  # per-call recurrent weights on layer 0, both directions
        layers[0] = {d: dict(lp, w_hh=np.stack([lp["w_hh"] * (1.0 + 0.1 * g) for g in range(G)]))
                     for d, lp in layers[0].items()}
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    lengths = np.array([0, 1, T, 5, 9, T, 3, 7], np.int32)
    cy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    ch = rng.standard_normal((4, B, H)).astype(np.float32)
    cc = rng.standard_normal((4, B, H)).astype(np.float32)

    def jloss(layers, x):
        y, hn, cn = _bilstm_pallas(layers, x, jnp.asarray(lengths), jdt)
        return jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(hn * ch) + jnp.sum(cn * cc)

    jl, (jg_layers, jg_x) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, layers), jnp.asarray(x))

    tl = port_layers(layers)
    tx = torch.from_numpy(x).requires_grad_()
    y, hn, cn = bilstm(tl, tx, torch.from_numpy(lengths), tdt)
    loss = ((y.float() * torch.from_numpy(cy)).sum() + (hn * torch.from_numpy(ch)).sum()
            + (cn * torch.from_numpy(cc)).sum())
    grads = torch.autograd.grad(loss, [tx] + [t for lp in tl for t in lp.values()])
    want = [np.asarray(jg_x)] + [
        np.stack([np.asarray(jg_layers[l][d][k]) for d in ("fwd", "bwd")])
        for l in range(2) for k in ("w_ih", "w_hh", "b_ih", "b_hh")
    ]
    return float(loss.detach()), float(jl), [g.numpy() for g in grads], want


@pytest.mark.parametrize("route,G,H", [
    pytest.param("wide", 1, 8, id="wide-1"), pytest.param("wide", 2, 8, id="wide-2"),
    pytest.param("resident", 2, 8, id="resident-2"),
    # the wide route at H = 160, where the f32 lite sweep is bilstm_bwd_lite_f32.cu
    pytest.param("wide", 1, 160, id="wide-1-H160")])
def test_stack_matches_pallas_plan_f32(monkeypatch, route, G, H):
    """f32: the gradients to 2e-5; the loss, a sum of ~2,300 products of
    unit size that partly cancel (at H = 8), to 1e-5 absolute (f32 sums in
    another order)."""
    got_l, want_l, got, want = run_both(monkeypatch, route, "float32", G, seed=5 + G, H=H)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6, atol=1e-5)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)


@pytest.mark.parametrize("route,G,H", [
    pytest.param("wide", 2, 8, id="wide"), pytest.param("resident", 2, 8, id="resident"),
    # the wide route at H = 160, where the bf16 lite sweep is bilstm_bwd_lite_mma.cu
    pytest.param("wide", 1, 160, id="wide-1-H160")])
def test_stack_matches_pallas_plan_bf16(monkeypatch, route, G, H):
    """bf16 streams (hs, cs, the rounded gate cotangents, dx) round at the
    same points in both; but the JAX stack off the packed plan sums an
    upper layer's dx over directions and parts in bf16 (``_stack_bwd``,
    ``_layer_bwd``), where the port threads them unsummed into an f32 sum,
    and f32 sums run in another order. So a stream value may land one bf16
    ulp apart, and a gradient with it. The loss agrees to 1e-3 relative;
    every weight gradient to 2^-8 x max(1, max|ref|) (one bf16 ulp at unit
    scale) and the input gradient, itself a bf16 stream of values up to
    ~1.5, to 2^-7 x max(1, max|ref|). Measured at seeds 11, 13, 17: loss
    gaps up to 9.6e-4 relative, weight gradients up to 2.5e-3, the input
    gradient up to 4.7e-3 (x max(1, max|ref|))."""
    got_l, want_l, got, want = run_both(monkeypatch, route, "bfloat16", G, seed=13, H=H)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-3)
    for k, (g, w) in enumerate(zip(got, want)):
        tol = 2.0 ** -7 if k == 0 else 2.0 ** -8
        assert float(np.abs(g - w).max()) <= tol * max(1.0, float(np.abs(w).max()))


def test_lite_sweep_matches_autograd_through_the_recurrence():
    """``bidir_layer_sweep_lite``'s gate cotangents are the gradient of the
    loss with respect to the input gates: grouped weights, two unsummed dy
    streams per direction, final-state cotangents, lengths 0, 1 and T."""
    gen = torch.Generator().manual_seed(0)
    T, B, H, G = 9, 6, 4, 3
    parts = [torch.randn(T, B, H, generator=gen) for _ in range(2)]
    w_ih = torch.randn(2, 4 * H, 2 * H, generator=gen) * 0.5
    w_hh = torch.randn(2, G, 4 * H, H, generator=gen) * 0.5
    bias = torch.randn(2, 4 * H, generator=gen)
    lengths = torch.tensor([0, 1, T, 3, 5, T], dtype=torch.int32)
    xg = input_gates(parts, w_ih, bias, torch.float32).requires_grad_()
    hs_f, hs_b, hn, cn, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, torch.float32,
                                                      with_states=True)
    dyf = [torch.randn(T, B, H, generator=gen) for _ in range(2)]
    dyb = [torch.randn(T, B, H, generator=gen) for _ in range(2)]
    dhn, dcn = torch.randn(2, B, H, generator=gen), torch.randn(2, B, H, generator=gen)
    loss = ((hs_f * (dyf[0] + dyf[1])).sum() + (hs_b * (dyb[0] + dyb[1])).sum()
            + (hn * dhn).sum() + (cn * dcn).sum())
    (want,) = torch.autograd.grad(loss, [xg])
    with torch.no_grad():
        got = bidir_layer_sweep_lite(xg.detach(), lengths, w_hh, hs_f, hs_b, cs_f, cs_b,
                                     dyf, dyb, dhn, dcn, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, T, B, 4 * H)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # a length-0 row and the positions past a row's length take no gradient
    assert torch.all(got[:, :, 0] == 0) and torch.all(got[:, 3:, 3] == 0)


def test_three_layer_step_on_the_wide_route_matches_jax(monkeypatch):
    """A 3-layer net's train step (f32, dropout 0) with every layer on the
    wide route, against JAX ``step(train=True)`` on its lite plan: the
    loss, the aux values and every gradient to 1e-5."""
    pin(monkeypatch, "wide")
    vocab, embed, pairs, T = 30, 16, 4, 12
    kw = dict(vocab_size=vocab, embedding_size=embed, rnn_num_layers=3, num_epochs=5,
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

    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    loss, aux = net.step({k: torch.from_numpy(v) for k, v in batch.items()},
                         torch.Generator().manual_seed(0), train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sum(n.startswith("encoder.lstm.2.") for n in want) == 4
    for name, p in net.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("E_parts,H,route", [
    ([64], 64, "resident"), ([64, 64], 64, "resident"),
    ([256], 256, "wide"), ([256, 256], 256, "wide"),
    ([128, 128], 128, "wide"), ([128], 128, "wide"),
    ([32], 32, "resident"), ([32, 32], 32, "resident"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_by_shape(E_parts, H, route, dtype):
    assert lstm_cuda.layer_route(E_parts, H, dtype) == route


def test_shape_neither_route_takes_raises():
    with pytest.raises(ValueError, match="no bilstm route"):
        lstm_cuda.layer_route([512], 512, torch.float32)
