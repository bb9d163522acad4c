"""The port's LSTM stack under autograd (``ops/lstm_stack.py:BiLSTMStack``
on the CPU, i.e. the plain train forward and the plain backward) against
the JAX package's whole-stack custom VJP ``pallas_bilstm_stack``, run in
interpret mode through the packed TPU kernels (kernel table rows 1, train
variant, and 2): ``pick_plan`` is pinned to ``"packed"``, as in
``tests/test_lstm_pallas.py::test_packed_mode_matches_scan``.

The loss is linear in ``y``, ``hn`` and ``cn`` with seeded random
coefficients, so every output's cotangent is a known dense array.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import intrepppid_tpu.ops.lstm_pallas_layer as LPL
from intrepppid_tpu.ops.lstm import _bilstm_pallas, init_lstm_params
from intrepppid_tpu_torch.ops.lstm import bidir_layer, bidir_layer_bwd, bilstm
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def port_layers(layers):
    return [
        {k: torch.stack([torch.from_numpy(np.array(lp[d][k])) for d in ("fwd", "bwd")])
         .requires_grad_() for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
        for lp in layers
    ]


def run_both(monkeypatch, dtype, G, seed):
    monkeypatch.setattr(
        LPL, "pick_plan",
        lambda B, T, H, G, cd=jnp.float32, E=0, **kw: (B, 1, T, "packed"),
    )
    jdt, tdt = DTYPES[dtype]
    B, T, H = 8, 12, 8
    rng = np.random.default_rng(seed)
    layers = init_lstm_params(jax.random.PRNGKey(seed), H, H, 2)
    layers = jax.tree_util.tree_map(np.asarray, layers)
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
        return (jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(hn * ch) + jnp.sum(cn * cc))

    jl, (jg_layers, jg_x) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, layers), jnp.asarray(x))

    tl = port_layers(layers)
    tx = torch.from_numpy(x).requires_grad_()
    y, hn, cn = bilstm(tl, tx, torch.from_numpy(lengths), tdt)
    loss = ((y.float() * torch.from_numpy(cy)).sum() + (hn * torch.from_numpy(ch)).sum()
            + (cn * torch.from_numpy(cc)).sum())
    params = [t for lp in tl for t in lp.values()]
    grads = torch.autograd.grad(loss, [tx] + params)
    want = [np.asarray(jg_x)] + [
        np.stack([np.asarray(jg_layers[l][d][k]) for d in ("fwd", "bwd")])
        for l in range(2) for k in ("w_ih", "w_hh", "b_ih", "b_hh")
    ]
    return float(loss.detach()), float(jl), [g.numpy() for g in grads], want


@pytest.mark.parametrize("G", [1, 2])
def test_stack_value_and_grad_match_packed_pallas_f32(monkeypatch, G):
    got_l, want_l, got, want = run_both(monkeypatch, "float32", G, seed=3 + G)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)


def test_stack_value_and_grad_match_packed_pallas_bf16(monkeypatch):
    """bf16 streams (hs, cs, dgc, dx) round at the same points in both, but
    the f32 sums that feed them run in another order, so a stream value may
    land one bf16 ulp (2^-8 relative) apart. Such a flip is diluted by the
    sums that form the loss and each gradient: the loss agrees to 1e-4
    relative and every gradient to 2e-3 of its largest magnitude (half a
    bf16 ulp at unit scale); at this seed the gaps are ~1e-7."""
    got_l, want_l, got, want = run_both(monkeypatch, "bfloat16", 2, seed=11)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    for g, w in zip(got, want):
        assert float(np.abs(g - w).max()) <= 2e-3 * max(1.0, float(np.abs(w).max()))


def test_layer_bwd_matches_autograd_through_plain_forward():
    """``bidir_layer_bwd`` (the plain twin of the sweep + wgrad kernels)
    against torch autograd through ``bidir_layer``: grouped weights, two
    input parts and two unsummed dy streams per direction, f32."""
    gen = torch.Generator().manual_seed(0)
    T, B, H, G = 9, 6, 4, 3
    parts = [torch.randn(T, B, H, generator=gen).requires_grad_() for _ in range(2)]
    w_ih = (torch.randn(2, 4 * H, 2 * H, generator=gen) * 0.5).requires_grad_()
    w_hh = (torch.randn(2, G, 4 * H, H, generator=gen) * 0.5).requires_grad_()
    bias = torch.randn(2, 4 * H, generator=gen).requires_grad_()
    lengths = torch.tensor([0, 1, T, 3, 5, T], dtype=torch.int32)
    hs_f, hs_b, hn, cn, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias,
                                                 torch.float32, with_states=True)
    dyf = [torch.randn(T, B, H, generator=gen) for _ in range(2)]
    dyb = [torch.randn(T, B, H, generator=gen) for _ in range(2)]
    dhn, dcn = torch.randn(2, B, H, generator=gen), torch.randn(2, B, H, generator=gen)
    loss = ((hs_f * (dyf[0] + dyf[1])).sum() + (hs_b * (dyb[0] + dyb[1])).sum()
            + (hn * dhn).sum() + (cn * dcn).sum())
    want = torch.autograd.grad(loss, parts + [w_ih, w_hh, bias])
    with torch.no_grad():
        dxf, dxb, dw_ih, dw_hh, dbias = bidir_layer_bwd(
            parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
            dyf, dyb, dhn, dcn, torch.float32)
    got = [dxf[0] + dxb[0], dxf[1] + dxb[1], dw_ih, dw_hh, dbias]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    # a length-0 row takes no gradient into its input or the weights
    assert torch.all(dxf[0][:, 0] == 0) and torch.all(dxb[1][:, 0] == 0)
