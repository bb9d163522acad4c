"""The port at the shapes its bf16 tensor-core sweep takes (E = H = 64, two
layers, five weight groups on layer 0: the manuscript train step's LSTM
stack) against the JAX package's whole-stack custom VJP run in interpret
mode through the packed TPU kernels (kernel table rows 1, train variant, and
2), as ``tests/test_torch_port_lstm_train.py`` runs it at H = 8.

On the CPU the port's sweep is the plain twin (``bidir_layer_sweep``) that
``csrc/bilstm_bwd_mma.cu`` is held against on the card, reached through the
same dispatch (``lstm_cuda.sweep_kernel`` names the tensor-core kernel for
these shapes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import intrepppid_tpu.ops.lstm_pallas_layer as LPL
from intrepppid_tpu.ops.lstm import _bilstm_pallas, init_lstm_params
from intrepppid_tpu_torch.ops import lstm_cuda
from intrepppid_tpu_torch.ops.lstm import bilstm
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

B, T, H, G = 10, 16, 64, 5


def test_stack_matches_packed_pallas_at_the_sweep_shapes_bf16(monkeypatch):
    """Values and every gradient in bf16. The streams (hs, cs, dgc, dx)
    round at the same points in both, but the f32 sums that feed them run in
    another order, so a stream value may land one bf16 ulp (2^-8 relative)
    apart; the sums that form the loss and each gradient dilute such a flip:
    the loss agrees to 1e-4 relative and every gradient to 2e-3 of its
    largest magnitude, the tolerance ``test_torch_port_lstm_train.py``
    states."""
    monkeypatch.setattr(
        LPL, "pick_plan",
        lambda B, T, H, G, cd=jnp.float32, E=0, **kw: (B, 1, T, "packed"),
    )
    for E_parts in ([H], [H, H]):
        assert lstm_cuda.sweep_kernel(E_parts, H, torch.bfloat16) == "bilstm_bwd_mma"
        assert lstm_cuda.layer_route(E_parts, H, torch.bfloat16) == "resident"
    seed = 5
    rng = np.random.default_rng(seed)
    layers = jax.tree_util.tree_map(
        np.asarray, init_lstm_params(jax.random.PRNGKey(seed), H, H, 2))
    layers[0] = {d: dict(lp, w_hh=np.stack([lp["w_hh"] * (1.0 + 0.1 * g) for g in range(G)]))
                 for d, lp in layers[0].items()}
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    lengths = np.array([0, 1, T, 5, 9, T, 3, 7, 12, T - 1], np.int32)
    cy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    ch = rng.standard_normal((4, B, H)).astype(np.float32)
    cc = rng.standard_normal((4, B, H)).astype(np.float32)

    def jloss(layers, x):
        y, hn, cn = _bilstm_pallas(layers, x, jnp.asarray(lengths), jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(hn * ch) + jnp.sum(cn * cc)

    want_l, (jg_layers, jg_x) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, layers), jnp.asarray(x))

    tl = [{k: torch.stack([torch.from_numpy(np.array(lp[d][k])) for d in ("fwd", "bwd")])
           .requires_grad_() for k in ("w_ih", "w_hh", "b_ih", "b_hh")} for lp in layers]
    tx = torch.from_numpy(x).requires_grad_()
    y, hn, cn = bilstm(tl, tx, torch.from_numpy(lengths), torch.bfloat16)
    loss = ((y.float() * torch.from_numpy(cy)).sum() + (hn * torch.from_numpy(ch)).sum()
            + (cn * torch.from_numpy(cc)).sum())
    params = [t for lp in tl for t in lp.values()]
    got = torch.autograd.grad(loss, [tx] + params)
    want = [np.asarray(jg_x)] + [
        np.stack([np.asarray(jg_layers[l][d][k]) for d in ("fwd", "bwd")])
        for l in range(2) for k in ("w_ih", "w_hh", "b_ih", "b_hh")
    ]
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-4)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= 2e-3 * max(1.0, float(np.abs(w).max()))
