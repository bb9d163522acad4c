"""Every layer width the JAX package's Pallas kernels take has a route of
hand kernels in the port (``ops/lstm_cuda.py:padded_width``,
``padded_parts`` and ``layer_route``), and the zero-padded route is the
unpadded layer.

* the grid: each layer shape at 1 <= H <= 288 for which
  ``intrepppid_tpu/ops/lstm_pallas_layer.py:pick_plan`` returns a plan, at
  the train step's shapes (400 rows; layer 0 at E = H in 5 weight groups,
  a stacked layer at E = 2H) and the serve dispatch's (800 rows, 1 group),
  T = 1500, f32 and bf16, names a hand kernel (a ``csrc/*.cu`` source) for
  each of the route's steps at its padded widths (H and each input part);
  the recurrence op takes every such H, on the CPU any H, and on the card
  every H up to 1024;
* the padded layer (units, input columns or both), run through the plain
  twins on the CPU as on the card, against the unpadded plain layer
  (values and gradients; ragged lengths, grouped ``w_hh``): 1e-6 x max(1,
  max|ref|) in f32 (the same sums, in another blocking) and 2^-8 x max(1,
  max|ref|) in bf16 (one bf16 rounding of a stream value);
* two-layer models at embedding 48, 50, 80, 100, 112 and 272 against the
  JAX package (``utils/convert.py:from_jax_params``, dropout off): the
  forward and one train step's gradients, to the tolerance of the port's
  other step tests (rtol 1e-4, atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.ops.lstm_pallas_layer import pick_plan
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.ops import lstm_cuda
from intrepppid_tpu_torch.ops.lstm import bidir_layer, bidir_layer_bwd
from intrepppid_tpu_torch.ops.lstm_recurrence import (
    fused_lstm_recurrence,
    recurrence_bwd,
    recurrence_fwd,
)
from intrepppid_tpu_torch.utils.convert import from_jax_params
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}
# (rows, weight groups, input parts) of each layer shape of the grid
SHAPES = {"train layer 0": (400, 5, lambda H: [H]),
          "train stacked": (400, 1, lambda H: [H, H]),
          "serve layer 0": (800, 1, lambda H: [H]),
          "serve stacked": (800, 1, lambda H: [H, H])}


def jax_takes(B, G, E_parts, H, dtype):
    """Whether JAX's ``pick_plan`` gives the layer a Pallas plan (a stack
    threads 1 or 2 dy streams into a layer's backward)."""
    return any(pick_plan(B, 1500, H, G, DTYPES[dtype], E=sum(E_parts), nyparts=ny) is not None
               for ny in (1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_width_jax_takes_names_hand_kernels(dtype):
    """Every H from 1 to 288 at the four shapes: where JAX has a Pallas
    plan, the port has a route at a padded shape (Hp >= H, each part at
    least its width, Hp within the wide kernels' 288), the route takes
    that shape as it is, and each of its steps names a hand kernel."""
    hand = set(lstm_cuda._SIGNATURES)
    taken = 0
    for H in range(1, 289):
        for what, (B, G, parts) in SHAPES.items():
            E_parts = parts(H)
            if not jax_takes(B, G, E_parts, H, dtype):
                continue
            taken += 1
            Hp = lstm_cuda.padded_width(E_parts, H, dtype)
            Ep = lstm_cuda.padded_parts(E_parts, H, dtype)
            route = lstm_cuda.layer_route(E_parts, H, dtype)
            assert lstm_cuda.padded_width(Ep, Hp, dtype) == Hp, (what, H, Hp, Ep)
            assert lstm_cuda.padded_parts(Ep, Hp, dtype) == Ep, (what, H, Hp, Ep)
            assert route == lstm_cuda.layer_route(Ep, Hp, dtype)
            assert H <= Hp <= 288 and (Hp == H or Hp % 16 == 0), (what, H, Hp)
            assert all(ep == e or (ep > e and ep % 8 == 0) for e, ep in zip(E_parts, Ep))
            if route == "resident":
                kernels = [lstm_cuda.fwd_kernel(Ep, Hp, dtype),
                           lstm_cuda.sweep_kernel(Ep, Hp, dtype)]
            else:
                kernels = [lstm_cuda.gates_kernel(Ep, Hp, dtype),
                           lstm_cuda.wide_fwd_kernel(Hp, dtype),
                           lstm_cuda.lite_kernel(Hp, dtype)]
            kernels.append(lstm_cuda.wgrad_kernel(Ep, Hp, dtype))
            assert set(kernels) <= hand, (what, H, kernels)
    # JAX has a Pallas plan for every shape of the grid up to H = 242 in f32
    # and 286 in bf16 (its scan past them)
    assert taken == (242 if dtype == torch.float32 else 286) * len(SHAPES)


@pytest.mark.parametrize("E_parts,H,dtype,Hp,route", [
    ([80], 80, torch.float32, 80, "resident"),     # the one-stage f32 sweep
    ([80, 80], 80, torch.float32, 96, "wide"),
    ([80, 80], 80, torch.bfloat16, 96, "wide"),
    ([48, 48], 48, torch.float32, 48, "resident"),  # the f32 tensor-core sweep takes E = 96
    ([48, 48], 48, torch.bfloat16, 48, "resident"),  # parts at 56: fewer products than H = 64
    ([112], 112, torch.float32, 128, "wide"),
    ([112, 112], 112, torch.bfloat16, 128, "wide"),
    ([240], 240, torch.bfloat16, 256, "wide"),
    ([64], 64, torch.bfloat16, 64, "resident"),
    ([256, 256], 256, torch.float32, 256, "wide"),
])
def test_padded_width_and_route(E_parts, H, dtype, Hp, route):
    assert lstm_cuda.padded_width(E_parts, H, dtype) == Hp
    assert lstm_cuda.layer_route(E_parts, H, dtype) == route
    if (E_parts, H, dtype) == ([48, 48], 48, torch.bfloat16):
        assert lstm_cuda.padded_parts(E_parts, H, dtype) == (56, 56)
    if (E_parts, H, dtype) == ([80], 80, torch.float32):
        assert lstm_cuda.sweep_kernel(E_parts, H, dtype) == "bilstm_bwd_f32_onestage"
    if (E_parts, H, dtype) == ([48, 48], 48, torch.float32):
        assert lstm_cuda.sweep_kernel(E_parts, H, dtype) == "bilstm_bwd_f32"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recurrence_op_takes_every_width_to_256(dtype):
    """The op's widths (past 256 since the 288-thread and global-weight
    instances): on the card every H up to 1024 runs at the next multiple
    of 32 on hand kernels, and past 1024 the card's check raises, naming
    the limit; the CPU's plain twins take any H, unpadded past 1024."""
    hand = set(lstm_cuda._SIGNATURES)
    for H in list(range(1, 300)) + list(range(300, 1025, 29)) + [1024]:
        Hp = lstm_cuda.recurrence_width(H, dtype)
        assert Hp == max(32, -(-H // 32) * 32)
        assert {lstm_cuda.recurrence_sweep_kernel(Hp, dtype),
                lstm_cuda.recurrence_wgrad_kernel(Hp, dtype), "lstm_recurrence_fwd"} <= hand
    for H in (1025, 1040, 4096):
        with pytest.raises(ValueError, match="H <= 1024 on the card"):
            lstm_cuda.recurrence_width(H, dtype)
        assert lstm_cuda.recurrence_width(H, dtype, on_card=False) == H
    with pytest.raises(ValueError, match="H % 32 == 0"):
        lstm_cuda.recurrence_check(1056, dtype)


def test_pad_gate_rows_keeps_each_gate_block_in_place():
    t = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)  # H = 3
    p = lstm_cuda.pad_gate_rows(t, 3, 5, -1)
    assert p.shape == (2, 20)
    for q in range(4):
        assert torch.equal(p[:, 5 * q:5 * q + 3], t[:, 3 * q:3 * q + 3])
        assert torch.all(p[:, 5 * q + 3:5 * q + 5] == 0)
    assert torch.equal(lstm_cuda.unpad_gate_rows(p, 3, 5, -1), t)


def layer_case(E_parts, H, G, dtype, seed, T=9, B=8):
    rng = np.random.default_rng(seed)

    def u(*shape, scale=1.0):
        return torch.from_numpy((rng.random(shape, dtype=np.float32) * 2 - 1) * scale)

    parts = tuple(u(T, B, e).to(dtype) for e in E_parts)
    w_ih = u(2, 4 * H, sum(E_parts), scale=H ** -0.5).to(dtype)
    w_hh = u(2, G, 4 * H, H, scale=H ** -0.5).to(dtype)
    bias = u(2, 4 * H)
    lengths = torch.tensor([T, 0, 3, 1, T, 5, 7, 2][:B], dtype=torch.int32)
    ny = 2 if len(E_parts) == 1 else 1
    dy = [u(T, B, H).to(dtype) for _ in range(2 * ny)]
    return parts, lengths, w_ih, w_hh, bias, tuple(dy[:ny]), tuple(dy[ny:]), u(2, B, H), \
        u(2, B, H)


def assert_within(got, want, tol, what):
    for n, (a, b) in enumerate(zip(got, want)):
        a, b = a.detach().float(), b.detach().float()
        assert a.shape == b.shape, (what, n)
        err = float((a - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), (what, n, err)


@pytest.mark.parametrize("E_parts,H,G", [([80, 80], 80, 1), ([112], 112, 2), ([112, 112], 112, 1),
                                         ([10], 10, 2), ([50], 50, 4), ([100], 100, 2),
                                         ([100, 100], 100, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_layer_equals_unpadded_plain_layer(E_parts, H, G, dtype):
    """``layer_fwd`` and ``layer_bwd`` on the CPU run the plain twins at
    the padded shape (units; and at embedding 10, 50 and 100 input columns
    too, ``padded_parts``); their results equal the plain layer at H."""
    assert lstm_cuda.padded_width(E_parts, H, dtype) > H
    if H in (10, 50, 100):
        assert lstm_cuda.padded_parts(E_parts, H, dtype) != tuple(E_parts)
    parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = layer_case(E_parts, H, G, dtype, H)
    got = lstm_cuda.layer_fwd(parts, lengths, w_ih, w_hh, bias, dtype, with_states=True)
    want = bidir_layer(parts, lengths, w_ih, w_hh, bias, dtype, with_states=True)
    assert_within(got, want, TOL[dtype], "forward")
    assert_within(lstm_cuda.layer_fwd(parts, lengths, w_ih, w_hh, bias, dtype), want[:4],
                  TOL[dtype], "eval forward")
    hs_f, hs_b, _, _, cs_f, cs_b = want
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, dtype)
    got = lstm_cuda.layer_bwd(*args)
    want = bidir_layer_bwd(*args)
    assert_within(list(got[0]) + list(got[1]) + list(got[2:]),
                  list(want[0]) + list(want[1]) + list(want[2:]), TOL[dtype], "backward")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_recurrence_op_equals_unpadded_plain_op(dtype):
    """``fused_lstm_recurrence`` at H = 80 runs at 96 (zero units in every
    gate block of ``xg`` and ``w``); its outputs and the gradients of ``xg``
    and ``w`` equal the plain op's at 80."""
    T, D, B, G, H = 7, 2, 6, 2, 80
    assert lstm_cuda.recurrence_width(H, dtype) == 96
    rng = np.random.default_rng(1)

    def u(*shape, scale=1.0):
        return torch.from_numpy((rng.random(shape, dtype=np.float32) * 2 - 1) * scale)

    xg = u(T, D, B, 4 * H)
    w = u(D, G, H, 4 * H, scale=H ** -0.5).to(dtype)
    valid = torch.from_numpy(rng.random((T, D, B)) > 0.3)
    dhs, dhn, dcn = u(T, D, B, H), u(D, B, H), u(D, B, H)
    xg_r, w_r = xg.clone().requires_grad_(), w.clone().requires_grad_()
    hs, hn, cn = fused_lstm_recurrence(xg_r, valid, w_r, G, dtype)
    torch.autograd.backward((hs, hn, cn), (dhs, dhn, dcn))
    want_hs, want_cs, want_hn, want_cn = recurrence_fwd(xg, valid, w, G, dtype)
    assert_within((hs, hn, cn), (want_hs, want_hn, want_cn), TOL[dtype], "forward")
    dxg, dw = recurrence_bwd(xg, valid, w, want_hs, want_cs, dhs, dhn, dcn, G, dtype)
    assert_within((xg_r.grad, w_r.grad), (dxg, dw), TOL[dtype], "backward")


@pytest.mark.parametrize("embedding", [48, 50, 80, 100, 112, 272])
def test_two_layer_model_matches_jax(embedding):
    """A two-layer model (the factory's default) at embedding 48, 50, 80,
    100, 112 and 272, f32, dropout off: the eval step's loss and aux values (the eval
    forward) and one train step's loss, aux values and every gradient
    against JAX ``step(train=True)`` (with every dropout rate 0 its forward
    is the eval forward)."""
    vocab, pairs, T = 30, 2, 8
    kw = dict(vocab_size=vocab, embedding_size=embedding, num_epochs=5,
              rnn_dropout_rate=0.0, embedding_droprate=0.0, do_rate=0.0)
    jnet = jax_network(4, **kw)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(embedding)))
    net = intrepppid_network(4, device="cpu", **kw)
    net.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(embedding)

    def ids():
        a = rng.integers(1, vocab, (pairs, T)).astype(np.int32)
        for i, n in enumerate([T, 3]):
            a[i, n:] = 0
        return a

    batch = {k: ids() for k in ("p1", "p2", "anchor", "positive", "negative")}
    batch["label"] = np.array([1, 0], np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnet.step(p, jbatch, jax.random.PRNGKey(0), train=True), has_aux=True))(jp)
    with torch.no_grad():
        _, eval_aux = net.step(tb, torch.Generator().manual_seed(0), train=False)
    loss, aux = net.step(tb, torch.Generator().manual_seed(0), train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(eval_aux[k]), float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sum(n.startswith("encoder.lstm.1.") for n in want) == 4
    for name, p in net.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
