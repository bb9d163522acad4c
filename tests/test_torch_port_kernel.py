"""The port's LSTM kernel wrappers (``intrepppid_tpu_torch/ops/lstm_cuda.py``:
the eval and train forward, the backward sweep, the weight gradients, the
wide route's input gates, cluster forward and lite sweep, the time-major
recurrence op's forward, sweep and weight gradient, the bf16
tensor-core forwards (the wide one too), sweeps and weight gradients, and
the f32 tensor-core forward, sweeps and weight gradients in three tf32
passes, with the dispatch that picks them), their plain
PyTorch versions (``ops/lstm.py``, ``ops/lstm_recurrence.py``) and the
autograd units (``ops/lstm_stack.py``, ``FusedLSTMRecurrence``), and on the
card the training loop's ``fit`` and resume, without JAX.

On the CPU each wrapper takes its plain version. The tests marked ``cuda``
hold each CUDA kernel against its plain version on the card and skip
without one; this file imports no JAX, so it also runs on a machine that
has none:

    python -m pytest --noconftest tests/test_torch_port_kernel.py -q
"""
import pytest
import torch

from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.ops import lstm_cuda
from intrepppid_tpu_torch.ops.lstm import (
    bidir_layer,
    bidir_layer_bwd,
    bidir_layer_sweep,
    bidir_layer_sweep_lite,
    bidir_layer_wgrad,
    bidir_recurrence,
    input_gates,
)
from intrepppid_tpu_torch.ops.lstm_recurrence import (
    fused_lstm_recurrence,
    recurrence_bwd,
    recurrence_fwd,
    recurrence_sweep,
    recurrence_wgrad,
)
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)


def test_bilstm_masking_semantics():
    """Frozen state past each row's length: the reverse direction stays at
    zero until position length-1 and a length-0 row keeps zero state."""
    torch.manual_seed(0)
    T, B, H = 6, 3, 4
    x = torch.randn(T, B, H)
    w_ih, w_hh = torch.randn(2, 4 * H, H) * 0.5, torch.randn(2, 4 * H, H) * 0.5
    bias = torch.randn(2, 4 * H)
    lengths = torch.tensor([0, 3, T], dtype=torch.int32)
    hs_f, hs_b, hn, cn = bidir_layer((x,), lengths, w_ih, w_hh, bias, torch.float32)
    assert torch.all(hs_f[:, 0] == 0) and torch.all(hs_b[:, 0] == 0)
    assert torch.all(hn[:, 0] == 0) and torch.all(cn[:, 0] == 0)
    # forward output past the length holds the frozen state
    assert torch.equal(hs_f[3:, 1], hs_f[2:3, 1].expand(T - 3, H))
    assert torch.equal(hn[0, 1], hs_f[2, 1])
    # reverse direction is zero past the length, and ends at position 0
    assert torch.all(hs_b[3:, 1] == 0) and torch.any(hs_b[2, 1] != 0)
    assert torch.equal(hn[1, 1], hs_b[0, 1])
    # a row of length T equals an unmasked run of its own
    full = bidir_layer((x[:, 2:].contiguous(),), torch.tensor([T], dtype=torch.int32),
                       w_ih, w_hh, bias, torch.float32)
    assert torch.equal(full[2][:, 0], hn[:, 2])


def test_wrapper_takes_plain_version_on_cpu():
    torch.manual_seed(1)
    T, B, H = 5, 4, 8
    parts = (torch.randn(T, B, H), torch.randn(T, B, H))
    args = (parts, torch.tensor([5, 0, 2, 4], dtype=torch.int32),
            torch.randn(2, 4 * H, 2 * H), torch.randn(2, 4 * H, H), torch.randn(2, 4 * H))
    before = lstm_cuda.bilstm_layer_fwd_f32.launches
    got = lstm_cuda.bilstm_layer_fwd(*args, torch.float32)
    want = bidir_layer(*args, torch.float32)
    assert lstm_cuda.bilstm_layer_fwd_f32.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "E_parts,H,dtype,ok",
    [
        ([64], 64, torch.float32, True),
        ([64, 64], 64, torch.float32, True),   # ~209 KB of f32 weights fits
        ([64, 64], 64, torch.bfloat16, True),
        ([32, 32], 32, torch.float32, True),
        ([96, 96], 96, torch.float32, False),  # weights past shared memory
        ([48], 64, torch.float32, False),      # E does not divide the threads
        ([64], 60, torch.bfloat16, False),     # H not a 16-byte multiple
    ],
)
def test_bwd_launch_plan(E_parts, H, dtype, ok):
    if not ok:
        with pytest.raises(ValueError, match="bilstm_bwd kernel"):
            lstm_cuda.bwd_launch_plan(E_parts, H, dtype)
        return
    threads, rows, smem = lstm_cuda.bwd_launch_plan(E_parts, H, dtype)
    assert threads % H == 0 and threads <= 256 and rows == threads // H * 2
    assert smem <= lstm_cuda.SMEM_LIMIT


def test_group_padding_round_trip():
    """Each weight group is padded to whole row tiles with zero (length-0)
    rows and sliced back, as the wrappers do for the kernels."""
    t = torch.arange(2 * 12 * 3).reshape(2, 12, 3)
    padded = lstm_cuda._group_pad(t, 1, 3, 4)
    assert padded.shape == (2, 24, 3)
    assert torch.equal(padded[:, 4:8], torch.zeros(2, 4, 3, dtype=t.dtype))
    assert torch.equal(padded[:, 8:12], t[:, 4:8])
    assert torch.equal(lstm_cuda._group_unpad(padded, 1, 3, 4), t)
    assert lstm_cuda._tile_pad(400, 5, 16) == 0 and lstm_cuda._tile_pad(60, 5, 8) == 4
    assert lstm_cuda._tile_pad(60, 1, 8) == 0


def layer_case(T, B, E_parts, H, G, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * scale

    parts = tuple(u(T, B, e).to(dtype) for e in E_parts)
    w_ih = u(2, 4 * H, sum(E_parts), scale=H ** -0.5).to(dtype)
    w_hh = u(2, G, 4 * H, H, scale=H ** -0.5).to(dtype)
    bias = u(2, 4 * H)
    lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, T])
    dy = [u(T, B, H).to(dtype) for _ in range(4)]
    return parts, lengths, w_ih, w_hh, bias, dy, u(2, B, H), u(2, B, H)


def _cuda_core_fwd_plan(E_parts, H, dtype):
    """ValueError for a shape the deleted ``csrc/bilstm_fwd.cu`` did not
    take (its ``launch_plan``: 256 threads of H units, 4 rows a thread,
    both weights resident in the compute dtype beside two f32 [x ; h]
    tiles, at most 4 input chunks a thread); the tests that hold a plan
    change against the trees that had it read it here."""
    size = torch.empty((), dtype=dtype).element_size()
    vec, E = 16 // size, sum(E_parts)
    if H % 4 or H > 256 or any(e <= 0 or e % vec for e in E_parts):
        raise ValueError(f"bilstm_fwd.cu took no E_parts={list(E_parts)}, H={H}")
    groups = 256 // H
    rows = 4 * groups
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    smem = a16(E * 4 * H * size) + a16(H * 4 * H * size) + 2 * rows * (E + H) * 4
    if smem > lstm_cuda.SMEM_LIMIT or rows * E // vec > 4 * H * groups:
        raise ValueError(f"bilstm_fwd.cu took no E_parts={list(E_parts)}, H={H}")


def test_train_wrappers_take_plain_versions_on_cpu():
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(
        6, 4, [8, 8], 8, 2, torch.float32, torch.device("cpu"))
    counts = [f.launches for f in (lstm_cuda.bilstm_layer_fwd_train_f32, lstm_cuda.bilstm_bwd,
                                   lstm_cuda.bilstm_wgrad_f32)]
    fwd = lstm_cuda.bilstm_layer_fwd_train(parts, lengths, w_ih, w_hh, bias, torch.float32)
    want = bidir_layer(parts, lengths, w_ih, w_hh, bias, torch.float32, with_states=True)
    assert all(torch.equal(a, b) for a, b in zip(fwd, want))
    hs_f, hs_b, _, _, cs_f, cs_b = fwd
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn,
            torch.float32)
    got = lstm_cuda.bilstm_bwd(*args)
    ref = bidir_layer_sweep(*args)
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1] + got[2:], ref[0] + ref[1] + ref[2:]))
    gw = lstm_cuda.bilstm_wgrad(got[2], parts, hs_f, hs_b, 2)
    rw = bidir_layer_wgrad(got[2], parts, hs_f, hs_b, 2)
    assert all(torch.equal(a, b) for a, b in zip(gw, rw))
    assert [f.launches for f in (lstm_cuda.bilstm_layer_fwd_train_f32, lstm_cuda.bilstm_bwd,
                                 lstm_cuda.bilstm_wgrad_f32)] == counts


def test_wide_wrappers_take_plain_versions_on_cpu():
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(
        6, 4, [32, 32], 32, 2, torch.float32, torch.device("cpu"))
    wrappers = (lstm_cuda.bilstm_gates_f32, lstm_cuda.bilstm_fwd_wide_f32,
                lstm_cuda.bilstm_fwd_wide_train_f32)
    counts = [f.launches for f in wrappers]
    xg = lstm_cuda.bilstm_gates(parts, w_ih, bias, torch.float32)
    assert xg.shape == (2, 6, 4, 128) and xg.dtype == torch.float32
    assert torch.equal(xg, input_gates(parts, w_ih, bias, torch.float32))
    fwd = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, torch.float32)
    want = bidir_layer(parts, lengths, w_ih, w_hh, bias, torch.float32, with_states=True)
    assert all(torch.equal(a, b) for a, b in zip(fwd, want))
    assert all(torch.equal(a, b) for a, b in zip(
        lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, torch.float32), want[:4]))
    hs_f, hs_b, _, _, cs_f, cs_b = fwd
    args = (lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn, torch.float32)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite(xg, *args), bidir_layer_sweep_lite(xg, *args))
    assert [f.launches for f in wrappers] == counts


def test_wide_plan_fills_the_card_in_fewest_waves():
    """The scaled train shape at H = 256 with 16 clusters at once: the
    tensor-core lite sweep's 32-row tiles cover layer 0's five groups of 80
    (15 tiles) and layer 1's 400 rows (13) in two waves, as its 40-row ones
    would, so it takes the smaller; with more room on the card it takes the
    smallest tile of its fewest waves. The kinds of the CUDA-core cluster
    kernels (the layer sweep's, and the recurrence op's forward, whose
    source is gone) are refused."""
    sixteen = lambda R, smem: 16  # noqa: E731
    assert lstm_cuda.wide_plan("lite_mma", 400, 5, 256, sixteen)[:2] == (32, 15)
    assert lstm_cuda.wide_plan("lite_mma", 400, 1, 256, sixteen)[:2] == (32, 13)
    R, tiles, smem = lstm_cuda.wide_plan("lite_mma", 400, 5, 256, sixteen)
    assert smem == lstm_cuda.wide_smem("lite_mma", 256, R) <= lstm_cuda.SMEM_LIMIT
    for kind in ("fwd", "bwd"):
        with pytest.raises(ValueError, match=f"no kernel of kind '{kind}'"):
            lstm_cuda.wide_plan(kind, 400, 5, 256, sixteen)
        with pytest.raises(ValueError, match=f"no kernel of kind '{kind}'"):
            lstm_cuda.wide_smem(kind, 256, 16)
    # more room on the card: the smallest tile that fits one wave
    assert lstm_cuda.wide_plan("lite_mma", 400, 1, 128, lambda R, smem: 64)[0] == 16


@pytest.mark.parametrize("H,E_parts,ok", [(256, [256, 256], True), (128, [128], True),
                                          (32, [32], True), (288, [288], True),
                                          (320, [320], False),
                                          (96, [96], True), (80, [80], False),
                                          (256, [200], False)])
def test_wide_check(H, E_parts, ok):
    if ok:
        lstm_cuda.wide_check(H, E_parts)
    else:
        with pytest.raises(ValueError, match="bilstm wide kernels"):
            lstm_cuda.wide_check(H, E_parts)


def test_kernel_refuses_operands_that_would_lose_their_gradient():
    w = torch.zeros(2, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda._no_graph(torch.zeros(3), w)
    with torch.no_grad():
        lstm_cuda._no_graph(w)
    lstm_cuda._no_graph(w.detach())


def model_grads(device, dtype=torch.float32, embedding_size=16):
    """``loss.backward()`` through a small model's train step: the
    gradient of every LSTM parameter and of the embedding table."""
    net = intrepppid_network(4, vocab_size=30, embedding_size=embedding_size, compute_dtype=dtype,
                             device=device, rnn_dropout_rate=0.0, embedding_droprate=0.0,
                             do_rate=0.0)
    g = torch.Generator().manual_seed(0)
    B, T = 8, 32
    batch = {}
    for k in ("anchor", "positive", "negative", "p1", "p2"):
        ids = torch.randint(1, 30, (B, T), generator=g)
        ids[1:, 20:] = 0
        batch[k] = ids.to(device)
    batch["label"] = torch.tensor([0, 1] * (B // 2), device=device)
    loss, _ = net.step(batch, torch.Generator(device=device).manual_seed(0), train=True)
    loss.backward()
    return {n: p.grad for n, p in net.named_parameters()
            if n.startswith("encoder.lstm.") or n == "encoder.embedding"}


def test_model_backward_reaches_every_lstm_weight():
    """Regression for the lost gradient: LSTM outputs filled through ctypes
    carried no autograd graph, so on the card ``loss.backward()`` trained
    only ``fc`` and the head. The stack now runs as one autograd Function:
    every LSTM parameter and the embedding get a non-zero gradient."""
    grads = model_grads(torch.device("cpu"))
    assert len(grads) == 1 + 2 * 4
    for name, grad in grads.items():
        assert grad is not None and torch.all(torch.isfinite(grad)), name
        assert float(grad.abs().sum()) > 0, name


# ------------------------------------------------ the time-major recurrence
def recurrence_case(T, D, B, H, G, dtype, dev, mask, seed=0):
    """Operands of the recurrence op: ``mask`` "lengths" builds ``valid``
    as the layer does (a prefix for direction 0, a suffix for the others,
    lengths mixing 0, 1, T and random values), "holes" draws it at random
    with an all-zero and an all-one row."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 2 - 1

    xg = u(T, D, B, 4 * H)
    w = (u(D, G, H, 4 * H) * H ** -0.5).to(dtype).contiguous()
    if mask == "lengths":
        lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev)
        lengths[:3] = torch.tensor([0, 1, T], device=dev)
        steps = torch.arange(T, device=dev)
        fwd = steps[:, None] < lengths[None, :]
        rev = (T - 1 - steps)[:, None] < lengths[None, :]
        valid = torch.stack([fwd] + [rev] * (D - 1), dim=1)
    else:
        valid = torch.rand(T, D, B, generator=g, device=dev) < 0.7
        valid[:, :, 0] = False
        valid[:, :, 1] = True
    return xg, valid, w, u(T, D, B, H), u(D, B, H), u(D, B, H)


@pytest.mark.parametrize("mask", ["lengths", "holes"])
def test_recurrence_wrappers_take_plain_versions_on_cpu(mask):
    T, D, B, H, G = 6, 2, 6, 8, 2
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, torch.float32,
                                                  torch.device("cpu"), mask)
    wrappers = (lstm_cuda.lstm_recurrence_fwd, lstm_cuda.lstm_recurrence_bwd,
                lstm_cuda.lstm_recurrence_wgrad)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, torch.float32)
    want = recurrence_fwd(xg, valid, w, G, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    hs, cs = want[:2]
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, torch.float32)
    dxg = lstm_cuda.lstm_recurrence_bwd(*args)
    assert torch.equal(dxg, recurrence_sweep(*args))
    dw = lstm_cuda.lstm_recurrence_wgrad(hs, dxg, G, torch.float32)
    assert torch.equal(dw, recurrence_wgrad(hs, dxg, G, torch.float32))
    ref = recurrence_bwd(*args)
    assert torch.equal(ref[0], dxg) and torch.equal(ref[1], dw)
    assert [f.launches for f in wrappers] == before
    # a frozen step writes the state it found, and its gate cotangent is zero
    off = ~valid
    assert torch.all(dxg[off] == 0)
    assert torch.equal(hs[1:][off[1:]], hs[:-1][off[1:]])
    assert torch.all(hs[0][off[0]] == 0)


@pytest.mark.parametrize("H", [320, 512])
def test_recurrence_wide_mma_wrappers_take_plain_versions_on_cpu(H):
    """The bf16 tensor-core wrappers past 288 take the plain twins for CPU
    tensors, counting no launch; ``lstm_recurrence_fwd`` and
    ``lstm_recurrence_bwd`` hand bf16 past 288 to them only on the card."""
    T, D, B, G, cd = 3, 2, 4, 2, torch.bfloat16
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, torch.device("cpu"),
                                                  "holes")
    wrappers = (lstm_cuda.lstm_recurrence_fwd_wide_mma, lstm_cuda.lstm_recurrence_bwd_wide_mma)
    before = [f.launches for f in wrappers]
    want = recurrence_fwd(xg, valid, w, G, cd)
    assert all(torch.equal(a, b) for a, b in
               zip(lstm_cuda.lstm_recurrence_fwd_wide_mma(xg, valid, w, G, cd), want))
    args = (xg, valid, w, want[0], want[1], dhs, dhn, dcn, G, cd)
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd_wide_mma(*args), recurrence_sweep(*args))
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_fwd_wide_mma(xg, valid, w.clone().requires_grad_(), G, cd)


def recurrence_at_width(Hp, xg, valid, w, G, dtype, dhs, dhn, dcn):
    """The plain forward and backward at Hp units (every gate block of
    ``xg`` and ``w`` grown by zero units, as ``fused_lstm_recurrence`` runs
    a width its kernels do not take), cut back to H: ``(hs, hn, cn, dxg,
    dw)``."""
    H = w.shape[-2]
    xg_p = lstm_cuda.pad_gate_rows(xg, H, Hp, -1)
    w_p = lstm_cuda.pad_units(lstm_cuda.pad_gate_rows(w, H, Hp, -1), H, Hp, -2)

    def pad(t):
        return None if t is None else lstm_cuda.pad_units(t, H, Hp)

    hs, cs, hn, cn = recurrence_fwd(xg_p, valid, w_p, G, dtype)
    dxg, dw = recurrence_bwd(xg_p, valid, w_p, hs, cs, pad(dhs), pad(dhn), pad(dcn), G, dtype)
    return (hs[..., :H], hn[..., :H], cn[..., :H], lstm_cuda.unpad_gate_rows(dxg, H, Hp, -1),
            lstm_cuda.unpad_gate_rows(dw, H, Hp, -1)[..., :H, :])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recurrence_plain_backward_matches_autograd(dtype):
    """``recurrence_bwd`` against autograd through ``recurrence_fwd`` (f32;
    in bf16 autograd rounds the cotangents where the op does not, so only
    the autograd unit's plumbing is held: same values as the plain pair at
    the op's width, ``recurrence_width``: H = 8 runs at 32, padded; that
    pair is the plain pair at H = 8 to 1e-6 in f32 and one bf16 rounding of
    ``dw`` in bf16)."""
    T, D, B, H, G = 7, 3, 4, 8, 2
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, dtype, torch.device("cpu"),
                                                  "holes", seed=3)
    hs, cs, hn, cn = recurrence_fwd(xg, valid, w, G, dtype)
    dxg, dw = recurrence_bwd(xg, valid, w, hs, cs, dhs, dhn, dcn, G, dtype)
    assert dw.dtype == w.dtype and dxg.dtype == torch.float32
    Hp = lstm_cuda.recurrence_width(H, dtype)
    at_hp = recurrence_at_width(Hp, xg, valid, w, G, dtype, dhs, dhn, dcn)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    for a, b in zip(at_hp, (hs, hn, cn, dxg, dw)):
        assert float((a.float() - b.float()).abs().max()) <= tol * max(1.0, float(b.abs().max()))
    xg_g, w_g = xg.clone().requires_grad_(), w.clone().requires_grad_()
    out = fused_lstm_recurrence(xg_g, valid, w_g, G, dtype)
    assert all(torch.equal(a, b) for a, b in zip(out, at_hp[:3]))
    torch.autograd.backward(out, [dhs, dhn, dcn])
    assert torch.equal(xg_g.grad, at_hp[3]) and torch.equal(w_g.grad, at_hp[4])
    if dtype == torch.float32:
        xg_a, w_a = xg.clone().requires_grad_(), w.clone().requires_grad_()
        ref = recurrence_fwd(xg_a, valid, w_a, G, dtype)
        gx, gw = torch.autograd.grad([ref[0], ref[2], ref[3]], [xg_a, w_a], [dhs, dhn, dcn])
        assert float((gx - dxg).abs().max()) <= 1e-5
        assert float((gw - dw).abs().max()) <= 1e-5
    # only hn read: the other cotangents arrive as None
    xg_g.grad = w_g.grad = None
    fused_lstm_recurrence(xg_g, valid, w_g, G, dtype)[1].backward(dhn)
    only = recurrence_at_width(Hp, xg, valid, w, G, dtype, None, dhn, None)[3:]
    assert torch.equal(xg_g.grad, only[0]) and torch.equal(w_g.grad, only[1])


def test_recurrence_wrappers_refuse_operands_that_require_grad():
    """The wrappers' outputs carry no graph on the card, so under grad mode
    they refuse a differentiable operand, on the CPU too: the autograd unit
    ``fused_lstm_recurrence`` is the way in."""
    T, D, B, H, G = 4, 2, 4, 8, 1
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, torch.float32,
                                                  torch.device("cpu"), "holes")
    hs, cs, _, _ = lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, torch.float32)
    dxg = lstm_cuda.lstm_recurrence_bwd(xg, valid, w, hs, cs, dhs, dhn, dcn, G, torch.float32)
    wg = w.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_fwd(xg, valid, wg, G, torch.float32)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_bwd(xg, valid, wg, hs, cs, dhs, dhn, dcn, G, torch.float32)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_wgrad(hs, dxg.requires_grad_(), G, torch.float32)
    with torch.no_grad():
        lstm_cuda.lstm_recurrence_fwd(xg, valid, wg, G, torch.float32)
    assert fused_lstm_recurrence(xg, valid, wg, G, torch.float32)[0].requires_grad


@pytest.mark.parametrize("H,dtype,ok", [(32, torch.float32, True), (64, torch.bfloat16, True),
                                        (256, torch.bfloat16, True), (8, torch.float32, False),
                                        (288, torch.float32, True), (1024, torch.float32, True),
                                        (1056, torch.float32, False), (48, torch.float32, False),
                                        (64, torch.float16, False)])
def test_recurrence_check(H, dtype, ok):
    if ok:
        lstm_cuda.recurrence_check(H, dtype)
    else:
        with pytest.raises(ValueError, match="H % 32 == 0"):
            lstm_cuda.recurrence_check(H, dtype)


# ------------------------------------------------- the tensor-core sweeps
@pytest.mark.parametrize(
    "E_parts,H,dtype,kernel",
    [
        ([64], 64, torch.bfloat16, "bilstm_bwd_mma"),
        ([64, 64], 64, torch.bfloat16, "bilstm_bwd_mma"),
        ([32, 32], 32, torch.bfloat16, "bilstm_bwd_mma"),
        ([32], 32, torch.bfloat16, "bilstm_bwd_mma"),
        ([64], 64, torch.float32, "bilstm_bwd_f32"),   # f32: three tf32 passes
        ([64, 64], 64, torch.float32, "bilstm_bwd_f32"),
        ([32, 32], 32, torch.float32, "bilstm_bwd_f32"),
        ([40], 80, torch.float32, "bilstm_bwd_f32_onestage"),  # H > 64: one stage
        ([32], 64, torch.bfloat16, "bilstm_bwd_mma"),  # (E + H) % 32 == 0
        ([128], 64, torch.bfloat16, "bilstm_bwd_mma"),
        ([80], 80, torch.bfloat16, "bilstm_bwd_mma"),  # its <80, 80> instance
        ([40, 40], 80, torch.bfloat16, "bilstm_bwd_mma"),
        ([40], 80, torch.bfloat16, "bilstm_bwd"),  # E != H past 64: the CUDA cores
        ([72], 72, torch.bfloat16, "bilstm_bwd_mma"),  # H % 16 == 8: its <72, 72> instance
        ([8], 8, torch.bfloat16, "bilstm_bwd_mma"),  # K = 16 run as 32
        ([8, 8], 8, torch.bfloat16, "bilstm_bwd_mma"),
        ([24, 24], 24, torch.bfloat16, "bilstm_bwd_mma"),  # K = 72 run as 96
        ([40], 40, torch.bfloat16, "bilstm_bwd_mma"),
        ([120], 40, torch.bfloat16, "bilstm_bwd_mma"),
        ([56, 56], 56, torch.bfloat16, "bilstm_bwd_mma"),
        # H % 16 == 0 and K = 48 or 24: run to 64 or 32 over zero columns
        # (ids kept from the CUDA-core sweep's cases)
        pytest.param([16, 16], 16, torch.bfloat16, "bilstm_bwd_mma",
                     id="E_parts20-16-dtype20-bilstm_bwd"),
        pytest.param([8], 16, torch.bfloat16, "bilstm_bwd_mma",
                     id="E_parts21-16-dtype21-bilstm_bwd"),
        ([72], 72, torch.float32, "bilstm_bwd"),  # f32 keeps the CUDA cores at 72
        # K = 80: the tensor-core sweep takes it (run as 96); no forward does
        pytest.param([16], 64, torch.bfloat16, "bilstm_bwd_mma", id="E_parts23-64-dtype23-None"),
        ([16], 96, torch.bfloat16, None),   # neither sweep takes H = 96
        ([64], 60, torch.bfloat16, None),
        ([48], 80, torch.bfloat16, None),   # no E but 80 past H = 64; bilstm_bwd.cu neither
    ],
)
def test_sweep_kernel_by_shape_and_dtype(E_parts, H, dtype, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="bilstm_bwd_mma kernel takes bfloat16"):
            lstm_cuda.sweep_kernel(E_parts, H, dtype)
        return
    assert lstm_cuda.sweep_kernel(E_parts, H, dtype) == kernel
    if (H, sum(E_parts)) == (64, 16):
        # no forward takes it, so the layer runs padded: its parts at 64
        with pytest.raises(ValueError, match="bilstm_fwd_mma kernel takes"):
            lstm_cuda.fwd_kernel(E_parts, H, dtype)
        assert (lstm_cuda.padded_width(E_parts, H, dtype),
                lstm_cuda.padded_parts(E_parts, H, dtype)) == (64, (64,))
        return
    assert lstm_cuda.layer_route(E_parts, H, dtype) == "resident"


def test_sweep_kernel_leaves_the_wide_route_alone():
    """H = 256 (and H = 128) fit no resident sweep in either dtype: the
    layer stays on the wide route, whose lite sweep is unchanged."""
    for dtype in (torch.float32, torch.bfloat16):
        assert lstm_cuda.layer_route([256], 256, dtype) == "wide"
        assert lstm_cuda.layer_route([128, 128], 128, dtype) == "wide"
        with pytest.raises(ValueError, match="bilstm_bwd_mma kernel"):
            lstm_cuda.sweep_kernel([256], 256, dtype)


@pytest.mark.parametrize("E_parts,H,ny,threads", [([64], 64, 2, 256), ([64, 64], 64, 1, 384),
                                                  ([32], 32, 2, 128), ([32, 32], 32, 0, 192),
                                                  ([16, 16], 32, 1, 128), ([80], 80, 2, 320),
                                                  ([40, 40], 80, 1, 320), ([72], 72, 2, 288),
                                                  ([8], 8, 2, 32), ([16, 16], 8, 1, 96),
                                                  ([24, 24], 24, 0, 160), ([40], 40, 2, 160),
                                                  ([120], 40, 1, 320), ([56, 56], 56, 2, 352)])
def test_bwd_mma_plan(E_parts, H, ny, threads):
    """One warp per 8 hidden units, one more per 16 dx columns past the
    first H; the block's tile chunks and shared memory within the kernel's
    constants."""
    got, smem = lstm_cuda.bwd_mma_plan(E_parts, H, torch.bfloat16, ny)
    assert got == threads <= lstm_cuda.BWD_MMA_MAX_THREADS
    assert smem <= lstm_cuda.SMEM_LIMIT
    assert smem <= lstm_cuda.bwd_mma_plan(E_parts, H, torch.bfloat16)[1]  # ny = 2 is the most
    assert threads >= 4 * H  # one 16-byte chunk of the dgc tile per thread
    E = sum(E_parts)
    assert 8 * (E + (2 + ny) * H) // 8 <= lstm_cuda.BWD_MMA_MAX_CHUNKS * threads
    # bf16 weights: the manuscript layer 1 holds 4H x (E + H + 8) x 2 bytes resident
    if E_parts == [64, 64]:
        assert 256 * 200 * 2 < smem < 140_000
    with pytest.raises(ValueError, match="bilstm_bwd_mma kernel takes bfloat16"):
        lstm_cuda.bwd_mma_plan(E_parts, H, torch.float32, ny)


def test_bwd_mma_plan_at_80():
    """The tensor-core sweep at E = H = 80 (layer 0 of the two-layer model
    at embedding 80): 10 warps, one per 8 units, whose m16 rows 8-15 carry
    all 80 dx columns; 400 tile chunks a step, under 3 x 320; K = 160 and
    the dh product's 320; shared memory for the resident weights (320
    permuted rows of 160 + 8), two dgates tiles (8 rows of 320 + 8) and
    three stages of the x | h, c_prev and two dy tiles: 138,752 B, one
    block an SM; 8-row tiles make 5 x 10 x 2 = 100 blocks at the train
    step's 400 rows in 5 groups. Past H = 64 it takes E = H = 80 alone (the
    shapes ``bilstm_bwd.cu`` took there), so E = 16, 48 and 112, which its
    formula would fit, keep their padded shapes."""
    threads, smem = lstm_cuda.bwd_mma_plan([80], 80, torch.bfloat16)
    assert threads == 320 and (80 + 4 * 80) <= lstm_cuda.BWD_MMA_MAX_CHUNKS * threads
    assert smem == (320 * 168 * 2 + 2 * 8 * 328 * 2 + 3 * 8 * 2 * (168 + 3 * 88)) == 138752
    assert 2 * (smem + 1024) > 233472  # one block an SM
    assert lstm_cuda.bwd_mma_plan([40, 40], 80, torch.bfloat16) == (320, 138752)
    assert 2 * lstm_cuda.mma_tiles(400, 5) == 100
    assert lstm_cuda.BWD_MMA_MAX_H == 80 and lstm_cuda.MMA_MAX_H == 64
    for E_parts, H in (([48], 80), ([16], 80), ([112], 80), ([96], 96), ([80], 96)):
        with pytest.raises(ValueError, match="bilstm_bwd_mma kernel takes bfloat16"):
            lstm_cuda.bwd_mma_plan(E_parts, H, torch.bfloat16)
    # E = H = 72 (H % 16 == 8) is taken since, by its own instance
    assert lstm_cuda.bwd_mma_plan([72], 72, torch.bfloat16) == (288, 125824)
    # the f32 sweep keeps its cap; the f32 forward has a cap of its own (80)
    with pytest.raises(ValueError, match="bilstm_bwd_f32 kernel takes float32"):
        lstm_cuda.bwd_f32_plan([80], 80, torch.float32)
    assert lstm_cuda.fwd_f32_plan([80], 80, torch.float32) == (320, 225792)
    for dtype in (torch.float32, torch.bfloat16):
        assert lstm_cuda.padded_width([48], 80, dtype) == 80
    assert lstm_cuda.padded_parts([48], 80, torch.bfloat16) == (80,)


def test_bwd_mma_plan_at_h_mod_16_eq_8():
    """At H % 16 == 8 the tensor-core sweep takes the shapes ``bilstm_bwd.cu``
    takes there (so no layer changes its route or padded shape) and runs the
    gate product's K = E + H to the next multiple of 32 over zero columns:
    at E = H = 72 (layer 0 of the two-layer model at embedding 72) 9 warps,
    K = 144 run as 160, shared memory for the resident weights (288
    permuted rows of 160 + 8), two dgates tiles (8 rows of 288 + 8) and
    three stages of the [x ; h] tile (8 rows of 168), c_prev and two dy
    tiles: 125,824 B. The shapes the CUDA-core sweep refuses at these widths
    stay refused (the stacked layer at 72, E = 144, runs wide at 96), and
    f32 keeps its own kernels."""
    bf16 = torch.bfloat16
    assert lstm_cuda.BWD_MMA_ODD_WIDTHS == (8, 24, 40, 56, 72)
    threads, smem = lstm_cuda.bwd_mma_plan([72], 72, bf16)
    assert threads == 288 and 72 + 4 * 72 <= lstm_cuda.BWD_MMA_MAX_CHUNKS * threads
    assert smem == 288 * 168 * 2 + 2 * 8 * 296 * 2 + 3 * 8 * 2 * (168 + 3 * 80) == 125824
    for H in lstm_cuda.BWD_MMA_ODD_WIDTHS:
        for E_parts in ([H], [H, H], [2 * H], [3 * H], [4 * H], [8 * H]):
            try:
                lstm_cuda.bwd_launch_plan(E_parts, H, bf16)
            except ValueError:
                with pytest.raises(ValueError, match="only at the shapes bilstm_bwd.cu takes"):
                    lstm_cuda.bwd_mma_plan(E_parts, H, bf16)
                continue
            threads, smem = lstm_cuda.bwd_mma_plan(E_parts, H, bf16)
            Kp = -(-(sum(E_parts) + H) // 32) * 32
            assert threads >= 4 * H and smem <= lstm_cuda.SMEM_LIMIT
            assert smem == (4 * H * (Kp + 8) * 2 + 2 * 8 * (4 * H + 8) * 2
                            + 3 * 8 * 2 * (Kp + 8 + 3 * (H + 8)))
            assert lstm_cuda.sweep_kernel(E_parts, H, bf16) == "bilstm_bwd_mma"
        with pytest.raises(ValueError, match="bilstm_bwd_mma kernel takes bfloat16"):
            lstm_cuda.bwd_mma_plan([H], H, torch.float32)
    assert lstm_cuda.layer_route([72, 72], 72, bf16) == "wide"
    assert (lstm_cuda.padded_width([72, 72], 72, bf16),
            lstm_cuda.padded_parts([72, 72], 72, bf16)) == (96, (80, 80))
    # H % 16 == 0 at K % 32 != 0: the same zero columns (the next test)
    for E_parts, H in (([16, 16], 16), ([8], 16), ([24], 48)):
        assert lstm_cuda.sweep_kernel(E_parts, H, bf16) == "bilstm_bwd_mma"


@pytest.mark.parametrize("E_parts,H,threads,smem", [
    ([8], 16, 64, 12800), ([16, 16], 16, 96, 18432), ([8, 8], 32, 128, 32000),
    ([24], 48, 192, 59392)])
def test_bwd_mma_plan_at_any_k(E_parts, H, threads, smem):
    """At H in ``BWD_MMA_ANY_K_WIDTHS`` (16-64) the tensor-core sweep takes
    every E whose parts are multiples of 8, K = E + H run to the next
    multiple of 32 over zero columns as at H % 16 == 8: one warp per 8
    units and one per 16 dx columns past the first H; shared memory for the
    resident weights (4H rows of Kp + 8), two dgates tiles (8 rows of 4H +
    8) and three stages of the [x ; h] tile (8 rows of Kp + 8), c_prev and
    the dy tiles (8 rows of H + 8 each). The stacked layer of the bf16
    model at embedding 16 (E = 16 + 16, K = 48) is the main path: 3 warps,
    18,432 B. It still refuses f32, parts that are not multiples of 8, and
    widths outside its lists (H = 96; H = 80 but at E = 80)."""
    bf16 = torch.bfloat16
    assert lstm_cuda.BWD_MMA_ANY_K_WIDTHS == (16, 32, 48, 64)
    E = sum(E_parts)
    Kp = -(-(E + H) // 32) * 32
    assert (E + H) % 32 and Kp > E + H
    assert lstm_cuda.bwd_mma_plan(E_parts, H, bf16) == (threads, smem)
    assert smem == (4 * H * (Kp + 8) * 2 + 2 * 8 * (4 * H + 8) * 2
                    + 3 * 8 * 2 * (Kp + 8 + 3 * (H + 8)))
    assert threads == 32 * (H // 8 + -(-max(0, E // 8 - H // 8) // 2)) >= 4 * H
    assert lstm_cuda.bwd_mma_plan(E_parts, H, bf16, ny=0)[1] == smem - 3 * 8 * 2 * 2 * (H + 8)
    assert lstm_cuda.sweep_kernel(E_parts, H, bf16) == "bilstm_bwd_mma"
    with pytest.raises(ValueError, match="bilstm_bwd_mma kernel takes bfloat16"):
        lstm_cuda.bwd_mma_plan(E_parts, H, torch.float32)
    with pytest.raises(ValueError, match="bilstm_bwd_mma kernel takes bfloat16"):
        lstm_cuda.bwd_mma_plan([E + 4], H, bf16)
    for E_parts, H in (([16], 96), ([40], 80), ([80, 80], 80)):
        with pytest.raises(ValueError, match="bilstm_bwd_mma kernel takes bfloat16"):
            lstm_cuda.bwd_mma_plan(E_parts, H, bf16)
    assert lstm_cuda.sweep_kernel([40], 80, bf16) == "bilstm_bwd"


def test_mma_tiles_are_cut_inside_each_weight_group():
    assert lstm_cuda.mma_tiles(400, 5) == 50 and lstm_cuda.mma_tiles(400, 1) == 50
    assert lstm_cuda.mma_tiles(30, 5) == 5 and lstm_cuda.mma_tiles(50, 1) == 7
    assert lstm_cuda.mma_tiles(27, 3) == 6


def _permuted(j, H):
    """ops-side mirror of ``csrc/bilstm_mma.cuh:permuted_of_gate_row``."""
    q, u = divmod(j, H)
    return 32 * (u // 8) + 8 * q + u % 8


@pytest.mark.parametrize("H", [16, 32, 48, 64])
def test_gate_row_permutation_puts_a_units_gates_in_one_lane(H):
    """The permutation the kernels stage the weights with is a bijection of
    the 4H gate rows; warp w's two m16 tiles (32 permuted rows) hold units
    8w .. 8w+7, and lane group g of the m16n8 accumulator (tile rows g and
    g + 8) finds gates i, f in the first tile and g, o in the second, all of
    unit 8w + g. The header's two functions are read from the source."""
    src = (lstm_cuda._build.CSRC / "bilstm_mma.cuh").read_text()
    assert "return ((u >> 3) << 5) + (q << 3) + (u & 7);" in src
    assert "return ((p & 31) >> 3) * H + ((p >> 5) << 3) + (p & 7);" in src
    perm = [_permuted(j, H) for j in range(4 * H)]
    assert sorted(perm) == list(range(4 * H))
    inverse = {p: j for j, p in enumerate(perm)}
    for p, j in inverse.items():
        assert ((p & 31) >> 3) * H + ((p >> 5) << 3) + (p & 7) == j
    for w in range(H // 8):
        for g in range(8):
            rows = [32 * w + 16 * mt + g + 8 * half for mt in range(2) for half in range(2)]
            assert [inverse[p] for p in rows] == [q * H + 8 * w + g for q in range(4)]
    # 8 consecutive permuted rows are 8 consecutive gate rows: the dgc tile
    # leaves as 16-byte chunks
    for c in range(4 * H // 8):
        assert [inverse[8 * c + r] for r in range(8)] == list(
            range(inverse[8 * c], inverse[8 * c] + 8))


def test_sweep_mma_wrappers_take_plain_versions_on_cpu():
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(
        6, 6, [16, 16], 16, 2, torch.bfloat16, torch.device("cpu"))
    cd = torch.bfloat16
    wrappers = (lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_mma, lstm_cuda.lstm_recurrence_bwd,
                lstm_cuda.lstm_recurrence_bwd_mma)
    before = [f.launches for f in wrappers]
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:1], dy[2:3], dhn, None,
            cd)
    ref = bidir_layer_sweep(*args)
    for got in (lstm_cuda.bilstm_bwd_mma(*args), lstm_cuda.bilstm_bwd(*args),
                lstm_cuda.bilstm_bwd(*args, kernel="bilstm_bwd")):
        assert all(torch.equal(a, b)
                   for a, b in zip(got[0] + got[1] + got[2:], ref[0] + ref[1] + ref[2:]))
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_bwd_mma(parts, lengths, w_ih.clone().requires_grad_(), *args[3:])

    xg, valid, w, dhs, dhn, dcn = recurrence_case(5, 3, 6, 32, 2, cd, torch.device("cpu"), "holes")
    hs, cs, _, _ = recurrence_fwd(xg, valid, w, 2, cd)
    rargs = (xg, valid, w, hs, cs, dhs, None, dcn, 2, cd)
    dxg = recurrence_sweep(*rargs)
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd_mma(*rargs), dxg)
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd(*rargs), dxg)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_bwd_mma(xg, valid, w.clone().requires_grad_(), *rargs[3:])
    assert [f.launches for f in wrappers] == before


@pytest.mark.parametrize("H,dtype,kernel", [
    (64, torch.bfloat16, "lstm_recurrence_bwd_mma"), (32, torch.bfloat16, "lstm_recurrence_bwd_mma"),
    (64, torch.float32, "lstm_recurrence_bwd_f32"), (32, torch.float32, "lstm_recurrence_bwd_f32"),
    # bf16 at 96-288: the tensor-core sweep of those widths (ids kept from
    # the cluster sweep's cases)
    pytest.param(128, torch.bfloat16, "lstm_recurrence_bwd_mid_mma",
                 id="128-dtype4-lstm_recurrence_bwd"),
    pytest.param(256, torch.bfloat16, "lstm_recurrence_bwd_mid_mma",
                 id="256-dtype5-lstm_recurrence_bwd"),
    pytest.param(96, torch.bfloat16, "lstm_recurrence_bwd_mid_mma",
                 id="96-dtype6-lstm_recurrence_bwd"),
    # f32 at 96-288: the tensor-core sweep in three tf32 passes (ids kept from
    # the cluster sweep's cases)
    pytest.param(256, torch.float32, "lstm_recurrence_bwd_mid_f32",
                 id="256-dtype7-lstm_recurrence_bwd"),
    pytest.param(96, torch.float32, "lstm_recurrence_bwd_mid_f32",
                 id="96-dtype8-lstm_recurrence_bwd"),
    pytest.param(128, torch.float32, "lstm_recurrence_bwd_mid_f32",
                 id="128-dtype9-lstm_recurrence_bwd"),
    pytest.param(288, torch.bfloat16, "lstm_recurrence_bwd_mid_mma",
                 id="288-dtype10-lstm_recurrence_bwd"),
    pytest.param(288, torch.float32, "lstm_recurrence_bwd_mid_f32",
                 id="288-dtype11-lstm_recurrence_bwd"),
    (320, torch.bfloat16, "lstm_recurrence_bwd_wide_mma"),
    (512, torch.bfloat16, "lstm_recurrence_bwd_wide_mma"),
    (1024, torch.bfloat16, "lstm_recurrence_bwd_wide_mma"),
    (320, torch.float32, "lstm_recurrence_bwd_wide_f32"),
    (512, torch.float32, "lstm_recurrence_bwd_wide_f32"),
    (1024, torch.float32, "lstm_recurrence_bwd_wide_f32"),
    (48, torch.bfloat16, None), (48, torch.float32, None), (64, torch.float16, None),
    (1056, torch.bfloat16, None)])
def test_recurrence_sweep_kernel_by_width_and_dtype(H, dtype, kernel):
    """bf16 at H = 32 / 64 takes the tensor-core sweep, f32 there its three
    tf32 passes (whose pre-split weights fit one block); past 288 the
    tensor-core sweeps of the wide widths, bf16 and (three tf32 passes)
    f32, up to the op's 1024 on the card; from H = 96 to 288 f32 and bf16
    take the tensor-core sweeps of those widths (f32 in three tf32 passes),
    each with a row tile that fits shared memory at each width; the cluster
    sweep is on no path."""
    if kernel is None:
        with pytest.raises(ValueError, match="lstm_recurrence_bwd_mma takes bfloat16"):
            lstm_cuda.recurrence_sweep_kernel(H, dtype)
        return
    assert lstm_cuda.recurrence_sweep_kernel(H, dtype) == kernel
    if kernel.endswith("_bwd_mma"):
        assert lstm_cuda.recurrence_mma_smem(H) <= lstm_cuda.SMEM_LIMIT // 2  # two blocks an SM
    if kernel == "lstm_recurrence_bwd_f32":
        assert lstm_cuda.recurrence_f32_smem(H) <= lstm_cuda.SMEM_LIMIT
    if kernel.endswith("wide_mma"):
        assert min(lstm_cuda.recurrence_wide_mma_smem("bwd", H, R) for R in
                   lstm_cuda.REC_WIDE_MMA_ROWS["bwd"][1 if H <= 512 else 2]) <= lstm_cuda.SMEM_LIMIT
    if kernel.endswith("wide_f32"):
        assert min(lstm_cuda.recurrence_wide_f32_smem(H, R) for R in
                   lstm_cuda.REC_WIDE_F32_ROWS[1 if H <= 512 else 2]) <= lstm_cuda.SMEM_LIMIT
    if kernel.endswith("mid_f32"):
        cluster, resident = (lstm_cuda.REC_MID_F32_CLUSTER.get(H, 8),
                             H not in lstm_cuda.REC_MID_F32_FROM_L2)
        assert min(lstm_cuda.recurrence_mid_f32_smem(H, R, cluster, resident) for R in
                   lstm_cuda.REC_MID_F32_ROWS) <= lstm_cuda.SMEM_LIMIT
    if kernel.endswith("mid_mma"):
        cluster = lstm_cuda.REC_MID_MMA_CLUSTER["bwd"].get(H, 8)
        assert min(lstm_cuda.recurrence_mid_mma_smem("bwd", H, R, cluster) for R in
                   lstm_cuda.REC_MID_MMA_ROWS) <= lstm_cuda.SMEM_LIMIT


@pytest.mark.parametrize("H,dtype,kernel", [
    (32, torch.bfloat16, "lstm_recurrence_fwd_mma"),
    # f32 at 32 / 64 and 288: the tensor-core forwards in three tf32 passes
    # (ids kept from the cluster forward's cases)
    pytest.param(64, torch.float32, "lstm_recurrence_fwd_f32",
                 id="64-dtype1-lstm_recurrence_fwd"),
    (64, torch.bfloat16, "lstm_recurrence_fwd_mma"),
    pytest.param(32, torch.float32, "lstm_recurrence_fwd_f32",
                 id="32-dtype3-lstm_recurrence_fwd"),
    # bf16 at 96-288: the tensor-core forward of those widths (ids kept from
    # the cluster forward's cases)
    pytest.param(96, torch.bfloat16, "lstm_recurrence_fwd_mid_mma",
                 id="96-dtype4-lstm_recurrence_fwd"),
    pytest.param(256, torch.bfloat16, "lstm_recurrence_fwd_mid_mma",
                 id="256-dtype5-lstm_recurrence_fwd"),
    pytest.param(288, torch.bfloat16, "lstm_recurrence_fwd_mid_mma",
                 id="288-dtype6-lstm_recurrence_fwd"),
    pytest.param(288, torch.float32, "lstm_recurrence_fwd_mid_f32",
                 id="288-dtype7-lstm_recurrence_fwd"),
    (96, torch.float32, "lstm_recurrence_fwd_mid_f32"),
    (128, torch.float32, "lstm_recurrence_fwd_mid_f32"),
    (224, torch.float32, "lstm_recurrence_fwd_mid_f32"),
    (320, torch.bfloat16, "lstm_recurrence_fwd_wide_mma"),
    (352, torch.bfloat16, "lstm_recurrence_fwd_wide_mma"),
    (512, torch.bfloat16, "lstm_recurrence_fwd_wide_mma"),
    (1024, torch.bfloat16, "lstm_recurrence_fwd_wide_mma"),
    (320, torch.float32, "lstm_recurrence_fwd_wide_f32"),
    (512, torch.float32, "lstm_recurrence_fwd_wide_f32"),
    (1024, torch.float32, "lstm_recurrence_fwd_wide_f32"),
    (48, torch.bfloat16, None), (64, torch.float16, None), (1056, torch.bfloat16, None)])
def test_recurrence_fwd_kernel_by_width_and_dtype(H, dtype, kernel):
    """The forward's picker, by width and dtype alone, a tensor-core kernel
    everywhere (f32 in three tf32 passes): at H = 32 and 64 the forward with
    one block a row tile, whose f32 weights fit one block pre-split; from 96
    to 288 the forward whose blocks hold their share of the weights, with a
    row tile that fits shared memory; past 288 the forwards reading their
    fragments from L2, up to the op's 1024 on the card; what none takes is refused by the op's check."""
    if kernel is None:
        with pytest.raises(ValueError, match="H % 32 == 0"):
            lstm_cuda.recurrence_fwd_kernel(H, dtype)
        return
    assert lstm_cuda.recurrence_fwd_kernel(H, dtype) == kernel
    if kernel.endswith("wide_f32"):
        assert min(lstm_cuda.recurrence_wide_f32_smem(H, R, "fwd") for R in
                   lstm_cuda.REC_WIDE_F32_FWD_ROWS[1 if H <= 512 else 2]) <= lstm_cuda.SMEM_LIMIT
    if kernel.endswith("mid_mma"):
        cluster = lstm_cuda.REC_MID_MMA_CLUSTER["fwd"].get(H, 8)
        assert min(lstm_cuda.recurrence_mid_mma_smem("fwd", H, R, cluster) for R in
                   lstm_cuda.REC_MID_MMA_ROWS) <= lstm_cuda.SMEM_LIMIT
    if kernel == "lstm_recurrence_fwd_f32":
        assert lstm_cuda.recurrence_fwd_f32_smem(H) <= lstm_cuda.SMEM_LIMIT
    if kernel.endswith("mid_f32"):
        plan = lstm_cuda.recurrence_mid_f32_plan(400, 5, H, lambda c, r, R, m: 15, kind="fwd")
        assert plan[0] == lstm_cuda.REC_FWD_MID_F32_CLUSTER.get(H, 8)
        assert plan[1] == (H not in lstm_cuda.REC_FWD_MID_F32_FROM_L2)
        assert plan[4] <= lstm_cuda.SMEM_LIMIT


@pytest.mark.parametrize("H,D", [(32, 1), (64, 2), (64, 3)])
def test_recurrence_fwd_mma_wrapper_takes_plain_version_on_cpu(H, D):
    """The bf16 tensor-core forward at H = 32 / 64 takes the plain twin for
    CPU tensors bit for bit, counting no launch, and so does the op's
    forward by each of its names; under grad mode an operand that requires
    grad is refused."""
    T, B, G, cd = 5, 6, 2, torch.bfloat16
    wrappers = (lstm_cuda.lstm_recurrence_fwd_mma, lstm_cuda.lstm_recurrence_fwd)
    before = [f.launches for f in wrappers]
    for mask in ("lengths", "holes"):
        xg, valid, w, _, _, _ = recurrence_case(T, D, B, H, G, cd, torch.device("cpu"), mask,
                                                seed=H + D)
        want = recurrence_fwd(xg, valid, w, G, cd)
        for got in (lstm_cuda.lstm_recurrence_fwd_mma(xg, valid, w, G, cd),
                    *(lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd, kernel=k)
                      for k in (None, "lstm_recurrence_fwd_mma"))):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_fwd_mma(xg.clone().requires_grad_(), valid, w, G, cd)
    with torch.no_grad():
        lstm_cuda.lstm_recurrence_fwd_mma(xg.clone().requires_grad_(), valid, w, G, cd)


def test_recurrence_kernels_by_width_are_the_parents_but_bf16_past_288():
    """Every width the op's kernels take (H % 32 == 0, 32 to 1024) in f32
    and bf16 names a tensor-core forward, sweep and wgrad (f32 in three
    tf32 passes; the f32 wgrad was the CUDA-core one before): at 32 and 64 the one-block
    kernels, from 96 to 288 the kernels whose blocks hold their share of the
    weight fragments, past 288 the ones reading them from L2; what was
    refused stays refused."""
    def parent(H, dtype):
        wgrad = "lstm_recurrence_wgrad_mma" if dtype == torch.bfloat16 \
            else "lstm_recurrence_wgrad_f32"
        if H in (32, 64):
            return (("lstm_recurrence_fwd_mma", "lstm_recurrence_bwd_mma", wgrad)
                    if dtype == torch.bfloat16 else
                    ("lstm_recurrence_fwd_f32", "lstm_recurrence_bwd_f32", wgrad))
        return "lstm_recurrence_fwd_mid_f32", "lstm_recurrence_bwd_mid_f32", wgrad

    for dtype in (torch.float32, torch.bfloat16):
        for H in range(32, 1025):
            pick = (lstm_cuda.recurrence_fwd_kernel, lstm_cuda.recurrence_sweep_kernel,
                    lstm_cuda.recurrence_wgrad_kernel)
            if H % 32:
                for f in pick:
                    with pytest.raises(ValueError, match="H % 32 == 0"):
                        f(H, dtype)
                continue
            want = parent(H, dtype)
            if dtype == torch.bfloat16 and H > 288:
                want = ("lstm_recurrence_fwd_wide_mma", "lstm_recurrence_bwd_wide_mma", want[2])
            if dtype == torch.float32 and H > 288:
                want = ("lstm_recurrence_fwd_wide_f32", "lstm_recurrence_bwd_wide_f32", want[2])
            if dtype == torch.bfloat16 and 96 <= H <= 288:
                want = ("lstm_recurrence_fwd_mid_mma", "lstm_recurrence_bwd_mid_mma", want[2])
            assert tuple(f(H, dtype) for f in pick) == want, (H, dtype)


@pytest.mark.parametrize("H,kind,want", [
    (320, "fwd", {16: 22528, 32: 45056, 48: 67584, 80: 112640}),
    (512, "fwd", {16: 35584, 32: 71168, 48: 106752, 80: 177920}),
    (1024, "fwd", {16: 70400, 32: 140800}),
    (320, "bwd", {16: 67072, 32: 123904}),
    (512, "bwd", {16: 107008, 32: 197632}),
    (1024, "bwd", {16: 213504})])
def test_recurrence_wide_mma_smem_and_plan(H, kind, want):
    """The shared memory of the bf16 tensor-core recurrence kernels past 288
    by row tile, as their sources lay it out (fwd: two bf16 h tiles and the
    staged new h; bwd: the f32 h_prev tile, its bf16 rounding, the dgates
    tile and the f32 partial dh of all units); the plan takes the fewest
    waves, then the smallest tile that fits; past 1024 (the stop) and for a
    tile with no instance they refuse."""
    rows = lstm_cuda.REC_WIDE_MMA_ROWS[kind][1 if H <= 512 else 2]
    assert {R: lstm_cuda.recurrence_wide_mma_smem(kind, H, R) for R in rows} == want
    fits = [R for R, b in want.items() if b <= lstm_cuda.SMEM_LIMIT]
    # the train step's shape on a card holding 15 clusters at once: 400 rows in 5 groups, D = 2
    R, tiles, smem = lstm_cuda.wide_plan(f"rec_{kind}_mma", 400, 5, H, lambda R, b: 15, 2)
    waves = {r: -(-2 * 5 * -(-80 // r) // 15) for r in fits}
    assert waves[R] == min(waves.values()) and R == min(r for r in fits if waves[r] == waves[R])
    assert tiles == 5 * -(-80 // R) and smem == want[R] <= lstm_cuda.SMEM_LIMIT
    assert lstm_cuda.wide_plan(f"rec_{kind}_mma", 40, 5, H, lambda R, b: 15, 2)[0] == 16
    with pytest.raises(ValueError, match="from 320 to 1024"):
        lstm_cuda.recurrence_wide_mma_smem(kind, H + 544 if H == 512 else 1056, 16)
    with pytest.raises(ValueError, match="from 320 to 1024"):
        lstm_cuda.recurrence_wide_mma_smem(kind, 288, 16)
    with pytest.raises(ValueError, match="no instance for a row tile of 24"):
        lstm_cuda.recurrence_wide_mma_smem(kind, H, 24)


def test_recurrence_mma_weights_layout():
    """The weight copy both bf16 tensor-core kernels past 288 read, held
    against the mma.sync A-fragment layout: lane 4 g + t of (group, k16
    step kk, m16 half mt) holds rows g, g + 8 of the group's permuted gate
    rows (row 8 * gate + unit % 8) at columns 2t, 2t + 1 and 2t + 8, 2t + 9
    of the k16 step; and the same fragment transposed 8x8 by 8x8 (as
    movmatrix does in the sweep) is the A fragment of w's rows (units) by
    those gate columns."""
    torch.manual_seed(0)
    D, G, H = 2, 3, 352
    w = torch.randn(D, G, H, 4 * H).to(torch.bfloat16)
    wf = lstm_cuda.recurrence_mma_weights(w)
    assert wf.shape == (D, G, H // 8, H // 16, 2, 32, 8) and wf.dtype == torch.bfloat16

    def col(p):  # permuted gate row of the whole layer -> w's column
        group, pl = divmod(p, 32)
        return (pl // 8) * H + 8 * group + pl % 8

    def frag(A, lane):  # the A fragment of a 16x16 block, registers in mma order
        g, t = divmod(lane, 4)
        return torch.stack([A[g, 2 * t], A[g, 2 * t + 1], A[g + 8, 2 * t], A[g + 8, 2 * t + 1],
                            A[g, 2 * t + 8], A[g, 2 * t + 9], A[g + 8, 2 * t + 8],
                            A[g + 8, 2 * t + 9]])

    for d, g_, group, kk, mt in ((0, 0, 0, 0, 0), (1, 2, 43, 21, 1), (0, 1, 17, 5, 1)):
        rows = [col(32 * group + 16 * mt + r) for r in range(16)]
        A = w[d, g_, 16 * kk:16 * kk + 16][:, rows].T  # [gate row][input]
        for lane in range(32):
            assert torch.equal(wf[d, g_, group, kk, mt, lane], frag(A, lane))
            # the transposed use: register r of the dh product's fragment is
            # 8x8 block (0, 2, 1, 3)[r] of the gate fragment, transposed
            got = wf[d, g_, group, kk, mt].reshape(32, 4, 2)
            g, t = divmod(lane, 4)
            blocks = [got[:, q].reshape(8, 4, 2).reshape(8, 8) for q in (0, 2, 1, 3)]
            assert torch.equal(torch.cat([b.T[g, 2 * t:2 * t + 2] for b in blocks]),
                               frag(A.T, lane))




@pytest.mark.parametrize("H,want", [(320, {16: 63488, 32: 116736}),
                                    (512, {16: 100352, 32: 184320}),
                                    (544, {16: 107520}), (1024, {16: 198656})])
def test_recurrence_wide_f32_smem_and_plan(H, want):
    """The shared memory of the f32 tensor-core recurrence sweep past 288 by
    row tile, as its source lays it out (the f32 h_prev tile and the
    block's f32 dgates tile, rows padded by 16 floats; the f32 partial dh
    of all units, rows padded to 8 mod 16); the plan takes the fewest
    waves, then the smallest tile; it refuses bf16, widths up to 288 and
    past 1024, and a tile with no instance."""
    rows = lstm_cuda.REC_WIDE_F32_ROWS[1 if H <= 512 else 2]
    assert {R: lstm_cuda.recurrence_wide_f32_smem(H, R) for R in rows} == want
    groups, R = -(-H // 64), 32
    if H == 512:
        assert want[R] == R * (H + 16) * 4 + R * (32 * groups + 16) * 4 + H * 40 * 4
    assert all(b <= lstm_cuda.SMEM_LIMIT for b in want.values())
    assert lstm_cuda.wide_smem("rec_bwd_f32", H, rows[0]) == want[rows[0]]
    # the train step's shape on a card holding 15 clusters at once: 400 rows in 5 groups, D = 2
    R, tiles, smem = lstm_cuda.wide_plan("rec_bwd_f32", 400, 5, H, lambda R, b: 15, 2)
    waves = {r: -(-2 * 5 * -(-80 // r) // 15) for r in want}
    assert waves[R] == min(waves.values()) and R == min(r for r in want if waves[r] == waves[R])
    assert tiles == 5 * -(-80 // R) and smem == want[R]
    assert lstm_cuda.wide_plan("rec_bwd_f32", 40, 5, H, lambda R, b: 15, 2)[0] == 16
    for bad in (288, 1056):
        with pytest.raises(ValueError, match="from 320 to 1024"):
            lstm_cuda.recurrence_wide_f32_smem(bad, 16)
    with pytest.raises(ValueError, match="takes compute dtype float32"):
        lstm_cuda.recurrence_wide_f32_check(H, torch.bfloat16)
    with pytest.raises(ValueError, match="no instance for a row tile of 24"):
        lstm_cuda.recurrence_wide_f32_smem(H, 24)


def test_recurrence_f32_weights_layout():
    """The f32 weight copy the f32 tensor-core sweep past 288 reads, held
    against the tf32 mma.sync A-fragment layout with the K order the kernel
    uses: lane 4 g + t of (group, k8 step kk = 2c + kh, m16 half mt) holds
    rows g, g + 8 of the group's permuted gate rows (row 8 * gate +
    unit % 8) at input 16 c + 2 kh + 4t (registers 0, 1) and the input after
    it (registers 2, 3). Then the dh product's use: each 8x8 block of two
    fragments transposed (as movmatrix does on its two b16 halves) is the A
    fragment of w's rows (units 16 m + 4 (g >> 1) + (g & 1), and two
    further for rows g + 8) by gate columns 16 mt + 8 hi + 2t (+ 1)."""
    torch.manual_seed(0)
    D, G, H = 2, 3, 352
    w = torch.randn(D, G, H, 4 * H)
    wf = lstm_cuda.recurrence_f32_weights(w)
    assert wf.shape == (D, G, H // 8, H // 8, 2, 32, 4) and wf.dtype == torch.float32

    def col(p):  # permuted gate row of the whole layer -> w's column
        group, pl = divmod(p, 32)
        return (pl // 8) * H + 8 * group + pl % 8

    for d, g_, group, kk, mt in ((0, 0, 0, 0, 0), (1, 2, 43, 21, 1), (0, 1, 17, 5, 1)):
        c, kh = divmod(kk, 2)
        for lane in range(32):
            g, t = divmod(lane, 4)
            k = 16 * c + 2 * kh + 4 * t
            rows = [col(32 * group + 16 * mt + r) for r in (g, g + 8)]
            want = torch.stack([w[d, g_, k, rows[0]], w[d, g_, k, rows[1]],
                                w[d, g_, k + 1, rows[0]], w[d, g_, k + 1, rows[1]]])
            assert torch.equal(wf[d, g_, group, kk, mt, lane], want)
    d, g_, group = 1, 1, 5
    for m, mt, hi in ((0, 0, 0), (7, 1, 1), (21, 0, 1)):
        got = {}
        for kh in range(2):
            F = wf[d, g_, group, 2 * m + kh, mt]
            # the 8x8 block of gate rows 8 hi ..: lane (g, t) holds columns 2t, 2t + 1
            X = torch.stack([torch.stack([F[4 * g + c2 // 2, hi + 2 * (c2 % 2)]
                                          for c2 in range(8)]) for g in range(8)])
            for lane in range(32):
                g, t = divmod(lane, 4)
                got[lane, kh], got[lane, kh + 2] = X[2 * t, g], X[2 * t + 1, g]
        for lane in range(32):
            g, t = divmod(lane, 4)
            u0, p0 = 16 * m + 4 * (g >> 1) + (g & 1), 32 * group + 16 * mt + 8 * hi + 2 * t
            want = [w[d, g_, u0, col(p0)], w[d, g_, u0 + 2, col(p0)],
                    w[d, g_, u0, col(p0 + 1)], w[d, g_, u0 + 2, col(p0 + 1)]]
            assert [float(got[lane, r]) for r in range(4)] == [float(v) for v in want]


@pytest.mark.parametrize("H", [320, 512])
def test_recurrence_wide_f32_wrapper_takes_plain_version_on_cpu(H):
    """The f32 tensor-core sweep past 288 takes the plain twin for CPU
    tensors, counting no launch, and refuses operands that require grad;
    ``lstm_recurrence_bwd`` hands f32 past 288 to it only on the card, and
    reaches it by name."""
    T, D, B, G, cd = 3, 2, 4, 2, torch.float32
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, torch.device("cpu"),
                                                  "holes")
    wrappers = (lstm_cuda.lstm_recurrence_bwd_wide_f32, lstm_cuda.lstm_recurrence_bwd)
    before = [f.launches for f in wrappers]
    hs, cs = recurrence_fwd(xg, valid, w, G, cd)[:2]
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    want = recurrence_sweep(*args)
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd_wide_f32(*args), want)
    for kernel in (None, "lstm_recurrence_bwd_wide_f32"):
        assert torch.equal(lstm_cuda.lstm_recurrence_bwd(*args, kernel=kernel), want)
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_bwd_wide_f32(xg, valid, w.clone().requires_grad_(), *args[3:])


def test_lite_mma_plan_at_288():
    """The tensor-core lite sweep at H = 288 (36 unit groups, 4 or 5 a
    block): its shared memory by row tile, as the uneven instance lays it
    out (the bf16 W_hh slice of the 5-group block, two h_prev buffers, the
    f32 xg slice, c_prev and two dy streams and the bf16 dgates tile, each
    sized for 40 units, and ONE f32 partial buffer of 288 units x 40); the
    plan at the train step's 400 rows in 5 groups takes 32-row tiles
    (15 a direction: two waves of 15 or 16 clusters), the largest that fit.
    Its check refuses f32 there and the bf16 widths no instance takes."""
    assert lstm_cuda.wide_smem("lite_mma", 288, 32) == (
        160 * 296 * 2 + 2 * 32 * 296 * 2 + 32 * 164 * 4 + 3 * 32 * 40 * 2 + 32 * 168 * 2
        + 288 * 40 * 4) == 218112 <= lstm_cuda.SMEM_LIMIT
    assert lstm_cuda.wide_smem("lite_mma", 288, 16) == 179456
    assert all(lstm_cuda.wide_smem("lite_mma", 288, r) > lstm_cuda.SMEM_LIMIT for r in (40, 80))
    for clusters in (15, 16):
        assert lstm_cuda.wide_plan("lite_mma", 400, 5, 288, lambda R, s: clusters) == (
            32, 15, 218112)
    assert lstm_cuda.wide_plan("lite_mma", 400, 1, 288, lambda R, s: 16) == (32, 13, 218112)
    assert lstm_cuda.wide_plan("lite_mma", 40, 1, 288, lambda R, s: 16)[:2] == (16, 3)
    assert lstm_cuda.LITE_MMA_UNEVEN_ROWS == (16, 32)
    lstm_cuda.lite_mma_check(288, torch.bfloat16)
    for H, dtype in ((288, torch.float32), (320, torch.bfloat16), (64, torch.bfloat16),
                     (96, torch.bfloat16), (192, torch.float32)):
        with pytest.raises(ValueError, match="bilstm_bwd_lite_mma kernel takes bfloat16"):
            lstm_cuda.lite_mma_check(H, dtype)


def test_lite_mma_uneven_plan_at_256():
    """H = 288's instance for uneven unit groups, asked for by name at
    H = 256 (4 groups a block) to be timed against that width's kernel: its
    shared memory is the 256 kernel's less one of the two partial buffers
    (the C entry tells the two apart by it), its plan takes 16- and 32-row
    tiles (32 at the train step's 400 rows in 5 groups: two waves of 15),
    and the plan of every width the dispatch names is what it was."""
    fifteen = lambda R, smem: 15  # noqa: E731
    assert lstm_cuda.wide_smem("lite_mma_uneven", 256, 32) == (
        128 * 264 * 2 + 2 * 32 * 264 * 2 + 32 * 132 * 4 + 3 * 32 * 32 * 2 + 32 * 136 * 2
        + 256 * 40 * 4) == 174080 == lstm_cuda.wide_smem("lite_mma", 256, 32) - 256 * 40 * 4
    assert lstm_cuda.wide_smem("lite_mma_uneven", 256, 16) == (
        lstm_cuda.wide_smem("lite_mma", 256, 16) - 256 * 40 * 4)
    assert lstm_cuda.wide_smem("lite_mma_uneven", 288, 32) == lstm_cuda.wide_smem(
        "lite_mma", 288, 32) == 218112
    assert lstm_cuda.wide_plan("lite_mma_uneven", 400, 5, 256, fifteen) == (32, 15, 174080)
    assert lstm_cuda.wide_plan("lite_mma_uneven", 40, 1, 256, fifteen)[:2] == (16, 3)
    assert lstm_cuda.wide_plan("lite_mma", 400, 5, 256, fifteen) == (32, 15, 215040)
    # on the CPU the wrapper runs the plain twin, whatever it is asked for
    T, B, H, G, cd = 3, 4, 256, 1, torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [8], H, G, cd, "cpu")
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:1], dy[2:3], dhn, dcn, cd)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite_mma(*args, uneven=True),
                       bidir_layer_sweep_lite(*args))


# ------------------------------------- the tensor-core forward and wgrad
@pytest.mark.parametrize(
    "E_parts,H,dtype,kernel",
    [
        ([64], 64, torch.bfloat16, "bilstm_fwd_mma"),
        ([64, 64], 64, torch.bfloat16, "bilstm_fwd_mma"),
        ([32], 32, torch.bfloat16, "bilstm_fwd_mma"),
        ([32, 32], 32, torch.bfloat16, "bilstm_fwd_mma"),
        ([48], 48, torch.bfloat16, "bilstm_fwd_mma"),
        ([16], 16, torch.bfloat16, "bilstm_fwd_mma"),
        ([64], 64, torch.float32, "bilstm_fwd_f32"),   # f32: three tf32 passes
        ([64, 64], 64, torch.float32, "bilstm_fwd_f32"),
        ([32], 32, torch.float32, "bilstm_fwd_f32"),
        ([32, 32], 32, torch.float32, "bilstm_fwd_f32"),
        ([48], 48, torch.float32, "bilstm_fwd_f32"),
        ([16, 16], 16, torch.float32, "bilstm_fwd_f32"),
        ([80], 80, torch.float32, "bilstm_fwd_f32"),   # f32 at H = 80: its 320-thread instance
        ([40, 40], 80, torch.float32, "bilstm_fwd_f32"),
        ([80], 80, torch.bfloat16, "bilstm_fwd_mma"),  # bf16 at E = H = 80: its <80, 80> instance
        ([128, 128], 128, torch.float32, None),        # too wide for any
        # (H, E) not instantiated: no forward since bilstm_fwd.cu went (ids
        # kept from its cases)
        pytest.param([32], 64, torch.bfloat16, None, id="E_parts16-64-dtype16-bilstm_fwd"),
        ([60], 64, torch.bfloat16, None),               # parts not multiples of 8
        ([128, 128], 128, torch.bfloat16, None),        # too wide for either
        ([40, 40], 80, torch.bfloat16, "bilstm_fwd_mma"),
        ([72], 72, torch.bfloat16, "bilstm_fwd_mma"),  # its <72, 72> instance: nine k16 steps
        pytest.param([72], 72, torch.float32, None,    # f32 at H % 16 == 8
                     id="E_parts21-72-dtype21-bilstm_fwd"),
        # bf16 at 56: its <56, 56> instance, K = 112 in k16 steps (id kept
        # from the CUDA-core forward's case); at 24 and 40 a k8 tail
        pytest.param([56], 56, torch.bfloat16, "bilstm_fwd_mma",
                     id="E_parts22-56-dtype22-bilstm_fwd"),
        ([24], 24, torch.bfloat16, "bilstm_fwd_mma"),
        ([40, 40], 40, torch.bfloat16, "bilstm_fwd_mma"),
        ([56, 56], 48, torch.bfloat16, "bilstm_fwd_mma"),
        ([8], 16, torch.bfloat16, "bilstm_fwd_mma"),
    ],
)
def test_fwd_kernel_by_shape_and_dtype(E_parts, H, dtype, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel.*; bilstm_fwd_mma kernel takes"):
            lstm_cuda.fwd_kernel(E_parts, H, dtype)
        return
    assert lstm_cuda.fwd_kernel(E_parts, H, dtype) == kernel
    assert lstm_cuda.layer_route(E_parts, H, dtype) == "resident"


@pytest.mark.parametrize("H,E", lstm_cuda.FWD_MMA_SHAPES)
def test_fwd_mma_plan(H, E):
    """One warp per 8 hidden units; a step's x chunks within the kernel's
    per-thread constant; the three-stage [x ; h] ring within a block's
    static shared memory, its rows padded to an odd number of 16 bytes (8
    elements past K where K % 16 == 0, 16 where K % 16 == 8: the k8 tail);
    K whole k16 steps and at most one k8 step; one and two input parts."""
    K = E + H
    pad = lstm_cuda.fwd_mma_pad(K)
    assert pad == (8 if K % 16 == 0 else 16) and ((K + pad) * 2 // 16) % 2 == 1
    for E_parts in ([E], [E // 2, E // 2]) if (E // 2) % 8 == 0 else ([E],):
        threads, smem = lstm_cuda.fwd_mma_plan(E_parts, H, torch.bfloat16)
        assert threads == 4 * H <= lstm_cuda.FWD_MMA_MAX_THREADS
        assert E <= lstm_cuda.FWD_MMA_MAX_CHUNKS * threads  # 8 rows x E / 8 chunks
        assert smem == 3 * 8 * (K + pad) * 2
        assert K % 8 == 0 and smem <= 48 * 1024 <= lstm_cuda.SMEM_LIMIT
    with pytest.raises(ValueError, match="bilstm_fwd_mma kernel takes bfloat16"):
        lstm_cuda.fwd_mma_plan([E], H, torch.float32)
    with pytest.raises(ValueError, match="bilstm_fwd_mma kernel takes bfloat16"):
        lstm_cuda.fwd_mma_plan([E // 3, E // 3, E - 2 * (E // 3)], H, torch.bfloat16)


@pytest.mark.parametrize(
    "E_parts,H,dtype,kernel",
    [
        ([64], 64, torch.bfloat16, "bilstm_wgrad_mma"),
        ([64, 64], 64, torch.bfloat16, "bilstm_wgrad_mma"),
        ([32], 32, torch.bfloat16, "bilstm_wgrad_mma"),
        ([32, 32], 32, torch.bfloat16, "bilstm_wgrad_mma"),
        ([256], 256, torch.bfloat16, "bilstm_wgrad_mma"),
        ([256, 256], 256, torch.bfloat16, "bilstm_wgrad_mma"),
        ([64], 64, torch.float32, "bilstm_wgrad_f32"),  # f32: three tf32 passes
        ([256, 256], 256, torch.float32, "bilstm_wgrad_f32"),
        ([16], 16, torch.bfloat16, "bilstm_wgrad_mma"),  # 4H past whole 128-row tiles: masked
        ([64], 24, torch.bfloat16, "bilstm_wgrad_mma"),
        ([80], 80, torch.bfloat16, "bilstm_wgrad_mma"),
        ([48, 48], 48, torch.bfloat16, "bilstm_wgrad_mma"),
        ([64], 20, torch.bfloat16, None),              # H % 8 != 0
        ([32, 32], 32, torch.float32, "bilstm_wgrad_f32"),
        ([128], 128, torch.float32, "bilstm_wgrad_f32"),
        # f32 at H % 32 == 16: the 64-row gate tiles (ids kept from the
        # CUDA-core kernel's cases)
        pytest.param([80], 80, torch.float32, "bilstm_wgrad_f32",
                     id="E_parts15-80-dtype15-bilstm_wgrad"),
        pytest.param([16], 16, torch.float32, "bilstm_wgrad_f32",
                     id="E_parts16-16-dtype16-bilstm_wgrad"),
        ([64], 24, torch.float32, None),
    ],
)
def test_wgrad_kernel_by_shape_and_dtype(E_parts, H, dtype, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="bilstm_wgrad_mma kernel.*; bilstm_wgrad_f32 kernel"):
            lstm_cuda.wgrad_kernel(E_parts, H, dtype)
        return
    assert lstm_cuda.wgrad_kernel(E_parts, H, dtype) == kernel


@pytest.mark.parametrize("T,B,G,E_parts,H,want", [
    (1500, 400, 5, [64], 64, (2, 1, 27)), (1500, 400, 1, [64, 64], 64, (2, 2, 66)),
    (1500, 400, 5, [256], 256, (8, 4, 2)), (1500, 400, 1, [256, 256], 256, (8, 6, 6)),
    (300, 400, 5, [32], 32, (1, 1, 53)), (3, 400, 5, [64], 64, (2, 1, 8)),
    (1, 27, 3, [32, 32], 32, (1, 1, 1))])
def test_wgrad_mma_plan(T, B, G, E_parts, H, want):
    """Whole 128-row tiles of the gates, 128-column tiles of the source
    columns, and splits that bring the grid near WGRAD_TARGET_BLOCKS with at
    least one 32-row K-tile each (more splits than positions at T = 3)."""
    m_tiles, n_tiles, splits = lstm_cuda.wgrad_mma_plan(T, B, G, E_parts, H)
    assert (m_tiles, n_tiles, splits) == want
    assert m_tiles * lstm_cuda.WGRAD_MMA_TILE_M == 4 * H
    assert (n_tiles - 1) * lstm_cuda.WGRAD_MMA_TILE_N < sum(E_parts) + H
    assert splits <= -(-T * (B // G) // lstm_cuda.WGRAD_MMA_TILE_K)
    assert lstm_cuda.WGRAD_MMA_SMEM <= lstm_cuda.SMEM_LIMIT // 2  # two blocks an SM


@pytest.mark.parametrize("T,B,G", [(5, 40, 5), (3, 400, 5), (1, 27, 3), (7, 12, 1), (2, 3, 3)])
def test_wgrad_mma_rows_cover_each_row_once(T, B, G):
    """The K-tiling as a host-side plan: over a launch's splits, each (t, b)
    row of a weight group is read exactly once for that group and
    direction; h_prev is position t - 1 (direction 0) or t + 1 (direction
    1), and None (read as zeros) past the ends."""
    splits = lstm_cuda.wgrad_mma_plan(T, B, G, [32], 32)[2]
    Bg = B // G
    for d in (0, 1):
        for g in range(G):
            rows = [r for split in range(splits)
                    for r in lstm_cuda.wgrad_mma_rows(T, B, G, splits, split, g, d)]
            assert sorted((t, b) for t, b, _ in rows) == [
                (t, b) for t in range(T) for b in range(g * Bg, (g + 1) * Bg)]
            for t, _, tp in rows:
                want = t + (1 if d else -1)
                assert tp == (want if 0 <= want < T else None)
    # more splits than positions: splits cut inside a position's rows
    assert lstm_cuda.wgrad_mma_plan(3, 400, 5, [64], 64)[2] > 3


def test_forward_and_wgrad_mma_wrappers_take_plain_versions_on_cpu():
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(
        6, 6, [32, 32], 32, 2, torch.bfloat16, torch.device("cpu"))
    cd = torch.bfloat16
    wrappers = (lstm_cuda.bilstm_layer_fwd, lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_layer_fwd_mma, lstm_cuda.bilstm_layer_fwd_train_mma,
                lstm_cuda.bilstm_wgrad, lstm_cuda.bilstm_wgrad_mma)
    before = [f.launches for f in wrappers]
    want = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd, with_states=True)
    for got in (lstm_cuda.bilstm_layer_fwd_train_mma(parts, lengths, w_ih, w_hh, bias, cd),
                lstm_cuda.bilstm_layer_fwd_train(parts, lengths, w_ih, w_hh, bias, cd)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for got in (lstm_cuda.bilstm_layer_fwd_mma(parts, lengths, w_ih, w_hh, bias, cd),
                lstm_cuda.bilstm_layer_fwd(parts, lengths, w_ih, w_hh, bias, cd)):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want[:4]))
    hs_f, hs_b, _, _, cs_f, cs_b = want
    dgc = bidir_layer_sweep(parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
                            dy[:1], dy[2:3], dhn, dcn, cd)[2]
    ref = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, 2)
    for got in (lstm_cuda.bilstm_wgrad_mma(dgc, parts, hs_f, hs_b, 2),
                lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, 2)):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_layer_fwd_mma(parts, lengths, w_ih.clone().requires_grad_(), w_hh,
                                       bias, cd)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_layer_fwd_train_mma(parts, lengths, w_ih, w_hh,
                                             bias.clone().requires_grad_(), cd)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_wgrad_mma(dgc.clone().requires_grad_(), parts, hs_f, hs_b, 2)
    with torch.no_grad():
        lstm_cuda.bilstm_wgrad_mma(dgc.clone().requires_grad_(), parts, hs_f, hs_b, 2)


# --------------- the f32 tensor-core sweep and the recurrence wgrad (bf16)
def _resident_before_f32(E_parts, H, dtype):
    """``layer_route``'s answer as it was before the f32 tensor-core sweep:
    resident where a forward and either older sweep plan fit."""
    try:
        lstm_cuda.fwd_kernel(E_parts, H, dtype)
    except ValueError:
        return False
    for plan in (lstm_cuda.bwd_mma_plan, lstm_cuda.bwd_launch_plan):
        try:
            plan(E_parts, H, dtype)
            return True
        except ValueError:
            pass
    return False


def _route_and_width(E_parts, H, dtype):
    """``(layer_route, padded_width, padded_parts)``, or ``(None, None,
    None)`` where no shape takes the layer."""
    try:
        return (lstm_cuda.layer_route(E_parts, H, dtype),
                lstm_cuda.padded_width(E_parts, H, dtype),
                lstm_cuda.padded_parts(E_parts, H, dtype))
    except ValueError:
        return None, None, None


def _has_wgrad(E_parts, H, dtype):
    try:
        lstm_cuda.wgrad_kernel(E_parts, H, dtype)
        return True
    except ValueError:
        return False


def test_f32_sweep_changes_no_route():
    """Every (E_parts, H, dtype) the resident route took before the f32
    tensor-core sweeps keeps that route at its own width. A layer it did not
    take is resident at its own width now only where an f32 tensor-core
    sweep takes it (a tensor-core plan no longer waits on
    ``bwd_launch_plan``); the others keep their route or are padded
    (``padded_width``, ``padded_parts``). The f32 sweep takes each model
    shape in f32. (A layer at its own widths also needs a weight-gradient
    kernel, ``_route_at``.)"""
    for H in range(8, 272, 8):
        for E_parts in ([8], [16], [24], [32], [40], [48], [64], [96], [120], [128], [256],
                        [32, 32], [64, 64], [128, 128], [256, 256]):
            for dtype in (torch.float32, torch.bfloat16):
                route, Hp, Ep = _route_and_width(E_parts, H, dtype)
                own = (route, Hp, Ep) == ("resident", H, tuple(E_parts))
                resident = (_resident_before_f32(E_parts, H, dtype)
                            and _has_wgrad(E_parts, H, dtype))
                if resident:
                    assert own, (E_parts, H, dtype)
                elif own:
                    assert lstm_cuda.sweep_kernel(E_parts, H, dtype) in (
                        "bilstm_bwd_f32", "bilstm_bwd_f32_onestage"), (E_parts, H, dtype)
                if resident and dtype == torch.float32 and H <= 64 and H % 16 == 0:
                    assert lstm_cuda.sweep_kernel(E_parts, H, dtype) == "bilstm_bwd_f32"


@pytest.mark.parametrize("E_parts,H,threads,smem", [
    ([64], 64, 256, 156288), ([64, 64], 64, 384, 225920), ([32], 32, 128, 45696),
    ([32, 32], 32, 192, 64128), ([16], 16, 64, 14976)])
def test_bwd_f32_plan(E_parts, H, threads, smem):
    """One warp per 8 hidden units and one per 16 dx columns past the first
    H; shared memory for the f32 weights (4H rows of E + H, stride rounded
    to 32 floats plus 8), one dgates tile and two [x ; h] stages; the
    manuscript's layer 1 fits a block by a few KB."""
    assert lstm_cuda.bwd_f32_plan(E_parts, H, torch.float32) == (threads, smem)
    assert smem <= lstm_cuda.SMEM_LIMIT and threads <= lstm_cuda.BWD_MMA_MAX_THREADS
    assert 2 * (sum(E_parts) + H) <= lstm_cuda.BWD_F32_MAX_CHUNKS * threads
    with pytest.raises(ValueError, match="bilstm_bwd_f32 kernel takes float32"):
        lstm_cuda.bwd_f32_plan(E_parts, H, torch.bfloat16)
    with pytest.raises(ValueError, match="bilstm_bwd_f32 kernel takes float32"):
        lstm_cuda.bwd_f32_plan([40], 80, torch.float32)
    with pytest.raises(ValueError, match="bilstm_bwd_f32 kernel: E=192"):
        lstm_cuda.bwd_f32_plan([96, 96], 64, torch.float32)


@pytest.mark.parametrize("H,dtype,kernel", [
    *((H, torch.bfloat16, "lstm_recurrence_wgrad_mma") for H in (32, 64, 96, 256)),
    # f32 on the tensor cores in three tf32 passes at every width (ids kept
    # from the CUDA-core kernel's cases)
    pytest.param(64, torch.float32, "lstm_recurrence_wgrad_f32",
                 id="64-dtype4-lstm_recurrence_wgrad"),
    pytest.param(256, torch.float32, "lstm_recurrence_wgrad_f32",
                 id="256-dtype5-lstm_recurrence_wgrad"),
    (48, torch.bfloat16, None), (64, torch.float16, None),
    *((H, torch.float32, "lstm_recurrence_wgrad_f32") for H in (32, 96, 128, 288, 320, 1024))])
def test_recurrence_wgrad_kernel_by_width_and_dtype(H, dtype, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="H % 32 == 0"):
            lstm_cuda.recurrence_wgrad_kernel(H, dtype)
        return
    assert lstm_cuda.recurrence_wgrad_kernel(H, dtype) == kernel


@pytest.mark.parametrize("T,B,D,G,H,want", [
    (1500, 400, 2, 5, 64, (1, 2, 13)), (1500, 400, 2, 1, 64, (1, 2, 66)),
    (300, 400, 2, 5, 32, (1, 1, 26)), (1500, 400, 2, 5, 256, (4, 8, 1)),
    (3, 400, 1, 1, 64, (1, 2, 13)), (2, 27, 3, 3, 96, (2, 3, 1)), (1, 27, 2, 3, 64, (1, 2, 1))])
def test_recurrence_wgrad_mma_plan(T, B, D, G, H, want):
    """64-column tiles of the h columns, 128-column tiles of the gates, and
    splits that keep the grid within one wave of two blocks an SM, with at
    least one 64-row K-tile each (more splits than positions at T = 3)."""
    m_tiles, n_tiles, splits = lstm_cuda.recurrence_wgrad_mma_plan(T, B, D, G, H)
    assert (m_tiles, n_tiles, splits) == want
    tile_m = lstm_cuda.REC_WGRAD_MMA_TILE_M
    assert (m_tiles - 1) * tile_m < H <= m_tiles * tile_m
    assert n_tiles * lstm_cuda.REC_WGRAD_MMA_TILE_N == 4 * H
    blocks = m_tiles * n_tiles * D * G * splits
    assert splits == 1 or blocks <= lstm_cuda.REC_WGRAD_MMA_TARGET_BLOCKS
    assert splits <= max(1, -(-(T - 1) * (B // G) // lstm_cuda.REC_WGRAD_MMA_TILE_K))
    assert lstm_cuda.REC_WGRAD_MMA_SMEM <= lstm_cuda.SMEM_LIMIT // 2  # two blocks an SM


@pytest.mark.parametrize("T,B,D,G,H,want", [
    (1500, 400, 2, 5, 32, (1, 2, 66)), (1500, 400, 2, 5, 64, (1, 4, 33)),
    (1500, 400, 2, 1, 64, (1, 4, 33)), (1500, 400, 2, 5, 96, (2, 6, 11)),
    (1500, 400, 2, 5, 128, (2, 8, 13)), (1500, 400, 2, 5, 288, (5, 18, 2)),
    (1500, 400, 2, 1, 320, (5, 20, 9)), (300, 400, 2, 5, 1024, (16, 64, 1))])
def test_recurrence_wgrad_f32_plan(T, B, D, G, H, want):
    """The f32 tensor-core recurrence wgrad: 64-column tiles of the h
    columns (the last one half zero where H % 64 == 32), 64-column tiles of
    the gates (the tile the dispatch takes at every width: the faster in
    turns at H = 64 and 128), two blocks an SM, and the split whose blocks
    fill the card's 132 SMs in whole waves best (at most
    ``WGRAD_F32_MAX_WAVES``, no more splits than 32-row K-tiles); the
    64 x 128 tile, one block an SM, splits the same rows over half the
    blocks. Both tiles' shared memory lets their blocks share an SM."""
    assert lstm_cuda.REC_WGRAD_F32_TILE_N == 64
    plan = lstm_cuda.recurrence_wgrad_f32_plan(T, B, D, G, H, 132)
    assert plan == want == lstm_cuda.recurrence_wgrad_f32_plan(T, B, D, G, H, 132, 64)
    m_tiles, n_tiles, splits = plan
    assert (m_tiles - 1) * 64 < H <= m_tiles * 64 and n_tiles * 64 == 4 * H
    k_tiles = -(-(T - 1) * (B // G) // lstm_cuda.REC_WGRAD_F32_TILE_K)
    per_split = m_tiles * n_tiles * D * G
    assert 1 <= splits <= k_tiles
    assert per_split * splits <= lstm_cuda.WGRAD_F32_MAX_WAVES * 264 or splits == 1
    waves = lambda s, slots: -(-per_split * s // slots) / s  # noqa: E731
    assert all(waves(splits, 264) <= waves(s, 264) for s in range(1, splits + 1))
    wide = lstm_cuda.recurrence_wgrad_f32_plan(T, B, D, G, H, 132, 128)
    assert wide[:2] == (m_tiles, n_tiles // 2) and wide[2] >= 1
    assert lstm_cuda.REC_WGRAD_F32_BLOCKS == {128: 1, 64: 2}
    for tile_n, blocks in lstm_cuda.REC_WGRAD_F32_BLOCKS.items():
        smem = lstm_cuda.recurrence_wgrad_f32_smem(tile_n)
        assert smem == 4 * 32 * (64 + 8 + tile_n + 8) * 4
        assert blocks * (smem + lstm_cuda.BLOCK_SMEM_RESERVE) <= lstm_cuda.SM_SMEM


@pytest.mark.parametrize("T,B,G", [(5, 40, 5), (3, 400, 1), (2, 27, 3), (7, 12, 1), (1, 6, 2)])
def test_recurrence_wgrad_mma_rows_cover_each_row_once(T, B, G):
    """The K-tiling as a host-side plan: over a launch's splits, each
    (s, b) row of a weight group with s >= 1 is read exactly once, with its
    h_prev at s - 1; step 0, whose h_prev is zero, is no row."""
    splits = lstm_cuda.recurrence_wgrad_mma_plan(T, B, 1, G, 64)[2]
    Bg = B // G
    for g in range(G):
        rows = [r for split in range(splits)
                for r in lstm_cuda.recurrence_wgrad_mma_rows(T, B, G, splits, split, g)]
        assert sorted((s, b) for s, b, _ in rows) == [
            (s, b) for s in range(1, T) for b in range(g * Bg, (g + 1) * Bg)]
        assert all(sp == s - 1 for s, _, sp in rows)
    assert lstm_cuda.recurrence_wgrad_mma_plan(3, 400, 1, 1, 64)[2] > 3


def test_f32_sweep_and_recurrence_wgrad_wrappers_take_plain_versions_on_cpu():
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(
        6, 6, [16, 16], 16, 2, torch.float32, torch.device("cpu"))
    cd = torch.float32
    wrappers = (lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_f32, lstm_cuda.lstm_recurrence_wgrad,
                lstm_cuda.lstm_recurrence_wgrad_mma)
    before = [f.launches for f in wrappers]
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], None, dcn,
            cd)
    ref = bidir_layer_sweep(*args)
    for got in (lstm_cuda.bilstm_bwd_f32(*args), lstm_cuda.bilstm_bwd(*args),
                lstm_cuda.bilstm_bwd(*args, kernel="bilstm_bwd_f32")):
        assert all(torch.equal(a, b)
                   for a, b in zip(got[0] + got[1] + got[2:], ref[0] + ref[1] + ref[2:]))
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_bwd_f32(parts, lengths, w_ih.clone().requires_grad_(), *args[3:])
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_bwd_f32(parts, lengths, w_ih, w_hh, bias.clone().requires_grad_(),
                                 *args[5:])
    with torch.no_grad():
        lstm_cuda.bilstm_bwd_f32(parts, lengths, w_ih.clone().requires_grad_(), *args[3:])

    for dtype in (torch.bfloat16, torch.float32):
        xg, valid, w, dhs, dhn, dcn = recurrence_case(5, 3, 6, 32, 2, dtype, torch.device("cpu"),
                                                      "holes")
        hs, cs, _, _ = recurrence_fwd(xg, valid, w, 2, dtype)
        dxg = recurrence_sweep(xg, valid, w, hs, cs, dhs, dhn, dcn, 2, dtype)
        dw = recurrence_wgrad(hs, dxg, 2, dtype)
        assert torch.equal(lstm_cuda.lstm_recurrence_wgrad_mma(hs, dxg, 2, dtype), dw)
        assert torch.equal(lstm_cuda.lstm_recurrence_wgrad(hs, dxg, 2, dtype), dw)
        assert torch.equal(lstm_cuda.lstm_recurrence_wgrad(
            hs, dxg, 2, dtype, kernel="lstm_recurrence_wgrad"), dw)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_wgrad_mma(hs.clone().requires_grad_(), dxg, 2, dtype)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_wgrad_mma(hs, dxg.clone().requires_grad_(), 2, dtype)
    with torch.no_grad():
        lstm_cuda.lstm_recurrence_wgrad_mma(hs.clone().requires_grad_(), dxg, 2, dtype)
    assert [f.launches for f in wrappers] == before


def test_any_k_sweep_and_f32_recurrence_wgrad_wrappers_take_plain_versions_on_cpu():
    """The bf16 tensor-core sweep at the stacked layer of the bf16 model at
    embedding 16 (K = 48), its instance and its run-time build, and the f32
    tensor-core recurrence wgrad at either tile take their plain twins on
    the CPU and count no launch; the latter refuses an operand that
    requires grad under grad mode, as the bf16 one does."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(
        5, 10, [16, 16], 16, 2, cd, torch.device("cpu"))
    wrappers = (lstm_cuda.bilstm_bwd_mma, lstm_cuda.bilstm_bwd, lstm_cuda.lstm_recurrence_wgrad,
                lstm_cuda.lstm_recurrence_wgrad_f32)
    before = [f.launches for f in wrappers]
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    for ny in (0, 1, 2):
        args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
                dhn, dcn, cd)
        ref = bidir_layer_sweep(*args)
        for got in (lstm_cuda.bilstm_bwd_mma(*args), lstm_cuda.bilstm_bwd_mma(*args, generic=True),
                    lstm_cuda.bilstm_bwd(*args)):
            assert all(torch.equal(a, b)
                       for a, b in zip(got[0] + got[1] + got[2:], ref[0] + ref[1] + ref[2:]))
    xg, valid, w, dhs, dhn, dcn = recurrence_case(6, 3, 6, 64, 2, torch.float32,
                                                  torch.device("cpu"), "holes")
    hs, cs, _, _ = recurrence_fwd(xg, valid, w, 2, torch.float32)
    dxg = recurrence_sweep(xg, valid, w, hs, cs, dhs, dhn, dcn, 2, torch.float32)
    dw = recurrence_wgrad(hs, dxg, 2, torch.float32)
    for tile_n in (None, 128, 64):
        assert torch.equal(lstm_cuda.lstm_recurrence_wgrad_f32(hs, dxg, 2, torch.float32,
                                                               tile_n=tile_n), dw)
    assert torch.equal(lstm_cuda.lstm_recurrence_wgrad(hs, dxg, 2, torch.float32), dw)
    assert torch.equal(lstm_cuda.lstm_recurrence_wgrad(
        hs, dxg, 2, torch.float32, kernel="lstm_recurrence_wgrad_f32"), dw)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_wgrad_f32(hs.clone().requires_grad_(), dxg, 2, torch.float32)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_wgrad_f32(hs, dxg.clone().requires_grad_(), 2, torch.float32)
    with torch.no_grad():
        lstm_cuda.lstm_recurrence_wgrad_f32(hs.clone().requires_grad_(), dxg, 2, torch.float32)
    assert [f.launches for f in wrappers] == before


# ------- the f32 tensor-core forward and recurrence sweep (three tf32 passes)
@pytest.mark.parametrize("E_parts,H,rows,smem", [
    ([64], 64, 8, 147968), ([64, 64], 64, 8, 217600), ([64, 64], 64, 16, 230400),
    ([64], 64, 16, 156672), ([32], 32, 8, 41472), ([32, 32], 32, 16, 66560),
    ([16], 16, 16, 15360), ([48], 48, 8, 86528), ([80], 80, 8, 225792),
    ([40, 40], 80, 8, 225792), ([16], 80, 8, 139776)])
def test_fwd_f32_plan(E_parts, H, rows, smem):
    """One warp per 8 hidden units; shared memory for the f32 weights (4H
    rows of E + H, stride rounded to 32 floats plus 8) and two [x ; h]
    stages of 8 or 16 rows: the manuscript's layer 1 at 16-row tiles fits a
    block by 2 KB; a step's x chunks within the kernel's per-thread
    constant."""
    threads, got = lstm_cuda.fwd_f32_plan(E_parts, H, torch.float32, rows)
    E = sum(E_parts)
    ks = -(-(E + H) // 32) * 32 + 8
    assert (threads, got) == (4 * H, smem) == (4 * H, (4 * H + 2 * rows) * ks * 4)
    assert smem <= lstm_cuda.SMEM_LIMIT and threads <= lstm_cuda.FWD_F32_MAX_THREADS
    assert rows * E // 4 <= lstm_cuda.FWD_F32_MAX_CHUNKS * threads
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.fwd_f32_plan(E_parts, H, torch.bfloat16, rows)
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.fwd_f32_plan(E_parts, H, torch.float32, 32)
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.fwd_f32_plan([48], 96, torch.float32, rows)
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.fwd_f32_plan([8, 8, 8], 16, torch.float32, rows)
    # 16-row tiles of x past 2H wide would need more chunks a thread
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel: E=64, H=16 at 16-row"):
        lstm_cuda.fwd_f32_plan([64], 16, torch.float32, 16)
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel: E=192, H=64"):
        lstm_cuda.fwd_f32_plan([96, 96], 64, torch.float32, 8)


@pytest.mark.parametrize("B,G,sms,rows", [
    (800, 1, 132, 16), (800, 5, 132, 16), (400, 5, 132, 8), (400, 1, 132, 8),
    (128, 1, 132, 8), (120, 5, 132, 8), (528, 1, 132, 8), (536, 1, 132, 16),
    (400, 5, 80, 16)])
def test_fwd_f32_rows_picks_the_tile_height(B, G, sms, rows):
    """8-row tiles where both directions' tiles fill the SMs in one wave
    (the train step's 400 rows in 5 groups, an infer dispatch of 128
    rows), 16-row tiles past that (serve's 800 rows: 100 blocks instead of
    200), unless 16 rows do not fit the plan."""
    assert lstm_cuda.fwd_f32_rows([64, 64], 64, B, G, sms) == rows
    assert lstm_cuda.fwd_f32_rows([64], 16, B, G, sms) == 8  # x chunks: 16 rows do not fit
    assert (2 * lstm_cuda.mma_tiles(B, G, 8) <= sms) == (rows == 8)
    assert lstm_cuda.mma_tiles(800, 1, 16) == 50 and lstm_cuda.mma_tiles(120, 5, 16) == 10


def _resident_before_f32_forward(E_parts, H, dtype):
    """``layer_route``'s answer as it was before the f32 tensor-core
    forward: resident where either older forward plan and a sweep fit."""
    for plan in (lstm_cuda.fwd_mma_plan, _cuda_core_fwd_plan):
        try:
            plan(E_parts, H, dtype)
            break
        except ValueError:
            pass
    else:
        return False
    try:
        lstm_cuda.sweep_kernel(E_parts, H, dtype)
    except ValueError:
        return False
    return True


def test_f32_forward_changes_no_route():
    """Every (E_parts, H, dtype) the resident route took before the f32
    tensor-core forward keeps that route at its own width, but the shapes
    whose only forward was the deleted ``bilstm_fwd.cu`` (no layer of the
    width grid runs at one); a layer it did not take is resident at its own
    width now only where ``bilstm_fwd_f32`` takes it (``fwd_f32_plan`` did
    not wait on the CUDA-core plan), and bf16 keeps its kernel; the new
    kernel takes each model shape in f32."""
    for H in range(8, 272, 8):
        for E_parts in ([8], [16], [24], [32], [40], [48], [64], [96], [120], [128], [256],
                        [32, 32], [48, 48], [64, 64], [128, 128], [256, 256]):
            for dtype in (torch.float32, torch.bfloat16):
                route, Hp, Ep = _route_and_width(E_parts, H, dtype)
                own = (route, Hp, Ep) == ("resident", H, tuple(E_parts))
                if (_resident_before_f32_forward(E_parts, H, dtype)
                        and _has_wgrad(E_parts, H, dtype)):
                    try:
                        lstm_cuda.fwd_kernel(E_parts, H, dtype)
                    except ValueError:  # bilstm_fwd.cu's alone
                        assert not own, (E_parts, H, dtype)
                        continue
                    assert own, (E_parts, H, dtype)
                elif own:
                    assert lstm_cuda.fwd_kernel(E_parts, H, dtype) == "bilstm_fwd_f32"
                if not own:
                    continue
                kernel = lstm_cuda.fwd_kernel(E_parts, H, dtype)
                if dtype == torch.bfloat16:
                    assert kernel != "bilstm_fwd_f32"
                elif H <= 64 and H % 16 == 0 and sum(E_parts) <= 2 * H:
                    assert kernel == "bilstm_fwd_f32", (E_parts, H)
                if kernel == "bilstm_fwd_f32":
                    _cuda_core_fwd_plan(E_parts, H, dtype)


def test_f32_forward_and_recurrence_sweep_wrappers_take_plain_versions_on_cpu():
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(
        6, 6, [16, 16], 16, 2, torch.float32, torch.device("cpu"))
    cd = torch.float32
    wrappers = (lstm_cuda.bilstm_layer_fwd, lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_layer_fwd_f32, lstm_cuda.bilstm_layer_fwd_train_f32,
                lstm_cuda.lstm_recurrence_bwd, lstm_cuda.lstm_recurrence_bwd_f32)
    before = [f.launches for f in wrappers]
    want = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd, with_states=True)
    for got in (lstm_cuda.bilstm_layer_fwd_train_f32(parts, lengths, w_ih, w_hh, bias, cd),
                lstm_cuda.bilstm_layer_fwd_train(parts, lengths, w_ih, w_hh, bias, cd)):
        assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    for got in (lstm_cuda.bilstm_layer_fwd_f32(parts, lengths, w_ih, w_hh, bias, cd),
                lstm_cuda.bilstm_layer_fwd(parts, lengths, w_ih, w_hh, bias, cd)):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want[:4]))
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_layer_fwd_f32(parts, lengths, w_ih.clone().requires_grad_(), w_hh,
                                       bias, cd)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_layer_fwd_train_f32(parts, lengths, w_ih, w_hh,
                                             bias.clone().requires_grad_(), cd)
    with torch.no_grad():
        lstm_cuda.bilstm_layer_fwd_f32(parts, lengths, w_ih.clone().requires_grad_(), w_hh,
                                       bias, cd)

    xg, valid, w, dhs, dhn, dcn = recurrence_case(5, 3, 6, 32, 2, cd, torch.device("cpu"),
                                                  "holes")
    hs, cs, _, _ = recurrence_fwd(xg, valid, w, 2, cd)
    rargs = (xg, valid, w, hs, cs, dhs, None, dcn, 2, cd)
    dxg = recurrence_sweep(*rargs)
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd_f32(*rargs), dxg)
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd(*rargs), dxg)
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd(*rargs, kernel="lstm_recurrence_bwd_f32"),
                       dxg)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_bwd_f32(xg, valid, w.clone().requires_grad_(), *rargs[3:])
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_bwd_f32(xg.clone().requires_grad_(), *rargs[1:])
    assert [f.launches for f in wrappers] == before


# ------------- the tensor-core input gates and lite sweep (bf16, wide route)
@pytest.mark.parametrize(
    "E_parts,H,dtype,kernel",
    [
        ([256], 256, torch.bfloat16, "bilstm_gates_mma"),
        ([256, 256], 256, torch.bfloat16, "bilstm_gates_mma"),
        ([128], 128, torch.bfloat16, "bilstm_gates_mma"),
        ([128, 128], 128, torch.bfloat16, "bilstm_gates_mma"),
        ([16, 32], 32, torch.bfloat16, "bilstm_gates_mma"),  # every shape wide_check admits
        ([96], 96, torch.bfloat16, "bilstm_gates_mma"),
        ([256], 256, torch.float32, "bilstm_gates_f32"),      # three tf32 passes
        ([128, 128], 128, torch.float32, "bilstm_gates_f32"),
        ([200], 256, torch.bfloat16, None),   # a part not a multiple of 16
        ([256], 80, torch.bfloat16, None),    # H % 32 != 0
        ([256], 256, torch.float16, None),
    ],
)
def test_gates_kernel_by_shape_and_dtype(E_parts, H, dtype, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="bilstm (wide|gates) kernels"):
            lstm_cuda.gates_kernel(E_parts, H, dtype)
        return
    assert lstm_cuda.gates_kernel(E_parts, H, dtype) == kernel


@pytest.mark.parametrize(
    "H,dtype,kernel",
    [
        (256, torch.bfloat16, "bilstm_bwd_lite_mma"),
        (128, torch.bfloat16, "bilstm_bwd_lite_mma"),
        (256, torch.float32, "bilstm_bwd_lite_f32"),  # three tf32 passes
        (128, torch.float32, "bilstm_bwd_lite_f32"),
        (96, torch.float32, "bilstm_bwd_lite_f32_resident"),  # W_hh resident in one block
        # f32 at 160-224: the f32 tensor-core sweep's instances for 2 / 3, 3
        # and 3 / 4 unit groups a block (ids kept from the CUDA-core sweep's cases)
        pytest.param(160, torch.float32, "bilstm_bwd_lite_f32", id="160-dtype5-bilstm_bwd_lite"),
        pytest.param(224, torch.float32, "bilstm_bwd_lite_f32", id="224-dtype6-bilstm_bwd_lite"),
        pytest.param(192, torch.float32, "bilstm_bwd_lite_f32", id="192-dtype7-bilstm_bwd_lite"),
        # bf16 at 160-224: the tensor-core sweep's second kernel, its (group, n8
        # tile) items dealt over 8 warps (ids kept from the CUDA-core sweep's cases)
        pytest.param(192, torch.bfloat16, "bilstm_bwd_lite_mma", id="192-dtype8-bilstm_bwd_lite"),
        (96, torch.bfloat16, "bilstm_bwd_lite_mma_resident"),  # W_hh resident in one block
        # 32 and 64: no lite sweep since csrc/bilstm_bwd_lite.cu went (ids kept)
        pytest.param(32, torch.bfloat16, None, id="32-dtype10-bilstm_bwd_lite"),
        (80, torch.bfloat16, None),
        (288, torch.float32, "bilstm_bwd_lite_f32"),  # 4 or 5 unit groups a block
        (288, torch.bfloat16, "bilstm_bwd_lite_mma"),  # 4 or 5 unit groups a block
        (320, torch.float32, None),
        (256, torch.float16, None),
        pytest.param(160, torch.bfloat16, "bilstm_bwd_lite_mma",
                     id="160-dtype16-bilstm_bwd_lite"),
        pytest.param(224, torch.bfloat16, "bilstm_bwd_lite_mma",
                     id="224-dtype17-bilstm_bwd_lite"),
        (256, torch.bfloat16, "bilstm_bwd_lite_mma"),
        (128, torch.float32, "bilstm_bwd_lite_f32"),
        pytest.param(64, torch.bfloat16, None, id="64-dtype20-bilstm_bwd_lite"),
    ],
)
def test_lite_kernel_by_width_and_dtype(H, dtype, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="; bilstm_bwd_lite_mma kernel takes bfloat16"):
            lstm_cuda.lite_kernel(H, dtype)
        return
    assert lstm_cuda.lite_kernel(H, dtype) == kernel


def _route_without_the_wide_dispatch(E_parts, H, dtype):
    """``layer_route``'s rule, written out: at the layer's padded shape
    (``padded_width``, ``padded_parts``; None where none), resident where
    the resident forward and sweep dispatches take the layer, else wide
    where ``wide_check`` passes."""
    try:
        E_parts, H = (lstm_cuda.padded_parts(E_parts, H, dtype),
                      lstm_cuda.padded_width(E_parts, H, dtype))
    except ValueError:
        return None
    try:
        lstm_cuda.fwd_kernel(E_parts, H, dtype)
        lstm_cuda.sweep_kernel(E_parts, H, dtype)
        return "resident"
    except ValueError:
        pass
    try:
        lstm_cuda.wide_check(H, E_parts)
        return "wide"
    except ValueError:
        return None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_wide_kernels_change_no_route(dtype):
    """The input-gate and lite-sweep dispatches pick kernels inside the wide
    route and never move a layer between routes: every (E_parts, H) keeps
    its route (at its padded width), every wide layer has an input-gate and
    a sweep kernel, and the scaled configuration's layers take the
    tensor-core ones (in f32 the sweep's three tf32 passes)."""
    for H0 in range(8, 272, 8):
        for E_parts in ([8], [16], [32], [48], [64], [96], [128], [256], [512],
                        [32, 32], [64, 64], [128, 128], [256, 256]):
            route, H, Ep = _route_and_width(E_parts, H0, dtype)
            assert route == _route_without_the_wide_dispatch(E_parts, H0, dtype), (E_parts, H0)
            if route != "wide":
                continue
            gates, lite = lstm_cuda.gates_kernel(Ep, H, dtype), lstm_cuda.lite_kernel(H, dtype)
            bf16 = dtype == torch.bfloat16
            assert gates == ("bilstm_gates_mma" if bf16 else "bilstm_gates_f32")
            assert lite == ("bilstm_bwd_lite_f32_resident" if (H, bf16) == (96, False)
                            else "bilstm_bwd_lite_mma_resident" if H == 96
                            else "bilstm_bwd_lite_mma" if bf16 else "bilstm_bwd_lite_f32")
            assert H >= 96, (E_parts, H0)  # no layer runs wide at 32 or 64
    for E_parts in ([256], [256, 256]):
        assert lstm_cuda.layer_route(E_parts, 256, dtype) == "wide"


def test_lite_mma_plan_fills_the_card_in_fewest_waves():
    """The tensor-core sweep's shared memory per row tile, and its plan at
    the scaled train shapes with 15 clusters on the card at once: 400 rows
    in 5 groups of 80 (layer 0) and in 1 group (the stacked layers)."""
    fifteen = lambda R, smem: 15  # noqa: E731
    # H = 256, 32-row tile: the bf16 W_hh slice (128 rows of 256 + 8), two
    # h_prev buffers, the f32 xg slice (128 + 4 a row), c_prev and two dy
    # streams, the bf16 dgates tile (128 + 8), two f32 partial buffers of
    # 256 units x 40
    assert lstm_cuda.wide_smem("lite_mma", 256, 32) == (
        128 * 264 * 2 + 2 * 32 * 264 * 2 + 32 * 132 * 4 + 3 * 32 * 32 * 2 + 32 * 136 * 2
        + 2 * 256 * 40 * 4) == 215040
    assert lstm_cuda.wide_smem("lite_mma", 256, 40) == 231424 <= lstm_cuda.SMEM_LIMIT
    assert lstm_cuda.wide_smem("lite_mma", 256, 80) > lstm_cuda.SMEM_LIMIT
    assert lstm_cuda.wide_smem("lite_mma", 128, 80) == 208384
    # G = 5: 16-row tiles make 25 tiles a direction (4 waves); 32 and 40 make
    # 15 and 10 (2 waves each): the smaller tile wins
    assert lstm_cuda.wide_plan("lite_mma", 400, 5, 256, fifteen) == (32, 15, 215040)
    assert lstm_cuda.wide_plan("lite_mma", 400, 1, 256, fifteen) == (32, 13, 215040)
    # H = 128: 80-row tiles fit, one group each: 10 clusters, one wave
    assert lstm_cuda.wide_plan("lite_mma", 400, 5, 128, fifteen)[:2] == (80, 5)
    # a small batch: the smallest tile of the one wave
    assert lstm_cuda.wide_plan("lite_mma", 40, 1, 256, fifteen)[:2] == (16, 3)
    # the rows of every tile the plan may take are whole n8 tiles
    assert all(r % 8 == 0 for r in lstm_cuda.LITE_MMA_ROWS)


def test_tensor_core_wide_wrappers_take_plain_versions_on_cpu():
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(
        6, 4, [128], 128, 2, cd, torch.device("cpu"))
    wrappers = (lstm_cuda.bilstm_gates_mma, lstm_cuda.bilstm_bwd_lite_mma)
    before = [f.launches for f in wrappers]
    want = input_gates(parts, w_ih, bias, cd)
    for got in (lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd),
                lstm_cuda.bilstm_gates(parts, w_ih, bias, cd)):
        assert torch.equal(got, want)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(want, lengths, w_hh, cd, with_states=True)
    args = (want, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn, cd)
    ref = bidir_layer_sweep_lite(*args)
    for got in (lstm_cuda.bilstm_bwd_lite_mma(*args), lstm_cuda.bilstm_bwd_lite(*args)):
        assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_gates_mma(parts, w_ih.clone().requires_grad_(), bias, cd)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_bwd_lite_mma(want.clone().requires_grad_(), *args[1:])
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_bwd_lite_mma(*args[:3], hs_f.clone().requires_grad_(), *args[4:])
    with torch.no_grad():
        lstm_cuda.bilstm_gates_mma(parts, w_ih.clone().requires_grad_(), bias, cd)


# ----------- the tensor-core wide forward (bf16) and the f32 wgrad (3xTF32)
@pytest.mark.parametrize(
    "H,dtype,kernel",
    [
        (256, torch.bfloat16, "bilstm_fwd_wide_mma"),
        (128, torch.bfloat16, "bilstm_fwd_wide_mma"),
        (256, torch.float32, "bilstm_fwd_wide_f32"),  # three tf32 passes
        (128, torch.float32, "bilstm_fwd_wide_f32"),
        # bf16 at 160-224: the kernel for uneven unit groups (ids kept from the
        # cluster kernel's cases); at 192 8 warps are not even over 3 groups a block
        pytest.param(192, torch.bfloat16, "bilstm_fwd_wide_mma", id="192-dtype4-bilstm_fwd_wide"),
        # bf16 at 96: one block, W_hh in registers (id kept from the cluster kernel's case)
        pytest.param(96, torch.bfloat16, "bilstm_fwd_wide_mma_resident",
                     id="96-dtype5-bilstm_fwd_wide"),
        # 32: no wide forward since csrc/bilstm_fwd_wide.cu was retired (id kept)
        pytest.param(32, torch.bfloat16, None, id="32-dtype6-bilstm_fwd_wide"),
        (80, torch.bfloat16, None),
        (288, torch.float32, "bilstm_fwd_wide_f32"),  # 4 or 5 unit groups a block
        (288, torch.bfloat16, "bilstm_fwd_wide_mma"),  # its instance for uneven groups
        (320, torch.float32, None),
        (256, torch.float16, None),
        # f32 at 96: one block, W_hh in registers, three tf32 passes (id kept
        # from the cluster kernel's case)
        pytest.param(96, torch.float32, "bilstm_fwd_wide_f32_resident",
                     id="96-dtype12-bilstm_fwd_wide"),
        pytest.param(160, torch.bfloat16, "bilstm_fwd_wide_mma",
                     id="160-dtype13-bilstm_fwd_wide"),
        # f32 at 160-224: the f32 tensor-core forward's instances for 2 / 3, 3
        # and 3 / 4 unit groups a block (id kept from the cluster kernel's case)
        pytest.param(224, torch.float32, "bilstm_fwd_wide_f32", id="224-dtype14-bilstm_fwd_wide"),
        (160, torch.float32, "bilstm_fwd_wide_f32"),
        (192, torch.float32, "bilstm_fwd_wide_f32"),
        (224, torch.bfloat16, "bilstm_fwd_wide_mma"),
    ],
)
def test_wide_fwd_kernel_by_width_and_dtype(H, dtype, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="; bilstm_fwd_wide_mma kernel takes bfloat16"):
            lstm_cuda.wide_fwd_kernel(H, dtype)
        return
    assert lstm_cuda.wide_fwd_kernel(H, dtype) == kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_forward_and_f32_wgrad_dispatch_change_no_route(dtype):
    """The wide-forward and weight-gradient dispatches pick kernels inside
    a route and never move a layer between routes, over the sweep of
    ``test_tensor_core_wide_kernels_change_no_route``: every (E_parts, H)
    keeps its route, every wide layer has a forward kernel (the tensor-core
    one in bf16 at H = 128, 256 and 288 and in f32 at 128-288, the one-block
    ones in bf16 and f32 at 96),
    and every layer takes a tensor-core wgrad: in f32 every layer with
    H % 16 == 0 (64-row gate tiles at H % 32 == 16), in bf16 every layer
    with H % 8 == 0 (the masked last gate tile); none keeps
    ``bilstm_wgrad.cu``. Each at the layer's padded shape, where every
    layer has a weight-gradient kernel."""
    bf16 = dtype == torch.bfloat16
    for H0 in range(8, 272, 8):
        for E_parts in ([8], [16], [32], [48], [64], [96], [128], [256], [512],
                        [32, 32], [64, 64], [128, 128], [256, 256]):
            route, H, Ep = _route_and_width(E_parts, H0, dtype)
            assert route == _route_without_the_wide_dispatch(E_parts, H0, dtype), (E_parts, H0)
            if route is None:
                continue
            if route == "wide":
                assert lstm_cuda.wide_fwd_kernel(H, dtype) == (
                    "bilstm_fwd_wide_mma_resident" if (H, bf16) == (96, True)
                    else "bilstm_fwd_wide_f32_resident" if H == 96
                    else "bilstm_fwd_wide_f32" if not bf16 else "bilstm_fwd_wide_mma")
            wgrad = lstm_cuda.wgrad_kernel(Ep, H, dtype)
            assert H % (8 if bf16 else 16) == 0, (E_parts, H)
            assert wgrad == ("bilstm_wgrad_mma" if bf16 else "bilstm_wgrad_f32"), (E_parts, H)
    for E_parts in ([256], [256, 256]):
        assert lstm_cuda.layer_route(E_parts, 256, dtype) == "wide"


def test_fwd_wide_mma_plan_fills_the_card_in_fewest_waves():
    """The tensor-core wide forward's shared memory per row tile, and its
    plan at the scaled train shapes with 15 clusters on the card at once:
    400 rows in 5 groups of 80 (layer 0) and in 1 group (the stacked
    layers)."""
    fifteen = lambda R, smem: 15  # noqa: E731
    # H = 256, 80-row tile: the bf16 W_hh slice (128 permuted gate rows of
    # 256 + 8), two bf16 h tiles (80 rows of 256 + 8), the staged new h and
    # c of the block's 32 units (80 rows of 32 + 8 each)
    assert lstm_cuda.wide_smem("fwd_mma", 256, 80) == (
        128 * 264 * 2 + 2 * 80 * 264 * 2 + 2 * 80 * 40 * 2) == 164864
    assert lstm_cuda.wide_smem("fwd_mma", 128, 80) == (
        64 * 136 * 2 + 2 * 80 * 136 * 2 + 2 * 80 * 24 * 2) == 68608
    for H in lstm_cuda.FWD_WIDE_MMA_WIDTHS:
        assert all(lstm_cuda.wide_smem("fwd_mma", H, r) <= lstm_cuda.SMEM_LIMIT
                   for r in lstm_cuda.FWD_WIDE_MMA_ROWS)
    assert all(r % 8 == 0 for r in lstm_cuda.FWD_WIDE_MMA_ROWS)
    # G = 5: one 80-row tile a group, 10 clusters, one wave (64-row tiles
    # would make two a group, 20 clusters)
    assert lstm_cuda.wide_plan("fwd_mma", 400, 5, 256, fifteen) == (80, 5, 164864)
    # G = 1: 64-row tiles make 7 tiles, 14 clusters: the smallest tile of one wave
    assert lstm_cuda.wide_plan("fwd_mma", 400, 1, 256, fifteen) == (64, 7, 145408)
    # a card that holds 8 clusters: 80-row tiles still take the fewest waves
    assert lstm_cuda.wide_plan("fwd_mma", 400, 5, 256, lambda R, smem: 8)[:2] == (80, 5)
    # a small batch: the smallest tile of the one wave
    assert lstm_cuda.wide_plan("fwd_mma", 40, 1, 256, fifteen)[:2] == (16, 3)
    assert lstm_cuda.wide_plan("fwd_mma", 400, 5, 128, fifteen)[:2] == (80, 5)
    # the H100's 132 SMs in clusters of 8 hold 15 clusters of one block an SM
    # and 30 of the tiles compiled for two (shared memory for two blocks an
    # SM): the 32-row tiles put both layer shapes in one wave
    h100 = lambda R, smem: 30 if 2 * (smem + 1024) <= 233472 else 15  # noqa: E731
    assert lstm_cuda.wide_plan("fwd_mma", 400, 5, 256, h100) == (32, 15, 106496)
    assert lstm_cuda.wide_plan("fwd_mma", 400, 1, 256, h100)[:2] == (32, 13)


def test_fwd_wide_mma_plan_at_288():
    """The tensor-core wide forward at H = 288 (36 unit groups, 4 or 5 a
    block): its shared memory by row tile, as the uneven instance lays it
    out (the bf16 W_hh slice of the 5-group block, 160 permuted gate rows
    of 288 + 8; two bf16 h tiles of 288 + 8; the staged new h and c of 40
    units + 8): one block an SM at every tile. It is built for tiles of at
    most 4 items a warp (16, 32 and 40 rows), though 64 and 80 would fit
    shared memory. At the train step's 400 rows in 5 groups and in 1, with
    15 or 16 clusters on the card at once, 32- and 40-row tiles both take
    two waves (30 and 26 clusters; 20 and 20), and the plan takes the
    smaller; a small batch takes 16 rows. Its check takes bf16 at 288, not
    f32."""
    assert lstm_cuda.wide_smem("fwd_mma", 288, 32) == (
        160 * 296 * 2 + 2 * 32 * 296 * 2 + 2 * 32 * 48 * 2) == 138752
    assert lstm_cuda.FWD_WIDE_MMA_UNEVEN_ROWS == (16, 32, 40)
    assert [lstm_cuda.wide_smem("fwd_mma", 288, r) for r in lstm_cuda.FWD_WIDE_MMA_ROWS] == [
        116736, 138752, 149760, 182784, 204800]
    assert all(lstm_cuda.SMEM_LIMIT >= lstm_cuda.wide_smem("fwd_mma", 288, r) > 115712
               for r in lstm_cuda.FWD_WIDE_MMA_ROWS)  # none fits two blocks an SM
    for clusters in (15, 16):
        assert lstm_cuda.wide_plan("fwd_mma", 400, 5, 288, lambda R, s: clusters) == (
            32, 15, 138752)
        assert lstm_cuda.wide_plan("fwd_mma", 400, 1, 288, lambda R, s: clusters) == (
            32, 13, 138752)
    # the even widths keep every tile
    assert lstm_cuda.wide_plan("fwd_mma", 400, 5, 256, lambda R, s: 15)[0] == 80
    assert lstm_cuda.wide_plan("fwd_mma", 40, 1, 288, lambda R, s: 15)[:2] == (16, 3)
    # the even widths keep their shared memory
    assert lstm_cuda.wide_smem("fwd_mma", 256, 80) == 164864
    assert lstm_cuda.wide_smem("fwd_mma", 128, 80) == 68608
    lstm_cuda.fwd_wide_mma_check(288, torch.bfloat16)
    for H, dtype in ((288, torch.float32), (320, torch.bfloat16), (64, torch.bfloat16),
                     (96, torch.bfloat16)):
        with pytest.raises(ValueError, match="bilstm_fwd_wide_mma kernel takes bfloat16"):
            lstm_cuda.fwd_wide_mma_check(H, dtype)


def test_new_tensor_core_wrappers_take_plain_versions_on_cpu():
    """On the CPU the tensor-core sweep at E = H = 80 and the wide forward at
    H = 288 (both variants) run their plain twins, bit for bit, and launch
    nothing; the CUDA-core sweep and the tensor-core forward asked for by
    name do the same."""
    cpu, cd = torch.device("cpu"), torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 10, [80], 80, 2, cd, cpu)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn,
            cd)
    wrappers = (lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_mma, lstm_cuda.bilstm_fwd_wide_mma,
                lstm_cuda.bilstm_fwd_wide_train_mma)
    before = [f.launches for f in wrappers]
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    want = flat(bidir_layer_sweep(*args))
    for got in (lstm_cuda.bilstm_bwd_mma(*args), lstm_cuda.bilstm_bwd(*args),
                lstm_cuda.bilstm_bwd(*args, kernel="bilstm_bwd")):
        assert all(torch.equal(a, b) for a, b in zip(flat(got), want))
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(3, 10, [16], 288, 5, cd, cpu)
    xg = input_gates(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    for got in (lstm_cuda.bilstm_fwd_wide_train_mma(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd,
                                                kernel="bilstm_fwd_wide_mma")):
        assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    for got in (lstm_cuda.bilstm_fwd_wide_mma(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide_mma")):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want[:4]))
    assert [f.launches for f in wrappers] == before


@pytest.mark.parametrize("T,B,G,E_parts,H,want", [
    (1500, 400, 5, [64], 64, (2, 1, 33)), (1500, 400, 1, [64, 64], 64, (2, 2, 33)),
    (1500, 400, 5, [256], 256, (8, 4, 2)), (1500, 400, 1, [256, 256], 256, (8, 6, 11)),
    (3, 400, 4, [64], 64, (2, 1, 8)), (1, 27, 3, [32, 32], 32, (1, 1, 1))])
def test_wgrad_f32_plan_fills_whole_waves(T, B, G, E_parts, H, want):
    """The f32 tensor-core wgrad takes the bf16 kernel's tiles and, one block
    an SM on 132 SMs, the split with the fewest waves per share of the rows
    among at most WGRAD_F32_MAX_WAVES waves of blocks and no more splits
    than 32-row K-tiles (the manuscript's layer 0: 33 splits of 20 blocks,
    five whole waves, where the bf16 plan's 27 would leave a fifth wave of
    12 blocks); at T = 3 more splits than positions."""
    from fractions import Fraction

    got = lstm_cuda.wgrad_f32_plan(T, B, G, E_parts, H, 132)
    assert got == want
    m_tiles, n_tiles, splits = got
    assert (m_tiles, n_tiles) == lstm_cuda.wgrad_mma_plan(T, B, G, E_parts, H)[:2]
    per_split = m_tiles * n_tiles * 2 * G
    most = min(-(-T * (B // G) // lstm_cuda.WGRAD_MMA_TILE_K),
               lstm_cuda.WGRAD_F32_MAX_WAVES * 132 // per_split)
    assert 1 <= splits <= max(1, most)

    def cost(s):
        return Fraction(-(-per_split * s // 132), s)

    assert all(cost(splits) <= cost(s) for s in range(1, most + 1))
    # one block an SM: its shared memory alone leaves no room for a second
    assert lstm_cuda.WGRAD_F32_SMEM > lstm_cuda.SMEM_LIMIT // 2


def test_wide_forward_mma_and_wgrad_f32_wrappers_take_plain_versions_on_cpu():
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(6, 4, [128], 128, 2, cd,
                                                          torch.device("cpu"))
    wrappers = (lstm_cuda.bilstm_fwd_wide_mma, lstm_cuda.bilstm_fwd_wide_train_mma,
                lstm_cuda.bilstm_wgrad, lstm_cuda.bilstm_wgrad_f32)
    before = [f.launches for f in wrappers]
    xg = input_gates(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    for got in (lstm_cuda.bilstm_fwd_wide_train_mma(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)):
        assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    for got in (lstm_cuda.bilstm_fwd_wide_mma(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want[:4]))
    f32 = layer_case(5, 6, [32, 32], 32, 2, torch.float32, torch.device("cpu"))
    parts32 = f32[0]
    hs_f, hs_b = bidir_layer(*f32[:5], torch.float32)[:2]
    dgc = torch.rand(2, 5, 6, 128, generator=torch.Generator().manual_seed(1)) * 2 - 1
    ref = bidir_layer_wgrad(dgc, parts32, hs_f, hs_b, 2)
    for got in (lstm_cuda.bilstm_wgrad_f32(dgc, parts32, hs_f, hs_b, 2),
                lstm_cuda.bilstm_wgrad(dgc, parts32, hs_f, hs_b, 2)):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_fwd_wide_mma(xg.clone().requires_grad_(), lengths, w_hh, cd)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_fwd_wide_train_mma(xg, lengths, w_hh.clone().requires_grad_(), cd)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_wgrad_f32(dgc.clone().requires_grad_(), parts32, hs_f, hs_b, 2)
    with torch.no_grad():
        lstm_cuda.bilstm_fwd_wide_mma(xg.clone().requires_grad_(), lengths, w_hh, cd)
        lstm_cuda.bilstm_wgrad_f32(dgc.clone().requires_grad_(), parts32, hs_f, hs_b, 2)


# -------- the f32 tensor-core input gates and wide forward (three tf32 passes)
@pytest.mark.parametrize("H", [96, 128, 160, 192, 224, 256, 288])
@pytest.mark.parametrize("parts", [1, 2])
def test_gates_kernel_takes_f32_on_the_tensor_cores_at_every_wide_width(H, parts):
    """Every f32 shape ``wide_check`` admits past the resident widths takes
    the f32 tensor-core gates, one input part or two (the stacked layers);
    bf16 keeps its own; ``bilstm_gates.cu`` is reached by name only."""
    E_parts = [H] * parts
    assert lstm_cuda.gates_kernel(E_parts, H, torch.float32) == "bilstm_gates_f32"
    assert lstm_cuda.gates_kernel(E_parts, H, torch.bfloat16) == "bilstm_gates_mma"
    assert lstm_cuda.gates_kernel([16] * parts, H, torch.float32) == "bilstm_gates_f32"


@pytest.mark.parametrize("H,kernel", [
    # 96: the one-block forward (id kept from the CUDA-core forward's case)
    pytest.param(96, "bilstm_fwd_wide_f32_resident", id="96-bilstm_fwd_wide"),
    (128, "bilstm_fwd_wide_f32"),
    # 160-224: the instances for 2 / 3, 3 and 3 / 4 unit groups a block (ids
    # kept from the CUDA-core forward's cases)
    pytest.param(160, "bilstm_fwd_wide_f32", id="160-bilstm_fwd_wide"),
    pytest.param(192, "bilstm_fwd_wide_f32", id="192-bilstm_fwd_wide"),
    pytest.param(224, "bilstm_fwd_wide_f32", id="224-bilstm_fwd_wide"),
    (256, "bilstm_fwd_wide_f32"), (288, "bilstm_fwd_wide_f32")])
def test_wide_fwd_kernel_takes_f32_at_the_tensor_core_widths(H, kernel):
    """The f32 wide forward runs on the tensor cores at the widths of the
    f32 lite sweep (128-288), and at 96 on the one-block tensor-core
    forward. Its check refuses bf16 and the other widths."""
    assert lstm_cuda.wide_fwd_kernel(H, torch.float32) == kernel
    assert (kernel == "bilstm_fwd_wide_f32") == (H in lstm_cuda.FWD_WIDE_F32_WIDTHS)
    if kernel == "bilstm_fwd_wide_f32":
        lstm_cuda.fwd_wide_f32_check(H, torch.float32)
        with pytest.raises(ValueError, match="bilstm_fwd_wide_f32 kernel takes float32"):
            lstm_cuda.fwd_wide_f32_check(H, torch.bfloat16)
    else:
        with pytest.raises(ValueError, match="bilstm_fwd_wide_f32 kernel takes float32"):
            lstm_cuda.fwd_wide_f32_check(H, torch.float32)


@pytest.mark.parametrize("H", [128, 160, 192, 224, 256, 288])
def test_fwd_wide_f32_smem_and_plan(H):
    """The f32 tensor-core forward's shared memory by row tile
    (csrc/bilstm_fwd_wide_f32.cu:smem_bytes): two f32 h tiles of rows of
    H + 16 and the staged new h (8 units a group of the block with the most
    unit groups + 16 a row); its weights are read from L2. Its row tiles
    are 16 and 32 at 128-256 (every unit group two warps or more) and 16 at
    288; others are refused. The plan picks, at the train shape and small
    ones, one of them under SMEM_LIMIT, and whole row tiles of each weight
    group; at 288 it takes 16-row tiles, even where 32 would fit one wave;
    at 160-224 it takes 32-row tiles at the train shape (50,176 / 58,368 /
    67,584 bytes, two blocks an SM: one wave of 30 clusters)."""
    groups = -(-H // 64)
    rows = lstm_cuda.fwd_wide_f32_rows(H)
    assert rows == ((16, 32) if H <= 256 else (16,))
    for R in rows:
        assert lstm_cuda.wide_smem("fwd_f32", H, R) == (
            2 * R * (H + 16) * 4 + R * (8 * groups + 16) * 4)
    if H in (160, 192, 224):
        assert lstm_cuda.wide_plan("fwd_f32", 400, 5, H, lambda r, sm: 30) == (
            32, 15, {160: 50176, 192: 58368, 224: 67584}[H])
        assert 2 * (lstm_cuda.wide_smem("fwd_f32", H, 32) + 1024) <= 233472
    for R in (40,) + ((32,) if H > 256 else ()):
        with pytest.raises(ValueError, match=f"no instance for a row tile of {R} at H={H}"):
            lstm_cuda.wide_smem("fwd_f32", H, R)
    with pytest.raises(ValueError, match="bilstm_fwd_wide_f32 kernel takes float32"):
        lstm_cuda.wide_smem("fwd_f32", 96, 16)
    if H == 288:
        assert lstm_cuda.wide_plan("fwd_f32", 400, 5, 288, lambda r, sm: 30)[:2] == (16, 25)
    for B, G, clusters in ((400, 5, 15), (400, 1, 30), (27, 3, 15), (8, 1, 33)):
        R, tiles, smem = lstm_cuda.wide_plan("fwd_f32", B, G, H, lambda r, sm: clusters)
        assert smem <= lstm_cuda.SMEM_LIMIT and R in rows
        assert tiles == G * -(-(B // G) // R)
        assert smem == lstm_cuda.wide_smem("fwd_f32", H, R)


def test_f32_tensor_core_wide_wrappers_take_plain_versions_on_cpu():
    """On the CPU the f32 tensor-core gates and wide forward (both variants)
    run their plain twins bit for bit and launch
    nothing; so does the dispatch, and so does the forward named. They
    refuse bf16 and, under grad mode, operands that require grad."""
    cpu, cd = torch.device("cpu"), torch.float32
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 10, [16, 32], 288, 5, cd, cpu)
    wrappers = (lstm_cuda.bilstm_gates_f32, lstm_cuda.bilstm_fwd_wide_f32,
                lstm_cuda.bilstm_fwd_wide_train_f32)
    before = [f.launches for f in wrappers]
    want_xg = input_gates(parts, w_ih, bias, cd)
    for got in (lstm_cuda.bilstm_gates_f32(parts, w_ih, bias, cd),
                lstm_cuda.bilstm_gates(parts, w_ih, bias, cd)):
        assert torch.equal(got, want_xg)
    xg = want_xg
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    got = lstm_cuda.bilstm_fwd_wide_train_f32(xg, lengths, w_hh, cd)
    assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    got = lstm_cuda.bilstm_fwd_wide_f32(xg, lengths, w_hh, cd)
    assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want[:4]))
    for got in (lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd,
                                                kernel="bilstm_fwd_wide_f32")):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [f.launches for f in wrappers] == before
    bf16 = torch.bfloat16
    with pytest.raises(ValueError, match="bilstm_gates_f32 kernel takes torch.float32"):
        lstm_cuda.bilstm_gates_f32(tuple(p.to(bf16) for p in parts), w_ih.to(bf16), bias, bf16)
    with pytest.raises(ValueError, match="bilstm_gates_mma kernel takes torch.bfloat16"):
        lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    for fn in (lstm_cuda.bilstm_fwd_wide_f32, lstm_cuda.bilstm_fwd_wide_train_f32):
        with pytest.raises(ValueError, match="bilstm_fwd_wide_f32 kernel takes float32"):
            fn(xg, lengths, w_hh.to(bf16), bf16)
        with pytest.raises(RuntimeError, match="no autograd graph"):
            fn(xg.clone().requires_grad_(), lengths, w_hh, cd)
        with pytest.raises(RuntimeError, match="no autograd graph"):
            fn(xg, lengths, w_hh.clone().requires_grad_(), cd)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_gates_f32(parts, w_ih.clone().requires_grad_(), bias, cd)
    with torch.no_grad():
        lstm_cuda.bilstm_gates_f32(parts, w_ih.clone().requires_grad_(), bias, cd)
        lstm_cuda.bilstm_fwd_wide_f32(xg.clone().requires_grad_(), lengths, w_hh, cd)


# ---- the f32 forward at H = 80 and the one-block f32 lite sweep at H = 96
def test_f32_forward_takes_80_in_8_row_tiles():
    """Layer 0 of the model at embedding 80 in f32 (E = H = 80) takes the f32
    tensor-core forward in its 320-thread instances: 8-row tiles only (the
    weights, 320 rows of stride 168, and two 8-row stages take 225,792
    bytes; 16 rows would take 236,544), at every batch; at the train step's
    400 rows in 5 groups 100 blocks. bf16 takes the tensor-core forward's
    <80, 80> instance there, the f32 sweep its one-stage kernel, and E past
    80 at H = 80 does not fit."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert lstm_cuda.fwd_kernel([80], 80, f32) == "bilstm_fwd_f32"
    assert lstm_cuda.fwd_f32_plan([80], 80, f32, 8) == (320, (320 + 16) * 168 * 4) == (
        320, 225792)
    with pytest.raises(ValueError, match="236544 bytes of shared memory"):
        lstm_cuda.fwd_f32_plan([80], 80, f32, 16)
    for B, G in ((400, 5), (800, 1), (27, 3)):
        assert lstm_cuda.fwd_f32_rows([80], 80, B, G, 132) == 8
    assert 2 * lstm_cuda.mma_tiles(400, 5) == 100
    assert lstm_cuda.FWD_F32_MAX_H == 80 and lstm_cuda.FWD_F32_MAX_THREADS == 4 * 80
    assert lstm_cuda.fwd_kernel([80], 80, bf16) == "bilstm_fwd_mma"
    assert lstm_cuda.sweep_kernel([80], 80, f32) == "bilstm_bwd_f32_onestage"
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.fwd_f32_plan([80], 96, f32)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        lstm_cuda.fwd_f32_plan([88], 80, f32)


def test_lite_f32_resident_plan_and_dispatch():
    """The f32 lite sweep at H = 96 (the stacked layer of the model at
    embedding 80, run at 96) takes the one-block sweep with W_hh resident:
    12 warps; shared memory for the f32 weights (384 rows of stride 104),
    the dgates tile (8 rows of 388), two h_prev stages and the warp pairs'
    exchange: 181,888 bytes, one block an SM; 8-row tiles make 100 blocks at
    400 rows in one group. At 112 the weights alone would not fit. f32 at
    160, 192 and 224 takes the f32 tensor-core (cluster) sweep; bf16 at 96
    takes the one-block bf16 sweep."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert lstm_cuda.lite_kernel(96, f32) == "bilstm_bwd_lite_f32_resident"
    threads, smem = lstm_cuda.lite_f32_resident_plan(96, f32)
    assert threads == 384
    assert smem == (384 * 104 + 8 * 388 + 2 * 8 * 104 + 12 * 64) * 4 == 181888
    assert smem <= lstm_cuda.SMEM_LIMIT < 2 * smem
    assert 4 * 112 * (128 + 8) * 4 > lstm_cuda.SMEM_LIMIT
    assert 2 * lstm_cuda.mma_tiles(400, 1) == 100
    for H in (160, 192, 224):
        assert lstm_cuda.lite_kernel(H, f32) == "bilstm_bwd_lite_f32"
    assert lstm_cuda.lite_kernel(96, bf16) == "bilstm_bwd_lite_mma_resident"
    for H, dtype in ((96, bf16), (128, f32), (160, f32), (64, f32)):
        with pytest.raises(ValueError, match="bilstm_bwd_lite_f32_resident kernel takes float32"):
            lstm_cuda.lite_f32_resident_plan(H, dtype)
    assert lstm_cuda.layer_route([80, 80], 80, f32) == "wide"
    assert lstm_cuda.padded_width([80, 80], 80, f32) == 96


@pytest.mark.parametrize("ny", [0, 1, 2])
def test_lite_f32_resident_wrapper_takes_plain_version_on_cpu(ny):
    """On the CPU the one-block f32 lite sweep and the dispatch at H = 96
    run the plain twin bit for bit and launch nothing; under grad mode the
    wrapper refuses an operand that requires grad."""
    cpu, cd, H = torch.device("cpu"), torch.float32, 96
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(5, 6, [32, 32], H, 1, cd, cpu)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny], dhn, dcn, cd)
    wrappers = (lstm_cuda.bilstm_bwd_lite_f32_resident,)
    before = [f.launches for f in wrappers]
    want = bidir_layer_sweep_lite(*args)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite_f32_resident(*args), want)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite(*args), want)
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_bwd_lite_f32_resident(xg.clone().requires_grad_(), *args[1:])
    with torch.no_grad():
        lstm_cuda.bilstm_bwd_lite_f32_resident(xg.clone().requires_grad_(), *args[1:])


# ---- the bf16 forward at E = H = 80, 72 and the one-block bf16 lite sweep at 96
def test_fwd_mma_plan_at_80_and_72():
    """Layer 0 of the bf16 two-layer models at embedding 80 and 72 (E = H)
    takes the tensor-core forward's <80, 80> and <72, 72> instances: one
    warp per 8 units, 320 and 288 threads (past the 256 of the instances up
    to 64; ``FWD_MMA_MAX_THREADS``); the three-stage ring of 8-row [x ; h]
    tiles, 8 x (160 + 8) x 2 x 3 = 8,064 bytes and 8 x (144 + 8) x 2 x 3 =
    7,296; K = 160 in ten k16 steps and 144 in nine; 100 blocks at the
    train step's 400 rows in 5 groups. It takes them only where
    ``bilstm_fwd.cu`` took them, and no other width past 64 (nor a shape up
    to 64 it has no instance for)."""
    bf16 = torch.bfloat16
    assert lstm_cuda.fwd_mma_plan([80], 80, bf16) == (320, 8 * 168 * 2 * 3) == (320, 8064)
    assert lstm_cuda.fwd_mma_plan([40, 40], 80, bf16) == (320, 8064)
    assert lstm_cuda.fwd_mma_plan([72], 72, bf16) == (288, 8 * 152 * 2 * 3) == (288, 7296)
    assert lstm_cuda.FWD_MMA_MAX_THREADS == 320 and (80 + 80) % 16 == (72 + 72) % 16 == 0
    assert 2 * lstm_cuda.mma_tiles(400, 5) == 100
    for E_parts, H in (([80], 80), ([40, 40], 80), ([72], 72)):
        _cuda_core_fwd_plan(E_parts, H, bf16)
        assert lstm_cuda.fwd_kernel(E_parts, H, bf16) == "bilstm_fwd_mma"
    for E_parts, H in (([72], 80), ([80], 72), ([96], 96), ([48], 56), ([160], 80)):
        with pytest.raises(ValueError, match="bilstm_fwd_mma kernel takes bfloat16"):
            lstm_cuda.fwd_mma_plan(E_parts, H, bf16)
    with pytest.raises(ValueError, match="bilstm_fwd_mma kernel takes bfloat16"):
        lstm_cuda.fwd_mma_plan([80], 80, torch.float32)
    # the sweep beside it on both models: the tensor-core one's own instances
    assert lstm_cuda.sweep_kernel([80], 80, bf16) == lstm_cuda.sweep_kernel([72], 72, bf16) == (
        "bilstm_bwd_mma")


def test_lite_mma_resident_plan_and_dispatch():
    """The bf16 lite sweep at H = 96 (the stacked layer of the bf16 models
    at embedding 80 and 72, run at 96) takes the one-block bf16 sweep:
    12 warps; shared memory for the bf16 weights (384 rows of stride 104),
    the dgates tile in f32 (8 rows of 388) and in bf16 (8 rows of 392),
    three ring stages of the step tiles (8 rows each of h_prev, c_prev and
    two dy streams at stride 104 in bf16 and of xg at 388 in f32: 19,072
    bytes) and the warp pairs' exchange: 158,848 bytes; 1152 tile chunks a
    step at most, 3 a thread; 100 blocks at 400 rows in one group. f32 at
    96 keeps its own one-block sweep; at 160, 192 and 224 each dtype takes
    its tensor-core sweep."""
    f32, bf16 = torch.float32, torch.bfloat16
    threads, smem = lstm_cuda.lite_mma_resident_plan(96, bf16)
    assert threads == 384 == 4 * 96
    stage = 4 * 8 * 104 * 2 + 8 * 388 * 4
    assert stage == 19072 and 8 * (4 * 12 + 96) == 3 * threads
    assert smem == (384 * 104 * 2 + 8 * 388 * 4 + 8 * 392 * 2 + 3 * stage
                    + 12 * 64 * 4) == 158848 <= lstm_cuda.SMEM_LIMIT
    assert lstm_cuda.LITE_MMA_RESIDENT_WIDTHS == (96,)
    assert lstm_cuda.lite_kernel(96, bf16) == "bilstm_bwd_lite_mma_resident"
    assert lstm_cuda.lite_kernel(96, f32) == "bilstm_bwd_lite_f32_resident"
    for H in (160, 192, 224):
        assert lstm_cuda.lite_kernel(H, bf16) == "bilstm_bwd_lite_mma"
        assert lstm_cuda.lite_kernel(H, f32) == "bilstm_bwd_lite_f32"
    for H, dtype in ((96, f32), (128, bf16), (160, bf16), (64, bf16), (80, bf16)):
        with pytest.raises(ValueError, match="bilstm_bwd_lite_mma_resident kernel takes bfloat16"):
            lstm_cuda.lite_mma_resident_plan(H, dtype)
    for E_parts, H in (([80, 80], 80), ([72, 72], 72)):
        assert lstm_cuda.layer_route(E_parts, H, bf16) == "wide"
        assert lstm_cuda.padded_width(E_parts, H, bf16) == 96
        assert lstm_cuda.padded_parts(E_parts, H, bf16) == (80, 80)


@pytest.mark.parametrize("ny", [0, 1, 2])
def test_lite_mma_resident_wrapper_takes_plain_version_on_cpu(ny):
    """On the CPU the one-block bf16 lite sweep and the dispatch at H = 96
    run the plain twin bit for bit and launch nothing; under grad mode the
    wrapper refuses an operand that requires grad."""
    cpu, cd, H = torch.device("cpu"), torch.bfloat16, 96
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(5, 6, [32, 32], H, 1, cd, cpu)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny], dhn, dcn, cd)
    wrappers = (lstm_cuda.bilstm_bwd_lite_mma_resident,)
    before = [f.launches for f in wrappers]
    want = bidir_layer_sweep_lite(*args)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite_mma_resident(*args), want)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite(*args), want)
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_bwd_lite_mma_resident(xg.clone().requires_grad_(), *args[1:])
    with torch.no_grad():
        lstm_cuda.bilstm_bwd_lite_mma_resident(xg.clone().requires_grad_(), *args[1:])


@pytest.mark.parametrize("E_parts,H", [([80], 80), ([40, 40], 80), ([72], 72)])
def test_fwd_mma_wrappers_at_80_and_72_take_plain_versions_on_cpu(E_parts, H):
    """On the CPU the tensor-core forward at E = H = 80 and 72 and the
    dispatch (both variants) run the plain twin bit for bit and launch
    nothing."""
    cpu, cd = torch.device("cpu"), torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(5, 12, E_parts, H, 3, cd, cpu)
    args = (parts, lengths, w_ih, w_hh, bias, cd)
    want = bidir_layer(*args, with_states=True)
    wrappers = (lstm_cuda.bilstm_layer_fwd, lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_layer_fwd_mma, lstm_cuda.bilstm_layer_fwd_train_mma)
    before = [f.launches for f in wrappers]
    for got in (lstm_cuda.bilstm_layer_fwd_train_mma(*args),
                lstm_cuda.bilstm_layer_fwd_train(*args)):
        assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    for got in (lstm_cuda.bilstm_layer_fwd_mma(*args), lstm_cuda.bilstm_layer_fwd(*args)):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert [f.launches for f in wrappers] == before


# ------ the f32 lite sweep at 160-224 and the one-block bf16 wide forward at 96
def _lite_f32_deal(H, rank, BR):
    """The item deal in block ``rank`` of the cluster at a row tile of BR
    (``csrc/lstm_recurrence_wide_mma.cuh:deal_items``, which the f32 and
    bf16 lite sweeps and the f32 wide forward share): each warp's gate
    items (its unit group and n8 tiles) and its m16 tiles of the dh
    product, by the kernel's arithmetic."""
    n, warps, NT = H // 8, 8, BR // 8
    UG = (rank + 1) * n // 8 - rank * n // 8
    items, w = [], 0
    for q in range(UG):
        m = warps // UG + (q < warps % UG)
        for k in range(m):
            items.append((q, (k + 1) * NT // m - k * NT // m))
            w += 1
    ni = [c for _, c in items]
    rank_of = [sum(ni[x] < ni[w] or (ni[x] == ni[w] and x < w) for x in range(warps))
               for w in range(warps)]
    dh = [len(range(r, H // 16, warps)) for r in rank_of]
    return UG, items, dh


@pytest.mark.parametrize("H", [160, 192, 224])
def test_lite_f32_at_160_to_224_plan_and_dispatch(H):
    """The f32 lite sweep at 160, 192 and 224 (layer 0 of the f32 models at
    embedding 160-224, and the stacked layers run there) takes the f32
    tensor-core sweep: its instance for 3 groups a block at 160 and 192
    (``max_block_groups``), the 256 one's 4 at 224. The deal, as the
    kernel computes it, in every block and row tile: the unit groups split
    2 / 3, 3 and 3 / 4 a block; every warp's items lie in one group and are
    at most GI = ceil(NT / (8 // MG)) (two at 32-row tiles), every n8 tile
    of every group is taken once; the dh product's H / 16 m16 tiles are
    dealt once each, two to a warp at most, and its extra tiles go to the
    warps with the fewest gate items (at 192: warps 0, 1, 3 and 4, one item
    each). bf16 takes the bf16 tensor-core sweep on the same deal there; no
    layer changes route."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert lstm_cuda.lite_kernel(H, f32) == "bilstm_bwd_lite_f32"
    assert lstm_cuda.lite_kernel(H, bf16) == "bilstm_bwd_lite_mma"
    MG = -(-H // 64)
    assert MG == (3 if H < 224 else 4)
    groups = set()
    for BR in lstm_cuda.LITE_F32_ROWS:
        NT, GI = BR // 8, -(-(BR // 8) // (8 // MG))
        for rank in range(8):
            UG, items, dh = _lite_f32_deal(H, rank, BR)
            assert len(items) == 8 and UG <= MG
            groups.add(UG)
            assert max(c for _, c in items) <= GI <= 2
            assert [sum(c for q2, c in items if q2 == q) for q in range(UG)] == [NT] * UG
            assert sum(dh) == H // 16 and max(dh) <= 2
            if BR == 32:
                most = max(c for _, c in items)
                fewest = min(c for _, c in items)
                extra = {w for w in range(8) if dh[w] == 2}
                # the extra dh tiles go to the warps with the fewest items first
                light = {w for w in range(8) if items[w][1] == fewest}
                assert light <= extra if len(extra) >= len(light) else extra <= light
                if H == 192:
                    assert extra == {0, 1, 3, 4} and most == 2
                    assert all(items[w][1] == 1 for w in extra)
    assert groups == {160: {2, 3}, 192: {3}, 224: {3, 4}}[H]
    for E_parts in ([H], [H, H]):
        assert lstm_cuda.layer_route(E_parts, H, f32) == "wide"
        assert lstm_cuda.padded_width(E_parts, H, f32) == H


def test_lite_f32_deal_at_the_older_widths_is_the_warps_own_order():
    """At 128, 256 and 288 the dh product's warp order (by gate items) is
    the warps' own, so the f32 lite sweep's schedule there is unchanged:
    the dh product's extra m16 tiles stay on warps 0 and 1 at 288."""
    for H in (128, 256, 288):
        for rank in range(8):
            for BR in lstm_cuda.LITE_F32_ROWS:
                _, items, dh = _lite_f32_deal(H, rank, BR)
                want = [len(range(w, H // 16, 8)) for w in range(8)]
                assert dh == want, (H, rank, BR)


def test_fwd_wide_mma_resident_plan_and_dispatch():
    """The bf16 wide forward at H = 96 (the stacked layer of the bf16 models
    at embedding 80 and 72, run at 96) takes the one-block tensor-core
    forward: 12 warps, one per 8 units, 384 threads; the weights in
    registers (2 m16 tiles x 6 k16 steps x 4 = 48 a thread); shared memory
    for two bf16 h tiles (8 rows of 104) and five ring stages of the f32 xg
    tile (8 rows of 388): 3,328 + 62,080 = 65,408 bytes; 100 blocks at 400
    rows in one group. f32 at 96 keeps the CUDA-core cluster kernel (160-224
    take the tensor-core ones, f32 and bf16); no layer changes route or
    padded shape."""
    f32, bf16 = torch.float32, torch.bfloat16
    threads, smem = lstm_cuda.fwd_wide_mma_resident_plan(96, bf16)
    assert threads == 384 == 4 * 96 and 2 * 4 * 6 * 4 // 4 == 48
    assert smem == 2 * 8 * 104 * 2 + 5 * 8 * 388 * 4 == 65408 <= lstm_cuda.SMEM_LIMIT
    assert 8 * 4 * 96 == 2 * threads * 4  # two 16-byte xg chunks a thread a step
    assert lstm_cuda.FWD_WIDE_MMA_RESIDENT_WIDTHS == (96,)
    assert 2 * lstm_cuda.mma_tiles(400, 1) == 100
    assert lstm_cuda.wide_fwd_kernel(96, bf16) == "bilstm_fwd_wide_mma_resident"
    assert lstm_cuda.wide_fwd_kernel(96, f32) == "bilstm_fwd_wide_f32_resident"
    for H in (160, 192, 224):
        assert lstm_cuda.wide_fwd_kernel(H, f32) == "bilstm_fwd_wide_f32"
        assert lstm_cuda.wide_fwd_kernel(H, bf16) == "bilstm_fwd_wide_mma"
    for H, dtype in ((96, f32), (128, bf16), (160, bf16), (64, bf16), (80, bf16)):
        with pytest.raises(ValueError, match="bilstm_fwd_wide_mma_resident kernel takes bfloat16"):
            lstm_cuda.fwd_wide_mma_resident_plan(H, dtype)
    for E_parts, H in (([80, 80], 80), ([72, 72], 72)):
        assert lstm_cuda.layer_route(E_parts, H, bf16) == "wide"
        assert lstm_cuda.padded_width(E_parts, H, bf16) == 96


@pytest.mark.parametrize("G", [1, 3])
def test_fwd_wide_mma_resident_wrappers_take_plain_versions_on_cpu(G):
    """On the CPU the one-block bf16 wide forward (both variants), the
    dispatch and the dispatch asked for it by name run the plain twin bit
    for bit and launch nothing; the retired cluster kernel's name is
    refused; under grad mode the wrappers refuse an operand that requires
    grad."""
    cpu, cd, H = torch.device("cpu"), torch.bfloat16, 96
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(5, 9, [32, 32], H, G, cd, cpu)
    xg = input_gates(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_fwd_wide_mma_resident,
                lstm_cuda.bilstm_fwd_wide_train_mma_resident)
    before = [f.launches for f in wrappers]
    for got in (lstm_cuda.bilstm_fwd_wide_train_mma_resident(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd,
                                                kernel="bilstm_fwd_wide_mma_resident")):
        assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    for got in (lstm_cuda.bilstm_fwd_wide_mma_resident(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert [f.launches for f in wrappers] == before
    with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
        lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")
    for fwd in wrappers:
        with pytest.raises(RuntimeError, match="no autograd graph"):
            fwd(xg.clone().requires_grad_(), lengths, w_hh, cd)
        with torch.no_grad():
            fwd(xg, lengths, w_hh.clone().requires_grad_(), cd)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_model_backward_reaches_every_lstm_weight_on_card(cuda_device):
    """The card twin of the regression test: the same gradients as the
    CPU's plain path, through the train forward, sweep and wgrad kernels
    (the forward and the sweep counted on the wrapper of the kernel the
    dispatch names)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    sweep = getattr(lstm_cuda, lstm_cuda.sweep_kernel([16], 16, torch.float32))
    fwd = {"bilstm_fwd_f32": lstm_cuda.bilstm_layer_fwd_train_f32}[
        lstm_cuda.fwd_kernel([16], 16, torch.float32)]
    wgrad = getattr(lstm_cuda, lstm_cuda.wgrad_kernel([16], 16, torch.float32))
    before = (fwd.launches, sweep.launches, wgrad.launches)
    got = model_grads(cuda_device)
    torch.cuda.synchronize()
    after = (fwd.launches, sweep.launches, wgrad.launches)
    assert all(a - b == 2 for a, b in zip(after, before))  # one per layer
    want = model_grads(torch.device("cpu"))
    for name, grad in got.items():
        assert grad is not None and float(grad.abs().sum()) > 0, name
        ref = want[name]
        assert float((grad.cpu() - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E_parts,H,G,B", [([64], 64, 5, 30), ([64, 64], 64, 1, 50),
                                           ([32, 32], 32, 3, 24), ([80], 80, 5, 30)])
def test_train_kernels_match_plain_on_card(cuda_device, dtype, E_parts, H, G, B):
    """Train forward, sweep and wgrad against their plain versions. Groups
    of 6 rows (H = 64, 80) and 8 rows (H = 32) are padded to whole row
    tiles. At H = 80 (layer 0 of a model at embedding 80) the forward is
    the tensor-core one in both dtypes (3xTF32 in f32), the wgrad the
    tensor-core one (in f32 its 64-row tile), and the sweep the tensor-core
    one in bf16 and the one-stage 3xTF32 sweep in f32."""
    T = 30
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, dtype,
                                                                 cuda_device)
    tol = 1e-4 if dtype == torch.float32 else 3e-2

    def close(got, want):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert float((a.float() - b.float()).abs().max()) <= tol * max(
                1.0, float(b.float().abs().max()))

    fwd = lstm_cuda.bilstm_layer_fwd_train(parts, lengths, w_ih, w_hh, bias, dtype)
    ref = bidir_layer(parts, lengths, w_ih, w_hh, bias, dtype, with_states=True)
    close(fwd, ref)
    hs_f, hs_b, _, _, cs_f, cs_b = ref
    ny = 2 if len(E_parts) == 1 else 1
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn, dcn, dtype)
    got, want = lstm_cuda.bilstm_bwd(*args), bidir_layer_sweep(*args)
    close(got[0] + got[1] + got[2:], want[0] + want[1] + want[2:])
    close(lstm_cuda.bilstm_wgrad(want[2], parts, hs_f, hs_b, G),
          bidir_layer_wgrad(want[2], parts, hs_f, hs_b, G))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E_parts,H", [([64], 64), ([64, 64], 64), ([32, 32], 32)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, E_parts, H):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    T, B = 40, 50
    parts = tuple((torch.rand(T, B, e, generator=g, device=cuda_device) * 2 - 1).to(dtype)
                  for e in E_parts)
    w_ih = ((torch.rand(2, 4 * H, sum(E_parts), generator=g, device=cuda_device) - .5) / 4).to(dtype)
    w_hh = ((torch.rand(2, 4 * H, H, generator=g, device=cuda_device) - .5) / 4).to(dtype)
    bias = torch.rand(2, 4 * H, generator=g, device=cuda_device) - .5
    lengths = torch.randint(0, T + 1, (B,), generator=g, device=cuda_device, dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, T])
    # the launch counts on the wrapper of the kernel the dispatch names
    wrapper = {"bilstm_fwd_mma": lstm_cuda.bilstm_layer_fwd_mma,
               "bilstm_fwd_f32": lstm_cuda.bilstm_layer_fwd_f32}[
        lstm_cuda.fwd_kernel(E_parts, H, dtype)]
    before = wrapper.launches
    got = lstm_cuda.bilstm_layer_fwd(parts, lengths, w_ih, w_hh, bias, dtype)
    want = bidir_layer(parts, lengths, w_ih, w_hh, bias, dtype)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E_parts,H,G,B", [([256], 256, 5, 60), ([256, 256], 256, 1, 70),
                                           ([128], 128, 2, 30), ([128, 128], 128, 1, 20),
                                           ([32], 32, 3, 24)])
def test_wide_kernels_match_plain_on_card(cuda_device, dtype, E_parts, H, G, B):
    """Input gates, the cluster forward (both variants), the lite sweep
    and wgrad against their plain versions. Groups of 12, 15 and 8 rows
    leave short row tiles inside each group. The gates are the tensor-core
    kernels (in f32 three tf32 passes), and at H = 128 and 256 the forward
    and the sweep are too, counted on their own wrappers; the CUDA-core
    forward's name is refused (its source is retired); at H = 32, where no
    layer runs wide, the forward and the lite sweep refuse (their CUDA-core
    kernels are gone) and nothing falls back; in f32 wgrad is the 3xTF32
    kernel at every width here."""
    T = 24
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, dtype,
                                                                 cuda_device)
    tol = 1e-4 if dtype == torch.float32 else 3e-2

    def close(got, want):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert float((a.float() - b.float()).abs().max()) <= tol * max(
                1.0, float(b.float().abs().max()))

    wrappers = (lstm_cuda.bilstm_gates_mma, lstm_cuda.bilstm_bwd_lite_mma,
                lstm_cuda.bilstm_fwd_wide_mma, lstm_cuda.bilstm_fwd_wide_train_mma,
                lstm_cuda.bilstm_wgrad, lstm_cuda.bilstm_wgrad_mma, lstm_cuda.bilstm_wgrad_f32,
                lstm_cuda.bilstm_bwd_lite_f32, lstm_cuda.bilstm_gates_f32,
                lstm_cuda.bilstm_fwd_wide_f32, lstm_cuda.bilstm_fwd_wide_train_f32)
    before = [f.launches for f in wrappers]
    xg = lstm_cuda.bilstm_gates(parts, w_ih, bias, dtype)
    close([xg], [input_gates(parts, w_ih, bias, dtype)])
    gates_mma = lstm_cuda.gates_kernel(E_parts, H, dtype) == "bilstm_gates_mma"
    lite = lstm_cuda.lite_kernel(H, dtype) if H >= 96 else None  # none at 32
    lite_mma = lite == "bilstm_bwd_lite_mma"
    lite_f32 = lite == "bilstm_bwd_lite_f32"
    fwd = lstm_cuda.wide_fwd_kernel(H, dtype) if H >= 96 else None  # none at 32
    fwd_mma, fwd_f32 = fwd == "bilstm_fwd_wide_mma", fwd == "bilstm_fwd_wide_f32"
    assert gates_mma == (dtype == torch.bfloat16)
    assert lstm_cuda.gates_kernel(E_parts, H, dtype) == (
        "bilstm_gates_mma" if gates_mma else "bilstm_gates_f32")
    assert lite_mma == fwd_mma == (dtype == torch.bfloat16 and H in (128, 256))
    assert lite_f32 == fwd_f32 == (dtype == torch.float32 and H in (128, 256))
    ref = bidir_recurrence(xg, lengths, w_hh, dtype, with_states=True)
    if H < 96:
        for fwd in (lstm_cuda.bilstm_fwd_wide_train, lstm_cuda.bilstm_fwd_wide):
            with pytest.raises(ValueError, match=f"no wide forward kernel takes H={H}"):
                fwd(xg, lengths, w_hh, dtype)
    else:
        close(lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype), ref)
        close(lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, dtype), ref[:4])
    # csrc/bilstm_fwd_wide.cu is retired: its name is refused
    with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
        lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype, kernel="bilstm_fwd_wide")
    hs_f, hs_b, _, _, cs_f, cs_b = ref
    ny = 2 if len(E_parts) == 1 else 1
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny], dhn, dcn, dtype)
    dgates = bidir_layer_sweep_lite(*args)
    if H < 96:
        with pytest.raises(ValueError, match=f"no lite sweep kernel takes H={H}"):
            lstm_cuda.bilstm_bwd_lite(*args)
    else:
        close([lstm_cuda.bilstm_bwd_lite(*args)], [dgates])
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    dgc = dgates.to(dtype)
    close(lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, G),
          bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G))
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert [f.launches - b for f, b in zip(wrappers, before)] == [
        int(gates_mma), int(lite_mma), int(fwd_mma), int(fwd_mma), 0, int(bf16), int(not bf16),
        int(lite_f32), int(not gates_mma), int(fwd_f32), int(fwd_f32)]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("H,G,B,rows", [(256, 5, 60, 16), (256, 5, 60, 32), (256, 1, 70, 40),
                                        (256, 3, 27, 32), (128, 2, 30, 80), (128, 1, 20, 40),
                                        (128, 5, 60, 16)])
def test_lite_mma_row_tiles_match_plain_on_card(cuda_device, monkeypatch, H, G, B, rows, T):
    """The tensor-core lite sweep at each row tile it is built for (pinned
    with monkeypatch on the plan's candidates), with 0-2 dy streams, with and
    without final-state cotangents; groups of 12, 70, 9, 15, 20 rows leave
    short tiles, and lengths of 0, 1 and T."""
    monkeypatch.setattr(lstm_cuda, "LITE_MMA_ROWS", (rows,))
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd, cuda_device)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    for ny, final in ((2, True), (1, False), (0, True)):
        args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
                dhn if final else None, dcn if final else None, cd)
        want = bidir_layer_sweep_lite(*args)
        got = lstm_cuda.bilstm_bwd_lite_mma(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 3e-2 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_forward_and_backward_input_gates_agree_bitwise_on_card(cuda_device, monkeypatch):
    """The wide route forms the input gates in the forward and again in the
    backward (``layer_fwd``, ``layer_bwd``): in bf16 both are the tensor-core
    kernel on the same operands, and the two agree bit for bit."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(20, 30, [128, 128], 128, 1, cd,
                                                                cuda_device)
    seen = []
    gates = lstm_cuda.bilstm_gates

    def record(*args, **kwargs):
        seen.append(gates(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(lstm_cuda, "bilstm_gates", record)
    before = lstm_cuda.bilstm_gates_mma.launches
    hs_f, hs_b, _, _, cs_f, cs_b = lstm_cuda.layer_fwd(parts, lengths, w_ih, w_hh, bias, cd,
                                                       with_states=True)
    lstm_cuda.layer_bwd(parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:1], dy[2:3],
                        dhn, dcn, cd)
    torch.cuda.synchronize()
    assert len(seen) == 2 and lstm_cuda.bilstm_gates_mma.launches == before + 2
    assert torch.equal(seen[0], seen[1])


@pytest.mark.cuda
def test_wide_route_model_gradients_on_card(cuda_device, monkeypatch):
    """A model at embedding 128 (H = 128) takes the wide route on the card,
    its input gates, forward and sweeps the f32 tensor-core kernels (never
    the CUDA-core ones); its gradients equal the CPU plain path's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert lstm_cuda.layer_route([128], 128, torch.float32) == "wide"
    wrappers = (lstm_cuda.bilstm_gates_f32, lstm_cuda.bilstm_fwd_wide_train_f32,
                lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_bwd_lite_f32, lstm_cuda.bilstm_gates_mma)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, embedding_size=128)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [4, 2, 0, 2, 0]
    want = model_grads(torch.device("cpu"), embedding_size=128)
    for name, grad in got.items():
        ref = want[name]
        assert float((grad.cpu() - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("H,G,B,rows", [(256, 5, 60, 16), (256, 5, 60, 80), (256, 1, 70, 64),
                                        (256, 3, 27, 32), (256, 1, 70, 40), (128, 2, 30, 80),
                                        (128, 1, 20, 40), (128, 5, 60, 16)])
def test_fwd_wide_mma_row_tiles_match_plain_on_card(cuda_device, monkeypatch, H, G, B, rows, T):
    """The tensor-core wide forward at each row tile it is built for (pinned
    with monkeypatch on the plan's candidates), both variants against the
    plain recurrence in bf16; groups of 12, 70, 9, 15, 20 rows leave short
    tiles, and lengths of 0, 1 and T. The eval and train variants give the
    same hs bits."""
    monkeypatch.setattr(lstm_cuda, "FWD_WIDE_MMA_ROWS", (rows,))
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [H], H, G, cd, cuda_device)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    before = (lstm_cuda.bilstm_fwd_wide_mma.launches, lstm_cuda.bilstm_fwd_wide_train_mma.launches)
    got = lstm_cuda.bilstm_fwd_wide_train_mma(xg, lengths, w_hh, cd)
    ev = lstm_cuda.bilstm_fwd_wide_mma(xg, lengths, w_hh, cd)
    torch.cuda.synchronize()
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    assert (lstm_cuda.bilstm_fwd_wide_mma.launches,
            lstm_cuda.bilstm_fwd_wide_train_mma.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("E_parts,G", [([256], 5), ([256, 256], 1)])
def test_fwd_wide_mma_matches_plain_at_the_scaled_shape_on_card(cuda_device, E_parts, G):
    """The scaled step's layers (400 rows, T = 1500, H = 256; layer 0 with 5
    weight groups, a stacked layer with 1), ragged lengths: the dispatch
    takes the tensor-core forward in both variants, which agrees with the
    plain recurrence within 3e-2 x max(1, max|ref|) and gives the same hs
    bits in both; the retired CUDA-core kernel's name is refused."""
    cd, H, T, B = torch.bfloat16, 256, 1500, 400
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    del parts
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_fwd_wide_mma, lstm_cuda.bilstm_fwd_wide_train_mma)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
    ev = lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1]
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    del got, ev
    with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
        lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 3, 1])
@pytest.mark.parametrize("E_parts,H,G,B", [
    ([64], 64, 5, 30), ([64, 64], 64, 1, 50), ([32], 32, 3, 24), ([32, 32], 32, 1, 13),
    ([256], 256, 5, 60), ([256, 256], 256, 1, 20), ([64], 64, 4, 400)])
def test_wgrad_f32_matches_plain_on_card(cuda_device, T, E_parts, H, G, B):
    """The f32 tensor-core weight gradients (three tf32 passes) against
    their plain twin within 1e-4 x max(1, max|ref|), TF32 off in the twin:
    1 and 2 input parts, weight groups of 6-100 rows, T = 1 (every h_prev
    past an end), and T = 3 at 400 rows (more splits than positions). The
    dispatch hands ``bilstm_wgrad`` to it; the CUDA-core kernel asked for by
    name agrees."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device,
                                                          seed=T + B)
    hs_f, hs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd)[:2]
    g = torch.Generator(device=cuda_device).manual_seed(B)
    dgc = torch.rand(2, T, B, 4 * H, generator=g, device=cuda_device) * 2 - 1
    want = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
    before = (lstm_cuda.bilstm_wgrad.launches, lstm_cuda.bilstm_wgrad_f32.launches)
    _close(lstm_cuda.bilstm_wgrad_f32(dgc, parts, hs_f, hs_b, G), want, 1e-4)
    _close(lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, G), want, 1e-4)
    torch.cuda.synchronize()
    assert (lstm_cuda.bilstm_wgrad.launches, lstm_cuda.bilstm_wgrad_f32.launches) == (
        before[0], before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("E_parts,G", [([256], 5), ([256, 256], 1), ([64], 5), ([64, 64], 1)])
def test_wgrad_f32_at_full_length_on_card(cuda_device, E_parts, G):
    """Long K: at the train shape (400 rows, T = 1500) each (direction,
    group) sums 120,000-600,000 rows, cut by the split-K plan; the f32
    tensor-core kernel stays within 1e-4 x max(1, max|ref|) of the plain twin
    (TF32 off) at the scaled and the manuscript widths."""
    torch.backends.cuda.matmul.allow_tf32 = False
    H, T, B = E_parts[0], 1500, 400
    g = torch.Generator(device=cuda_device).manual_seed(G)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=cuda_device) * 2 - 1

    parts = tuple(u(T, B, e) for e in E_parts)
    hs_f, hs_b, dgc = u(T, B, H), u(T, B, H), u(2, T, B, 4 * H)
    want = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
    got = lstm_cuda.bilstm_wgrad_f32(dgc, parts, hs_f, hs_b, G)
    torch.cuda.synchronize()
    _close(got, want, 1e-4)


@pytest.mark.cuda
def test_fwd_wide_mma_and_wgrad_f32_edges_on_card(cuda_device):
    """An empty batch gives empty streams and zero weight gradients with no
    launch; T = 0 gives zero final states; the other dtype and a width the
    kernels do not take raise in the tensor-core wrappers (nothing falls
    back), and so does an unknown kernel name."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 10, [128], 128, 2, cd, cuda_device)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    before = (lstm_cuda.bilstm_fwd_wide_mma.launches, lstm_cuda.bilstm_wgrad_f32.launches)
    out = lstm_cuda.bilstm_fwd_wide_mma(xg[:, :, :0].contiguous(), lengths[:0],
                                        w_hh[:, :1].contiguous(), cd)
    assert [tuple(t.shape) for t in out] == [(4, 0, 128), (4, 0, 128), (2, 0, 128), (2, 0, 128)]
    empty = torch.zeros(4, 0, 64, device=cuda_device)
    dw_ih, dw_hh = lstm_cuda.bilstm_wgrad_f32(torch.zeros(2, 4, 0, 256, device=cuda_device),
                                              (empty,), empty, empty, 1)
    assert not dw_ih.any() and not dw_hh.any() and dw_hh.shape == (2, 1, 256, 64)
    assert (lstm_cuda.bilstm_fwd_wide_mma.launches,
            lstm_cuda.bilstm_wgrad_f32.launches) == before
    _, _, hn, cn, cs_f, _ = lstm_cuda.bilstm_fwd_wide_train_mma(xg[:, :0].contiguous(), lengths,
                                                                w_hh, cd)
    torch.cuda.synchronize()
    assert not hn.any() and not cn.any() and cs_f.shape == (0, 10, 128)
    with pytest.raises(ValueError, match="bilstm_fwd_wide_mma kernel takes bfloat16"):
        lstm_cuda.bilstm_fwd_wide_mma(xg, lengths, w_hh.float(), torch.float32)
    w96 = torch.zeros(2, 384, 96, dtype=cd, device=cuda_device)
    with pytest.raises(ValueError, match="bilstm_fwd_wide_mma kernel takes bfloat16"):
        lstm_cuda.bilstm_fwd_wide_mma(torch.zeros(2, 4, 10, 384, device=cuda_device), lengths,
                                      w96, cd)
    hs = torch.zeros(4, 10, 64, dtype=cd, device=cuda_device)
    with pytest.raises(ValueError, match="bilstm_wgrad_f32 kernel takes float32"):
        lstm_cuda.bilstm_wgrad_f32(torch.zeros(2, 4, 10, 256, dtype=cd, device=cuda_device),
                                   (hs,), hs, hs, 2)
    with pytest.raises(ValueError, match="no wide forward kernel named"):
        lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd, kernel="fast")


@pytest.mark.cuda
def test_bf16_wide_route_model_gradients_take_the_tensor_core_forward_on_card(cuda_device):
    """A bf16 model at embedding 128 (H = 128, the wide route) runs its
    train forward on the tensor-core wide forward (one launch per layer,
    none of ``bilstm_fwd_wide.cu``) beside the tensor-core gates, sweep and
    wgrad; its gradients equal the CPU plain path's within 2^-7 x max(1,
    max|grad|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = (lstm_cuda.bilstm_fwd_wide_train_mma,
                lstm_cuda.bilstm_gates_mma, lstm_cuda.bilstm_bwd_lite_mma,
                lstm_cuda.bilstm_wgrad_mma, lstm_cuda.bilstm_layer_fwd_train_mma)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=torch.bfloat16, embedding_size=128)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 4, 2, 2, 0]
    want = model_grads(torch.device("cpu"), dtype=torch.bfloat16, embedding_size=128)
    for name, grad in got.items():
        ref = want[name]
        assert float((grad.cpu() - ref).abs().max()) <= 2 ** -7 * max(
            1.0, float(ref.abs().max())), name


@pytest.mark.cuda
def test_kernel_rejects_bad_operands_on_card(cuda_device):
    T, B, H = 4, 3, 64
    parts = (torch.zeros(T, B, H, device=cuda_device),)
    lengths = torch.zeros(B, dtype=torch.int32, device=cuda_device)
    w_ih = torch.zeros(2, 4 * H, H, device=cuda_device)
    w_hh = torch.zeros(2, 4 * H, H, device=cuda_device)
    bias = torch.zeros(2, 4 * H, device=cuda_device)
    with pytest.raises(ValueError, match="bilstm kernel"):
        lstm_cuda.bilstm_layer_fwd(parts, lengths.long(), w_ih, w_hh, bias, torch.float32)
    with pytest.raises(ValueError, match="takes float32.*; bilstm_fwd_mma kernel takes bfloat16"):
        lstm_cuda.bilstm_layer_fwd(parts, lengths, w_ih, w_hh, bias, torch.float16)
    # an operand that requires grad, under grad mode: the kernel's outputs
    # would carry no graph, so the wrapper refuses
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_layer_fwd(parts, lengths, w_ih.requires_grad_(), w_hh, bias,
                                   torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["lengths", "holes"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,G,B,D", [(64, 5, 60, 2), (64, 1, 50, 2), (256, 5, 60, 2),
                                     (32, 3, 24, 2), (64, 2, 20, 1), (128, 1, 9, 3)])
def test_recurrence_kernels_match_plain_on_card(cuda_device, dtype, H, G, B, D, mask):
    """The recurrence op's forward, sweep and weight gradient against their
    plain versions: masks from lengths and masks with holes, groups of 12,
    8 and 10 rows that leave short row tiles, D = 1, 2 and 3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    T = 24
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, dtype, cuda_device, mask)
    tol = 1e-4 if dtype == torch.float32 else 3e-2

    def close(got, want):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert float((a.float() - b.float()).abs().max()) <= tol * max(
                1.0, float(b.float().abs().max()))

    # the launches count on the wrapper of the kernel the dispatch names
    fwd = getattr(lstm_cuda, lstm_cuda.recurrence_fwd_kernel(H, dtype))
    sweep = getattr(lstm_cuda, lstm_cuda.recurrence_sweep_kernel(H, dtype))
    wgrad = getattr(lstm_cuda, lstm_cuda.recurrence_wgrad_kernel(H, dtype))
    wrappers = (fwd, sweep, wgrad)
    before = [f.launches for f in wrappers]
    ref = recurrence_fwd(xg, valid, w, G, dtype)
    close(lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, dtype), ref)
    hs, cs = ref[:2]
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, dtype)
    dxg = recurrence_sweep(*args)
    close([lstm_cuda.lstm_recurrence_bwd(*args)], [dxg])
    none = (xg, valid, w, hs, cs, None, dhn, None, G, dtype)
    close([lstm_cuda.lstm_recurrence_bwd(*none)], [recurrence_sweep(*none)])
    close([lstm_cuda.lstm_recurrence_wgrad(hs, dxg, G, dtype)],
          [recurrence_wgrad(hs, dxg, G, dtype)])
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 2, 1]


@pytest.mark.cuda
def test_recurrence_autograd_on_card(cuda_device):
    """``fused_lstm_recurrence`` on the card: gradients for xg and w through
    the kernels, equal to the CPU plain path's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    T, D, B, H, G = 20, 2, 30, 64, 5
    cpu = recurrence_case(T, D, B, H, G, torch.float32, torch.device("cpu"), "holes")
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        xg, valid, w, dhs, dhn, dcn = (t.to(dev) for t in cpu)
        xg.requires_grad_(), w.requires_grad_()
        out = fused_lstm_recurrence(xg, valid, w, G, torch.float32)
        torch.autograd.backward(out, [dhs, dhn, dcn])
        grads[dev.type] = (xg.grad.cpu(), w.grad.cpu(), *(o.detach().cpu() for o in out))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


@pytest.mark.cuda
def test_recurrence_kernel_rejects_bad_operands_on_card(cuda_device):
    T, D, B, G = 4, 2, 4, 1
    valid = torch.ones(T, D, B, dtype=torch.bool, device=cuda_device)

    def operands(H, dtype=torch.float32):
        return (torch.zeros(T, D, B, 4 * H, device=cuda_device), valid,
                torch.zeros(D, G, H, 4 * H, device=cuda_device, dtype=dtype), G)

    with pytest.raises(ValueError, match="H % 32 == 0"):
        lstm_cuda.lstm_recurrence_fwd(*operands(8), torch.float32)
    with pytest.raises(ValueError, match="H % 32 == 0"):
        lstm_cuda.lstm_recurrence_fwd(*operands(64, torch.float16), torch.float16)
    with pytest.raises(ValueError, match="bilstm kernel: w"):
        lstm_cuda.lstm_recurrence_fwd(*operands(64, torch.bfloat16), torch.float32)
    xg, _, w, _ = operands(64)
    with pytest.raises(ValueError, match="weight groups"):
        lstm_cuda.lstm_recurrence_fwd(xg, valid, w.expand(D, 3, 64, 256).contiguous(), 3,
                                      torch.float32)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_fwd(xg.requires_grad_(), valid, w, G, torch.float32)


def _close(got, want, tol):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol * max(
            1.0, float(b.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 1])
@pytest.mark.parametrize("E_parts,H,G,B,ny,final", [
    ([64], 64, 5, 30, 2, True), ([64, 64], 64, 1, 50, 1, True), ([64], 64, 1, 13, 0, False),
    ([64, 64], 64, 2, 18, 2, False), ([32, 32], 32, 3, 24, 1, True), ([32], 32, 1, 9, 2, False)])
def test_sweep_mma_matches_plain_on_card(cuda_device, T, E_parts, H, G, B, ny, final):
    """The tensor-core sweep against its plain twin in bf16: 1 and 2 input
    parts, 0-2 dy streams, with and without final-state cotangents, weight
    groups of 6, 8, 9 and 13 rows (short tiles inside each group), and rows
    8-15 short of T so the second tile skips the positions past its longest
    row. The dispatch hands ``bilstm_bwd`` to it; the CUDA-core sweep asked
    for by name agrees too."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, cd,
                                                                 cuda_device, seed=T + B)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn if final else None, dcn if final else None, cd)
    want = bidir_layer_sweep(*args)
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    before = (lstm_cuda.bilstm_bwd.launches, lstm_cuda.bilstm_bwd_mma.launches)
    _close(flat(lstm_cuda.bilstm_bwd_mma(*args)), flat(want), 3e-2)
    _close(flat(lstm_cuda.bilstm_bwd(*args)), flat(want), 3e-2)
    torch.cuda.synchronize()
    assert (lstm_cuda.bilstm_bwd.launches, lstm_cuda.bilstm_bwd_mma.launches) == (
        before[0], before[1] + 2)
    _close(flat(lstm_cuda.bilstm_bwd(*args, kernel="bilstm_bwd")), flat(want), 3e-2)
    torch.cuda.synchronize()
    assert lstm_cuda.bilstm_bwd.launches == before[0] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["lengths", "holes"])
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("H,G,B,D", [(64, 5, 60, 2), (64, 1, 50, 2), (64, 2, 20, 1),
                                     (64, 1, 9, 3), (32, 3, 24, 2), (32, 1, 13, 1)])
def test_recurrence_sweep_mma_matches_plain_on_card(cuda_device, H, G, B, D, T, mask):
    """The tensor-core recurrence sweep against its plain twin in bf16:
    masks from lengths and with holes, D = 1, 2, 3, groups of 12, 10, 8, 9
    and 13 rows, with and without ``dhs`` / ``dcn``; the dispatcher
    launches nothing of its own."""
    cd = torch.bfloat16
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, cuda_device, mask,
                                                  seed=T + B)
    hs, cs, _, _ = recurrence_fwd(xg, valid, w, G, cd)
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    none = (xg, valid, w, hs, cs, None, dhn, None, G, cd)
    before = (lstm_cuda.lstm_recurrence_bwd.launches, lstm_cuda.lstm_recurrence_bwd_mma.launches)
    want = recurrence_sweep(*args)
    _close([lstm_cuda.lstm_recurrence_bwd_mma(*args)], [want], 3e-2)
    _close([lstm_cuda.lstm_recurrence_bwd(*args)], [want], 3e-2)
    _close([lstm_cuda.lstm_recurrence_bwd_mma(*none)], [recurrence_sweep(*none)], 3e-2)
    torch.cuda.synchronize()
    assert (lstm_cuda.lstm_recurrence_bwd.launches,
            lstm_cuda.lstm_recurrence_bwd_mma.launches) == (before[0], before[1] + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["lengths", "holes"])
@pytest.mark.parametrize("T", [24, 3, 1])
@pytest.mark.parametrize("H,G,B,D", [(64, 5, 60, 2), (64, 1, 50, 2), (64, 2, 20, 1),
                                     (64, 1, 9, 3), (32, 3, 24, 2), (32, 1, 13, 1),
                                     (32, 5, 35, 3), (64, 5, 400, 2)])
def test_recurrence_fwd_mma_matches_plain_on_card(cuda_device, H, G, B, D, T, mask):
    """The tensor-core recurrence forward against its plain twin in bf16 at
    3e-2 x max(1, max|ref|): masks from lengths and with holes, D = 1, 2
    and 3, G = 1, 2, 3 and 5 (groups of 12, 50, 10, 9, 8, 13, 7 and 80 rows:
    a short last tile inside most groups), T = 1, 3 and 24. The dispatch
    hands ``lstm_recurrence_fwd`` to it and its wrapper counts the launches;
    the dispatcher counts none."""
    cd = torch.bfloat16
    xg, valid, w, _, _, _ = recurrence_case(T, D, B, H, G, cd, cuda_device, mask, seed=T + B + H)
    want = recurrence_fwd(xg, valid, w, G, cd)
    assert lstm_cuda.recurrence_fwd_kernel(H, cd) == "lstm_recurrence_fwd_mma"
    wrappers = (lstm_cuda.lstm_recurrence_fwd_mma, lstm_cuda.lstm_recurrence_fwd)
    before = [f.launches for f in wrappers]
    _close(lstm_cuda.lstm_recurrence_fwd_mma(xg, valid, w, G, cd), want, 3e-2)
    _close(lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd), want, 3e-2)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["lengths", "holes"])
def test_recurrence_fwd_mma_at_the_main_path_shape_on_card(cuda_device, mask):
    """The recurrence backend's forward in the manuscript step: H = 64,
    D = 2, 400 rows in 5 groups, T = 1500, against the plain twin at 3e-2 x
    max(1, max|ref|); the same bits twice."""
    cd, T, D, B, H, G = torch.bfloat16, 1500, 2, 400, 64, 5
    xg, valid, w, _, _, _ = recurrence_case(T, D, B, H, G, cd, cuda_device, mask, seed=64)
    got = lstm_cuda.lstm_recurrence_fwd_mma(xg, valid, w, G, cd)
    assert all(torch.equal(a, b)
               for a, b in zip(lstm_cuda.lstm_recurrence_fwd_mma(xg, valid, w, G, cd), got))
    _close(got, recurrence_fwd(xg, valid, w, G, cd), 3e-2)


@pytest.mark.cuda
def test_recurrence_fwd_mma_edges_on_card(cuda_device):
    """An empty batch and T = 0 launch nothing (zero final states); f32
    operands, H = 96 and an operand that requires grad raise in the wrapper
    (nothing falls back)."""
    cd = torch.bfloat16
    xg, valid, w, _, _, _ = recurrence_case(4, 2, 10, 64, 2, cd, cuda_device, "holes")
    before = lstm_cuda.lstm_recurrence_fwd_mma.launches
    hs, cs, hn, cn = lstm_cuda.lstm_recurrence_fwd_mma(xg[:, :, :0].contiguous(),
                                                       valid[:, :, :0], w, 2, cd)
    assert hs.shape == (4, 2, 0, 64) and hn.shape == (2, 0, 64)
    hs, cs, hn, cn = lstm_cuda.lstm_recurrence_fwd_mma(xg[:0].contiguous(), valid[:0], w, 2, cd)
    torch.cuda.synchronize()
    assert hs.shape == (0, 2, 10, 64) and not hn.any() and not cn.any()
    assert lstm_cuda.lstm_recurrence_fwd_mma.launches == before
    with pytest.raises(ValueError, match="lstm_recurrence_fwd_mma kernel takes compute dtype"):
        lstm_cuda.lstm_recurrence_fwd_mma(xg, valid, w.float(), 2, torch.float32)
    wide = recurrence_case(4, 2, 10, 96, 2, cd, cuda_device, "holes")
    with pytest.raises(ValueError, match="lstm_recurrence_fwd_mma kernel takes compute dtype"):
        lstm_cuda.lstm_recurrence_fwd_mma(wide[0], wide[1], wide[2], 2, cd)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_fwd_mma(xg.clone().requires_grad_(), valid, w, 2, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 1])
@pytest.mark.parametrize("E_parts,H,G,B,ny,final", [
    ([8], 8, 5, 30, 2, True), ([16], 8, 1, 13, 1, False), ([8, 8], 8, 3, 27, 0, True),
    ([32], 8, 2, 18, 2, False), ([16, 16], 8, 1, 9, 1, True), ([24], 24, 5, 60, 2, True),
    ([48], 24, 1, 13, 0, False), ([24, 24], 24, 3, 24, 1, True), ([40], 40, 4, 20, 2, False),
    ([80], 40, 1, 11, 1, True), ([40, 40], 40, 2, 22, 2, True), ([120], 40, 1, 10, 0, False),
    ([56], 56, 5, 30, 1, True), ([112], 56, 1, 13, 2, False), ([56, 56], 56, 3, 27, 2, True),
    ([72], 72, 5, 30, 2, True), ([72], 72, 1, 13, 0, False), ([72], 72, 3, 27, 1, True)])
def test_sweep_mma_at_h_mod_16_eq_8_matches_plain_on_card(cuda_device, T, E_parts, H, G, B, ny,
                                                          final):
    """The tensor-core sweep at every shape it took over from
    ``bilstm_bwd.cu`` at H % 16 == 8 (H = 8, 24, 40, 56, 72; layer 0 and the
    stacked layer, E + H padded to a multiple of 32 inside the kernel)
    against its plain twin in bf16 at 3e-2 x max(1, max|ref|): 1 and 2
    input parts, 0-2 dy streams, with and without final-state cotangents,
    groups of 6 to 13 rows (short tiles inside each group), rows 8-15 short
    of T. The dispatch hands ``bilstm_bwd`` to it; ``bilstm_bwd.cu`` asked
    for by name agrees too up to 56, and at 72 (the <72, 72> instance's
    shape) is refused by name."""
    cd = torch.bfloat16
    assert lstm_cuda.sweep_kernel(E_parts, H, cd) == "bilstm_bwd_mma"
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, cd,
                                                                 cuda_device, seed=T + B + H)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn if final else None, dcn if final else None, cd)
    want = bidir_layer_sweep(*args)
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    before = (lstm_cuda.bilstm_bwd.launches, lstm_cuda.bilstm_bwd_mma.launches)
    _close(flat(lstm_cuda.bilstm_bwd_mma(*args)), flat(want), 3e-2)
    _close(flat(lstm_cuda.bilstm_bwd(*args)), flat(want), 3e-2)
    torch.cuda.synchronize()
    assert (lstm_cuda.bilstm_bwd.launches, lstm_cuda.bilstm_bwd_mma.launches) == (
        before[0], before[1] + 2)
    if H > lstm_cuda.MMA_MAX_H:
        with pytest.raises(ValueError, match="not asked for by name where the bf16 tensor-core"):
            lstm_cuda.bilstm_bwd(*args, kernel="bilstm_bwd")
        torch.cuda.synchronize()
        assert lstm_cuda.bilstm_bwd.launches == before[0]
        return
    _close(flat(lstm_cuda.bilstm_bwd(*args, kernel="bilstm_bwd")), flat(want), 3e-2)
    torch.cuda.synchronize()
    assert lstm_cuda.bilstm_bwd.launches == before[0] + 1


@pytest.mark.cuda
def test_sweep_mma_at_72_at_the_main_path_shape_on_card(cuda_device):
    """Layer 0 of the bf16 two-layer model at embedding 72: E = H = 72, 400
    rows in 5 groups, T = 1500, two dy streams a direction, the main path's
    lengths (groups at 0, 1 and T, the rest random), against the plain twin
    at 3e-2 x max(1, max|ref|); the same bits twice."""
    cd, T, B, G = torch.bfloat16, 1500, 400, 5
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [72], 72, G, cd,
                                                                 cuda_device, seed=72)
    lengths = _main_path_lengths(lengths, G, T)
    hs_f, hs_b, _, _, cs_f, cs_b = lstm_cuda.bilstm_layer_fwd_train(parts, lengths, w_ih, w_hh,
                                                                    bias, cd)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn,
            cd)
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    got = flat(lstm_cuda.bilstm_bwd_mma(*args))
    assert all(torch.equal(a, b) for a, b in zip(flat(lstm_cuda.bilstm_bwd_mma(*args)), got))
    _close(got, flat(bidir_layer_sweep(*args)), 3e-2)


@pytest.mark.cuda
def test_sweep_mma_rejects_what_it_does_not_take_on_card(cuda_device):
    """f32 operands and H = 128 raise in the tensor-core wrappers; nothing
    falls back."""
    T, D, B, G = 4, 2, 8, 1
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, 128, G, torch.bfloat16, cuda_device,
                                                  "holes")
    hs, cs, _, _ = recurrence_fwd(xg, valid, w, G, torch.bfloat16)
    with pytest.raises(ValueError, match="lstm_recurrence_bwd_mma kernel takes"):
        lstm_cuda.lstm_recurrence_bwd_mma(xg, valid, w, hs, cs, dhs, dhn, dcn, G, torch.bfloat16)
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [64], 64, 1, torch.float32,
                                                                 cuda_device)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, torch.float32,
                                               with_states=True)
    with pytest.raises(ValueError, match="bilstm_bwd_mma kernel takes bfloat16"):
        lstm_cuda.bilstm_bwd_mma(parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
                                 dy[:1], dy[2:3], dhn, dcn, torch.float32)


@pytest.mark.cuda
def test_bf16_model_gradients_take_the_tensor_core_sweep_on_card(cuda_device):
    """A bf16 model at embedding 64 runs its train forward, sweeps and
    weight gradients on the tensor-core kernels (one launch each per layer,
    none of the CUDA-core ones); its gradients equal the CPU plain path's
    within 2^-7 x max(1, max|grad|): bf16 streams, and the kernels' other
    order of sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = (lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_mma,
                lstm_cuda.bilstm_layer_fwd_train, lstm_cuda.bilstm_layer_fwd_train_mma,
                lstm_cuda.bilstm_wgrad, lstm_cuda.bilstm_wgrad_mma)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=torch.bfloat16, embedding_size=64)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [0, 2, 0, 2, 0, 2]
    want = model_grads(torch.device("cpu"), dtype=torch.bfloat16, embedding_size=64)
    for name, grad in got.items():
        ref = want[name]
        assert float((grad.cpu() - ref).abs().max()) <= 2 ** -7 * max(
            1.0, float(ref.abs().max())), name


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 1])
@pytest.mark.parametrize("E_parts,H,G,B", [
    ([64], 64, 5, 30), ([64, 64], 64, 1, 50), ([64], 64, 2, 18), ([32], 32, 3, 24),
    ([32, 32], 32, 1, 13), ([16, 16], 16, 4, 20), ([48], 48, 1, 11), ([80], 80, 5, 30),
    ([40, 40], 80, 2, 22), ([80], 80, 1, 9), ([72], 72, 3, 27), ([72], 72, 4, 20)])
def test_fwd_mma_matches_plain_on_card(cuda_device, T, E_parts, H, G, B):
    """The tensor-core forward against its plain twin in bf16, both
    variants: 1 and 2 input parts, weight groups of 5, 6, 8, 9, 11, 13 and
    50 rows (short tiles inside each group), rows of length 0, 1 and T, and
    rows 8-15 short of T so a tile stops at its longest row; at E = H = 80
    and 72 its 320- and 288-thread instances (K = 144 in nine k16 steps).
    The dispatch hands ``bilstm_layer_fwd(_train)`` to it; the CUDA-core
    forward asked for by name agrees too up to H = 64, and past it (E = H =
    80 and 72, retired there) refuses before any launch."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device,
                                                           seed=T + B)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    args = (parts, lengths, w_ih, w_hh, bias, cd)
    want = bidir_layer(*args, with_states=True)
    wrappers = (lstm_cuda.bilstm_layer_fwd, lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_layer_fwd_mma, lstm_cuda.bilstm_layer_fwd_train_mma)
    before = [f.launches for f in wrappers]
    _close(lstm_cuda.bilstm_layer_fwd_train_mma(*args), want, 3e-2)
    _close(lstm_cuda.bilstm_layer_fwd_mma(*args), want[:4], 3e-2)
    _close(lstm_cuda.bilstm_layer_fwd_train(*args), want, 3e-2)
    _close(lstm_cuda.bilstm_layer_fwd(*args), want[:4], 3e-2)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [0, 0, 2, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 3, 1])
@pytest.mark.parametrize("E_parts,H,G,B", [
    ([64], 64, 5, 30), ([64, 64], 64, 1, 50), ([32], 32, 3, 24), ([32, 32], 32, 1, 13),
    ([256], 256, 5, 60), ([256, 256], 256, 1, 20), ([64], 64, 4, 400)])
def test_wgrad_mma_matches_plain_on_card(cuda_device, T, E_parts, H, G, B):
    """The tensor-core weight gradients against their plain twin in bf16:
    1 and 2 input parts, weight groups of 6, 8, 12, 13, 20, 50 and 100 rows,
    T = 1 (every h_prev past an end), and T = 3 at 400 rows, where the
    launch has more splits than positions. The dispatch hands
    ``bilstm_wgrad`` to it; the CUDA-core kernel asked for by name agrees."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, cd,
                                                                 cuda_device, seed=T + B)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    dgc = (torch.rand(2, T, B, 4 * H, generator=g, device=cuda_device) * 2 - 1).to(cd)
    want = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
    if (T, B) == (3, 400):
        assert lstm_cuda.wgrad_mma_plan(T, B, G, E_parts, H)[2] > T
    before = (lstm_cuda.bilstm_wgrad.launches, lstm_cuda.bilstm_wgrad_mma.launches)
    _close(lstm_cuda.bilstm_wgrad_mma(dgc, parts, hs_f, hs_b, G), want, 3e-2)
    _close(lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, G), want, 3e-2)
    torch.cuda.synchronize()
    assert (lstm_cuda.bilstm_wgrad.launches, lstm_cuda.bilstm_wgrad_mma.launches) == (
        before[0], before[1] + 2)


@pytest.mark.cuda
def test_forward_and_wgrad_mma_edges_on_card(cuda_device):
    """An empty batch gives empty streams and zero weight gradients with no
    launch; T = 0 gives zero final states; f32 operands and a shape the
    kernels do not take raise in the tensor-core wrappers (nothing falls
    back), and so does an unknown kernel name."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 10, [64], 64, 2, cd, cuda_device)
    empty = tuple(p[:, :0].contiguous() for p in parts)
    before = (lstm_cuda.bilstm_layer_fwd_mma.launches, lstm_cuda.bilstm_wgrad_mma.launches)
    out = lstm_cuda.bilstm_layer_fwd_mma(empty, lengths[:0], w_ih, w_hh[:, :1].contiguous(),
                                         bias, cd)
    assert [tuple(t.shape) for t in out] == [(4, 0, 64), (4, 0, 64), (2, 0, 64), (2, 0, 64)]
    hs = torch.zeros(4, 0, 64, dtype=cd, device=cuda_device)
    dw_ih, dw_hh = lstm_cuda.bilstm_wgrad_mma(torch.zeros(2, 4, 0, 256, dtype=cd,
                                                          device=cuda_device),
                                              empty, hs, hs, 1)
    assert not dw_ih.any() and not dw_hh.any() and dw_hh.shape == (2, 1, 256, 64)
    assert (lstm_cuda.bilstm_layer_fwd_mma.launches,
            lstm_cuda.bilstm_wgrad_mma.launches) == before
    none = tuple(p[:0].contiguous() for p in parts)
    _, _, hn, cn, cs_f, _ = lstm_cuda.bilstm_layer_fwd_train_mma(none, lengths, w_ih, w_hh,
                                                                 bias, cd)
    torch.cuda.synchronize()
    assert not hn.any() and not cn.any() and cs_f.shape == (0, 10, 64)
    f32 = layer_case(4, 10, [64], 64, 2, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="bilstm_fwd_mma kernel takes bfloat16"):
        lstm_cuda.bilstm_layer_fwd_mma(*f32[:5], torch.float32)
    with pytest.raises(ValueError, match="bilstm_wgrad_mma kernel takes bfloat16"):
        hs32 = torch.zeros(4, 10, 64, device=cuda_device)
        lstm_cuda.bilstm_wgrad_mma(torch.zeros(2, 4, 10, 256, device=cuda_device), f32[0],
                                   hs32, hs32, 2)
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel.*; bilstm_fwd_mma kernel"):
        lstm_cuda.bilstm_layer_fwd((parts[0][..., :32].contiguous(),), lengths,
                                   w_ih[..., :32].contiguous(), w_hh, bias, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 1])
@pytest.mark.parametrize("E_parts,H,G,B,ny,final", [
    ([64], 64, 5, 30, 2, True), ([64, 64], 64, 1, 50, 1, True), ([64], 64, 1, 13, 0, False),
    ([64, 64], 64, 2, 18, 2, False), ([32, 32], 32, 3, 24, 1, True), ([32], 32, 1, 9, 2, False),
    ([32], 32, 4, 20, 2, True), ([64], 32, 5, 40, 1, False), ([16], 16, 2, 10, 1, True),
    ([48], 48, 2, 12, 1, True), ([32], 64, 1, 10, 2, False)])
def test_bwd_f32_matches_plain_on_card(cuda_device, T, E_parts, H, G, B, ny, final):
    """The f32 tensor-core sweep (three tf32 passes) against its plain twin
    within the f32 tolerance, 1e-4 x max(1, max|ref|): 1 and 2 input parts,
    0-2 dy streams, with and without final-state cotangents, weight groups
    of 5, 6, 8, 9, 10, 13 and 50 rows (short tiles inside each group), rows
    of length 0, 1 and T, rows 8-15 short of T so the second tile skips the
    positions past its longest row, and the shapes only its run-time
    instance takes (H = 48, 16; E = 32 at H = 64). The dispatch hands
    ``bilstm_bwd`` to it; the CUDA-core sweep asked for by name agrees
    too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, cd,
                                                                 cuda_device, seed=T + B)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn if final else None, dcn if final else None, cd)
    want = bidir_layer_sweep(*args)
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    before = (lstm_cuda.bilstm_bwd.launches, lstm_cuda.bilstm_bwd_f32.launches)
    _close(flat(lstm_cuda.bilstm_bwd_f32(*args)), flat(want), 1e-4)
    _close(flat(lstm_cuda.bilstm_bwd(*args)), flat(want), 1e-4)
    torch.cuda.synchronize()
    assert (lstm_cuda.bilstm_bwd.launches, lstm_cuda.bilstm_bwd_f32.launches) == (
        before[0], before[1] + 2)
    _close(flat(lstm_cuda.bilstm_bwd(*args, kernel="bilstm_bwd")), flat(want), 1e-4)
    torch.cuda.synchronize()
    assert lstm_cuda.bilstm_bwd.launches == before[0] + 1


@pytest.mark.cuda
def test_bwd_f32_edges_on_card(cuda_device):
    """An empty batch and T = 0 launch nothing; bf16 operands, H = 80 and an
    unknown kernel name raise in the f32 wrapper (nothing falls back)."""
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 10, [64], 64, 2, cd,
                                                                 cuda_device)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    before = lstm_cuda.bilstm_bwd_f32.launches
    empty = lambda t: t[:, :0].contiguous()  # noqa: E731
    out = lstm_cuda.bilstm_bwd_f32(tuple(empty(p) for p in parts), lengths[:0], w_ih,
                                   w_hh[:, :1].contiguous(), bias, *(empty(t) for t in (
                                       hs_f, hs_b, cs_f, cs_b)), (), (), None, None, cd)
    assert out[2].shape == (2, 4, 0, 256) and not out[3].any()
    assert lstm_cuda.bilstm_bwd_f32.launches == before
    bf = layer_case(4, 10, [64], 64, 2, torch.bfloat16, cuda_device)
    hb = bidir_layer(*bf[:5], torch.bfloat16, with_states=True)
    with pytest.raises(ValueError, match="bilstm_bwd_f32 kernel takes float32"):
        lstm_cuda.bilstm_bwd_f32(*bf[:5], hb[0], hb[1], hb[4], hb[5], bf[5][:1], bf[5][2:3],
                                 None, None, torch.bfloat16)
    with pytest.raises(ValueError, match="no sweep kernel named"):
        lstm_cuda.bilstm_bwd(parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:1],
                             dy[2:3], dhn, dcn, cd, kernel="fast")
    wide = layer_case(4, 10, [40], 80, 2, cd, cuda_device)
    hw = bidir_layer(*wide[:5], cd, with_states=True)
    with pytest.raises(ValueError, match="bilstm_bwd_f32 kernel takes float32"):
        lstm_cuda.bilstm_bwd_f32(*wide[:5], hw[0], hw[1], hw[4], hw[5], wide[5][:1],
                                 wide[5][2:3], None, None, cd)


@pytest.mark.cuda
def test_f32_model_gradients_take_the_f32_sweep_on_card(cuda_device):
    """An f32 model at embedding 64 runs its sweeps on the f32 tensor-core
    kernel (one launch per layer, none of ``bilstm_bwd.cu``), and its
    gradients equal the CPU plain path's within 1e-4 x max(1, max|grad|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = (lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_f32, lstm_cuda.bilstm_bwd_mma)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=torch.float32, embedding_size=64)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [0, 2, 0]
    want = model_grads(torch.device("cpu"), dtype=torch.float32, embedding_size=64)
    for name, grad in got.items():
        ref = want[name]
        assert float((grad.cpu() - ref).abs().max()) <= 1e-4 * max(
            1.0, float(ref.abs().max())), name


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 2, 1])
@pytest.mark.parametrize("H,G,B,D", [(64, 5, 60, 2), (64, 1, 50, 2), (32, 3, 24, 1),
                                     (256, 5, 60, 2), (96, 2, 18, 3), (64, 4, 400, 1)])
def test_recurrence_wgrad_mma_matches_plain_on_card(cuda_device, T, H, G, B, D):
    """The tensor-core recurrence wgrad against its plain twin in bf16
    (3e-2 x max(1, max|ref|)): H = 32 (half a column tile), 64, 96 (a
    partial last tile) and 256, D = 1-3, groups of 9, 10, 12, 24, 50 and 100
    rows, T = 2 (one row per batch row) and T = 1 (no row: zeros, no
    launch). The dispatch hands ``lstm_recurrence_wgrad`` to it; the
    CUDA-core kernel asked for by name agrees too."""
    cd = torch.bfloat16
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, cuda_device, "holes",
                                                  seed=T + B)
    hs, cs, _, _ = recurrence_fwd(xg, valid, w, G, cd)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    dxg = torch.rand(T, D, B, 4 * H, generator=g, device=cuda_device) * 2 - 1
    want = recurrence_wgrad(hs, dxg, G, cd)
    before = (lstm_cuda.lstm_recurrence_wgrad.launches,
              lstm_cuda.lstm_recurrence_wgrad_mma.launches)
    _close([lstm_cuda.lstm_recurrence_wgrad_mma(hs, dxg, G, cd)], [want], 3e-2)
    _close([lstm_cuda.lstm_recurrence_wgrad(hs, dxg, G, cd)], [want], 3e-2)
    torch.cuda.synchronize()
    launched = 2 if T > 1 else 0
    assert (lstm_cuda.lstm_recurrence_wgrad.launches,
            lstm_cuda.lstm_recurrence_wgrad_mma.launches) == (before[0], before[1] + launched)
    _close([lstm_cuda.lstm_recurrence_wgrad(hs, dxg, G, cd, kernel="lstm_recurrence_wgrad")],
           [want], 3e-2)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_recurrence_wgrad.launches == before[0] + launched // 2


@pytest.mark.cuda
def test_recurrence_wgrad_mma_edges_on_card(cuda_device):
    """Splits past the positions (T = 3 at 400 rows in one group), an empty
    batch (zeros, no launch); f32 and an unknown kernel name raise."""
    cd = torch.bfloat16
    T, D, B, H, G = 3, 1, 400, 64, 1
    assert lstm_cuda.recurrence_wgrad_mma_plan(T, B, D, G, H)[2] > T
    g = torch.Generator(device=cuda_device).manual_seed(0)
    hs = torch.rand(T, D, B, H, generator=g, device=cuda_device) * 2 - 1
    dxg = torch.rand(T, D, B, 4 * H, generator=g, device=cuda_device) * 2 - 1
    _close([lstm_cuda.lstm_recurrence_wgrad_mma(hs, dxg, G, cd)],
           [recurrence_wgrad(hs, dxg, G, cd)], 3e-2)
    before = lstm_cuda.lstm_recurrence_wgrad_mma.launches
    dw = lstm_cuda.lstm_recurrence_wgrad_mma(hs[:, :, :0].contiguous(),
                                             dxg[:, :, :0].contiguous(), 1, cd)
    torch.cuda.synchronize()
    assert dw.shape == (D, 1, H, 4 * H) and not dw.any()
    assert lstm_cuda.lstm_recurrence_wgrad_mma.launches == before
    with pytest.raises(ValueError, match="lstm_recurrence_wgrad_mma kernel takes compute dtype"):
        lstm_cuda.lstm_recurrence_wgrad_mma(hs, dxg, G, torch.float32)
    with pytest.raises(ValueError, match="no weight-gradient kernel named"):
        lstm_cuda.lstm_recurrence_wgrad(hs, dxg, G, cd, kernel="fast")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 1])
@pytest.mark.parametrize("E_parts,H,G,B,rows", [
    ([64], 64, 5, 30, 8), ([64], 64, 5, 30, 16), ([64, 64], 64, 1, 50, 8),
    ([64, 64], 64, 1, 50, 16), ([32], 32, 5, 40, 16), ([32, 32], 32, 1, 13, 8),
    ([32, 32], 32, 3, 27, 16), ([16, 16], 16, 4, 20, 16), ([48], 48, 2, 22, 8),
    ([32], 64, 1, 10, 16)])
def test_fwd_f32_matches_plain_on_card(cuda_device, monkeypatch, T, E_parts, H, G, B, rows):
    """The f32 tensor-core forward (three tf32 passes) against its plain
    twin within the f32 tolerance, 1e-4 x max(1, max|ref|), both variants:
    1 and 2 input parts, G = 1, 3, 4 and 5 (groups of 5, 6, 8, 9, 11, 13 and
    50 rows: short tiles inside each group), rows of length 0, 1 and T and
    rows 8-15 short of T so a tile stops at its longest row, tile heights 8
    and 16 (pinned with monkeypatch on ``fwd_f32_rows``), and the shapes only
    its run-time instance takes (H = 48, 16; E = 32 at H = 64). The dispatch
    hands ``bilstm_layer_fwd(_train)`` to it; the CUDA-core forward asked
    for by name agrees too."""
    monkeypatch.setattr(lstm_cuda, "fwd_f32_rows", lambda *shape: rows)
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device,
                                                           seed=T + B)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    args = (parts, lengths, w_ih, w_hh, bias, cd)
    want = bidir_layer(*args, with_states=True)
    wrappers = (lstm_cuda.bilstm_layer_fwd, lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_layer_fwd_f32, lstm_cuda.bilstm_layer_fwd_train_f32)
    before = [f.launches for f in wrappers]
    _close(lstm_cuda.bilstm_layer_fwd_train_f32(*args), want, 1e-4)
    _close(lstm_cuda.bilstm_layer_fwd_f32(*args), want[:4], 1e-4)
    _close(lstm_cuda.bilstm_layer_fwd_train(*args), want, 1e-4)
    _close(lstm_cuda.bilstm_layer_fwd(*args), want[:4], 1e-4)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [0, 0, 2, 2]


@pytest.mark.cuda
def test_fwd_f32_edges_on_card(cuda_device):
    """An empty batch launches nothing; T = 0 gives zero final states; bf16
    operands, H = 96 and an unknown kernel name raise in the f32 wrappers
    (nothing falls back)."""
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 10, [64], 64, 2, cd, cuda_device)
    before = (lstm_cuda.bilstm_layer_fwd_f32.launches,
              lstm_cuda.bilstm_layer_fwd_train_f32.launches)
    empty = tuple(p[:, :0].contiguous() for p in parts)
    out = lstm_cuda.bilstm_layer_fwd_f32(empty, lengths[:0], w_ih, w_hh[:, :1].contiguous(),
                                         bias, cd)
    assert [tuple(t.shape) for t in out] == [(4, 0, 64), (4, 0, 64), (2, 0, 64), (2, 0, 64)]
    assert lstm_cuda.bilstm_layer_fwd_f32.launches == before[0]
    none = tuple(p[:0].contiguous() for p in parts)
    _, _, hn, cn, cs_f, _ = lstm_cuda.bilstm_layer_fwd_train_f32(none, lengths, w_ih, w_hh,
                                                                 bias, cd)
    torch.cuda.synchronize()
    assert not hn.any() and not cn.any() and cs_f.shape == (0, 10, 64)
    assert lstm_cuda.bilstm_layer_fwd_train_f32.launches == before[1] + 1
    bf = layer_case(4, 10, [64], 64, 2, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.bilstm_layer_fwd_f32(*bf[:5], torch.bfloat16)
    wide = layer_case(4, 10, [48], 96, 2, cd, cuda_device)
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.bilstm_layer_fwd_train_f32(*wide[:5], cd)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["lengths", "holes"])
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("H,G,B,D", [(64, 5, 60, 2), (64, 1, 50, 2), (64, 2, 20, 1),
                                     (64, 1, 9, 3), (32, 2, 24, 2), (32, 1, 13, 1),
                                     (32, 3, 27, 3)])
def test_recurrence_sweep_f32_matches_plain_on_card(cuda_device, H, G, B, D, T, mask):
    """The f32 tensor-core recurrence sweep (three tf32 passes) against its
    plain twin within 1e-4 x max(1, max|ref|): masks from lengths and with
    holes, D = 1, 2, 3, G = 1, 2, 3 and 5 (groups of 12, 10, 9, 13 and 50
    rows: short tiles), with and without ``dhs`` / ``dcn``. The dispatch
    hands ``lstm_recurrence_bwd`` to it; the cluster sweep asked for by
    name agrees too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = torch.float32
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, cuda_device, mask,
                                                  seed=T + B)
    hs, cs, _, _ = recurrence_fwd(xg, valid, w, G, cd)
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    none = (xg, valid, w, hs, cs, None, dhn, None, G, cd)
    before = (lstm_cuda.lstm_recurrence_bwd.launches, lstm_cuda.lstm_recurrence_bwd_f32.launches)
    want = recurrence_sweep(*args)
    _close([lstm_cuda.lstm_recurrence_bwd_f32(*args)], [want], 1e-4)
    _close([lstm_cuda.lstm_recurrence_bwd(*args)], [want], 1e-4)
    _close([lstm_cuda.lstm_recurrence_bwd_f32(*none)], [recurrence_sweep(*none)], 1e-4)
    torch.cuda.synchronize()
    assert (lstm_cuda.lstm_recurrence_bwd.launches,
            lstm_cuda.lstm_recurrence_bwd_f32.launches) == (before[0], before[1] + 3)


@pytest.mark.cuda
def test_recurrence_sweep_f32_edges_on_card(cuda_device):
    """An empty batch launches nothing; bf16 and H = 128 raise in the f32
    wrapper, and an unknown kernel name in the dispatcher (nothing falls
    back)."""
    cd = torch.float32
    xg, valid, w, dhs, dhn, dcn = recurrence_case(4, 2, 8, 64, 1, cd, cuda_device, "holes")
    hs, cs, _, _ = recurrence_fwd(xg, valid, w, 1, cd)
    before = lstm_cuda.lstm_recurrence_bwd_f32.launches
    cut = lambda t: t[:, :, :0].contiguous()  # noqa: E731
    out = lstm_cuda.lstm_recurrence_bwd_f32(cut(xg), cut(valid), w, cut(hs), cut(cs), None,
                                            None, None, 1, cd)
    assert out.shape == (4, 2, 0, 256)
    assert lstm_cuda.lstm_recurrence_bwd_f32.launches == before
    with pytest.raises(ValueError, match="lstm_recurrence_bwd_f32 kernel takes compute dtype"):
        lstm_cuda.lstm_recurrence_bwd_f32(xg, valid, w.to(torch.bfloat16), hs, cs, dhs, dhn, dcn,
                                          1, torch.bfloat16)
    wide = recurrence_case(4, 2, 8, 128, 1, cd, cuda_device, "holes")
    hw, cw, _, _ = recurrence_fwd(wide[0], wide[1], wide[2], 1, cd)
    with pytest.raises(ValueError, match="lstm_recurrence_bwd_f32 kernel takes compute dtype"):
        lstm_cuda.lstm_recurrence_bwd_f32(wide[0], wide[1], wide[2], hw, cw, None, None, None, 1,
                                          cd)
    with pytest.raises(ValueError, match="no sweep kernel named"):
        lstm_cuda.lstm_recurrence_bwd(xg, valid, w, hs, cs, dhs, dhn, dcn, 1, cd, kernel="fast")


# ------------------------ the one-stage f32 sweep and the padded widths (card)
@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 1])
@pytest.mark.parametrize("E_parts,H,G,B,ny,final", [
    ([80], 80, 5, 30, 2, True), ([80], 80, 1, 13, 0, False), ([80], 80, 3, 27, 1, True),
    ([40], 80, 2, 18, 2, False), ([40, 40], 80, 1, 20, 1, True), ([16], 80, 4, 20, 2, True)])
def test_bwd_f32_onestage_matches_plain_on_card(cuda_device, T, E_parts, H, G, B, ny, final):
    """The one-stage f32 sweep (three tf32 passes, the next step's tile in
    registers) against its plain twin within 1e-4 x max(1, max|ref|): 1 and
    2 input parts, 0-2 dy streams, with and without final-state
    cotangents, groups of 5, 6, 9, 10 and 13 rows, rows of length 0, 1 and
    T, rows 8-15 short of T. The dispatch hands ``bilstm_bwd`` to it; the
    CUDA-core sweep asked for by name agrees too where it takes the shape
    (not E = 16 at H = 80, which only the tensor-core plan takes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, cd,
                                                                 cuda_device, seed=T + B + 7)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn if final else None, dcn if final else None, cd)
    want = bidir_layer_sweep(*args)
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    wrappers = (lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_f32_onestage)
    before = [f.launches for f in wrappers]
    _close(flat(lstm_cuda.bilstm_bwd_f32_onestage(*args)), flat(want), 1e-4)
    _close(flat(lstm_cuda.bilstm_bwd(*args)), flat(want), 1e-4)
    try:
        lstm_cuda.bwd_launch_plan(E_parts, H, cd)
        cores = 1
    except ValueError:
        cores = 0
    if cores:
        _close(flat(lstm_cuda.bilstm_bwd(*args, kernel="bilstm_bwd")), flat(want), 1e-4)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [cores, 2]


@pytest.mark.cuda
def test_bwd_f32_onestage_at_the_main_path_shape_on_card(cuda_device):
    """Layer 0 of the two-layer model at embedding 80: E = H = 80, 400 rows
    in 5 groups, two dy streams, T = 1500, the main path's lengths (groups
    at 0, 1 and T, the rest random), against the plain twin at 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd, T, B, G = torch.float32, 1500, 400, 5
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [80], 80, G, cd,
                                                                 cuda_device, seed=11)
    lengths[:240] = torch.tensor([0, 1, T], device=cuda_device).repeat_interleave(80)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn,
            cd)
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    _close(flat(lstm_cuda.bilstm_bwd_f32_onestage(*args)), flat(bidir_layer_sweep(*args)), 1e-4)


@pytest.mark.cuda
def test_bwd_f32_onestage_edges_on_card(cuda_device):
    """An empty batch launches nothing; bf16 operands and H = 96 raise in
    the one-stage wrapper (nothing falls back)."""
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 10, [80], 80, 2, cd,
                                                                 cuda_device)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    before = lstm_cuda.bilstm_bwd_f32_onestage.launches
    empty = lambda t: t[:, :0].contiguous()  # noqa: E731
    out = lstm_cuda.bilstm_bwd_f32_onestage(
        tuple(empty(p) for p in parts), lengths[:0], w_ih, w_hh[:, :1].contiguous(), bias,
        *(empty(t) for t in (hs_f, hs_b, cs_f, cs_b)), (), (), None, None, cd)
    assert out[2].shape == (2, 4, 0, 320) and not out[3].any()
    assert lstm_cuda.bilstm_bwd_f32_onestage.launches == before
    bf = layer_case(4, 10, [80], 80, 2, torch.bfloat16, cuda_device)
    hb = bidir_layer(*bf[:5], torch.bfloat16, with_states=True)
    with pytest.raises(ValueError, match="bilstm_bwd_f32_onestage kernel takes float32"):
        lstm_cuda.bilstm_bwd_f32_onestage(*bf[:5], hb[0], hb[1], hb[4], hb[5], bf[5][:1],
                                          bf[5][2:3], None, None, torch.bfloat16)
    wide = layer_case(4, 10, [48], 96, 2, cd, cuda_device)
    hw = bidir_layer(*wide[:5], cd, with_states=True)
    with pytest.raises(ValueError, match="bilstm_bwd_f32_onestage kernel takes float32"):
        lstm_cuda.bilstm_bwd_f32_onestage(*wide[:5], hw[0], hw[1], hw[4], hw[5], wide[5][:1],
                                          wide[5][2:3], None, None, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E_parts,H,G", [([80, 80], 80, 1), ([112], 112, 5),
                                         ([112, 112], 112, 1), ([48, 48], 48, 1),
                                         ([80], 80, 5), ([240], 240, 1), ([10], 10, 5),
                                         ([50], 50, 5), ([100], 100, 5), ([100, 100], 100, 1),
                                         ([272], 272, 5), ([272, 272], 272, 1)])
def test_repaired_widths_match_the_cpu_on_card(cuda_device, dtype, E_parts, H, G):
    """The layers the width repairs open, padded (``padded_width`` > H or
    ``padded_parts`` past the parts: embedding 10, 50, 100, the bf16
    stacked layer at 48; at 272 the 288-thread wide kernels) or taken
    natively (the f32 tensor-core sweep at E = 96, H = 48; the one-stage
    sweep at E = H = 80), on the card: ``layer_fwd`` (train variant) and
    ``layer_bwd`` against the CPU plain layer at the true widths, within
    1e-4 x max(1, max|ref|) in f32 and 3e-2 in bf16, each launching the
    kernels its route's pickers name at the padded shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B = 20, 30
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, dtype,
                                                                 cuda_device, seed=H)
    ny = 2 if len(E_parts) == 1 else 1
    Hp = lstm_cuda.padded_width(E_parts, H, dtype)
    Ep = lstm_cuda.padded_parts(E_parts, H, dtype)
    if lstm_cuda.layer_route(E_parts, H, dtype) == "resident":
        names = {"bilstm_bwd_mma": lstm_cuda.bilstm_bwd_mma, "bilstm_bwd": lstm_cuda.bilstm_bwd,
                 "bilstm_bwd_f32": lstm_cuda.bilstm_bwd_f32,
                 "bilstm_bwd_f32_onestage": lstm_cuda.bilstm_bwd_f32_onestage}
        ran = [names[lstm_cuda.sweep_kernel(Ep, Hp, dtype)]]
    else:
        ran = [getattr(lstm_cuda, lstm_cuda.gates_kernel(Ep, Hp, dtype)),
               getattr(lstm_cuda, lstm_cuda.lite_kernel(Hp, dtype))]
    ran.append(getattr(lstm_cuda, lstm_cuda.wgrad_kernel(Ep, Hp, dtype)))
    before = [f.launches for f in ran]
    fwd = lstm_cuda.layer_fwd(parts, lengths, w_ih, w_hh, bias, dtype, with_states=True)
    hs_f, hs_b, _, _, cs_f, cs_b = fwd
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn, dcn, dtype)
    bwd = lstm_cuda.layer_bwd(*args)
    torch.cuda.synchronize()
    assert all(f.launches > b for f, b in zip(ran, before)), [f.__name__ for f in ran]
    cpu = lambda t: (tuple(x.cpu() for x in t) if isinstance(t, (tuple, list))  # noqa: E731
                     else t.cpu())
    want_f = bidir_layer(*map(cpu, (parts, lengths, w_ih, w_hh, bias)), dtype, with_states=True)
    _close([t.cpu() for t in fwd], want_f, tol)
    want_b = bidir_layer_bwd(*map(cpu, args[:-1]), dtype)
    flat = lambda r: list(r[0]) + list(r[1]) + list(r[2:])  # noqa: E731
    _close([t.cpu() for t in flat(bwd)], flat(want_b), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hp", [(80, 96), (48, 64), (16, 32), (288, 288), (300, 320),
                                  (320, 320), (1024, 1024)])
def test_recurrence_op_at_padded_widths_on_card(cuda_device, dtype, H, Hp):
    """``fused_lstm_recurrence`` at a width the kernels do not take runs at
    ``recurrence_width`` (zero units in each gate block); its outputs and
    the gradients of ``xg`` and ``w`` equal the CPU plain op's at the true
    H (1e-4 x max(1, max|ref|) in f32, 3e-2 in bf16). At 288 the cluster
    kernels' 288-thread instance runs, past it the tensor-core ones."""
    assert lstm_cuda.recurrence_width(H, dtype) == Hp
    T, D, B, G = 12, 2, 10, 2
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, dtype, cuda_device, "holes",
                                                  seed=H)
    # the launch counts on the wrapper of the forward the dispatch names (bf16
    # past 288: the tensor-core one)
    fwd = getattr(lstm_cuda, lstm_cuda.recurrence_fwd_kernel(Hp, dtype))
    before = fwd.launches
    outs, grads = [], []
    for dev in (cuda_device, torch.device("cpu")):
        xg_r = xg.to(dev).clone().requires_grad_()
        w_r = w.to(dev).clone().requires_grad_()
        out = fused_lstm_recurrence(xg_r, valid.to(dev), w_r, G, dtype)
        torch.autograd.backward(out, [t.to(dev) for t in (dhs, dhn, dcn)])
        outs.append([t.detach().cpu() for t in out])
        grads.append([xg_r.grad.cpu(), w_r.grad.cpu()])
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    _close(outs[0], outs[1], tol)
    _close(grads[0], grads[1], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_layer_model_at_embedding_80_on_card(cuda_device, dtype):
    """The default two-layer model at embedding 80: layer 0 resident (in f32
    the tensor-core forward ``bilstm_fwd_f32.cu`` and the one-stage sweep,
    in bf16 the tensor-core forward ``bilstm_fwd_mma.cu`` and sweep
    ``bilstm_bwd_mma.cu``, their <80, 80> instances, never the CUDA-core
    ones), the stacked layer padded to 96 on the wide route (its lite sweep
    in f32 the one-block ``bilstm_bwd_lite_f32_resident.cu``, in bf16 the
    one-block ``bilstm_bwd_lite_mma_resident.cu``, never
    ``bilstm_bwd_lite.cu``; its forward in f32 the one-block
    ``bilstm_fwd_wide_f32_resident.cu``, in bf16 the one-block
    ``bilstm_fwd_wide_mma_resident.cu``, never ``bilstm_fwd_wide.cu``); its gradients
    equal the CPU plain path's (1e-4
    x max(1, max|grad|) in f32, 2^-7 in bf16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dtype == torch.float32
    wrappers = (lstm_cuda.bilstm_bwd_f32_onestage, lstm_cuda.bilstm_bwd_mma, lstm_cuda.bilstm_bwd,
                lstm_cuda.bilstm_bwd_lite_f32_resident,
                lstm_cuda.bilstm_layer_fwd_train, lstm_cuda.bilstm_layer_fwd_train_f32,
                lstm_cuda.bilstm_layer_fwd_train_mma, lstm_cuda.bilstm_bwd_lite_mma_resident,
                lstm_cuda.bilstm_fwd_wide_train_mma_resident,
                lstm_cuda.bilstm_fwd_wide_train_f32_resident)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=dtype, embedding_size=80)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [
        int(f32), int(not f32), 0, int(f32), 0, int(f32), int(not f32), int(not f32),
        int(not f32), int(f32)]
    want = model_grads(torch.device("cpu"), dtype=dtype, embedding_size=80)
    tol = 1e-4 if f32 else 2.0 ** -7
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= tol * max(
            1.0, float(ref.abs().max())), name


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(1, 30), (1500, 40)])
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("E_parts,H", [([16], 16), ([48, 48], 48), ([80], 80), ([80, 80], 80)])
def test_wgrad_mma_masked_gate_tile_matches_plain_on_card(cuda_device, E_parts, H, G, T, B):
    """The bf16 tensor-core weight gradients at H % 32 != 0 (the last
    128-row gate tile masked: 4H = 64, 192, 320) against their plain twin:
    dgc zero past each row's ragged length, as a sweep leaves it, 1 and 2
    parts, 1 and 5 weight groups, T = 1 (every h_prev past an end) and
    1500. The dispatch hands ``bilstm_wgrad`` to it."""
    cd = torch.bfloat16
    assert lstm_cuda.wgrad_kernel(E_parts, H, cd) == "bilstm_wgrad_mma"
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device,
                                                           seed=H + T)
    hs_f, hs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd)[:2]
    g = torch.Generator(device=cuda_device).manual_seed(H)
    live = (torch.arange(T, device=cuda_device)[:, None] < lengths[None, :]).to(cd)
    dgc = ((torch.rand(2, T, B, 4 * H, generator=g, device=cuda_device) * 2 - 1).to(cd)
           * live[None, :, :, None])
    want = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
    before = (lstm_cuda.bilstm_wgrad.launches, lstm_cuda.bilstm_wgrad_mma.launches)
    _close(lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, G), want, 3e-2)
    torch.cuda.synchronize()
    assert (lstm_cuda.bilstm_wgrad.launches, lstm_cuda.bilstm_wgrad_mma.launches) == (
        before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_kernels_at_288_match_plain_on_card(cuda_device, dtype, T):
    """At H = 288 the dispatch names the tensor-core wide forward and lite
    sweep in both dtypes (three tf32 passes in f32), which agree with their
    plain twins (60 rows in 5 weight groups, ragged lengths; 1e-4 x max(1,
    max|ref|) in f32, 3e-2 in bf16); the CUDA-core forward (whose 288-thread
    instance is gone) and lite sweep take no width past 256 in either dtype:
    asked for by name, they refuse before any launch."""
    H, G, B = 288, 5, 60
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, dtype,
                                                                 cuda_device, seed=T)
    f32 = dtype == torch.float32
    assert lstm_cuda.wide_fwd_kernel(H, dtype) == (
        "bilstm_fwd_wide_f32" if f32 else "bilstm_fwd_wide_mma")
    assert lstm_cuda.lite_kernel(H, dtype) == (
        "bilstm_bwd_lite_f32" if f32 else "bilstm_bwd_lite_mma")
    xg = input_gates(parts, w_ih, bias, dtype)
    want = bidir_recurrence(xg, lengths, w_hh, dtype, with_states=True)
    for fwd in (lstm_cuda.bilstm_fwd_wide_train, lstm_cuda.bilstm_fwd_wide):
        with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
            fwd(xg, lengths, w_hh, dtype, kernel="bilstm_fwd_wide")
    hs_f, hs_b, _, _, cs_f, cs_b = want
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, tuple(dy[:2]), tuple(dy[2:]), dhn, dcn,
            dtype)
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    _close(lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype), want, tol)
    _close([lstm_cuda.bilstm_bwd_lite(*args)], [bidir_layer_sweep_lite(*args)], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,D,G,B,T,mask", [
    (320, 2, 2, 16, 12, "lengths"), (320, 1, 5, 30, 9, "holes"), (352, 3, 1, 9, 7, "holes"),
    (512, 2, 5, 50, 10, "lengths"), (512, 3, 2, 20, 7, "holes"), (512, 2, 1, 10, 1, "holes"),
    (512, 1, 1, 81, 5, "off"), (512, 2, 5, 400, 3, "lengths"), (1024, 2, 2, 12, 6, "holes"),
    (992, 2, 1, 9, 5, "lengths"), (1024, 1, 5, 10, 1, "off")])
def test_recurrence_wide_mma_kernels_match_plain_on_card(cuda_device, H, D, G, B, T, mask):
    """The bf16 tensor-core forward and sweep past 288 against their plain
    twins at 2^-7 x max(1, max|ref|): D = 1, 2 and 3; G = 1, 2 and 5; masks
    from lengths, with holes (an all-off and an all-on row) and all off;
    T = 1; groups of 8, 6, 9, 10, 80 and 81 rows, which leave short row
    tiles; the sweep with dhs and dcn None, and with all three None. The
    dispatch names them (their wrappers count the launches); the bf16 sweep
    of 96-288 asked for by name refuses past 288 units."""
    cd, tol = torch.bfloat16, 2.0 ** -7
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, cuda_device,
                                                  "holes" if mask == "off" else mask, seed=H + T)
    if mask == "off":
        valid = torch.zeros_like(valid)
    assert lstm_cuda.recurrence_fwd_kernel(H, cd) == "lstm_recurrence_fwd_wide_mma"
    assert lstm_cuda.recurrence_sweep_kernel(H, cd) == "lstm_recurrence_bwd_wide_mma"
    wrappers = (lstm_cuda.lstm_recurrence_fwd_wide_mma, lstm_cuda.lstm_recurrence_bwd_wide_mma,
                lstm_cuda.lstm_recurrence_fwd, lstm_cuda.lstm_recurrence_bwd)
    before = [f.launches for f in wrappers]
    ref = recurrence_fwd(xg, valid, w, G, cd)
    _close(lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd), ref, tol)
    hs, cs = ref[:2]
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    dxg = recurrence_sweep(*args)
    _close([lstm_cuda.lstm_recurrence_bwd(*args)], [dxg], tol)
    for part in ((xg, valid, w, hs, cs, None, dhn, None, G, cd),
                 (xg, valid, w, hs, cs, None, None, None, G, cd)):
        _close([lstm_cuda.lstm_recurrence_bwd_wide_mma(*part)], [recurrence_sweep(*part)], tol)
    with pytest.raises(ValueError, match="lstm_recurrence_bwd_mid_mma and lstm_recurrence_fwd"):
        lstm_cuda.lstm_recurrence_bwd(*args, kernel="lstm_recurrence_bwd_mid_mma")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 3, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("H", [320, 512])
def test_recurrence_wide_mma_autograd_on_card(cuda_device, H):
    """``fused_lstm_recurrence`` in bf16 past 288 on the card, through the
    tensor-core forward and sweep and the tensor-core wgrad: outputs and the
    gradients of xg and w equal the CPU plain path's (3e-2 x max(1,
    max|ref|), the repo's bf16 tolerance for the op's gradients: the
    gate cotangents are rounded to bf16 for dW on both sides, in another
    order of sums)."""
    T, D, B, G, cd = 10, 2, 12, 2, torch.bfloat16
    cpu = recurrence_case(T, D, B, H, G, cd, torch.device("cpu"), "holes", seed=H)
    wrappers = (lstm_cuda.lstm_recurrence_fwd_wide_mma, lstm_cuda.lstm_recurrence_bwd_wide_mma,
                lstm_cuda.lstm_recurrence_wgrad_mma)
    before = [f.launches for f in wrappers]
    got = {}
    for dev in (cuda_device, torch.device("cpu")):
        xg, valid, w, dhs, dhn, dcn = (t.to(dev) for t in cpu)
        xg.requires_grad_(), w.requires_grad_()
        out = fused_lstm_recurrence(xg, valid, w, G, cd)
        torch.autograd.backward(out, [dhs, dhn, dcn])
        got[dev.type] = [xg.grad.cpu(), w.grad.cpu(), *(o.detach().cpu() for o in out)]
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1, 1]
    _close(got["cuda"], got["cpu"], 3e-2)


@pytest.mark.cuda
def test_recurrence_wide_mma_rejects_bad_operands_on_card(cuda_device):
    """The tensor-core wrappers past 288 refuse what their kernels do not
    take, before any launch: another compute dtype, a width up to 288, a
    weight of the wrong shape or dtype, a mask of the wrong shape, an
    unknown kernel name, and operands that require grad."""
    T, D, B, G, H = 3, 2, 4, 1, 320
    cd = torch.bfloat16
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, cuda_device, "holes")
    hs = torch.zeros(T, D, B, H, device=cuda_device)
    wrappers = (lstm_cuda.lstm_recurrence_fwd_wide_mma, lstm_cuda.lstm_recurrence_bwd_wide_mma)
    before = [f.launches for f in wrappers]
    with pytest.raises(ValueError, match="take compute dtype bfloat16"):
        lstm_cuda.lstm_recurrence_fwd_wide_mma(xg, valid, w.float(), G, torch.float32)
    small = recurrence_case(T, D, B, 288, G, cd, cuda_device, "holes")
    with pytest.raises(ValueError, match="from 320 to 1024"):
        lstm_cuda.lstm_recurrence_fwd_wide_mma(*small[:3], G, cd)
    with pytest.raises(ValueError, match="from 320 to 1024"):
        lstm_cuda.lstm_recurrence_bwd_wide_mma(*small[:3], small[3], small[3], None, None, None,
                                               G, cd)
    with pytest.raises(ValueError, match="bilstm kernel: w"):
        lstm_cuda.lstm_recurrence_fwd_wide_mma(xg, valid, w.float(), G, cd)
    with pytest.raises(ValueError, match="valid must be"):
        lstm_cuda.lstm_recurrence_bwd_wide_mma(xg, valid[:, :1], w, hs, hs, None, None, None,
                                               G, cd)
    with pytest.raises(ValueError, match="no forward kernel named"):
        lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd, kernel="lstm_recurrence_fwd_fast")
    # the tensor-core forward with one block a row tile takes H = 32 and 64 alone
    with pytest.raises(ValueError, match="lstm_recurrence_fwd_mma kernel takes compute dtype"):
        lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd, kernel="lstm_recurrence_fwd_mma")
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_bwd_wide_mma(xg.clone().requires_grad_(), valid, w, hs, hs,
                                               None, None, None, G, cd)
    assert [f.launches for f in wrappers] == before


@pytest.mark.cuda
def test_recurrence_op_past_1024_raises_on_card(cuda_device):
    """The card's recurrence kernels take H <= 1024: the op at H = 1040
    raises, naming the limit, and launches nothing; the same operands on
    the CPU run the plain twins."""
    T, D, B, G, H = 2, 2, 4, 1, 1040
    xg, valid, w, _, _, _ = recurrence_case(T, D, B, H, G, torch.float32, cuda_device, "holes")
    before = lstm_cuda.lstm_recurrence_fwd.launches
    with pytest.raises(ValueError, match="H <= 1024 on the card"):
        fused_lstm_recurrence(xg, valid, w, G, torch.float32)
    assert lstm_cuda.lstm_recurrence_fwd.launches == before
    hs, hn, cn = fused_lstm_recurrence(xg.cpu(), valid.cpu(), w.cpu(), G, torch.float32)
    assert hs.shape == (T, D, B, H) and torch.isfinite(hs).all()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("G,B,rows", [(5, 60, 16), (5, 60, 32), (1, 70, 32), (3, 27, 16),
                                      (5, 400, 32), (2, 30, 32)])
def test_lite_mma_at_288_matches_plain_on_card(cuda_device, monkeypatch, G, B, rows, T):
    """The tensor-core lite sweep at H = 288 (its instance for 4 or 5 unit
    groups a block, one partial buffer) at each row tile it is built for
    (pinned with monkeypatch on the plan's candidates) against its plain
    twin at the repo's bf16 tolerance, 3e-2 x max(1, max|ref|): G = 1, 2, 3
    and 5, groups of 12, 70, 9, 80 and 15 rows (short tiles), lengths of 0,
    1 and T, T = 1; 0, 1 and 2 dy streams a direction, with and without
    final-state cotangents; the dispatch names it and its wrapper counts
    each launch; the CUDA-core sweep asked for by name refuses 288 units."""
    monkeypatch.setattr(lstm_cuda, "LITE_MMA_UNEVEN_ROWS", (rows,))
    H, cd = 288, torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd,
                                                                 cuda_device, seed=B + T)
    assert lstm_cuda.lite_kernel(H, cd) == "bilstm_bwd_lite_mma"
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_bwd_lite_mma,)
    before = [f.launches for f in wrappers]
    for ny, final in ((2, True), (1, False), (0, True), (2, False)):
        args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
                dhn if final else None, dcn if final else None, cd)
        want = bidir_layer_sweep_lite(*args)
        _close([lstm_cuda.bilstm_bwd_lite(*args)], [want], 3e-2)
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [4]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("G,B,rows", [(5, 60, 16), (5, 400, 32), (1, 70, 32), (3, 27, 16)])
def test_lite_mma_uneven_at_256_matches_plain_on_card(cuda_device, monkeypatch, G, B, rows, T):
    """H = 288's instance for uneven unit groups, asked for by name at
    H = 256 (4 groups a block), at each row tile it is built for against
    its plain twin at 3e-2 x max(1, max|ref|): 0-2 dy streams, with and
    without final-state cotangents, short tiles, lengths of 0, 1 and T.
    At 128, which it is not built for, it raises and launches nothing."""
    monkeypatch.setattr(lstm_cuda, "LITE_MMA_UNEVEN_ROWS", (rows,))
    H, cd = 256, torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd,
                                                                 cuda_device, seed=B + T)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    for ny, final in ((2, True), (1, False), (0, True)):
        args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
                dhn if final else None, dcn if final else None, cd)
        _close([lstm_cuda.bilstm_bwd_lite_mma(*args, uneven=True)],
                [bidir_layer_sweep_lite(*args)], 3e-2)
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, 8, [128], 128, 1, cd,
                                                                 cuda_device)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    before = lstm_cuda.bilstm_bwd_lite_mma.launches
    with pytest.raises(ValueError, match="uneven instance takes H = 256 and 288"):
        lstm_cuda.bilstm_bwd_lite_mma(xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:1],
                                      dy[2:3], None, None, cd, uneven=True)
    assert lstm_cuda.bilstm_bwd_lite_mma.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("E_parts,G", [([272], 5), ([272, 272], 1)])
def test_lite_mma_at_288_takes_the_model_layers_on_card(cuda_device, E_parts, G):
    """Both layers of the bf16 model at embedding 272 (run at H = 288) at
    the train step's 400 rows and T = 300: ``layer_bwd`` launches the
    tensor-core lite sweep and not the CUDA-core one, and agrees with the
    plain layer at the true widths (3e-2 x max(1, max|ref|))."""
    H, cd, T, B = 272, torch.bfloat16, 300, 400
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, cd,
                                                                 cuda_device, seed=G)
    assert lstm_cuda.lite_kernel(lstm_cuda.padded_width(E_parts, H, cd), cd) == \
        "bilstm_bwd_lite_mma"
    ny = 2 if len(E_parts) == 1 else 1
    hs_f, hs_b, _, _, cs_f, cs_b = lstm_cuda.layer_fwd(parts, lengths, w_ih, w_hh, bias, cd,
                                                       with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn, dcn, cd)
    wrappers = (lstm_cuda.bilstm_bwd_lite_mma, lstm_cuda.bilstm_wgrad_ih)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.layer_bwd(*args)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1]
    want = bidir_layer_bwd(*args)
    flat = lambda r: list(r[0]) + list(r[1]) + list(r[2:])  # noqa: E731
    _close(flat(got), flat(want), 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("H,D,G,B,T,mask", [
    (320, 2, 2, 16, 12, "lengths"), (320, 1, 5, 30, 9, "holes"), (352, 3, 1, 9, 7, "holes"),
    (512, 2, 5, 50, 10, "lengths"), (512, 3, 2, 20, 7, "holes"), (512, 2, 1, 10, 1, "holes"),
    (512, 1, 1, 81, 5, "off"), (512, 2, 5, 400, 3, "lengths"), (544, 2, 2, 12, 6, "holes"),
    (1024, 2, 2, 12, 6, "holes"), (992, 2, 1, 9, 5, "lengths"), (1024, 1, 5, 10, 1, "off")])
def test_recurrence_wide_f32_matches_plain_on_card(cuda_device, H, D, G, B, T, mask):
    """The f32 tensor-core sweep past 288 (three tf32 passes) against its
    plain twin at 1e-4 x max(1, max|ref|): D = 1, 2 and 3; G = 1, 2 and 5;
    masks from lengths, with holes (an all-off and an all-on row) and all
    off; T = 1; groups of 8, 6, 9, 10, 80 and 81 rows, which leave short
    row tiles; up to 512 (32- or 16-row tiles) and past it (two unit groups
    a warp, 16-row tiles) to the stop at 1024; dhs, dhn and dcn None in
    turn. The dispatch names it (its wrapper counts the launches), and the
    f32 sweep of 96-288 asked for by name refuses past 288 units."""
    cd, tol = torch.float32, 1e-4
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, cuda_device,
                                                  "holes" if mask == "off" else mask, seed=H + T)
    if mask == "off":
        valid = torch.zeros_like(valid)
    assert lstm_cuda.recurrence_sweep_kernel(H, cd) == "lstm_recurrence_bwd_wide_f32"
    wrappers = (lstm_cuda.lstm_recurrence_bwd_wide_f32, lstm_cuda.lstm_recurrence_bwd)
    before = [f.launches for f in wrappers]
    hs, cs = recurrence_fwd(xg, valid, w, G, cd)[:2]
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    dxg = recurrence_sweep(*args)
    _close([lstm_cuda.lstm_recurrence_bwd(*args)], [dxg], tol)
    for part in ((xg, valid, w, hs, cs, None, dhn, None, G, cd),
                 (xg, valid, w, hs, cs, dhs, None, dcn, G, cd),
                 (xg, valid, w, hs, cs, None, None, None, G, cd)):
        _close([lstm_cuda.lstm_recurrence_bwd_wide_f32(*part)], [recurrence_sweep(*part)], tol)
    with pytest.raises(ValueError, match="lstm_recurrence_bwd_mid_f32 takes compute dtype"):
        lstm_cuda.lstm_recurrence_bwd(*args, kernel="lstm_recurrence_bwd_mid_f32")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [4, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("H", [320, 512])
def test_recurrence_wide_f32_autograd_on_card(cuda_device, monkeypatch, H):
    """``fused_lstm_recurrence`` in f32 past 288 on the card, through the
    f32 tensor-core forward and sweep (one f32 fragment copy of the weights
    built once for both) and the f32 tensor-core wgrad, never the cluster
    kernels or the CUDA-core wgrad: outputs and the gradients of xg and w
    equal the CPU plain path's within 1e-4 x max(1, max|ref|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    T, D, B, G, cd = 10, 2, 12, 2, torch.float32
    cpu = recurrence_case(T, D, B, H, G, cd, torch.device("cpu"), "holes", seed=H)
    wrappers = (lstm_cuda.lstm_recurrence_fwd_wide_f32, lstm_cuda.lstm_recurrence_bwd_wide_f32,
                lstm_cuda.lstm_recurrence_fwd, lstm_cuda.lstm_recurrence_bwd,
                lstm_cuda.lstm_recurrence_wgrad, lstm_cuda.lstm_recurrence_wgrad_f32)
    copies = []
    weights = lstm_cuda.recurrence_f32_weights
    monkeypatch.setattr(lstm_cuda, "recurrence_f32_weights",
                        lambda w: copies.append(w.shape) or weights(w))
    before = [f.launches for f in wrappers]
    got = {}
    for dev in (cuda_device, torch.device("cpu")):
        xg, valid, w, dhs, dhn, dcn = (t.to(dev) for t in cpu)
        xg.requires_grad_(), w.requires_grad_()
        out = fused_lstm_recurrence(xg, valid, w, G, cd)
        torch.autograd.backward(out, [dhs, dhn, dcn])
        got[dev.type] = [xg.grad.cpu(), w.grad.cpu(), *(o.detach().cpu() for o in out)]
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1, 0, 0, 0, 1]
    assert copies == [(D, G, H, 4 * H)]  # one copy for the forward and the sweep
    _close(got["cuda"], got["cpu"], 1e-4)


@pytest.mark.cuda
def test_recurrence_wide_f32_rejects_bad_operands_on_card(cuda_device):
    """The f32 tensor-core sweep past 288 refuses what its kernel does not
    take, before any launch: bf16, a width up to 288, a weight of the wrong
    dtype, a mask of the wrong shape, an unknown kernel name, and operands
    that require grad."""
    T, D, B, G, H = 3, 2, 4, 1, 320
    cd = torch.float32
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, cuda_device, "holes")
    hs = torch.zeros(T, D, B, H, device=cuda_device)
    wrapper = lstm_cuda.lstm_recurrence_bwd_wide_f32
    before = wrapper.launches
    with pytest.raises(ValueError, match="takes compute dtype float32"):
        wrapper(xg, valid, w.to(torch.bfloat16), hs, hs, None, None, None, G, torch.bfloat16)
    small = recurrence_case(T, D, B, 288, G, cd, cuda_device, "holes")
    with pytest.raises(ValueError, match="from 320 to 1024"):
        wrapper(*small[:3], small[3], small[3], None, None, None, G, cd)
    with pytest.raises(ValueError, match="bilstm kernel: w"):
        wrapper(xg, valid, w.to(torch.bfloat16), hs, hs, None, None, None, G, cd)
    with pytest.raises(ValueError, match="valid must be"):
        wrapper(xg, valid[:, :1], w, hs, hs, None, None, None, G, cd)
    with pytest.raises(ValueError, match="no sweep kernel named"):
        lstm_cuda.lstm_recurrence_bwd(xg, valid, w, hs, hs, None, None, None, G, cd,
                                      kernel="lstm_recurrence_bwd_f64")
    with pytest.raises(RuntimeError, match="no autograd graph"):
        wrapper(xg.clone().requires_grad_(), valid, w, hs, hs, None, None, None, G, cd)
    assert wrapper.launches == before


# ------------- the tensor-core sweep at E = H = 80 and wide forward at 288
@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 1])
@pytest.mark.parametrize("E_parts,G,B,ny,final", [
    ([80], 5, 400, 2, True), ([80], 5, 60, 2, False), ([80], 1, 13, 0, False),
    ([40, 40], 3, 27, 1, True), ([80], 2, 18, 1, True)])
def test_sweep_mma_at_80_matches_plain_on_card(cuda_device, T, E_parts, G, B, ny, final):
    """The tensor-core sweep's <80, 80> instance (10 warps, rows 8-15 of
    each warp's dh tile carrying all 80 dx columns) against its plain twin
    at 3e-2 x max(1, max|ref|): the main path's 400 rows in 5 groups with
    two dy streams a direction, 1 and 2 input parts, 0-2 dy streams, with
    and without final-state cotangents, groups of 80, 12, 13, 9 and 9 rows
    (short tiles), lengths of 0, 1 and T, rows 8-15 short of T. The
    dispatch hands ``bilstm_bwd`` to it; ``bilstm_bwd.cu`` asked for by name
    refuses the shape the tensor-core sweep took over."""
    cd, H = torch.bfloat16, 80
    assert lstm_cuda.sweep_kernel(E_parts, H, cd) == "bilstm_bwd_mma"
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, cd,
                                                                 cuda_device, seed=T + B + 3)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn if final else None, dcn if final else None, cd)
    want = bidir_layer_sweep(*args)
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    wrappers = (lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_mma)
    before = [f.launches for f in wrappers]
    _close(flat(lstm_cuda.bilstm_bwd_mma(*args)), flat(want), 3e-2)
    _close(flat(lstm_cuda.bilstm_bwd(*args)), flat(want), 3e-2)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [0, 2]
    with pytest.raises(ValueError, match="not asked for by name where the bf16 tensor-core"):
        lstm_cuda.bilstm_bwd(*args, kernel="bilstm_bwd")
    assert lstm_cuda.bilstm_bwd.launches == before[0]


@pytest.mark.cuda
def test_sweep_mma_at_80_at_the_main_path_shape_on_card(cuda_device):
    """Layer 0 of the bf16 two-layer model at embedding 80: E = H = 80, 400
    rows in 5 groups, two dy streams, T = 1500, the main path's lengths
    (groups at 0, 1 and T, the rest random), against the plain twin at
    3e-2 x max(1, max|ref|)."""
    cd, T, B, G = torch.bfloat16, 1500, 400, 5
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [80], 80, G, cd,
                                                                 cuda_device, seed=12)
    lengths[:240] = torch.tensor([0, 1, T], device=cuda_device).repeat_interleave(80)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn,
            cd)
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    _close(flat(lstm_cuda.bilstm_bwd_mma(*args)), flat(bidir_layer_sweep(*args)), 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("G,B,rows", [(5, 400, 32), (1, 400, 40), (5, 60, 16), (3, 27, 32),
                                      (5, 60, 40), (1, 70, 16)])
def test_fwd_wide_mma_at_288_matches_plain_on_card(cuda_device, monkeypatch, G, B, rows, T):
    """The tensor-core wide forward's instance for uneven unit groups at
    H = 288 (4 or 5 groups a block, the (group, n8 tile) items dealt over 8
    warps) at each row tile it is built for (pinned with monkeypatch on the
    plan's candidates), both variants against the plain recurrence at
    3e-2 x max(1, max|ref|): the main path's 400 rows in 5 groups and in
    1, groups of 12, 9 and 70 rows (short tiles), lengths of 0, 1 and T.
    (At 400 rows in 5 groups the 32-row tile is the plan's.)
    The dispatch names it, the eval and train variants give the same hs
    bits, and the retired CUDA-core forward's name is refused."""
    monkeypatch.setattr(lstm_cuda, "FWD_WIDE_MMA_UNEVEN_ROWS", (rows,))
    H, cd = 288, torch.bfloat16
    assert lstm_cuda.wide_fwd_kernel(H, cd) == "bilstm_fwd_wide_mma"
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                           seed=B + T + rows)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_fwd_wide_mma, lstm_cuda.bilstm_fwd_wide_train_mma)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
    ev = lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1]
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
        lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")


@pytest.mark.cuda
@pytest.mark.parametrize("E_parts,G", [([272], 5), ([272, 272], 1)])
def test_fwd_wide_mma_at_288_takes_the_model_layers_on_card(cuda_device, E_parts, G):
    """Both layers of the bf16 model at embedding 272 (run at H = 288) at
    the train step's 400 rows and T = 300: ``layer_fwd`` (both variants)
    launches the tensor-core forward and never the CUDA-core one, and agrees
    with the plain layer at the true widths (3e-2 x max(1, max|ref|))."""
    H, cd, T, B = 272, torch.bfloat16, 300, 400
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device,
                                                           seed=G + 1)
    wrappers = (lstm_cuda.bilstm_fwd_wide_mma, lstm_cuda.bilstm_fwd_wide_train_mma)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.layer_fwd(parts, lengths, w_ih, w_hh, bias, cd, with_states=True)
    ev = lstm_cuda.layer_fwd(parts, lengths, w_ih, w_hh, bias, cd)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1]
    want = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd, with_states=True)
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16])
def test_two_layer_model_at_embedding_272_on_card(cuda_device, dtype):
    """The bf16 two-layer model at embedding 272, both layers run at
    H = 288 on the wide route: its forwards are the tensor-core forward's
    instance for uneven groups (never the 288-thread CUDA-core one) and its
    sweeps the tensor-core lite sweep's; its gradients equal the CPU plain
    path's within 2^-7 x max(1, max|grad|)."""
    wrappers = (lstm_cuda.bilstm_fwd_wide_train_mma, lstm_cuda.bilstm_bwd_lite_mma,
                lstm_cuda.bilstm_wgrad_ih)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=dtype, embedding_size=272)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 2, 2]
    want = model_grads(torch.device("cpu"), dtype=dtype, embedding_size=272)
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= 2.0 ** -7 * max(
            1.0, float(ref.abs().max())), name


@pytest.mark.cuda
def test_sweep_mma_at_80_and_fwd_wide_mma_at_288_reject_bad_operands_on_card(cuda_device):
    """What the two kernels do not take raises and launches nothing, with no
    fall back: the sweep at E = 48, H = 80 and in f32 at E = H = 80, a
    wrong-typed weight; the forward at 288 in f32, at 320, and a wrong-typed
    or wrong-shaped operand."""
    wrappers = (lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_bwd_mma, lstm_cuda.bilstm_fwd_wide_mma,
                lstm_cuda.bilstm_fwd_wide_train_mma)
    before = [f.launches for f in wrappers]
    for E_parts, dtype, match in (([48], torch.bfloat16, "bilstm_bwd_mma kernel takes bfloat16"),
                                  ([80], torch.float32, "bilstm_bwd_mma kernel takes bfloat16")):
        parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 16, E_parts, 80, 2, dtype,
                                                                     cuda_device)
        hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, dtype,
                                                   with_states=True)
        with pytest.raises(ValueError, match=match):
            lstm_cuda.bilstm_bwd_mma(parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
                                     dy[:2], dy[2:], dhn, dcn, dtype)
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 16, [80], 80, 2,
                                                                 torch.bfloat16, cuda_device)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, torch.bfloat16,
                                               with_states=True)
    with pytest.raises(ValueError, match="w_ih must be a contiguous"):
        lstm_cuda.bilstm_bwd_mma(parts, lengths, w_ih.float(), w_hh, bias, hs_f, hs_b, cs_f,
                                 cs_b, dy[:2], dy[2:], dhn, dcn, torch.bfloat16)
    for H, dtype in ((288, torch.float32), (320, torch.bfloat16)):
        xg = torch.zeros(2, 3, 8, 4 * H, device=cuda_device)
        w = torch.zeros(2, 4 * H, H, dtype=dtype, device=cuda_device)
        with pytest.raises(ValueError, match="bilstm_fwd_wide_mma kernel takes bfloat16"):
            lstm_cuda.bilstm_fwd_wide_mma(xg, lengths[:8], w, dtype)
    xg = torch.zeros(2, 3, 8, 4 * 288, device=cuda_device)
    w = torch.zeros(2, 4 * 288, 288, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="w_hh must be a contiguous"):
        lstm_cuda.bilstm_fwd_wide_train_mma(xg, lengths[:8], w.float(), torch.bfloat16)
    with pytest.raises(ValueError, match="lengths must be a contiguous"):
        lstm_cuda.bilstm_fwd_wide_mma(xg, lengths[:7], w, torch.bfloat16)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == before


# ------------------------------------------- the f32 tensor-core lite sweep
@pytest.mark.parametrize("H,want", [(128, {16: 26624, 32: 49152}),
                                    (256, {16: 51200, 32: 94208}),
                                    (288, {16: 58368, 32: 107520}),
                                    (160, {16: 33792, 32: 62464}),
                                    (192, {16: 38912, 32: 71680}),
                                    (224, {16: 46080, 32: 84992})])
def test_lite_f32_smem_and_plan(H, want):
    """The f32 tensor-core lite sweep's shared memory by row tile, as its
    source lays it out (the op sweep's: the f32 h_prev tile and the block's
    f32 dgates tile of ceil(H / 64) groups, rows padded by 16 floats; one
    f32 partial dh of all units, rows padded to 8 mod 16; the weights stay
    in L2); the plan takes the fewest waves, then the smallest tile: at the
    train step's 400 rows in 5 groups with 15 clusters on the card 32-row
    tiles, 30 clusters in two waves. It refuses bf16, the widths it does
    not take and a tile with no instance."""
    got = {R: lstm_cuda.wide_smem("lite_f32", H, R) for R in lstm_cuda.LITE_F32_ROWS}
    assert got == want
    R = 32
    assert want[R] == R * (H + 16) * 4 + R * (32 * -(-H // 64) + 16) * 4 + H * 40 * 4
    assert lstm_cuda.wide_plan("lite_f32", 400, 5, H, lambda R, b: 15) == (32, 15, want[32])
    assert lstm_cuda.wide_plan("lite_f32", 40, 5, H, lambda R, b: 15)[0] == 16
    for bad, dtype in ((96, torch.float32), (320, torch.float32), (H, torch.bfloat16)):
        with pytest.raises(ValueError, match="bilstm_bwd_lite_f32 kernel takes float32"):
            lstm_cuda.lite_f32_check(bad, dtype)
    with pytest.raises(ValueError, match="no instance for a row tile of 24"):
        lstm_cuda.wide_smem("lite_f32", H, 24)


@pytest.mark.parametrize("ny", [0, 2])
@pytest.mark.parametrize("H", [128, 288, 160])
def test_lite_f32_wrapper_takes_plain_version_on_cpu(H, ny):
    """The f32 tensor-core lite sweep takes the plain twin for CPU tensors,
    counting no launch; ``bilstm_bwd_lite`` hands f32 at 128-288 to it only
    on the card and reaches it by name, and refuses the deleted CUDA-core
    sweep's name;
    operands that require grad are refused. Its weight copy is the op
    sweep's layout of ``W_hh^T``: the fragment copy of ``w_hh`` transposed
    is that of the op's ``w``."""
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(5, 6, [H], H, 2, cd,
                                                                 torch.device("cpu"), seed=ny)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny], dhn, dcn, cd)
    wrappers = (lstm_cuda.bilstm_bwd_lite_f32,)
    before = [f.launches for f in wrappers]
    want = bidir_layer_sweep_lite(*args)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite_f32(*args), want)
    for kernel in (None, "bilstm_bwd_lite_f32"):
        assert torch.equal(lstm_cuda.bilstm_bwd_lite(*args, kernel=kernel), want)
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_bwd_lite_f32(xg, lengths, w_hh.clone().requires_grad_(), *args[3:])
    op_w = w_hh.transpose(-1, -2).contiguous()  # (2, G, H, 4H)
    assert torch.equal(lstm_cuda.recurrence_f32_weights(w_hh.transpose(-1, -2)),
                       lstm_cuda.recurrence_f32_weights(op_w))


@pytest.mark.parametrize("H,want", [(320, {32: 93184, 48: 139776}),
                                    (512, {32: 145408, 48: 218112}),
                                    (1024, {16: 142336})])
def test_recurrence_fwd_wide_f32_smem_and_plan(H, want):
    """The f32 tensor-core forward past 288: its shared memory by row tile
    (two f32 h tiles and the block's new h staged, rows padded by 16
    floats: 2 rows (H + 16) 4 + rows (8 ceil(H / 64) + 16) 4 bytes; 32 and
    48 rows up to 512, at 1024 16-row tiles only), and the plan at the train
    step's 400 rows in 5 groups with 15 clusters on the card: the fewest
    waves, then the smallest tile (32 rows up to 512, two waves either way
    at 32 and 48)."""
    rows = lstm_cuda.REC_WIDE_F32_FWD_ROWS[1 if H <= 512 else 2]
    got = {R: lstm_cuda.recurrence_wide_f32_smem(H, R, "fwd") for R in rows}
    assert got == want and all(b <= lstm_cuda.SMEM_LIMIT for b in want.values())
    for R in rows:
        assert want[R] == 2 * R * (H + 16) * 4 + R * (8 * -(-H // 64) + 16) * 4
        assert lstm_cuda.wide_smem("rec_fwd_f32", H, R) == want[R]
    R, tiles, smem = lstm_cuda.wide_plan("rec_fwd_f32", 400, 5, H, lambda R, b: 15, 2)
    waves = {r: -(-2 * 5 * -(-80 // r) // 15) for r in want}
    assert waves[R] == min(waves.values()) and R == min(r for r in want if waves[r] == waves[R])
    assert tiles == 5 * -(-80 // R) and smem == want[R]
    assert R == (32 if H <= 512 else 16)
    for bad in (80, 16 if H <= 512 else 32):
        with pytest.raises(ValueError, match=f"no instance for a row tile of {bad}"):
            lstm_cuda.recurrence_wide_f32_smem(H, bad, "fwd")
    with pytest.raises(ValueError, match="from 320 to 1024"):
        lstm_cuda.recurrence_wide_f32_smem(288, 16, "fwd")


@pytest.mark.parametrize("H", [320, 512])
def test_recurrence_fwd_wide_f32_wrapper_takes_plain_version_on_cpu(H):
    """The f32 tensor-core forward past 288 takes the plain twin for CPU
    tensors, counting no launch, and refuses operands that require grad;
    ``lstm_recurrence_fwd`` hands f32 past 288 to it only on the card and
    reaches it by name."""
    T, D, B, G, cd = 3, 2, 4, 2, torch.float32
    xg, valid, w, _, _, _ = recurrence_case(T, D, B, H, G, cd, torch.device("cpu"), "holes")
    wrappers = (lstm_cuda.lstm_recurrence_fwd_wide_f32, lstm_cuda.lstm_recurrence_fwd)
    before = [f.launches for f in wrappers]
    want = recurrence_fwd(xg, valid, w, G, cd)
    assert all(torch.equal(a, b) for a, b in zip(
        lstm_cuda.lstm_recurrence_fwd_wide_f32(xg, valid, w, G, cd), want))
    for kernel in (None, "lstm_recurrence_fwd_wide_f32"):
        assert all(torch.equal(a, b) for a, b in zip(
            lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd, kernel=kernel), want))
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_fwd_wide_f32(xg, valid, w.clone().requires_grad_(), G, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 32])
@pytest.mark.parametrize("H,G,B,T", [(128, 5, 400, 6), (256, 5, 400, 5), (288, 5, 400, 5),
                                     (128, 1, 30, 12), (256, 3, 27, 9), (288, 1, 20, 1),
                                     (288, 2, 50, 12)])
def test_lite_f32_matches_plain_on_card(cuda_device, monkeypatch, H, G, B, T, rows):
    """The f32 tensor-core lite sweep (three tf32 passes) at each row tile
    (pinned with monkeypatch on the plan's candidates) against its plain
    twin at 1e-4 x max(1, max|ref|): 400 rows in 5 groups (the train step's
    shape) and groups of 30, 9, 20 and 25 rows that leave short tiles, G = 1
    too; 0, 1 and 2 dy streams, with and without final-state cotangents;
    lengths of 0, 1 and T; T = 1. The dispatch names it (its wrapper counts
    the launches), and the CUDA-core sweep asked for by name refuses."""
    monkeypatch.setattr(lstm_cuda, "LITE_F32_ROWS", (rows,))
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd,
                                                                 cuda_device, seed=H + T)
    assert lstm_cuda.lite_kernel(H, cd) == "bilstm_bwd_lite_f32"
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_bwd_lite_f32,)
    before = [f.launches for f in wrappers]
    for ny, final in ((2, True), (1, False), (0, True)):
        args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
                dhn if final else None, dcn if final else None, cd)
        want = bidir_layer_sweep_lite(*args)
        _close([lstm_cuda.bilstm_bwd_lite(*args)], [want], 1e-4)
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [3]


@pytest.mark.cuda
def test_lite_f32_rejects_bad_operands_on_card(cuda_device):
    """The f32 tensor-core lite sweep refuses what its kernel does not take,
    before any launch: bf16, a width it is not built for, a bf16 stream, a
    weight of the wrong shape, three dy streams, an unknown kernel name,
    and operands that require grad."""
    cd, H = torch.float32, 128
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 10, [H], H, 2, cd, cuda_device)
    xg = input_gates(parts, w_ih, bias, cd)
    hs = torch.zeros(4, 10, H, device=cuda_device)
    args = (xg, lengths, w_hh, hs, hs, hs, hs, dy[:1], dy[2:3], dhn, dcn, cd)
    wrapper = lstm_cuda.bilstm_bwd_lite_f32
    before = wrapper.launches
    with pytest.raises(ValueError, match="bilstm_bwd_lite_f32 kernel takes float32"):
        wrapper(*args[:-1], torch.bfloat16)
    with pytest.raises(ValueError, match="bilstm_bwd_lite_f32 kernel takes float32"):
        wrapper(xg[..., :4 * 96].contiguous(), lengths, w_hh[..., :4 * 96, :96].contiguous(),
                *(t[..., :96].contiguous() for t in (hs, hs, hs, hs)), (), (), None, None, cd)
    with pytest.raises(ValueError, match="hs_f must be a contiguous"):
        wrapper(xg, lengths, w_hh, hs.to(torch.bfloat16), *args[4:])
    with pytest.raises(ValueError, match="w_hh must be a contiguous"):
        wrapper(xg, lengths, w_hh[..., :64].contiguous(), *args[3:])
    with pytest.raises(ValueError, match="0-2 dy streams"):
        wrapper(*args[:7], dy[:3], dy[:3], dhn, dcn, cd)
    with pytest.raises(ValueError, match="no lite sweep kernel named"):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite_tf32")
    with pytest.raises(RuntimeError, match="no autograd graph"):
        wrapper(xg.clone().requires_grad_(), *args[1:])
    torch.cuda.synchronize()
    assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("H,D,G,B,T,mask", [
    (320, 2, 2, 16, 12, "lengths"), (320, 1, 5, 30, 9, "holes"), (352, 3, 1, 9, 7, "holes"),
    (512, 2, 5, 50, 10, "lengths"), (512, 3, 2, 20, 7, "holes"), (512, 2, 1, 10, 1, "holes"),
    (512, 1, 1, 81, 5, "off"), (512, 2, 5, 400, 3, "lengths"), (544, 2, 2, 12, 6, "holes"),
    (1024, 2, 2, 12, 6, "holes"), (992, 2, 1, 9, 5, "lengths"), (1024, 1, 5, 10, 1, "off")])
def test_recurrence_fwd_wide_f32_matches_plain_on_card(cuda_device, H, D, G, B, T, mask):
    """The f32 tensor-core forward past 288 (three tf32 passes) against its
    plain twin at 1e-4 x max(1, max|ref|): D = 1, 2 and 3; G = 1, 2 and 5;
    masks from lengths, with holes (an all-off and an all-on row) and all
    off; T = 1; groups that leave short row tiles; up to 512 (32- or
    48-row tiles) and past it (two unit groups a warp, 16-row tiles) to the
    stop at 1024. The dispatch names it (its wrapper counts the launches),
    and a copy of the fragments built by the caller gives the same bits."""
    cd, tol = torch.float32, 1e-4
    xg, valid, w, _, _, _ = recurrence_case(T, D, B, H, G, cd, cuda_device,
                                            "holes" if mask == "off" else mask, seed=H + T)
    if mask == "off":
        valid = torch.zeros_like(valid)
    assert lstm_cuda.recurrence_fwd_kernel(H, cd) == "lstm_recurrence_fwd_wide_f32"
    wrappers = (lstm_cuda.lstm_recurrence_fwd_wide_f32, lstm_cuda.lstm_recurrence_fwd)
    before = [f.launches for f in wrappers]
    ref = recurrence_fwd(xg, valid, w, G, cd)
    got = lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd)
    _close(got, ref, tol)
    wf = lstm_cuda.recurrence_f32_weights(w)
    again = lstm_cuda.lstm_recurrence_fwd_wide_f32(xg, valid, w, G, cd, wf)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 0]


@pytest.mark.cuda
def test_recurrence_fwd_wide_f32_rejects_bad_operands_on_card(cuda_device):
    """The f32 tensor-core forward past 288 refuses what its kernel does
    not take, before any launch: bf16, a width up to 288, a weight of the
    wrong dtype, a mask of the wrong shape, a fragment copy of the wrong
    shape, an unknown kernel name, the f32 forward of H = 32 / 64 asked for
    by name, and operands that require grad."""
    T, D, B, G, H = 3, 2, 4, 1, 320
    cd = torch.float32
    xg, valid, w, _, _, _ = recurrence_case(T, D, B, H, G, cd, cuda_device, "holes")
    wrapper = lstm_cuda.lstm_recurrence_fwd_wide_f32
    before = wrapper.launches
    with pytest.raises(ValueError, match="takes compute dtype float32"):
        wrapper(xg, valid, w.to(torch.bfloat16), G, torch.bfloat16)
    small = recurrence_case(T, D, B, 288, G, cd, cuda_device, "holes")
    with pytest.raises(ValueError, match="from 320 to 1024"):
        wrapper(*small[:3], G, cd)
    with pytest.raises(ValueError, match="bilstm kernel: w"):
        wrapper(xg, valid, w.to(torch.bfloat16), G, cd)
    with pytest.raises(ValueError, match="valid must be"):
        wrapper(xg, valid[:, :, :2], w, G, cd)
    with pytest.raises(ValueError, match="wf must be a contiguous"):
        wrapper(xg, valid, w, G, cd, lstm_cuda.recurrence_f32_weights(small[2]))
    with pytest.raises(ValueError, match="no forward kernel named"):
        lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd, kernel="lstm_recurrence_fwd_tf32")
    with pytest.raises(ValueError, match="lstm_recurrence_fwd_f32 kernel takes compute dtype"):
        lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd, kernel="lstm_recurrence_fwd_f32")
    with pytest.raises(RuntimeError, match="no autograd graph"):
        wrapper(xg.clone().requires_grad_(), valid, w, G, cd)
    torch.cuda.synchronize()
    assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_default_backend_runs_the_op_past_288_on_card(cuda_device, dtype):
    """Past 288 units a layer the default backend ("auto") takes the
    recurrence op: the two-layer model at embedding 320 launches the op's
    tensor-core kernels past 288 (in f32 the three-tf32-pass forward and
    sweep) and no layer kernel; its
    gradients equal the CPU plain path's (1e-4 x max(1, max|grad|) in f32,
    2^-7 in bf16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dtype == torch.float32
    wide = ("lstm_recurrence_fwd_wide_f32", "lstm_recurrence_bwd_wide_f32") if f32 else \
        ("lstm_recurrence_fwd_wide_mma", "lstm_recurrence_bwd_wide_mma")
    wgrad = "lstm_recurrence_wgrad_f32" if f32 else "lstm_recurrence_wgrad_mma"
    layer = [n for n in dir(lstm_cuda) if n.startswith("bilstm_")
             and isinstance(getattr(getattr(lstm_cuda, n), "launches", None), int)]
    names = list(wide) + [wgrad, "lstm_recurrence_fwd", "lstm_recurrence_bwd",
                          "lstm_recurrence_wgrad"] + layer
    before = {n: getattr(lstm_cuda, n).launches for n in names}
    got = model_grads(cuda_device, dtype=dtype, embedding_size=320)
    torch.cuda.synchronize()
    ran = {n: getattr(lstm_cuda, n).launches - b for n, b in before.items()}
    assert all(ran[n] == 2 for n in wide) and ran[wgrad] == 2
    assert all(c == 0 for n, c in ran.items() if n not in wide and n != wgrad), ran
    want = model_grads(torch.device("cpu"), dtype=dtype, embedding_size=320)
    tol = 1e-4 if f32 else 2.0 ** -7
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= tol * max(
            1.0, float(ref.abs().max())), name


# --------- the f32 tensor-core input gates and wide forward, on the card
@pytest.mark.cuda
@pytest.mark.parametrize("H", [128, 256, 288])
@pytest.mark.parametrize("E_parts,G,B,T", [([1], 5, 400, 6), ([1], 1, 27, 5), ([16, 2], 3, 27, 1),
                                           ([2, 1], 1, 130, 3)])
def test_gates_f32_matches_plain_on_card(cuda_device, H, E_parts, G, B, T):
    """The f32 tensor-core input gates (three tf32 passes) against their
    plain twin at 1e-4 x max(1, max|ref|): one and two input parts (widths
    of H, 2H and 16), 400 rows in 5 groups (the train shape), 27 and 130
    rows (a ragged last row tile), T = 1; the same bits computed twice
    (the backward's recompute). The dispatch names it and its wrapper counts
    the launches."""
    cd = torch.float32
    E_parts = [e * H if e < 16 else e for e in E_parts]
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device,
                                                           seed=H + B)
    assert lstm_cuda.gates_kernel(E_parts, H, cd) == "bilstm_gates_f32"
    wrappers = (lstm_cuda.bilstm_gates_f32, lstm_cuda.bilstm_gates_mma)
    before = [f.launches for f in wrappers]
    want = input_gates(parts, w_ih, bias, cd)
    got = lstm_cuda.bilstm_gates(parts, w_ih, bias, cd)
    _close([got], [want], 1e-4)
    assert torch.equal(lstm_cuda.bilstm_gates_f32(parts, w_ih, bias, cd), got)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("H", [128, 256, 288])
@pytest.mark.parametrize("G,B,T", [(5, 400, 6), (1, 27, 5), (3, 27, 1), (1, 70, 9), (5, 60, 4)])
def test_fwd_wide_f32_matches_plain_on_card(cuda_device, monkeypatch, H, G, B, T):
    """The f32 tensor-core wide forward (three tf32 passes), both variants,
    at every row tile it is built for (pinned with monkeypatch on the
    plan's candidates)
    against the plain recurrence at 1e-4 x max(1, max|ref|): 400 rows in 5
    groups, groups of 27, 9, 70 and 12 rows (short tiles), lengths of 0, 1
    and T, T = 1. The eval and train variants give the same hs bits; the
    dispatch names it and its wrappers count the launches; the CUDA-core
    forward by name refuses these widths in f32."""
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                           seed=B + T + H)
    assert lstm_cuda.wide_fwd_kernel(H, cd) == "bilstm_fwd_wide_f32"
    xg = lstm_cuda.bilstm_gates_f32(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_fwd_wide_f32, lstm_cuda.bilstm_fwd_wide_train_f32)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
    ev = lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)
    _close(got, want, 1e-4)
    _close(ev, want[:4], 1e-4)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    rows = lstm_cuda.fwd_wide_f32_rows(H)
    for R in rows:
        monkeypatch.setattr(lstm_cuda, "FWD_WIDE_F32_ROWS", (R,))
        monkeypatch.setattr(lstm_cuda, "FWD_WIDE_F32_ROWS_288", (R,))
        tr = lstm_cuda.bilstm_fwd_wide_train_f32(xg, lengths, w_hh, cd)
        e = lstm_cuda.bilstm_fwd_wide_f32(xg, lengths, w_hh, cd)
        _close(tr, want, 1e-4)
        _close(e, want[:4], 1e-4)
        assert torch.equal(e[0], tr[0]) and torch.equal(e[1], tr[1])
    n = len(rows)
    with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
        lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1 + n, 1 + n]


@pytest.mark.cuda
def test_f32_wide_kernels_reject_bad_operands_on_card(cuda_device):
    """The f32 tensor-core gates and wide forward refuse what their kernels
    do not take, before any launch: bf16, a width the forward is not built
    for, a weight of the wrong shape or dtype, lengths on the CPU, a batch
    that is not a multiple of the weight groups, an unknown kernel name and operands that require grad."""
    cd, H = torch.float32, 128
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 10, [H], H, 2, cd, cuda_device)
    xg = input_gates(parts, w_ih, bias, cd)
    wrappers = (lstm_cuda.bilstm_gates_f32, lstm_cuda.bilstm_fwd_wide_f32,
                lstm_cuda.bilstm_fwd_wide_train_f32)
    before = [f.launches for f in wrappers]
    bf16 = torch.bfloat16
    with pytest.raises(ValueError, match="bilstm_gates_f32 kernel takes torch.float32"):
        lstm_cuda.bilstm_gates_f32(tuple(p.to(bf16) for p in parts), w_ih.to(bf16), bias, bf16)
    with pytest.raises(ValueError, match="w_ih must be a contiguous"):
        lstm_cuda.bilstm_gates_f32(parts, w_ih[..., :64].contiguous(), bias, cd)
    with pytest.raises(ValueError, match="bilstm wide kernels take 1 or 2 input parts"):
        lstm_cuda.bilstm_gates_f32((parts[0][..., :100].contiguous(),),
                                   w_ih[..., :100].contiguous(), bias, cd)
    fwd = lstm_cuda.bilstm_fwd_wide_train_f32
    with pytest.raises(ValueError, match="bilstm_fwd_wide_f32 kernel takes float32"):
        fwd(xg, lengths, w_hh.to(bf16), bf16)
    with pytest.raises(ValueError, match="bilstm_fwd_wide_f32 kernel takes float32"):
        fwd(xg[..., :4 * 96].contiguous(), lengths, w_hh[..., :4 * 96, :96].contiguous(), cd)
    with pytest.raises(ValueError, match="w_hh must be a contiguous"):
        fwd(xg, lengths, w_hh[..., :64].contiguous(), cd)
    with pytest.raises(ValueError, match="lengths must be a contiguous"):
        fwd(xg, lengths.cpu(), w_hh, cd)
    with pytest.raises(ValueError, match="not a multiple of 3 weight groups"):
        fwd(xg, lengths, torch.cat([w_hh, w_hh[:, :1]], 1).contiguous(), cd)
    with pytest.raises(ValueError, match="no wide forward kernel named"):
        lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide_tf32")
    with pytest.raises(RuntimeError, match="no autograd graph"):
        fwd(xg.clone().requires_grad_(), lengths, w_hh, cd)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == before


@pytest.mark.cuda
def test_two_layer_model_at_embedding_272_f32_on_card(cuda_device):
    """The f32 two-layer model at embedding 272 (both layers run at
    H = 288): one gradient step launches the f32 tensor-core gates, wide
    forward and lite sweep and never the CUDA-core gates, forward or sweep;
    its gradients equal the CPU plain path's within 1e-4 x max(1,
    max|grad|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = (lstm_cuda.bilstm_gates_f32, lstm_cuda.bilstm_fwd_wide_train_f32,
                lstm_cuda.bilstm_bwd_lite_f32, lstm_cuda.bilstm_gates_mma)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=torch.float32, embedding_size=272)
    torch.cuda.synchronize()
    ran = [f.launches - b for f, b in zip(wrappers, before)]
    assert min(ran[:3]) > 0 and ran[3:] == [0], ran
    want = model_grads(torch.device("cpu"), dtype=torch.float32, embedding_size=272)
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= 1e-4 * max(
            1.0, float(ref.abs().max())), name


def _main_path_lengths(lengths, G, T):
    """The main path's per-call lengths: every row of groups 0-2 at 0, 1
    and T (where there are three groups), the rest as drawn."""
    if G >= 3:
        Bg = lengths.shape[0] // G
        lengths[:3 * Bg] = torch.tensor([0, 1, T], dtype=lengths.dtype,
                                        device=lengths.device).repeat_interleave(Bg)
    return lengths


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 1])
@pytest.mark.parametrize("E_parts,G,B", [([80], 5, 30), ([80], 1, 13), ([40, 40], 3, 27),
                                         ([16], 2, 22), ([72], 4, 20)])
def test_fwd_f32_at_80_matches_plain_on_card(cuda_device, T, E_parts, G, B):
    """The f32 tensor-core forward at H = 80 (its 320-thread instances: E =
    80 unrolled, other widths read at run time) against its plain twin at
    1e-4 x max(1, max|ref|), both variants: 1 and 2 input parts, groups of
    5, 6, 9, 11 and 13 rows (short tiles inside each group), groups at
    lengths 0, 1 and T, rows of length 0, 1 and T and rows 8-15 short of T;
    the dispatch names it and its wrappers count the launches; the CUDA-core
    forward is not asked for by name there (refused: the f32 tensor-core
    forward took its route)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd, H = torch.float32, 80
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device,
                                                           seed=T + B + 80)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    lengths = _main_path_lengths(lengths, G, T)
    args = (parts, lengths, w_ih, w_hh, bias, cd)
    assert lstm_cuda.fwd_kernel(E_parts, H, cd) == "bilstm_fwd_f32"
    want = bidir_layer(*args, with_states=True)
    wrappers = (lstm_cuda.bilstm_layer_fwd, lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_layer_fwd_f32, lstm_cuda.bilstm_layer_fwd_train_f32)
    before = [f.launches for f in wrappers]
    _close(lstm_cuda.bilstm_layer_fwd_train(*args), want, 1e-4)
    _close(lstm_cuda.bilstm_layer_fwd(*args), want[:4], 1e-4)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [0, 0, 1, 1]


@pytest.mark.cuda
def test_fwd_f32_at_80_at_the_main_path_shape_on_card(cuda_device):
    """Layer 0 of the two-layer model at embedding 80: E = H = 80, 400 rows
    in 5 groups, T = 1500, the main path's lengths (groups at 0, 1 and T,
    the rest random), both variants against the plain twin at 1e-4; the
    two variants give the same hs bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd, T, B, G = torch.float32, 1500, 400, 5
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [80], 80, G, cd, cuda_device,
                                                           seed=12)
    lengths = _main_path_lengths(lengths, G, T)
    args = (parts, lengths, w_ih, w_hh, bias, cd)
    want = bidir_layer(*args, with_states=True)
    got = lstm_cuda.bilstm_layer_fwd_train_f32(*args)
    ev = lstm_cuda.bilstm_layer_fwd_f32(*args)
    _close(got, want, 1e-4)
    _close(ev, want[:4], 1e-4)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("G,B,ny,final", [(1, 30, 1, True), (1, 13, 0, False), (3, 27, 2, True),
                                          (5, 60, 2, False), (2, 22, 1, True)])
def test_lite_f32_resident_matches_plain_on_card(cuda_device, T, G, B, ny, final):
    """The one-block f32 lite sweep at H = 96 (three tf32 passes, W_hh
    resident) against its plain twin at 1e-4 x max(1, max|ref|): 0, 1 and 2
    dy streams, with and without final-state cotangents, groups of 30, 13,
    9, 12 and 11 rows (short tiles inside each group), groups at lengths 0,
    1 and T, rows of length 0, 1 and T and rows 8-15 short of T (a tile
    that stops early). The dispatch names it and its wrapper counts the
    launches; the deleted ``bilstm_bwd_lite.cu``'s name is refused."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd, H = torch.float32, 96
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                                seed=T + B + 96)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    lengths = _main_path_lengths(lengths, G, T)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn if final else None, dcn if final else None, cd)
    want = bidir_layer_sweep_lite(*args)
    assert lstm_cuda.lite_kernel(H, cd) == "bilstm_bwd_lite_f32_resident"
    wrappers = (lstm_cuda.bilstm_bwd_lite_f32_resident,)
    before = [f.launches for f in wrappers]
    _close([lstm_cuda.bilstm_bwd_lite(*args)], [want], 1e-4)
    _close([lstm_cuda.bilstm_bwd_lite_f32_resident(*args)], [want], 1e-4)
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2]


@pytest.mark.cuda
def test_lite_f32_resident_at_the_main_path_shape_on_card(cuda_device):
    """The stacked layer of the f32 model at embedding 80 at its run shape:
    H = 96, input parts 80 + 80, 400 rows in one group, one dy stream a
    direction, T = 1500, ragged lengths; the same bits twice (the pair
    exchange sums in a fixed order), and the plain twin at 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd, T, B, H = torch.float32, 1500, 400, 96
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [80, 80], H, 1, cd,
                                                                cuda_device, seed=13)
    xg = lstm_cuda.bilstm_gates_f32(parts, w_ih, bias, cd)
    del parts
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:1], dy[2:3], dhn, dcn, cd)
    got = lstm_cuda.bilstm_bwd_lite_f32_resident(*args)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite_f32_resident(*args), got)
    _close([got], [bidir_layer_sweep_lite(*args)], 1e-4)


@pytest.mark.cuda
def test_lite_f32_resident_edges_on_card(cuda_device):
    """An empty batch launches nothing and T = 0 gives an empty output;
    bf16 operands and H = 128 raise in the one-block wrapper (nothing falls
    back)."""
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 10, [96], 96, 2, cd,
                                                                cuda_device)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    before = lstm_cuda.bilstm_bwd_lite_f32_resident.launches
    empty = lambda t: t[:, :0].contiguous()  # noqa: E731
    out = lstm_cuda.bilstm_bwd_lite_f32_resident(
        xg[:, :, :0].contiguous(), lengths[:0], w_hh[:, :1].contiguous(),
        *(empty(t) for t in (hs_f, hs_b, cs_f, cs_b)), (), (), None, None, cd)
    assert out.shape == (2, 4, 0, 384)
    out = lstm_cuda.bilstm_bwd_lite_f32_resident(
        xg[:, :0].contiguous(), lengths, w_hh, *(t[:0].contiguous() for t in (hs_f, hs_b, cs_f,
                                                                             cs_b)),
        (), (), dhn, dcn, cd)
    assert out.shape == (2, 0, 10, 384)
    assert lstm_cuda.bilstm_bwd_lite_f32_resident.launches == before
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="bilstm_bwd_lite_f32_resident kernel takes float32"):
        lstm_cuda.bilstm_bwd_lite_f32_resident(xg, lengths, w_hh.to(bf), hs_f.to(bf),
                                               hs_b.to(bf), cs_f.to(bf), cs_b.to(bf), (), (),
                                               None, None, bf)
    wide = layer_case(4, 10, [128], 128, 2, cd, cuda_device)
    xw = input_gates(*wide[:1], wide[2], wide[4], cd)
    hw = bidir_recurrence(xw, wide[1], wide[3], cd, with_states=True)
    with pytest.raises(ValueError, match="bilstm_bwd_lite_f32_resident kernel takes float32"):
        lstm_cuda.bilstm_bwd_lite_f32_resident(xw, wide[1], wide[3], hw[0], hw[1], hw[4], hw[5],
                                               (), (), None, None, cd)


# ---- the bf16 forward at E = H = 80, 72 and the one-block bf16 lite sweep at 96
@pytest.mark.cuda
@pytest.mark.parametrize("H", [80, 72])
def test_fwd_mma_at_80_and_72_at_the_main_path_shape_on_card(cuda_device, H):
    """Layer 0 of the bf16 two-layer models at embedding 80 and 72: E = H,
    400 rows in 5 groups, T = 1500, the main path's lengths (groups at 0, 1
    and T, the rest random), both variants against the plain twin at 3e-2 x
    max(1, max|ref|); the same bits twice, and the two variants give the
    same hs bits."""
    cd, T, B, G = torch.bfloat16, 1500, 400, 5
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                           seed=H + 1)
    lengths = _main_path_lengths(lengths, G, T)
    args = (parts, lengths, w_ih, w_hh, bias, cd)
    assert lstm_cuda.fwd_kernel([H], H, cd) == "bilstm_fwd_mma"
    want = bidir_layer(*args, with_states=True)
    got = lstm_cuda.bilstm_layer_fwd_train(*args)
    ev = lstm_cuda.bilstm_layer_fwd(*args)
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)
    assert all(torch.equal(a, b) for a, b in zip(lstm_cuda.bilstm_layer_fwd_train_mma(*args),
                                                 got))
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])


@pytest.mark.cuda
def test_fwd_mma_at_80_rejects_bad_operands_on_card(cuda_device):
    """The tensor-core forward's wrappers refuse what its <80, 80> instance
    does not take, before any launch: f32 operands, E = 72 at H = 80 (no
    instance; no forward takes it since ``bilstm_fwd.cu`` went), a ``w_hh`` that
    is not contiguous; nothing falls back."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 10, [80], 80, 2, cd, cuda_device)
    before = [f.launches for f in (lstm_cuda.bilstm_layer_fwd_mma,
                                   lstm_cuda.bilstm_layer_fwd_train_mma)]
    for fwd in (lstm_cuda.bilstm_layer_fwd_mma, lstm_cuda.bilstm_layer_fwd_train_mma):
        with pytest.raises(ValueError, match="bilstm_fwd_mma kernel takes bfloat16"):
            fwd(tuple(p.float() for p in parts), lengths, w_ih.float(), w_hh.float(), bias,
                torch.float32)
        with pytest.raises(ValueError, match="bilstm_fwd_mma kernel takes bfloat16"):
            fwd((parts[0][..., :72].contiguous(),), lengths, w_ih[..., :72].contiguous(), w_hh,
                bias, cd)
        with pytest.raises(ValueError, match="w_hh must be a contiguous"):
            fwd(parts, lengths, w_ih, w_hh.transpose(-1, -2).contiguous().transpose(-1, -2),
                bias, cd)
    torch.cuda.synchronize()
    assert [f.launches for f in (lstm_cuda.bilstm_layer_fwd_mma,
                                 lstm_cuda.bilstm_layer_fwd_train_mma)] == before


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("G,B,ny,final", [(1, 30, 1, True), (1, 13, 0, False), (3, 27, 2, True),
                                          (5, 60, 2, False), (2, 22, 1, True),
                                          (4, 36, 0, True)])
def test_lite_mma_resident_matches_plain_on_card(cuda_device, T, G, B, ny, final):
    """The one-block bf16 lite sweep at H = 96 (W_hh resident, both
    products on mma.sync) against its plain twin at 3e-2 x max(1,
    max|ref|): 0, 1 and 2 dy streams, with and without final-state
    cotangents, groups of 30, 13, 9, 12, 11 and 9 rows (short tiles inside
    each group), groups at lengths 0, 1 and T, rows of length 0, 1 and T
    and rows 8-15 short of T (a tile that stops early). The dispatch names
    it and its wrapper counts the launches; the deleted
    ``bilstm_bwd_lite.cu``'s name is refused, before any launch."""
    cd, H = torch.bfloat16, 96
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                                seed=T + B + 97)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    lengths = _main_path_lengths(lengths, G, T)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn if final else None, dcn if final else None, cd)
    want = bidir_layer_sweep_lite(*args)
    assert lstm_cuda.lite_kernel(H, cd) == "bilstm_bwd_lite_mma_resident"
    wrappers = (lstm_cuda.bilstm_bwd_lite_mma_resident,)
    before = [f.launches for f in wrappers]
    _close([lstm_cuda.bilstm_bwd_lite(*args)], [want], 3e-2)
    _close([lstm_cuda.bilstm_bwd_lite_mma_resident(*args)], [want], 3e-2)
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2]


@pytest.mark.cuda
def test_lite_mma_resident_at_the_main_path_shape_on_card(cuda_device):
    """The stacked layer of the bf16 models at embedding 80 and 72 at its
    run shape: H = 96, input parts 80 + 80, 400 rows in one group, one dy
    stream a direction, T = 1500, ragged lengths; the same bits twice (the
    pair exchange sums in a fixed order), and the plain twin at 3e-2."""
    cd, T, B, H = torch.bfloat16, 1500, 400, 96
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [80, 80], H, 1, cd,
                                                                cuda_device, seed=14)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    del parts
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:1], dy[2:3], dhn, dcn, cd)
    got = lstm_cuda.bilstm_bwd_lite_mma_resident(*args)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite_mma_resident(*args), got)
    _close([got], [bidir_layer_sweep_lite(*args)], 3e-2)


@pytest.mark.cuda
def test_lite_mma_resident_edges_on_card(cuda_device):
    """An empty batch launches nothing and T = 0 gives an empty output; f32
    operands and H = 128 raise in the one-block bf16 wrapper (nothing falls
    back)."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 10, [96], 96, 2, cd,
                                                                cuda_device)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    before = lstm_cuda.bilstm_bwd_lite_mma_resident.launches
    empty = lambda t: t[:, :0].contiguous()  # noqa: E731
    out = lstm_cuda.bilstm_bwd_lite_mma_resident(
        xg[:, :, :0].contiguous(), lengths[:0], w_hh[:, :1].contiguous(),
        *(empty(t) for t in (hs_f, hs_b, cs_f, cs_b)), (), (), None, None, cd)
    assert out.shape == (2, 4, 0, 384)
    out = lstm_cuda.bilstm_bwd_lite_mma_resident(
        xg[:, :0].contiguous(), lengths, w_hh, *(t[:0].contiguous() for t in (hs_f, hs_b, cs_f,
                                                                             cs_b)),
        (), (), dhn, dcn, cd)
    assert out.shape == (2, 0, 10, 384)
    assert lstm_cuda.bilstm_bwd_lite_mma_resident.launches == before
    f32 = torch.float32
    with pytest.raises(ValueError, match="bilstm_bwd_lite_mma_resident kernel takes bfloat16"):
        lstm_cuda.bilstm_bwd_lite_mma_resident(xg, lengths, w_hh.to(f32), hs_f.to(f32),
                                               hs_b.to(f32), cs_f.to(f32), cs_b.to(f32), (), (),
                                               None, None, f32)
    wide = layer_case(4, 10, [128], 128, 2, cd, cuda_device)
    xw = input_gates(*wide[:1], wide[2], wide[4], cd)
    hw = bidir_recurrence(xw, wide[1], wide[3], cd, with_states=True)
    with pytest.raises(ValueError, match="bilstm_bwd_lite_mma_resident kernel takes bfloat16"):
        lstm_cuda.bilstm_bwd_lite_mma_resident(xw, wide[1], wide[3], hw[0], hw[1], hw[4], hw[5],
                                               (), (), None, None, cd)
    with pytest.raises(ValueError, match="hs_f must be"):
        lstm_cuda.bilstm_bwd_lite_mma_resident(xg, lengths, w_hh, hs_f.float(), hs_b, cs_f,
                                               cs_b, (), (), None, None, cd)
    torch.cuda.synchronize()
    assert lstm_cuda.bilstm_bwd_lite_mma_resident.launches == before


@pytest.mark.cuda
def test_two_layer_model_at_embedding_72_on_card(cuda_device):
    """The bf16 two-layer model at embedding 72: layer 0 (E = H = 72) on the
    tensor-core forward's and sweep's <72, 72> instances, the stacked layer
    padded to 96 on the wide route with the one-block bf16 lite sweep and
    wide forward; no CUDA-core forward, sweep, wide forward or lite sweep
    launches. Its gradients equal the CPU plain path's within 2^-7 x max(1,
    max|grad|)."""
    cd = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = (lstm_cuda.bilstm_layer_fwd_train_mma, lstm_cuda.bilstm_bwd_mma,
                lstm_cuda.bilstm_bwd_lite_mma_resident, lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_bwd, lstm_cuda.bilstm_fwd_wide_train_mma_resident)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=cd, embedding_size=72)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1, 1, 0, 0, 1]
    want = model_grads(torch.device("cpu"), dtype=cd, embedding_size=72)
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= 2.0 ** -7 * max(
            1.0, float(ref.abs().max())), name


# ---- the f32 lite sweep at 160-224 and the one-block bf16 wide forward at 96
@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("H,G,B,ny,final", [(160, 1, 30, 1, True), (192, 1, 13, 0, False),
                                            (224, 3, 27, 2, True), (160, 5, 60, 2, False),
                                            (192, 2, 22, 1, True), (224, 4, 36, 0, True),
                                            (160, 3, 27, 0, False)])
def test_lite_f32_at_160_to_224_matches_plain_on_card(cuda_device, T, H, G, B, ny, final):
    """The f32 tensor-core lite sweep at 160, 192 and 224 (its instances for
    2 / 3, 3 and 3 / 4 unit groups a block) against its plain twin at 1e-4
    x max(1, max|ref|): 0, 1 and 2 dy streams, with and without final-state
    cotangents, groups of 30, 13, 9, 12, 11 and 9 rows (short tiles inside
    each group), groups at lengths 0, 1 and T, rows of length 0, 1 and T
    and rows 8-15 short of T (a tile that stops early), at the plan's row
    tile. The dispatch names it and its wrapper counts the launches; the
    deleted ``bilstm_bwd_lite.cu``'s name is refused."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                                seed=T + B + H)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    lengths = _main_path_lengths(lengths, G, T)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn if final else None, dcn if final else None, cd)
    want = bidir_layer_sweep_lite(*args)
    assert lstm_cuda.lite_kernel(H, cd) == "bilstm_bwd_lite_f32"
    wrappers = (lstm_cuda.bilstm_bwd_lite_f32,)
    before = [f.launches for f in wrappers]
    _close([lstm_cuda.bilstm_bwd_lite(*args)], [want], 1e-4)
    _close([lstm_cuda.bilstm_bwd_lite_f32(*args)], [want], 1e-4)
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 32])
@pytest.mark.parametrize("H", [160, 192, 224])
def test_lite_f32_at_160_to_224_row_tiles_match_plain_on_card(cuda_device, monkeypatch, H,
                                                              rows):
    """The f32 lite sweep at 160-224 at each row tile (pinned with
    monkeypatch on the plan's candidates): 400 rows in 5 groups, two dy
    streams, T = 5, against the plain twin at 1e-4 x max(1, max|ref|)."""
    monkeypatch.setattr(lstm_cuda, "LITE_F32_ROWS", (rows,))
    torch.backends.cuda.matmul.allow_tf32 = False
    cd, T, B, G = torch.float32, 5, 400, 5
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                                seed=H + rows)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn, cd)
    _close([lstm_cuda.bilstm_bwd_lite_f32(*args)], [bidir_layer_sweep_lite(*args)], 1e-4)


@pytest.mark.cuda
def test_lite_f32_at_160_at_the_main_path_shape_on_card(cuda_device):
    """Layer 0 of the f32 two-layer model at embedding 160 (E = H = 160, 400
    rows in 5 groups, two dy streams, T = 1500, the main path's lengths):
    the same bits twice (the partial dh sums run in rank order), and the
    plain twin at 1e-4 x max(1, max|ref|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd, T, B, G, H = torch.float32, 1500, 400, 5, 160
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                                seed=16)
    lengths = _main_path_lengths(lengths, G, T)
    xg = lstm_cuda.bilstm_gates_f32(parts, w_ih, bias, cd)
    del parts
    hs_f, hs_b, _, _, cs_f, cs_b = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn, cd)
    got = lstm_cuda.bilstm_bwd_lite_f32(*args)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite_f32(*args), got)
    _close([got], [bidir_layer_sweep_lite(*args)], 1e-4)


@pytest.mark.cuda
def test_lite_f32_at_160_rejects_bad_operands_on_card(cuda_device):
    """The f32 lite sweep refuses what its kernel does not take at 160,
    before any launch: bf16 operands, a bf16 stream, a weight of the wrong
    shape; the deleted ``bilstm_bwd_lite.cu``'s name is refused at 128 and
    96; nothing falls back."""
    cd, H = torch.float32, 160
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 10, [H], H, 2, cd, cuda_device)
    xg = input_gates(parts, w_ih, bias, cd)
    hs = torch.zeros(4, 10, H, device=cuda_device)
    args = (xg, lengths, w_hh, hs, hs, hs, hs, dy[:1], dy[2:3], dhn, dcn, cd)
    wrapper = lstm_cuda.bilstm_bwd_lite_f32
    before = [wrapper.launches, lstm_cuda.bilstm_bwd_lite_f32_resident.launches]
    with pytest.raises(ValueError, match="bilstm_bwd_lite_f32 kernel takes float32"):
        wrapper(*args[:-1], torch.bfloat16)
    with pytest.raises(ValueError, match="hs_f must be a contiguous"):
        wrapper(xg, lengths, w_hh, hs.to(torch.bfloat16), *args[4:])
    with pytest.raises(ValueError, match="w_hh must be a contiguous"):
        wrapper(xg, lengths, w_hh[..., :128].contiguous(), *args[3:])
    for dtype, width in ((torch.float32, 128), (torch.bfloat16, 96)):
        case = layer_case(4, 10, [width], width, 1, dtype, cuda_device)
        xw = input_gates(case[0], case[2], case[4], dtype)
        hw = bidir_recurrence(xw, case[1], case[3], dtype, with_states=True)
        with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
            lstm_cuda.bilstm_bwd_lite(xw, case[1], case[3], hw[0], hw[1], hw[4], hw[5], (), (),
                                      None, None, dtype, kernel="bilstm_bwd_lite")
    torch.cuda.synchronize()
    assert [wrapper.launches, lstm_cuda.bilstm_bwd_lite_f32_resident.launches] == before


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("G,B", [(1, 30), (1, 13), (3, 27), (5, 60), (2, 22), (4, 36)])
def test_fwd_wide_mma_resident_matches_plain_on_card(cuda_device, T, G, B):
    """The one-block bf16 wide forward at H = 96 (W_hh as mma fragments in
    registers) against its plain twin at 3e-2 x max(1, max|ref|), both
    variants: groups of 30, 13, 9, 12, 11 and 9 rows (short tiles inside
    each group), groups at lengths 0, 1 and T, rows of length 0, 1 and T
    and rows 8-15 short of T (a tile that stops at its longest row). The
    dispatch names it and its wrappers count the launches; both variants
    give the same hs bits; ``bilstm_fwd_wide.cu``'s name is refused (the
    source is retired)."""
    cd, H = torch.bfloat16, 96
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                           seed=T + B + 96)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    lengths = _main_path_lengths(lengths, G, T)
    xg = input_gates(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    assert lstm_cuda.wide_fwd_kernel(H, cd) == "bilstm_fwd_wide_mma_resident"
    wrappers = (lstm_cuda.bilstm_fwd_wide_mma_resident,
                lstm_cuda.bilstm_fwd_wide_train_mma_resident)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
    ev = lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    _close(lstm_cuda.bilstm_fwd_wide_train_mma_resident(xg, lengths, w_hh, cd), want, 3e-2)
    _close(lstm_cuda.bilstm_fwd_wide_mma_resident(xg, lengths, w_hh, cd), want[:4], 3e-2)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
        lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 2]


@pytest.mark.cuda
def test_fwd_wide_mma_resident_at_the_main_path_shape_on_card(cuda_device):
    """The stacked layer of the bf16 models at embedding 80 and 72 at its
    run shape: H = 96, input parts 80 + 80 (the gates from the tensor-core
    gates kernel), 400 rows in one group, T = 1500, ragged lengths: both
    variants against the plain twin at 3e-2 x max(1, max|ref|), the same
    bits twice, and the same hs bits in both variants."""
    cd, T, B, H = torch.bfloat16, 1500, 400, 96
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [80, 80], H, 1, cd, cuda_device,
                                                           seed=15)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    del parts
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    got = lstm_cuda.bilstm_fwd_wide_train_mma_resident(xg, lengths, w_hh, cd)
    again = lstm_cuda.bilstm_fwd_wide_train_mma_resident(xg, lengths, w_hh, cd)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    ev = lstm_cuda.bilstm_fwd_wide_mma_resident(xg, lengths, w_hh, cd)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)


@pytest.mark.cuda
def test_fwd_wide_mma_resident_edges_on_card(cuda_device):
    """An empty batch launches nothing and T = 0 gives empty streams with a
    zero final state; f32 operands, H = 128 and a ``w_hh`` that is not
    contiguous raise in the one-block wrappers (nothing falls back)."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 10, [96], 96, 2, cd, cuda_device)
    xg = input_gates(parts, w_ih, bias, cd)
    wrappers = (lstm_cuda.bilstm_fwd_wide_mma_resident,
                lstm_cuda.bilstm_fwd_wide_train_mma_resident)
    before = [f.launches for f in wrappers]
    for fwd in wrappers:
        out = fwd(xg[:, :, :0].contiguous(), lengths[:0], w_hh[:, :1].contiguous(), cd)
        assert out[0].shape == (4, 0, 96) and out[2].shape == (2, 0, 96)
    assert [f.launches for f in wrappers] == before
    for fwd in wrappers:
        out = fwd(xg[:, :0].contiguous(), lengths, w_hh, cd)
        assert out[0].shape == (0, 10, 96) and not out[2].any() and not out[3].any()
        f32 = torch.float32
        with pytest.raises(ValueError, match="bilstm_fwd_wide_mma_resident kernel takes bfloat16"):
            fwd(xg, lengths, w_hh.to(f32), f32)
        wide = layer_case(4, 10, [128], 128, 2, cd, cuda_device)
        xw = input_gates(*wide[:1], wide[2], wide[4], cd)
        with pytest.raises(ValueError, match="bilstm_fwd_wide_mma_resident kernel takes bfloat16"):
            fwd(xw, wide[1], wide[3], cd)
        with pytest.raises(ValueError, match="w_hh must be a contiguous"):
            fwd(xg, lengths, w_hh.transpose(-1, -2).contiguous().transpose(-1, -2), cd)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1]


@pytest.mark.cuda
def test_two_layer_model_at_embedding_160_on_card(cuda_device):
    """The f32 two-layer model at embedding 160: both layers on the wide
    route at H = 160, their lite sweeps on ``bilstm_bwd_lite_f32.cu`` (never
    ``bilstm_bwd_lite.cu``), their forwards on ``bilstm_fwd_wide_f32.cu``
    (never ``bilstm_fwd_wide.cu``); its gradients equal the CPU plain
    path's within 1e-4 x max(1, max|grad|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = torch.float32
    wrappers = (lstm_cuda.bilstm_bwd_lite_f32, lstm_cuda.bilstm_wgrad_f32,
                lstm_cuda.bilstm_fwd_wide_train_f32, lstm_cuda.bilstm_wgrad_ih)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=cd, embedding_size=160)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 2, 2, 0]
    want = model_grads(torch.device("cpu"), dtype=cd, embedding_size=160)
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= 1e-4 * max(
            1.0, float(ref.abs().max())), name


# ---------- the bf16 lite sweep and the f32 wide forward at 160-224
@pytest.mark.parametrize("H,smem16,smem32", [(160, 80640, 103424), (192, 93952, 118784),
                                             (224, 125952, 156672)])
def test_lite_mma_at_160_to_224_plan_and_dispatch(H, smem16, smem32):
    """The bf16 lite sweep at 160, 192 and 224 (layer 0 of the bf16 models
    at embedding 160-224, and the stacked layers run there) takes the
    tensor-core sweep's second kernel (288's, ``MG = ceil(H / 64)`` groups
    a block: 3, 3, 4): its shared memory per row tile is the bf16 ``W_hh``
    slice of the largest block (32 MG gate rows of H + 8), two h_prev
    buffers, the f32 xg slice, c_prev and two dy streams, the bf16 dgates
    tile and ONE f32 partial dh buffer (H units x 40): 103,424 / 118,784 /
    156,672 bytes at 32 rows, where two buffers would take 129,024 /
    149,504 / 192,512. The plan takes 32-row tiles at the train step's 400
    rows in 5 groups (15 a direction, two waves). Its deal is the f32
    sweep's (``_lite_f32_deal``): at most two gate items a warp at 32-row
    tiles, and at 288 only the dispatch keeps warp w on group w."""
    bf16, fifteen = torch.bfloat16, (lambda R, smem: 15)
    assert lstm_cuda.lite_kernel(H, bf16) == "bilstm_bwd_lite_mma"
    lstm_cuda.lite_mma_check(H, bf16)
    MG = -(-H // 64)
    for R, want in ((16, smem16), (32, smem32)):
        got = lstm_cuda.wide_smem("lite_mma", H, R)
        assert got == (32 * MG * (H + 8) * 2 + 2 * R * (H + 8) * 2 + R * (32 * MG + 4) * 4
                       + 3 * R * 8 * MG * 2 + R * (32 * MG + 8) * 2 + H * 40 * 4) == want
        assert got == lstm_cuda.wide_smem("lite_mma_uneven", H, R)
    assert smem32 + H * 40 * 4 == {160: 129024, 192: 149504, 224: 192512}[H] <= (
        lstm_cuda.SMEM_LIMIT)
    assert lstm_cuda.wide_plan("lite_mma", 400, 5, H, fifteen) == (32, 15, smem32)
    assert lstm_cuda.wide_plan("lite_mma", 40, 1, H, fifteen)[:2] == (16, 3)
    for R in (40, 80):
        assert R not in lstm_cuda.LITE_MMA_UNEVEN_ROWS
    for rank in range(8):
        UG, items, dh = _lite_f32_deal(H, rank, 32)
        assert max(c for _, c in items) <= 2 and sum(dh) == H // 16 and max(dh) <= 2
    for E_parts in ([H], [H, H]):
        assert lstm_cuda.layer_route(E_parts, H, bf16) == "wide"
        assert lstm_cuda.padded_width(E_parts, H, bf16) == H


@pytest.mark.parametrize("H", [160, 192, 224])
def test_lite_mma_at_160_to_224_wrapper_takes_plain_version_on_cpu(H):
    """On the CPU the bf16 tensor-core lite sweep at 160-224 and the
    dispatch run the plain twin bit for bit and launch nothing; the deleted
    ``bilstm_bwd_lite.cu`` asked for by name is refused; under grad mode the
    wrapper refuses an operand that requires grad."""
    cpu, cd = torch.device("cpu"), torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 6, [16], H, 2, cd, cpu,
                                                                seed=H)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn, cd)
    want = bidir_layer_sweep_lite(*args)
    wrappers = (lstm_cuda.bilstm_bwd_lite_mma,)
    before = [f.launches for f in wrappers]
    for got in (lstm_cuda.bilstm_bwd_lite_mma(*args), lstm_cuda.bilstm_bwd_lite(*args)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_bwd_lite_mma(xg.clone().requires_grad_(), *args[1:])


@pytest.mark.parametrize("H", [160, 192, 224])
def test_fwd_wide_f32_at_160_to_224_wrappers_take_plain_versions_on_cpu(H):
    """On the CPU the f32 tensor-core wide forward at 160-224 (both
    variants), the dispatch and the dispatch asked for it by name run the
    plain twin bit for bit and launch nothing; the wrappers refuse bf16
    and, under grad mode, an operand that requires grad."""
    cpu, cd = torch.device("cpu"), torch.float32
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 6, [16], H, 3, cd, cpu, seed=H)
    xg = input_gates(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_fwd_wide_f32, lstm_cuda.bilstm_fwd_wide_train_f32)
    before = [f.launches for f in wrappers]
    for got in (lstm_cuda.bilstm_fwd_wide_train_f32(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd,
                                                kernel="bilstm_fwd_wide_f32")):
        assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    for got in (lstm_cuda.bilstm_fwd_wide_f32(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert [f.launches for f in wrappers] == before
    with pytest.raises(ValueError, match="bilstm_fwd_wide_f32 kernel takes float32"):
        lstm_cuda.bilstm_fwd_wide_f32(xg, lengths, w_hh.to(torch.bfloat16), torch.bfloat16)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_fwd_wide_train_f32(xg.clone().requires_grad_(), lengths, w_hh, cd)


@pytest.mark.parametrize("name,dtype,H", [
    # csrc/bilstm_bwd_lite.cu and csrc/bilstm_fwd_wide.cu are gone: their
    # names are refused at every width (the ids of the cases that timed or
    # refused them by name are kept)
    pytest.param("bilstm_bwd_lite", torch.float32, 160, id="bilstm_bwd_lite-dtype0-160-True"),
    pytest.param("bilstm_bwd_lite", torch.float32, 192, id="bilstm_bwd_lite-dtype1-192-True"),
    pytest.param("bilstm_bwd_lite", torch.float32, 224, id="bilstm_bwd_lite-dtype2-224-True"),
    pytest.param("bilstm_fwd_wide", torch.bfloat16, 96, id="bilstm_fwd_wide-dtype3-96-True"),
    pytest.param("bilstm_bwd_lite", torch.float32, 128, id="bilstm_bwd_lite-dtype4-128-True"),
    pytest.param("bilstm_bwd_lite", torch.bfloat16, 288, id="bilstm_bwd_lite-dtype5-288-True"),
    pytest.param("bilstm_bwd_lite", torch.bfloat16, 160, id="bilstm_bwd_lite-dtype6-160-False"),
    pytest.param("bilstm_bwd_lite", torch.bfloat16, 224, id="bilstm_bwd_lite-dtype7-224-False"),
    pytest.param("bilstm_bwd_lite", torch.bfloat16, 256, id="bilstm_bwd_lite-dtype8-256-False"),
    pytest.param("bilstm_fwd_wide", torch.float32, 160, id="bilstm_fwd_wide-dtype9-160-False"),
    pytest.param("bilstm_fwd_wide", torch.float32, 224, id="bilstm_fwd_wide-dtype10-224-False"),
    pytest.param("bilstm_fwd_wide", torch.float32, 96, id="bilstm_fwd_wide-dtype11-96-False"),
    pytest.param("bilstm_fwd_wide", torch.bfloat16, 192, id="bilstm_fwd_wide-dtype12-192-False"),
    pytest.param("bilstm_fwd_wide", torch.bfloat16, 128, id="bilstm_fwd_wide-dtype13-128-False"),
    pytest.param("bilstm_fwd_wide", torch.bfloat16, 256, id="bilstm_fwd_wide-dtype14-256-False"),
    pytest.param("bilstm_fwd_wide", torch.float32, 192, id="bilstm_fwd_wide-dtype15-192-True"),
    pytest.param("bilstm_fwd_wide", torch.bfloat16, 160, id="bilstm_fwd_wide-dtype16-160-True"),
    pytest.param("bilstm_fwd_wide", torch.bfloat16, 224, id="bilstm_fwd_wide-dtype17-224-True"),
])
def test_cuda_core_wide_kernels_by_name(name, dtype, H):
    """The CUDA-core lite sweep's and wide forward's sources are gone: no
    library is bound under their names, and the wrappers refuse them
    before they look at the operands, on the CPU too."""
    assert name not in lstm_cuda._SIGNATURES
    xg = torch.zeros(2, 3, 2, 4 * H, dtype=torch.float32)
    hs = torch.zeros(3, 2, H, dtype=dtype)
    lengths = torch.full((2,), 3, dtype=torch.int32)
    w_hh = torch.zeros(2, 4 * H, H, dtype=dtype)
    if name == "bilstm_bwd_lite":
        with pytest.raises(ValueError, match="no lite sweep kernel named 'bilstm_bwd_lite'"):
            lstm_cuda.bilstm_bwd_lite(xg, lengths, w_hh, hs, hs, hs, hs, (), (), None, None,
                                      dtype, kernel=name)
        return
    for fwd in (lstm_cuda.bilstm_fwd_wide, lstm_cuda.bilstm_fwd_wide_train):
        with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
            fwd(xg, lengths, w_hh, dtype, kernel=name)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("H,G,B,ny,final", [(160, 1, 30, 1, True), (192, 1, 13, 0, False),
                                            (224, 3, 27, 2, True), (160, 5, 60, 2, False),
                                            (192, 2, 22, 1, True), (224, 4, 36, 0, True),
                                            (160, 3, 27, 0, False)])
def test_lite_mma_at_160_to_224_matches_plain_on_card(cuda_device, T, H, G, B, ny, final):
    """The bf16 tensor-core lite sweep at 160, 192 and 224 (the second
    kernel's instances for 2 / 3, 3 and 3 / 4 unit groups a block, its items
    dealt over 8 warps) against its plain twin at 3e-2 x max(1, max|ref|):
    0, 1 and 2 dy streams, with and without final-state cotangents, groups
    of 30, 13, 9, 12, 11 and 9 rows (short tiles inside each group), groups
    at lengths 0, 1 and T, rows of length 0, 1 and T and rows 8-15 short of
    T (a tile that stops early), at the plan's row tile. The dispatch names
    it and its wrapper counts the launches."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                                seed=T + B + H)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    lengths = _main_path_lengths(lengths, G, T)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn if final else None, dcn if final else None, cd)
    want = bidir_layer_sweep_lite(*args)
    assert lstm_cuda.lite_kernel(H, cd) == "bilstm_bwd_lite_mma"
    wrappers = (lstm_cuda.bilstm_bwd_lite_mma,)
    before = [f.launches for f in wrappers]
    _close([lstm_cuda.bilstm_bwd_lite(*args)], [want], 3e-2)
    _close([lstm_cuda.bilstm_bwd_lite_mma(*args)], [want], 3e-2)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 32])
@pytest.mark.parametrize("H", [160, 192, 224])
def test_lite_mma_at_160_to_224_row_tiles_match_plain_on_card(cuda_device, monkeypatch, H,
                                                              rows):
    """The bf16 lite sweep at 160-224 at each row tile (pinned with
    monkeypatch on the plan's candidates): 400 rows in 5 groups, two dy
    streams, T = 5, against the plain twin at 3e-2 x max(1, max|ref|)."""
    monkeypatch.setattr(lstm_cuda, "LITE_MMA_UNEVEN_ROWS", (rows,))
    cd, T, B, G = torch.bfloat16, 5, 400, 5
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                                seed=H + rows)
    xg = input_gates(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn, cd)
    _close([lstm_cuda.bilstm_bwd_lite_mma(*args)], [bidir_layer_sweep_lite(*args)], 3e-2)


@pytest.mark.cuda
def test_lite_mma_at_160_at_the_main_path_shape_on_card(cuda_device):
    """Layer 0 of the bf16 two-layer model at embedding 160 (E = H = 160,
    400 rows in 5 groups, two dy streams, T = 1500, the main path's
    lengths): the same bits twice (the partial dh sums run in rank order),
    and the plain twin at 3e-2 x max(1, max|ref|)."""
    cd, T, B, G, H = torch.bfloat16, 1500, 400, 5, 160
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                                seed=17)
    lengths = _main_path_lengths(lengths, G, T)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    del parts
    hs_f, hs_b, _, _, cs_f, cs_b = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn, cd)
    got = lstm_cuda.bilstm_bwd_lite_mma(*args)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite_mma(*args), got)
    _close([got], [bidir_layer_sweep_lite(*args)], 3e-2)


@pytest.mark.cuda
def test_lite_mma_at_160_rejects_bad_operands_on_card(cuda_device):
    """The bf16 lite sweep refuses what its kernel does not take at 160,
    before any launch: f32 operands, an f32 stream, a weight of the wrong
    shape; the deleted ``bilstm_bwd_lite.cu``'s name is refused; nothing falls back."""
    cd, H = torch.bfloat16, 160
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(4, 10, [H], H, 2, cd, cuda_device)
    xg = input_gates(parts, w_ih, bias, cd)
    hs = torch.zeros(4, 10, H, device=cuda_device, dtype=cd)
    args = (xg, lengths, w_hh, hs, hs, hs, hs, dy[:1], dy[2:3], dhn, dcn, cd)
    wrapper = lstm_cuda.bilstm_bwd_lite_mma
    before = [wrapper.launches, lstm_cuda.bilstm_bwd_lite_f32.launches]
    with pytest.raises(ValueError, match="bilstm_bwd_lite_mma kernel takes bfloat16"):
        wrapper(*args[:-1], torch.float32)
    with pytest.raises(ValueError, match="hs_f must be a contiguous"):
        wrapper(xg, lengths, w_hh, hs.float(), *args[4:])
    with pytest.raises(ValueError, match="w_hh must be a contiguous"):
        wrapper(xg, lengths, w_hh[..., :128].contiguous(), *args[3:])
    f32 = torch.float32
    hs32 = hs.float()
    with pytest.raises(ValueError, match="no lite sweep kernel named .bilstm_bwd_lite."):
        lstm_cuda.bilstm_bwd_lite(xg, lengths, w_hh.float(), hs32, hs32, hs32, hs32, (), (),
                                  None, None, f32, kernel="bilstm_bwd_lite")
    torch.cuda.synchronize()
    assert [wrapper.launches, lstm_cuda.bilstm_bwd_lite_f32.launches] == before


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,rows", [(5, 60, 16), (5, 400, 32), (1, 70, 32)])
def test_lite_mma_at_288_item_deal_matches_plain_on_card(cuda_device, monkeypatch, G, B, rows):
    """The bf16 lite sweep at 288 (its items dealt over 8 warps, as at
    160-224) at each row tile against its plain twin at 3e-2 x
    max(1, max|ref|), T = 24, two dy streams, short tiles and lengths 0, 1
    and T; the same bits twice."""
    monkeypatch.setattr(lstm_cuda, "LITE_MMA_UNEVEN_ROWS", (rows,))
    H, cd, T = 288, torch.bfloat16, 24
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, cd,
                                                                 cuda_device, seed=B + rows)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn, cd)
    got = lstm_cuda.bilstm_bwd_lite_mma(*args)
    assert torch.equal(lstm_cuda.bilstm_bwd_lite_mma(*args), got)
    _close([got], [bidir_layer_sweep_lite(*args)], 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("H,G,B", [(160, 1, 30), (192, 1, 13), (224, 3, 27), (160, 5, 60),
                                   (192, 2, 22), (224, 4, 36)])
def test_fwd_wide_f32_at_160_to_224_matches_plain_on_card(cuda_device, monkeypatch, T, H, G,
                                                          B):
    """The f32 tensor-core wide forward at 160, 192 and 224 (its instances
    for 2 / 3, 3 and 3 / 4 unit groups a block), both variants, at the
    plan's row tile and at each one it is built for (pinned with
    monkeypatch), against the plain recurrence at 1e-4 x max(1, max|ref|):
    groups of 30, 13, 9, 12, 11 and 9 rows (short tiles), groups at lengths
    0, 1 and T, rows 8-15 short of T, T = 1. The eval and train variants
    give the same hs bits; the dispatch names it and its wrappers count the
    launches; ``bilstm_fwd_wide.cu`` asked for by name is refused (retired
    at f32 160-224 after it lost in turns)."""
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                           seed=T + B + H)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    lengths = _main_path_lengths(lengths, G, T)
    assert lstm_cuda.wide_fwd_kernel(H, cd) == "bilstm_fwd_wide_f32"
    xg = lstm_cuda.bilstm_gates_f32(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_fwd_wide_f32, lstm_cuda.bilstm_fwd_wide_train_f32)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
    ev = lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)
    _close(got, want, 1e-4)
    _close(ev, want[:4], 1e-4)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
        lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")
    rows = lstm_cuda.fwd_wide_f32_rows(H)
    assert rows == (16, 32)
    for R in rows:
        monkeypatch.setattr(lstm_cuda, "FWD_WIDE_F32_ROWS", (R,))
        tr = lstm_cuda.bilstm_fwd_wide_train_f32(xg, lengths, w_hh, cd)
        e = lstm_cuda.bilstm_fwd_wide_f32(xg, lengths, w_hh, cd)
        _close(tr, want, 1e-4)
        _close(e, want[:4], 1e-4)
        assert torch.equal(e[0], tr[0]) and torch.equal(e[1], tr[1])
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [3, 3]


@pytest.mark.cuda
def test_fwd_wide_f32_at_160_at_the_main_path_shape_on_card(cuda_device):
    """Layer 0 of the f32 two-layer model at embedding 160 (E = H = 160, 400
    rows in 5 groups, T = 1500, the main path's lengths): both variants
    against the plain twin at 1e-4 x max(1, max|ref|), the same bits twice,
    and the same hs bits in both variants."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd, T, B, G, H = torch.float32, 1500, 400, 5, 160
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                           seed=18)
    lengths = _main_path_lengths(lengths, G, T)
    xg = lstm_cuda.bilstm_gates_f32(parts, w_ih, bias, cd)
    del parts
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    got = lstm_cuda.bilstm_fwd_wide_train_f32(xg, lengths, w_hh, cd)
    again = lstm_cuda.bilstm_fwd_wide_train_f32(xg, lengths, w_hh, cd)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    ev = lstm_cuda.bilstm_fwd_wide_f32(xg, lengths, w_hh, cd)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    _close(got, want, 1e-4)
    _close(ev, want[:4], 1e-4)


@pytest.mark.cuda
def test_fwd_wide_f32_at_160_rejects_bad_operands_on_card(cuda_device):
    """The f32 tensor-core forward refuses what its kernel does not take at
    160, before any launch: bf16 operands, a weight of the wrong shape;
    ``bilstm_fwd_wide.cu``'s name is refused at f32 128 and bf16 96 (the
    source is retired); an empty batch launches nothing."""
    cd, H = torch.float32, 160
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 10, [H], H, 2, cd, cuda_device)
    xg = input_gates(parts, w_ih, bias, cd)
    wrappers = (lstm_cuda.bilstm_fwd_wide_f32, lstm_cuda.bilstm_fwd_wide_train_f32)
    before = [f.launches for f in wrappers]
    for fwd in wrappers[:2]:
        with pytest.raises(ValueError, match="bilstm_fwd_wide_f32 kernel takes float32"):
            fwd(xg, lengths, w_hh.to(torch.bfloat16), torch.bfloat16)
        with pytest.raises(ValueError, match="w_hh must be a contiguous"):
            fwd(xg, lengths, w_hh[..., :128].contiguous(), cd)
        out = fwd(xg[:, :, :0].contiguous(), lengths[:0], w_hh[:, :1].contiguous(), cd)
        assert out[0].shape == (4, 0, H)
    for dtype, width in ((torch.float32, 128), (torch.bfloat16, 96)):
        case = layer_case(4, 10, [width], width, 1, dtype, cuda_device)
        xw = input_gates(case[0], case[2], case[4], dtype)
        with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
            lstm_cuda.bilstm_fwd_wide_train(xw, case[1], case[3], dtype, kernel="bilstm_fwd_wide")
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == before


@pytest.mark.cuda
def test_two_layer_bf16_model_at_embedding_160_on_card(cuda_device):
    """The bf16 two-layer model at embedding 160: both layers on the wide
    route at H = 160, their lite sweeps on ``bilstm_bwd_lite_mma.cu``, their
    forwards on ``bilstm_fwd_wide_mma.cu``'s kernel for uneven groups (never
    ``bilstm_fwd_wide.cu``), their weight gradients split (``dW_ih`` on
    cuBLAS, ``dW_hh`` on ``bilstm_wgrad_mma.cu``); its gradients equal the
    CPU plain path's within 2^-7 x max(1, max|grad|)."""
    cd = torch.bfloat16
    wrappers = (lstm_cuda.bilstm_bwd_lite_mma, lstm_cuda.bilstm_fwd_wide_train_mma,
                lstm_cuda.bilstm_wgrad_ih, lstm_cuda.bilstm_wgrad_mma)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=cd, embedding_size=160)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 2, 2, 2]
    want = model_grads(torch.device("cpu"), dtype=cd, embedding_size=160)
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= 2.0 ** -7 * max(
            1.0, float(ref.abs().max())), name


# ---------- the bf16 wide forward at 160-224 and the split weight gradient
@pytest.mark.parametrize("H,MG", [(160, 3), (192, 3), (224, 4), (128, None), (256, None)])
def test_fwd_wide_mma_at_160_to_224_smem_and_plan(H, MG):
    """The bf16 wide forward at 160, 192 and 224 (H % 128 != 0; at 192 the 3
    unit groups of each block do not split over its 8 warps) takes the
    kernel for uneven groups: its shared memory is
    ``csrc/bilstm_fwd_wide_mma.cu:smem_bytes_u`` (the W_hh slice of the
    block of MG = ceil(H / 64) groups, 32 MG rows of H + 8; two h tiles; the
    staging of 8 MG units), two blocks fit an SM at every row tile
    (``blocks_per_sm_u``), and its plan takes the uneven row tiles: with 30
    clusters at once the 32-row tile puts the train shape (400 rows in 5
    groups, or in 1) on the card in one wave. 128 and 256 keep the even
    kernel's rows and bytes."""
    thirty = lambda R, smem: 30  # noqa: E731
    if MG is None:
        for R in lstm_cuda.FWD_WIDE_MMA_ROWS:
            U = H // 8
            assert lstm_cuda.wide_smem("fwd_mma", H, R) == (
                4 * U * (H + 8) * 2 + 2 * R * (H + 8) * 2 + 2 * R * (U + 8) * 2)
        assert lstm_cuda.wide_plan("fwd_mma", 400, 5, H, thirty)[0] in lstm_cuda.FWD_WIDE_MMA_ROWS
        return
    assert lstm_cuda.wide_fwd_kernel(H, torch.bfloat16) == "bilstm_fwd_wide_mma"
    for R in lstm_cuda.FWD_WIDE_MMA_UNEVEN_ROWS:
        smem = lstm_cuda.wide_smem("fwd_mma", H, R)
        assert smem == 32 * MG * (H + 8) * 2 + 2 * R * (H + 8) * 2 + 2 * R * (8 * MG + 8) * 2
        assert 2 * (smem + 1024) <= 233472
    smem32 = {160: 57856, 192: 68096, 224: 94208}[H]
    assert lstm_cuda.wide_smem("fwd_mma", H, 32) == smem32
    assert lstm_cuda.wide_plan("fwd_mma", 400, 5, H, thirty) == (32, 15, smem32)
    assert lstm_cuda.wide_plan("fwd_mma", 400, 1, H, thirty) == (32, 13, smem32)
    with pytest.raises(ValueError, match="bilstm_fwd_wide_mma kernel takes bfloat16"):
        lstm_cuda.fwd_wide_mma_check(H, torch.float32)


def test_wgrad_mma_plan_with_no_input_part():
    """``dW_hh`` alone (the bf16 wide route's split): the bf16 tensor-core
    wgrad takes no input part (the f32 one does not), its column tiles are
    H's alone and its split is planned for them: at the scaled shape (T =
    1500, 400 rows, H = 256) 2 column tiles and 4 splits for layer 0 (G =
    5) against 4 and 2 with its input part, 17 splits for the stacked layer
    (G = 1) against 6."""
    bf16 = torch.bfloat16
    lstm_cuda.wgrad_mma_check((), 256, bf16)
    lstm_cuda.wgrad_mma_check((), 80, bf16)
    with pytest.raises(ValueError, match="and 1 or 2 input parts"):
        lstm_cuda.wgrad_f32_check((), 256, torch.float32)
    with pytest.raises(ValueError, match="and 0, 1 or 2 input parts"):
        lstm_cuda.wgrad_mma_check((8, 8, 8), 256, bf16)
    assert lstm_cuda.wgrad_mma_plan(1500, 400, 5, (), 256) == (8, 2, 4)
    assert lstm_cuda.wgrad_mma_plan(1500, 400, 5, (256,), 256) == (8, 4, 2)
    assert lstm_cuda.wgrad_mma_plan(1500, 400, 1, (), 256) == (8, 2, 17)
    assert lstm_cuda.wgrad_mma_plan(1500, 400, 1, (256, 256), 256) == (8, 6, 6)
    for H in (96, 160, 288):
        m, n, splits = lstm_cuda.wgrad_mma_plan(1500, 400, 5, (), H)
        assert n == -(-H // 128) and m * n * 2 * 5 * splits >= lstm_cuda.WGRAD_TARGET_BLOCKS


@pytest.mark.parametrize("E_parts,G", [([32], 2), ([32, 16], 1)])
def test_wgrad_split_takes_plain_version_on_cpu(E_parts, G):
    """On the CPU the split weight gradient and its ``dW_ih`` products run
    the plain sums, bit for bit, and launch nothing; the tensor-core wgrad
    with no input part gives ``dW_hh`` alone and a ``(2, 4H, 0)`` dW_ih."""
    cpu, cd, H, T, B = torch.device("cpu"), torch.bfloat16, 32, 5, 6
    g = torch.Generator().manual_seed(len(E_parts))
    u = lambda *shape: (torch.rand(*shape, generator=g) * 2 - 1).to(cd)  # noqa: E731
    dgc, hs_f, hs_b = u(2, T, B, 4 * H), u(T, B, H), u(T, B, H)
    parts = tuple(u(T, B, e) for e in E_parts)
    want = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
    wrappers = (lstm_cuda.bilstm_wgrad_ih, lstm_cuda.bilstm_wgrad_mma)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.bilstm_wgrad_split(dgc, parts, hs_f, hs_b, G)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(lstm_cuda.bilstm_wgrad_ih(dgc, parts), want[0])
    hh = lstm_cuda.bilstm_wgrad_mma(dgc, (), hs_f, hs_b, G)
    assert hh[0].shape == (2, 4 * H, 0) and torch.equal(hh[1], want[1])
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.bilstm_wgrad_ih(dgc.clone().float().requires_grad_(), parts)
    assert cpu.type == "cpu"


@pytest.mark.parametrize("E_parts,H,dtype,wgrad", [
    ([128], 128, torch.bfloat16, "split"), ([128, 128], 128, torch.bfloat16, "split"),
    # wide at 96, where the whole kernel is the faster (id kept from the
    # split's case)
    pytest.param([72, 72], 72, torch.bfloat16, "whole", id="E_parts2-72-dtype2-split"),
    ([128], 128, torch.float32, "whole"), ([32], 32, torch.bfloat16, "whole"),
    ([64, 64], 64, torch.bfloat16, "whole")])
def test_layer_bwd_splits_the_wgrad_on_the_bf16_wide_route(monkeypatch, E_parts, H, dtype,
                                                            wgrad):
    """``layer_bwd`` takes ``bilstm_wgrad_split`` for every bf16 layer on the
    wide route past 96 units (128-288, padded ones too) and ``bilstm_wgrad``
    for the rest (f32, the resident route, and the wide layers at 96); on
    the CPU both give the plain sums."""
    cpu = torch.device("cpu")
    calls = []
    for name, tag in (("bilstm_wgrad_split", "split"), ("bilstm_wgrad", "whole")):
        monkeypatch.setattr(lstm_cuda, name,
                            lambda *a, _t=tag: calls.append(_t) or bidir_layer_wgrad(*a))
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(5, 4, E_parts, H, 2, dtype, cpu)
    hs_f, hs_b, _, _, cs_f, cs_b = lstm_cuda.layer_fwd(parts, lengths, w_ih, w_hh, bias, dtype,
                                                       with_states=True)
    got = lstm_cuda.layer_bwd(parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
                              dy[:1], dy[2:3], dhn, dcn, dtype)
    assert calls == [wgrad]
    assert got[2].shape == (2, 4 * H, sum(E_parts)) and got[3].shape == (2, 2, 4 * H, H)
    Hp = lstm_cuda.padded_width(E_parts, H, dtype)
    assert (lstm_cuda.layer_route(E_parts, H, dtype) == "wide" and dtype == torch.bfloat16
            and Hp > 96) == (wgrad == "split")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("H,G,B", [(160, 1, 30), (192, 1, 13), (224, 3, 27), (160, 5, 60),
                                   (192, 2, 22), (224, 4, 36), (192, 5, 400)])
def test_fwd_wide_mma_at_160_to_224_matches_plain_on_card(cuda_device, monkeypatch, T, H, G, B):
    """The bf16 tensor-core wide forward at 160, 192 and 224 (the kernel for
    uneven unit groups, 2 / 3, 3 and 3 / 4 a block), both variants, at the
    plan's row tile and at each one it is built for (pinned with
    monkeypatch), against the plain recurrence at 3e-2 x max(1, max|ref|):
    groups of 30, 13, 9, 12, 11, 9 and 80 rows (short tiles), groups at
    lengths 0, 1 and T, rows 8-15 short of T, T = 1. The eval and train
    variants give the same hs bits; the dispatch names it and its wrappers
    count the launches; ``bilstm_fwd_wide.cu``'s name is refused (the source
    is retired)."""
    cd = torch.bfloat16
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                           seed=T + B + H)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    lengths = _main_path_lengths(lengths, G, T)
    assert lstm_cuda.wide_fwd_kernel(H, cd) == "bilstm_fwd_wide_mma"
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_fwd_wide_mma, lstm_cuda.bilstm_fwd_wide_train_mma)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
    ev = lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
        lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")
    for R in lstm_cuda.FWD_WIDE_MMA_UNEVEN_ROWS:
        monkeypatch.setattr(lstm_cuda, "FWD_WIDE_MMA_UNEVEN_ROWS", (R,))
        tr = lstm_cuda.bilstm_fwd_wide_train_mma(xg, lengths, w_hh, cd)
        e = lstm_cuda.bilstm_fwd_wide_mma(xg, lengths, w_hh, cd)
        _close(tr, want, 3e-2)
        _close(e, want[:4], 3e-2)
        assert torch.equal(e[0], tr[0]) and torch.equal(e[1], tr[1])
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [4, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("H", [160, 192, 224])
def test_fwd_wide_mma_at_160_to_224_at_the_main_path_shape_on_card(cuda_device, H):
    """Layer 0 of a bf16 model at H = 160, 192 and 224 (E = H, 400 rows in 5
    groups, T = 1500, the main path's lengths): both variants against the
    plain twin at 3e-2 x max(1, max|ref|), the same bits twice, and the same
    hs bits in both variants."""
    cd, T, B, G = torch.bfloat16, 1500, 400, 5
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                           seed=H)
    lengths = _main_path_lengths(lengths, G, T)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    del parts
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    got = lstm_cuda.bilstm_fwd_wide_train_mma(xg, lengths, w_hh, cd)
    again = lstm_cuda.bilstm_fwd_wide_train_mma(xg, lengths, w_hh, cd)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    ev = lstm_cuda.bilstm_fwd_wide_mma(xg, lengths, w_hh, cd)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)


@pytest.mark.cuda
def test_fwd_wide_mma_at_160_rejects_bad_operands_on_card(cuda_device):
    """The bf16 tensor-core forward refuses what its kernel does not take at
    160, before any launch: f32 operands, a weight of the wrong shape;
    ``bilstm_fwd_wide.cu``'s name is refused at 160-224 (the source is
    retired); an empty batch launches nothing."""
    cd, H = torch.bfloat16, 160
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 10, [H], H, 2, cd, cuda_device)
    xg = input_gates(parts, w_ih, bias, cd)
    wrappers = (lstm_cuda.bilstm_fwd_wide_mma, lstm_cuda.bilstm_fwd_wide_train_mma)
    before = [f.launches for f in wrappers]
    for fwd in wrappers[:2]:
        with pytest.raises(ValueError, match="bilstm_fwd_wide_mma kernel takes bfloat16"):
            fwd(xg, lengths, w_hh.float(), torch.float32)
        with pytest.raises(ValueError, match="w_hh must be a contiguous"):
            fwd(xg, lengths, w_hh[..., :128].contiguous(), cd)
        out = fwd(xg[:, :, :0].contiguous(), lengths[:0], w_hh[:, :1].contiguous(), cd)
        assert out[0].shape == (4, 0, H)
    for width in (160, 192, 224):
        case = layer_case(4, 10, [width], width, 1, cd, cuda_device)
        xw = input_gates(case[0], case[2], case[4], cd)
        with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
            lstm_cuda.bilstm_fwd_wide(xw, case[1], case[3], cd, kernel="bilstm_fwd_wide")
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == before


def _wgrad_operands(T, B, E_parts, H, dev, seed):
    """bf16 wgrad operands: dgc zero past each row's ragged length (as a
    sweep leaves it; rows of length 0, 1 and T), the input parts and both
    directions' h streams."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: (torch.rand(*s, generator=g, device=dev) * 2 - 1).to(torch.bfloat16)  # noqa
    lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev)
    lengths[:3] = torch.tensor([0, 1, T], device=dev)
    live = (torch.arange(T, device=dev)[:, None] < lengths[None, :]).to(torch.bfloat16)
    dgc = u(2, T, B, 4 * H) * live[None, :, :, None]
    return dgc, tuple(u(T, B, e) for e in E_parts), u(T, B, H), u(T, B, H)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(1, 30), (300, 40)])
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("E_parts,H", [([96], 96), ([80, 80], 96), ([128], 128),
                                       ([128, 128], 128), ([160], 160), ([160, 160], 160),
                                       ([288], 288), ([288, 288], 288)])
def test_wgrad_split_matches_plain_on_card(cuda_device, monkeypatch, E_parts, H, G, T, B):
    """The bf16 wide route's split weight gradient (``dW_ih`` from cuBLAS
    bf16 products with f32 output, ``dW_hh`` from ``bilstm_wgrad_mma`` with
    no input part) against the plain sums at 3e-2 x max(1, max|ref|), as the
    whole kernel's card tests: one and two input parts, 1 and 5 weight
    groups, T = 1 (every h_prev past an end) and 300. ``dW_hh`` alone equals
    the whole kernel's bit for bit when it is split as the whole kernel is
    (``wgrad_mma_plan`` pinned to the whole launch's splits). The counters:
    one ``dW_ih`` call, one ``dW_hh`` launch; f32 is refused."""
    dgc, parts, hs_f, hs_b = _wgrad_operands(T, B, E_parts, H, cuda_device, H + G + T)
    want = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
    before = (lstm_cuda.bilstm_wgrad_ih.launches, lstm_cuda.bilstm_wgrad_mma.launches)
    got = lstm_cuda.bilstm_wgrad_split(dgc, parts, hs_f, hs_b, G)
    torch.cuda.synchronize()
    assert (lstm_cuda.bilstm_wgrad_ih.launches - before[0],
            lstm_cuda.bilstm_wgrad_mma.launches - before[1]) == (1, 1)
    _close(got, want, 3e-2)
    whole = lstm_cuda.bilstm_wgrad_mma(dgc, parts, hs_f, hs_b, G)
    _close(whole, want, 3e-2)
    splits = lstm_cuda.wgrad_mma_plan(T, B, G, [p.shape[-1] for p in parts], H)[2]
    plan = lstm_cuda.wgrad_mma_plan
    monkeypatch.setattr(lstm_cuda, "wgrad_mma_plan",
                        lambda T, B, G, E, H: plan(T, B, G, E, H)[:2] + (splits,))
    hh = lstm_cuda.bilstm_wgrad_mma(dgc, (), hs_f, hs_b, G)
    assert hh[0].shape == (2, 4 * H, 0)
    assert torch.equal(hh[1], whole[1])
    with pytest.raises(ValueError, match="bilstm_wgrad_ih takes bfloat16"):
        lstm_cuda.bilstm_wgrad_ih(dgc.float(), parts)


@pytest.mark.cuda
def test_wgrad_split_at_the_scaled_shape_on_card(cuda_device):
    """The scaled configuration's layer 0 (E = H = 256, 5 groups) and one
    stacked layer (E = 2 x 256, 1 group) at the train shape (400 rows, T =
    1500): the split weight gradient against the plain sums at 3e-2 x max(1,
    max|ref|), the same bits twice; its ``dW_ih`` columns are the whole
    kernel's within the same tolerance."""
    T, B, H = 1500, 400, 256
    for E_parts, G in (([256], 5), ([256, 256], 1)):
        dgc, parts, hs_f, hs_b = _wgrad_operands(T, B, E_parts, H, cuda_device, G)
        want = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
        got = lstm_cuda.bilstm_wgrad_split(dgc, parts, hs_f, hs_b, G)
        again = lstm_cuda.bilstm_wgrad_split(dgc, parts, hs_f, hs_b, G)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _close(got, want, 3e-2)
        _close(got[:1], lstm_cuda.bilstm_wgrad_mma(dgc, parts, hs_f, hs_b, G)[:1], 3e-2)
        del dgc, parts, hs_f, hs_b, want, got, again


# ---- the op's f32 sweep at 96-288 and the one-block f32 wide forward at 96
def test_fwd_wide_f32_resident_plan_and_dispatch():
    """The f32 wide forward at H = 96 (the stacked layer of the f32 model at
    embedding 80, run at 96) takes the one-block tensor-core forward in
    three tf32 passes: 12 warps, one per 8 units, 384 threads; the f32
    weights in registers (2 m16 tiles x 12 k8 steps x 4 = 96 a thread);
    shared memory for two f32 h tiles (8 rows of 96 + 16) and five ring
    stages of the f32 xg tile (8 rows of 388): 7,168 + 62,080 = 69,248
    bytes; 100 blocks at 400 rows in one group. No layer changes route or
    padded shape; at 32 and 64 (where no layer runs wide) no wide forward
    is left since the CUDA-core one was retired."""
    f32, bf16 = torch.float32, torch.bfloat16
    threads, smem = lstm_cuda.fwd_wide_f32_resident_plan(96, f32)
    assert threads == 384 == 4 * 96 and 2 * 12 * 4 == 96
    assert smem == 2 * 8 * 112 * 4 + 5 * 8 * 388 * 4 == 69248 <= lstm_cuda.SMEM_LIMIT
    assert (96 + lstm_cuda.FWD_WIDE_F32_RESIDENT_H_PAD) % 32 == 16  # 8 lanes' B loads: 32 banks
    assert lstm_cuda.FWD_WIDE_F32_RESIDENT_WIDTHS == (96,)
    assert lstm_cuda.wide_fwd_kernel(96, f32) == "bilstm_fwd_wide_f32_resident"
    assert lstm_cuda.wide_fwd_kernel(96, bf16) == "bilstm_fwd_wide_mma_resident"
    for H in (32, 64):
        with pytest.raises(ValueError, match=f"no wide forward kernel takes H={H}"):
            lstm_cuda.wide_fwd_kernel(H, f32)
    for H, dtype in ((96, bf16), (128, f32), (160, f32), (64, f32), (80, f32)):
        with pytest.raises(ValueError, match="bilstm_fwd_wide_f32_resident kernel takes float32"):
            lstm_cuda.fwd_wide_f32_resident_plan(H, dtype)
    assert lstm_cuda.layer_route([80, 80], 80, f32) == "wide"
    assert lstm_cuda.padded_width([80, 80], 80, f32) == 96


@pytest.mark.parametrize("G", [1, 3])
def test_fwd_wide_f32_resident_wrappers_take_plain_versions_on_cpu(G):
    """On the CPU the one-block f32 wide forward (both variants), the
    dispatch and the dispatch asked for it by name run the plain twin bit
    for bit and launch nothing; the retired cluster kernel's name is
    refused; under grad mode the wrappers refuse an operand that requires
    grad."""
    cpu, cd, H = torch.device("cpu"), torch.float32, 96
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(5, 9, [32, 32], H, G, cd, cpu)
    xg = input_gates(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_fwd_wide_f32_resident,
                lstm_cuda.bilstm_fwd_wide_train_f32_resident)
    before = [f.launches for f in wrappers]
    for got in (lstm_cuda.bilstm_fwd_wide_train_f32_resident(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd,
                                                kernel="bilstm_fwd_wide_f32_resident")):
        assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    for got in (lstm_cuda.bilstm_fwd_wide_f32_resident(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert [f.launches for f in wrappers] == before
    with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
        lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")
    for fwd in wrappers:
        with pytest.raises(RuntimeError, match="no autograd graph"):
            fwd(xg.clone().requires_grad_(), lengths, w_hh, cd)
        with torch.no_grad():
            fwd(xg, lengths, w_hh.clone().requires_grad_(), cd)


@pytest.mark.parametrize("H,rows,cluster,resident,want", [
    (96, 32, 4, True, 3 * 96 * 128 + 32 * 112 * 4 + 32 * 112 * 4 + 96 * 40 * 4),
    (128, 32, 4, True, 4 * 128 * 128 + 32 * 144 * 4 + 32 * 144 * 4 + 128 * 40 * 4),
    (128, 16, 8, True, 2 * 128 * 128 + 16 * 144 * 4 + 16 * 80 * 4 + 128 * 24 * 4),
    (128, 32, 8, False, 32 * 144 * 4 + 32 * 80 * 4 + 128 * 40 * 4),
    (160, 32, 4, True, 5 * 160 * 128 + 32 * 176 * 4 + 32 * 176 * 4 + 160 * 40 * 4),
    (192, 32, 4, True, 6 * 192 * 128 + 32 * 208 * 4 + 32 * 208 * 4 + 192 * 40 * 4),
    (224, 32, 8, True, 4 * 224 * 128 + 32 * 240 * 4 + 32 * 144 * 4 + 224 * 40 * 4),
    (256, 32, 8, True, 4 * 256 * 128 + 32 * 272 * 4 + 32 * 144 * 4 + 256 * 40 * 4),
    (288, 32, 8, False, 32 * 304 * 4 + 32 * 176 * 4 + 288 * 40 * 4),
    (288, 16, 8, False, 16 * 304 * 4 + 16 * 176 * 4 + 288 * 24 * 4)])
def test_recurrence_mid_f32_smem_and_plan(H, rows, cluster, resident, want):
    """The op's f32 sweep at 96-288 (csrc/lstm_recurrence_bwd_mid_f32.cu:
    smem_bytes): with the fragments resident, the block's share, 128 bytes
    a unit group and input for the most groups a block owns
    (ceil(H / 8 / cluster)); the f32 h_prev tile (rows of H + 16), the
    dgates tile (32 columns a group + 16) and the partial dh (H rows of 8
    mod 16 floats). The 4-block share fits at 96-192 (231,424 bytes at 192
    and 32 rows), the 8-block one to 256 (225,280), none at 288, which the
    plan reads from L2. At the train shape (400 rows in 5 groups, D = 2) the
    plan takes 32-row tiles: 30 clusters, one wave where the card holds 30
    4-block clusters, two of 15 8-block ones. Combinations without an
    instance are refused."""
    assert lstm_cuda.recurrence_mid_f32_smem(H, rows, cluster, resident) == want
    assert want <= lstm_cuda.SMEM_LIMIT
    plan = lstm_cuda.recurrence_mid_f32_plan(
        400, 5, H, lambda c, r, R, smem: {4: 30, 8: 15}[c])
    assert plan[:3] == (lstm_cuda.REC_MID_F32_CLUSTER.get(H, 8),
                        H not in lstm_cuda.REC_MID_F32_FROM_L2, 32)
    assert plan[3] == lstm_cuda.mma_tiles(400, 5, 32) == 15
    assert plan[4] == lstm_cuda.recurrence_mid_f32_smem(H, 32, plan[0], plan[1])
    for bad in ((H, 48, cluster, resident), (H, rows, 2, True), (H, rows, 4, False)):
        with pytest.raises(ValueError, match="no instance"):
            lstm_cuda.recurrence_mid_f32_smem(*bad)
    with pytest.raises(ValueError, match="no instance"):
        lstm_cuda.recurrence_mid_f32_smem(288, 32, 8, True)
    with pytest.raises(ValueError, match="no instance"):
        lstm_cuda.recurrence_mid_f32_smem(224, 32, 4, True)
    for h, dtype in ((64, torch.float32), (320, torch.float32), (128, torch.bfloat16),
                     (100, torch.float32)):
        with pytest.raises(ValueError, match="lstm_recurrence_bwd_mid_f32 takes compute dtype"):
            lstm_cuda.recurrence_mid_f32_check(h, dtype)


@pytest.mark.parametrize("H", [96, 160, 288])
def test_recurrence_mid_f32_wrapper_takes_plain_version_on_cpu(H):
    """On the CPU the op's f32 sweep at 96-288 and the dispatch, also by
    the sweep's name, run the plain twin bit for bit and launch nothing, with the f32 fragment copy handed in or not; under grad
    mode an operand that requires grad is refused."""
    T, D, B, G, cd = 4, 2, 6, 2, torch.float32
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, torch.device("cpu"),
                                                  "holes", seed=H)
    hs, cs, _, _ = recurrence_fwd(xg, valid, w, G, cd)
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    want = recurrence_sweep(*args)
    wrappers = (lstm_cuda.lstm_recurrence_bwd_mid_f32, lstm_cuda.lstm_recurrence_bwd)
    before = [f.launches for f in wrappers]
    wf = lstm_cuda.recurrence_f32_weights(w)
    for got in (lstm_cuda.lstm_recurrence_bwd_mid_f32(*args),
                lstm_cuda.lstm_recurrence_bwd_mid_f32(*args, wf=wf),
                lstm_cuda.lstm_recurrence_bwd(*args),
                lstm_cuda.lstm_recurrence_bwd(*args, kernel="lstm_recurrence_bwd_mid_f32")):
        assert torch.equal(got, want)
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_bwd_mid_f32(xg, valid, w.clone().requires_grad_(), *args[3:])


def _mid_f32_instances():
    """(H, blocks a cluster, resident, row tile) of every instance of the
    op's f32 sweep at 96-288."""
    return [(H, c, r, rows) for (c, r), widths in lstm_cuda.REC_MID_F32_INSTANCES.items()
            for H in widths for rows in lstm_cuda.REC_MID_F32_ROWS]


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,T,mask", [(1, 30, 300, "lengths"), (5, 40, 300, "holes"),
                                        (5, 65, 1, "lengths"), (3, 27, 7, "off")])
@pytest.mark.parametrize("H,cluster,resident,rows", _mid_f32_instances())
def test_recurrence_mid_f32_matches_plain_on_card(cuda_device, monkeypatch, H, cluster,
                                                  resident, rows, G, B, T, mask):
    """Every instance of the op's f32 sweep at 96-288 (blocks a cluster,
    fragments resident or read from L2, row tile; pinned with monkeypatch on
    the plan's tables) against its plain twin at 1e-4 x max(1, max|ref|):
    masks from lengths, with holes (an all-off and an all-on row) and all
    off; T = 1, 7 and 300; groups of 30, 8, 13 and 9 rows, which leave short
    row tiles; dhs, dhn and dcn None in turn; the same bits twice. Its
    wrapper counts the launches; the cluster sweep never launches."""
    monkeypatch.setattr(lstm_cuda, "REC_MID_F32_CLUSTER", {H: cluster})
    monkeypatch.setattr(lstm_cuda, "REC_MID_F32_FROM_L2", () if resident else (H,))
    monkeypatch.setattr(lstm_cuda, "REC_MID_F32_ROWS", (rows,))
    cd = torch.float32
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, 2, B, H, G, cd, cuda_device,
                                                  "holes" if mask == "off" else mask,
                                                  seed=H + T + G)
    if mask == "off":
        valid = torch.zeros_like(valid)
    assert lstm_cuda.recurrence_sweep_kernel(H, cd) == "lstm_recurrence_bwd_mid_f32"
    wrappers = (lstm_cuda.lstm_recurrence_bwd_mid_f32, lstm_cuda.lstm_recurrence_bwd)
    before = [f.launches for f in wrappers]
    hs, cs = recurrence_fwd(xg, valid, w, G, cd)[:2]
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    got = lstm_cuda.lstm_recurrence_bwd(*args)
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd(*args), got)
    _close([got], [recurrence_sweep(*args)], 1e-4)
    for part in ((xg, valid, w, hs, cs, None, dhn, None, G, cd),
                 (xg, valid, w, hs, cs, dhs, None, dcn, G, cd)):
        _close([lstm_cuda.lstm_recurrence_bwd(*part)], [recurrence_sweep(*part)], 1e-4)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [4, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("H,mask", [(128, "lengths"), (128, "holes"), (256, "lengths")])
def test_recurrence_mid_f32_at_the_main_path_shape_on_card(cuda_device, H, mask):
    """The one-layer f32 model at embedding 128 on the recurrence backend at
    its run shape (400 rows in 5 groups, D = 2, T = 1500) and the same rows
    at 256, on the dispatch's plan (4-block clusters at 128, 8-block ones at
    256, the fragments resident): against the plain twin at 1e-4 x max(1,
    max|ref|), the same bits twice, from the forward's fragment copy and
    from its own."""
    cd, G, B, T = torch.float32, 5, 400, 1500
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, 2, B, H, G, cd, cuda_device, mask, seed=H)
    hs, cs = lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd)[:2]
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    want = recurrence_sweep(*args)
    wf = lstm_cuda.recurrence_f32_weights(w)
    got = lstm_cuda.lstm_recurrence_bwd(*args, wf=wf)
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd(*args), got)
    _close([got], [want], 1e-4)
    before = lstm_cuda.lstm_recurrence_bwd_mid_f32.launches
    _close([lstm_cuda.lstm_recurrence_bwd_mid_f32(*args)], [want], 1e-4)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_recurrence_bwd_mid_f32.launches == before + 1


@pytest.mark.cuda
def test_recurrence_mid_f32_refuses_on_card(cuda_device, monkeypatch):
    """The op's f32 sweep at 96-288 asked for by name refuses bf16, the
    widths it does not take and a plan with no instance, before any launch;
    a batch of no row launches nothing; a wrong fragment copy is refused."""
    cd = torch.float32
    xg, valid, w, dhs, dhn, dcn = recurrence_case(4, 2, 10, 128, 2, cd, cuda_device, "holes")
    hs, cs = recurrence_fwd(xg, valid, w, 2, cd)[:2]
    wrapper = lstm_cuda.lstm_recurrence_bwd_mid_f32
    before = wrapper.launches
    with pytest.raises(ValueError, match="lstm_recurrence_bwd_mid_f32 takes compute dtype"):
        wrapper(xg, valid, w.to(torch.bfloat16), hs, cs, dhs, dhn, dcn, 2, torch.bfloat16)
    small = recurrence_case(4, 2, 10, 64, 2, cd, cuda_device, "holes")
    hsm, csm = recurrence_fwd(small[0], small[1], small[2], 2, cd)[:2]
    with pytest.raises(ValueError, match="lstm_recurrence_bwd_mid_f32 takes compute dtype"):
        wrapper(small[0], small[1], small[2], hsm, csm, None, None, None, 2, cd)
    with pytest.raises(ValueError, match="wf must be a contiguous"):
        wrapper(xg, valid, w, hs, cs, dhs, dhn, dcn, 2, cd, wf=torch.zeros(3, device=cuda_device))
    cut = lambda t: t[:, :, :0].contiguous()  # noqa: E731
    assert wrapper(cut(xg), cut(valid), w, cut(hs), cut(cs), None, None, None, 2, cd).shape == \
        (4, 2, 0, 512)
    monkeypatch.setattr(lstm_cuda, "REC_MID_F32_CLUSTER", {128: 2})
    with pytest.raises(ValueError, match="no instance"):
        wrapper(xg, valid, w, hs, cs, dhs, dhn, dcn, 2, cd)
    torch.cuda.synchronize()
    assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("G,B", [(1, 30), (1, 13), (3, 27), (5, 60), (2, 22), (5, 400)])
def test_fwd_wide_f32_resident_matches_plain_on_card(cuda_device, T, G, B):
    """The one-block f32 wide forward at H = 96 (three tf32 passes, W_hh as
    f32 mma fragments in registers) against its plain twin at 1e-4 x max(1,
    max|ref|), both variants: groups of 30, 13, 9, 12, 11 and 80 rows
    (short tiles inside each group), groups at lengths 0, 1 and T, rows of
    length 0, 1 and T and rows 8-15 short of T (a tile that stops at its
    longest row). The dispatch names it and its wrappers count the
    launches; both variants give the same hs bits; ``bilstm_fwd_wide.cu``'s
    name is refused (the source is retired)."""
    cd, H = torch.float32, 96
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [H], H, G, cd, cuda_device,
                                                           seed=T + B + 97)
    lengths[8:16] = torch.clamp(lengths[8:16], max=T // 3)
    lengths = _main_path_lengths(lengths, G, T)
    xg = input_gates(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    assert lstm_cuda.wide_fwd_kernel(H, cd) == "bilstm_fwd_wide_f32_resident"
    wrappers = (lstm_cuda.bilstm_fwd_wide_f32_resident,
                lstm_cuda.bilstm_fwd_wide_train_f32_resident)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
    ev = lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)
    _close(got, want, 1e-4)
    _close(ev, want[:4], 1e-4)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    assert all(torch.equal(a, b) for a, b in zip(
        lstm_cuda.bilstm_fwd_wide_train_f32_resident(xg, lengths, w_hh, cd), got))
    _close(lstm_cuda.bilstm_fwd_wide_f32_resident(xg, lengths, w_hh, cd), want[:4], 1e-4)
    with pytest.raises(ValueError, match="no wide forward kernel named 'bilstm_fwd_wide'"):
        lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 5])
def test_fwd_wide_f32_resident_at_the_main_path_shape_on_card(cuda_device, G):
    """The stacked layer of the f32 model at embedding 80 at its run shape:
    H = 96, input parts 80 + 80 (the gates from the f32 tensor-core gates
    kernel), 400 rows in one group (and in 5), T = 1500, ragged lengths:
    both variants against the plain twin at 1e-4 x max(1, max|ref|), the
    same bits twice, and the same hs bits in both variants."""
    cd, T, B, H = torch.float32, 1500, 400, 96
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [80, 80], H, G, cd, cuda_device,
                                                           seed=16 + G)
    xg = lstm_cuda.bilstm_gates_f32(parts, w_ih, bias, cd)
    del parts
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    got = lstm_cuda.bilstm_fwd_wide_train_f32_resident(xg, lengths, w_hh, cd)
    again = lstm_cuda.bilstm_fwd_wide_train_f32_resident(xg, lengths, w_hh, cd)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    ev = lstm_cuda.bilstm_fwd_wide_f32_resident(xg, lengths, w_hh, cd)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    _close(got, want, 1e-4)
    _close(ev, want[:4], 1e-4)


@pytest.mark.cuda
def test_fwd_wide_f32_resident_edges_on_card(cuda_device):
    """An empty batch launches nothing and T = 0 gives empty streams with a
    zero final state; bf16 operands, H = 128 and a ``w_hh`` that is not
    contiguous raise in the one-block f32 wrappers (nothing falls back)."""
    cd = torch.float32
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 10, [96], 96, 2, cd, cuda_device)
    xg = input_gates(parts, w_ih, bias, cd)
    wrappers = (lstm_cuda.bilstm_fwd_wide_f32_resident,
                lstm_cuda.bilstm_fwd_wide_train_f32_resident)
    before = [f.launches for f in wrappers]
    for fwd in wrappers:
        out = fwd(xg[:, :, :0].contiguous(), lengths[:0], w_hh[:, :1].contiguous(), cd)
        assert out[0].shape == (4, 0, 96) and out[2].shape == (2, 0, 96)
    assert [f.launches for f in wrappers] == before
    for fwd in wrappers:
        out = fwd(xg[:, :0].contiguous(), lengths, w_hh, cd)
        assert out[0].shape == (0, 10, 96) and not out[2].any() and not out[3].any()
        bf16 = torch.bfloat16
        with pytest.raises(ValueError, match="bilstm_fwd_wide_f32_resident kernel takes float32"):
            fwd(xg, lengths, w_hh.to(bf16), bf16)
        wide = layer_case(4, 10, [128], 128, 2, cd, cuda_device)
        xw = input_gates(*wide[:1], wide[2], wide[4], cd)
        with pytest.raises(ValueError, match="bilstm_fwd_wide_f32_resident kernel takes float32"):
            fwd(xw, wide[1], wide[3], cd)
        with pytest.raises(ValueError, match="w_hh must be a contiguous"):
            fwd(xg, lengths, w_hh.transpose(-1, -2).contiguous().transpose(-1, -2), cd)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recurrence_model_at_embedding_128_on_card(cuda_device, monkeypatch, dtype):
    """The two-layer model at embedding 128 on the recurrence backend: both
    layers run the op at 128; in f32 its forward and sweep are the
    tensor-core ``lstm_recurrence_{fwd,bwd}_mid_f32.cu`` (three tf32 passes,
    one f32 fragment copy a layer for both), in bf16
    ``lstm_recurrence_{fwd,bwd}_mid_mma.cu``; the dispatchers count no
    launch of their own. Its gradients equal the CPU plain path's (1e-4 x max(1,
    max|grad|) in f32, 2^-7 in bf16)."""
    from intrepppid_tpu_torch.ops import lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(lstm, "DEFAULT_BACKEND", "recurrence")
    f32 = dtype == torch.float32
    wrappers = (lstm_cuda.lstm_recurrence_fwd_mid_f32, lstm_cuda.lstm_recurrence_bwd_mid_f32,
                lstm_cuda.lstm_recurrence_fwd, lstm_cuda.lstm_recurrence_bwd,
                lstm_cuda.lstm_recurrence_fwd_mid_mma, lstm_cuda.lstm_recurrence_bwd_mid_mma)
    copies = []
    weights = lstm_cuda.recurrence_f32_weights
    monkeypatch.setattr(lstm_cuda, "recurrence_f32_weights",
                        lambda w: copies.append(w.shape) or weights(w))
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=dtype, embedding_size=128)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [
        2 * f32, 2 * f32, 0, 0, 2 * (not f32), 2 * (not f32)]
    assert len(copies) == 2 * f32  # one copy a layer, for the forward and the sweep
    want = model_grads(torch.device("cpu"), dtype=dtype, embedding_size=128)
    tol = 1e-4 if f32 else 2.0 ** -7
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= tol * max(
            1.0, float(ref.abs().max())), name


# ---------------- the op's bf16 tensor-core sweep and forward at 96-288
@pytest.mark.parametrize("kind,H,rows,cluster,want", [
    ("bwd", 96, 32, 4, 3 * 96 * 64 + 32 * 96 * 4 + 32 * 104 * 2 + 32 * 104 * 2 + 96 * 40 * 4),
    ("bwd", 128, 16, 4, 4 * 128 * 64 + 16 * 128 * 4 + 16 * 136 * 2 + 16 * 136 * 2 + 128 * 24 * 4),
    ("bwd", 128, 32, 8, 2 * 128 * 64 + 32 * 128 * 4 + 32 * 136 * 2 + 32 * 72 * 2 + 128 * 40 * 4),
    ("bwd", 224, 32, 4, 7 * 224 * 64 + 32 * 224 * 4 + 32 * 232 * 2 + 32 * 232 * 2 + 224 * 40 * 4),
    ("bwd", 256, 16, 4, 8 * 256 * 64 + 16 * 256 * 4 + 16 * 264 * 2 + 16 * 264 * 2 + 256 * 24 * 4),
    ("bwd", 256, 32, 8, 4 * 256 * 64 + 32 * 256 * 4 + 32 * 264 * 2 + 32 * 136 * 2 + 256 * 40 * 4),
    ("bwd", 288, 32, 8, 5 * 288 * 64 + 32 * 288 * 4 + 32 * 296 * 2 + 32 * 168 * 2 + 288 * 40 * 4),
    ("fwd", 96, 32, 4, 3 * 96 * 64 + 2 * 32 * 104 * 2 + 32 * 32 * 2 + 5 * (32 * 100 * 4 + 48)),
    ("fwd", 128, 16, 4, 4 * 128 * 64 + 2 * 16 * 136 * 2 + 16 * 40 * 2 + 5 * (16 * 132 * 4 + 48)),
    ("fwd", 192, 32, 4, 6 * 192 * 64 + 2 * 32 * 200 * 2 + 32 * 56 * 2 + 5 * (32 * 196 * 4 + 48)),
    ("fwd", 256, 16, 4, 8 * 256 * 64 + 2 * 16 * 264 * 2 + 16 * 72 * 2 + 4 * (16 * 260 * 4 + 48)),
    ("fwd", 288, 16, 8, 5 * 288 * 64 + 2 * 16 * 296 * 2 + 16 * 48 * 2 + 5 * (16 * 164 * 4 + 48))])
def test_recurrence_mid_mma_smem_and_plan(kind, H, rows, cluster, want):
    """The op's bf16 sweep and forward at 96-288
    (csrc/lstm_recurrence_{bwd,fwd}_mid_mma.cu:smem_bytes): first the
    block's share of the bf16 fragment copy, 64 bytes a unit group and
    input for the most groups a block owns (ceil(H / 8 / cluster)); the
    sweep's f32 h_prev tile, its bf16 rounding (rows of H + 8), the bf16
    dgates tile (32 columns a group + 8) and the f32 partial dh (H rows of 8
    mod 16 floats); the forward's two bf16 h tiles, its staged new h (8
    columns a group + 8) and its cp.async ring of f32 xg rows (4 gates x 8
    units a group + 4) and 48 mask bytes, 5 stages, 4 where a block owns 8
    groups (256 in 4-block clusters). At the train shape (400 rows in 5
    groups, D = 2) on a card that holds 30 4-block clusters or 15 8-block
    ones, the plan takes the table's cluster size and the row tile of the
    fewest waves, then the smallest; combinations without an instance are
    refused."""
    assert lstm_cuda.recurrence_mid_mma_smem(kind, H, rows, cluster) == want
    assert want <= lstm_cuda.SMEM_LIMIT
    table = lstm_cuda.REC_MID_MMA_CLUSTER[kind]
    cl = table.get(H, 8)
    plan = lstm_cuda.recurrence_mid_mma_plan(kind, 400, 5, H, lambda c, R, smem: {4: 30, 8: 15}[c])
    fits = [R for R in lstm_cuda.REC_MID_MMA_ROWS
            if lstm_cuda.recurrence_mid_mma_smem(kind, H, R, cl) <= lstm_cuda.SMEM_LIMIT]
    waves = {R: -(-2 * lstm_cuda.mma_tiles(400, 5, R) // {4: 30, 8: 15}[cl]) for R in fits}
    best = min(R for R in fits if waves[R] == min(waves.values()))
    assert plan == (cl, best, lstm_cuda.mma_tiles(400, 5, best),
                    lstm_cuda.recurrence_mid_mma_smem(kind, H, best, cl))
    for bad in ((kind, H, 48, cluster), (kind, H, rows, 2), ("lite", H, rows, cluster)):
        with pytest.raises(ValueError, match="no instance"):
            lstm_cuda.recurrence_mid_mma_smem(*bad)
    with pytest.raises(ValueError, match="no instance"):
        lstm_cuda.recurrence_mid_mma_smem(kind, 288, 16, 4)  # 9 groups outnumber 8 warps
    for h, dtype in ((64, torch.bfloat16), (320, torch.bfloat16), (128, torch.float32),
                     (100, torch.bfloat16)):
        with pytest.raises(ValueError, match="lstm_recurrence_fwd_mid_mma take compute dtype"):
            lstm_cuda.recurrence_mid_mma_check(h, dtype)


@pytest.mark.parametrize("H", [96, 160, 288])
def test_recurrence_mid_mma_wrappers_take_plain_version_on_cpu(H):
    """On the CPU the op's bf16 sweep and forward at 96-288 and the
    dispatch, by name or not, run the plain twins bit for bit and launch nothing, with the bf16 fragment copy handed in or not;
    under grad mode an operand that requires grad is refused."""
    T, D, B, G, cd = 4, 2, 6, 2, torch.bfloat16
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, torch.device("cpu"),
                                                  "holes", seed=H)
    want_fwd = recurrence_fwd(xg, valid, w, G, cd)
    hs, cs = want_fwd[:2]
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    want = recurrence_sweep(*args)
    wrappers = (lstm_cuda.lstm_recurrence_bwd_mid_mma, lstm_cuda.lstm_recurrence_fwd_mid_mma,
                lstm_cuda.lstm_recurrence_bwd, lstm_cuda.lstm_recurrence_fwd)
    before = [f.launches for f in wrappers]
    wf = lstm_cuda.recurrence_mma_weights(w)
    for got in (lstm_cuda.lstm_recurrence_bwd_mid_mma(*args),
                lstm_cuda.lstm_recurrence_bwd_mid_mma(*args, wf=wf),
                lstm_cuda.lstm_recurrence_bwd(*args, wf=wf),
                lstm_cuda.lstm_recurrence_bwd(*args, kernel="lstm_recurrence_bwd_mid_mma")):
        assert torch.equal(got, want)
    for got in (lstm_cuda.lstm_recurrence_fwd_mid_mma(xg, valid, w, G, cd),
                lstm_cuda.lstm_recurrence_fwd_mid_mma(xg, valid, w, G, cd, wf=wf),
                lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd, wf=wf),
                lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd,
                                              kernel="lstm_recurrence_fwd_mid_mma")):
        assert all(torch.equal(a, b) for a, b in zip(got, want_fwd))
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_bwd_mid_mma(xg, valid, w.clone().requires_grad_(), *args[3:])
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_fwd_mid_mma(xg.clone().requires_grad_(), valid, w, G, cd)


@pytest.mark.parametrize("H,dtype,copy", [
    (64, torch.bfloat16, None), (96, torch.bfloat16, "bf16"), (288, torch.bfloat16, "bf16"),
    (320, torch.bfloat16, "bf16"),
    # f32 at 96-288: the forward there reads the sweep's copy (ids kept)
    pytest.param(96, torch.float32, "f32", id="96-dtype4-None"),
    pytest.param(288, torch.float32, "f32", id="288-dtype5-None"),
    (320, torch.float32, "f32"), (128, torch.float32, "f32"), (64, torch.float32, None),
    (32, torch.float32, None)])
def test_recurrence_fragments_by_width_and_dtype(H, dtype, copy):
    """The fragment copy ``FusedLSTMRecurrence`` builds once in the forward
    and saves for the backward: wherever the forward runs on a cluster
    kernel (96 and past), the bf16 one in bf16 and the f32 one in f32; none
    at 32 and 64, whose kernels read ``w`` itself; bit for bit the copy the
    kernels' wrappers would build."""
    w = (torch.rand(2, 1, H, 4 * H, generator=torch.Generator().manual_seed(H)) - 0.5).to(dtype)
    got = lstm_cuda.recurrence_fragments(w, dtype)
    if copy is None:
        assert got is None
        return
    want = (lstm_cuda.recurrence_mma_weights(w) if copy == "bf16"
            else lstm_cuda.recurrence_f32_weights(w))
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(lstm_cuda._mma_copy(w, got) if copy == "bf16"
                       else lstm_cuda._f32_copy(w, got), want)


def _mid_mma_instances():
    """(H, blocks a cluster, row tile) of every instance of the op's bf16
    sweep or forward at 96-288 whose shared memory fits."""
    return [(H, c, rows) for c, widths in lstm_cuda.REC_MID_MMA_INSTANCES.items()
            for H in widths for rows in lstm_cuda.REC_MID_MMA_ROWS
            if min(lstm_cuda.recurrence_mid_mma_smem(k, H, rows, c) for k in ("bwd", "fwd"))
            <= lstm_cuda.SMEM_LIMIT]


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,T,D,mask", [(1, 30, 300, 2, "lengths"), (5, 40, 300, 2, "holes"),
                                          (5, 65, 1, 2, "lengths"), (3, 27, 7, 1, "holes")])
@pytest.mark.parametrize("H,cluster,rows", _mid_mma_instances())
def test_recurrence_mid_mma_matches_plain_on_card(cuda_device, monkeypatch, H, cluster, rows,
                                                  G, B, T, D, mask):
    """Every instance of the op's bf16 sweep and forward at 96-288 (blocks a
    cluster, row tile; pinned with monkeypatch on the plan's tables; each
    kernel where its shared memory fits) against its plain twin at 3e-2 x
    max(1, max|ref|): masks from lengths and with holes; T = 1, 7 and 300;
    D = 1 and 2; groups of 30, 8, 13 and 9 rows, which leave short row
    tiles; dhs, dhn and dcn None in turn; the bf16 fragment copy handed in
    or built; the same bits twice. The wrappers count the launches; the
    dispatchers count none."""
    cd = torch.bfloat16
    monkeypatch.setattr(lstm_cuda, "REC_MID_MMA_CLUSTER", {"bwd": {H: cluster},
                                                           "fwd": {H: cluster}})
    monkeypatch.setattr(lstm_cuda, "REC_MID_MMA_ROWS", (rows,))
    fits = {k: lstm_cuda.recurrence_mid_mma_smem(k, H, rows, cluster) <= lstm_cuda.SMEM_LIMIT
            for k in ("bwd", "fwd")}
    assert lstm_cuda.recurrence_fwd_kernel(H, cd) == "lstm_recurrence_fwd_mid_mma"
    assert lstm_cuda.recurrence_sweep_kernel(H, cd) == "lstm_recurrence_bwd_mid_mma"
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, cuda_device, mask,
                                                  seed=H + T + G + D)
    wrappers = (lstm_cuda.lstm_recurrence_fwd_mid_mma, lstm_cuda.lstm_recurrence_bwd_mid_mma,
                lstm_cuda.lstm_recurrence_fwd, lstm_cuda.lstm_recurrence_bwd)
    before = [f.launches for f in wrappers]
    wf = lstm_cuda.recurrence_mma_weights(w)
    want = recurrence_fwd(xg, valid, w, G, cd)
    if fits["fwd"]:
        got = lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd, wf=wf)
        again = lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _close(got, want, 3e-2)
    hs, cs = want[:2]
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    if fits["bwd"]:
        got = lstm_cuda.lstm_recurrence_bwd(*args, wf=wf)
        assert torch.equal(lstm_cuda.lstm_recurrence_bwd(*args), got)
        _close([got], [recurrence_sweep(*args)], 3e-2)
        for part in ((xg, valid, w, hs, cs, None, dhn, None, G, cd),
                     (xg, valid, w, hs, cs, dhs, None, dcn, G, cd)):
            _close([lstm_cuda.lstm_recurrence_bwd(*part)], [recurrence_sweep(*part)], 3e-2)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [
        2 * fits["fwd"], 4 * fits["bwd"], 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("H,G,mask", [(96, 1, "lengths"), (128, 5, "holes"), (224, 3, "lengths"),
                                      (256, 5, "holes"), (288, 2, "lengths")])
def test_recurrence_mid_mma_autograd_on_card(cuda_device, monkeypatch, H, G, mask):
    """``fused_lstm_recurrence`` in bf16 at 96-288 on the card against the
    same op on the CPU (the plain twins): values and the gradients of xg
    and w at 3e-2 x max(1, max|ref|). One step runs each new kernel once
    (the dispatchers count none), and builds the bf16 fragment copy once, in
    the forward, for both."""
    T, D, B, cd = 40, 2, 5 * G, torch.bfloat16
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, cd, torch.device("cpu"), mask,
                                                  seed=H + G)
    built = []
    real = lstm_cuda.recurrence_mma_weights
    monkeypatch.setattr(lstm_cuda, "recurrence_mma_weights",
                        lambda w: built.append(w.shape) or real(w))
    wrappers = (lstm_cuda.lstm_recurrence_fwd_mid_mma, lstm_cuda.lstm_recurrence_bwd_mid_mma,
                lstm_cuda.lstm_recurrence_fwd, lstm_cuda.lstm_recurrence_bwd)
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        x = xg.to(dev).requires_grad_()
        ww = w.to(dev).requires_grad_()
        before = [f.launches for f in wrappers]
        out = fused_lstm_recurrence(x, valid.to(dev), ww, G, cd)
        loss = (out[0] * dhs.to(dev)).sum() + (out[1] * dhn.to(dev)).sum() \
            + (out[2] * dcn.to(dev)).sum()
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1, 0, 0]
            assert built == [w.shape]
        grads[dev.type] = [t.detach().float().cpu() for t in (*out, x.grad, ww.grad)]
    _close(grads["cuda"], grads["cpu"], 3e-2)


@pytest.mark.cuda
def test_recurrence_mid_mma_refuses_on_card(cuda_device, monkeypatch):
    """The op's bf16 sweep and forward at 96-288 asked for by name refuse
    f32, the widths they do not take, a wrong fragment copy and a plan with
    no instance, before any launch; a batch of no row launches nothing."""
    cd = torch.bfloat16
    xg, valid, w, dhs, dhn, dcn = recurrence_case(4, 2, 10, 128, 2, cd, cuda_device, "holes")
    hs, cs = recurrence_fwd(xg, valid, w, 2, cd)[:2]
    bwd, fwd = lstm_cuda.lstm_recurrence_bwd_mid_mma, lstm_cuda.lstm_recurrence_fwd_mid_mma
    before = [bwd.launches, fwd.launches]
    with pytest.raises(ValueError, match="take compute dtype bfloat16"):
        bwd(xg, valid, w.float(), hs, cs, dhs, dhn, dcn, 2, torch.float32)
    with pytest.raises(ValueError, match="take compute dtype bfloat16"):
        fwd(xg, valid, w.float(), 2, torch.float32)
    small = recurrence_case(4, 2, 10, 64, 2, cd, cuda_device, "holes")
    hsm, csm = recurrence_fwd(small[0], small[1], small[2], 2, cd)[:2]
    with pytest.raises(ValueError, match="take compute dtype bfloat16"):
        bwd(small[0], small[1], small[2], hsm, csm, None, None, None, 2, cd)
    with pytest.raises(ValueError, match="take compute dtype bfloat16"):
        fwd(small[0], small[1], small[2], 2, cd)
    bad = torch.zeros(3, dtype=cd, device=cuda_device)
    with pytest.raises(ValueError, match="wf must be a contiguous"):
        bwd(xg, valid, w, hs, cs, dhs, dhn, dcn, 2, cd, wf=bad)
    with pytest.raises(ValueError, match="wf must be a contiguous"):
        fwd(xg, valid, w, 2, cd, wf=lstm_cuda.recurrence_mma_weights(w).float())
    cut = lambda t: t[:, :, :0].contiguous()  # noqa: E731
    assert bwd(cut(xg), cut(valid), w, cut(hs), cut(cs), None, None, None, 2, cd).shape == \
        (4, 2, 0, 512)
    assert fwd(cut(xg), cut(valid), w, 2, cd)[0].shape == (4, 2, 0, 128)
    for kind in ("bwd", "fwd"):
        monkeypatch.setattr(lstm_cuda, "REC_MID_MMA_CLUSTER", {"bwd": {128: 2}, "fwd": {128: 2}})
        with pytest.raises(ValueError, match="no instance"):
            (bwd(xg, valid, w, hs, cs, dhs, dhn, dcn, 2, cd) if kind == "bwd"
             else fwd(xg, valid, w, 2, cd))
    torch.cuda.synchronize()
    assert [bwd.launches, fwd.launches] == before


# ------------- the op's f32 tensor-core forwards (three tf32 passes), 32-288
@pytest.mark.parametrize("H,want", [(32, 23840), (64, 46368)])
def test_recurrence_fwd_f32_smem(H, want):
    """The op's f32 forward at H = 32 / 64 (csrc/lstm_recurrence_fwd_f32.cu:
    smem_bytes; its weights sit in registers, pre-split): two f32 h tiles (8
    rows of H + 8) and five stages of the f32 xg tile (8 rows of 4H + 4) and
    of 32 mask bytes; the launch cuts each weight group into 8-row tiles (50
    at the train shape)."""
    assert lstm_cuda.recurrence_fwd_f32_smem(H) == want == (
        4 * (2 * 8 * (H + 8) + 5 * 8 * (4 * H + 4)) + 5 * 32)
    assert want <= lstm_cuda.SMEM_LIMIT
    assert lstm_cuda.REC_FWD_F32_STAGES == 5 and lstm_cuda.mma_tiles(400, 5) == 50


@pytest.mark.parametrize("H,rows,cluster,resident,stages", [
    (96, 16, 4, True, 5), (96, 32, 4, True, 5), (128, 32, 4, True, 5), (160, 32, 4, True, 3),
    (192, 16, 4, True, 4), (128, 32, 8, True, 5), (224, 16, 8, True, 5), (256, 16, 8, True, 5),
    (256, 32, 8, False, 5), (288, 32, 8, False, 5), (288, 16, 8, False, 5)])
def test_recurrence_mid_f32_fwd_smem_and_plan(H, rows, cluster, resident, stages):
    """The op's f32 forward at 96-288 (csrc/lstm_recurrence_fwd_mid_f32.cu:
    smem_with / stages): with the fragments resident, the block's share (128
    bytes a unit group and input for ceil(H / 8 / cluster) groups); two f32
    h tiles (rows of H + 16), the staged new h (8 units a group + 4) and the
    ring, each stage an f32 xg row (32 a group + 4) for every tile row and
    48 mask bytes. An instance takes five stages, or as many as fit at its
    widest width, at least three: 4-block clusters at 160 and 32 rows take
    three, at 192 and 16 rows four; 32-row tiles fit neither there nor in
    resident 8-block clusters past 192, and no resident instance fits 288.
    At the train shape (400 rows in 5 groups, D = 2) the plan takes the
    table's cluster size and fragment place (from L2 at 224-288) and the
    fewest waves: 32-row tiles where they fit (one wave of 30 4-block
    clusters, two of 15 8-block ones)."""
    assert lstm_cuda.REC_FWD_MID_F32_FROM_L2 == (224, 256, 288)
    groups = -(-H // (8 * cluster))
    want = ((groups * H * 128 if resident else 0) + 2 * rows * (H + 16) * 4
            + rows * (8 * groups + 4) * 4 + stages * (rows * (32 * groups + 4) * 4 + 48))
    assert lstm_cuda.recurrence_mid_f32_smem(H, rows, cluster, resident, "fwd") == want
    assert lstm_cuda.recurrence_mid_f32_fwd_stages(rows, cluster, groups, resident) == stages
    assert want <= lstm_cuda.SMEM_LIMIT
    plan = lstm_cuda.recurrence_mid_f32_plan(
        400, 5, H, lambda c, r, R, smem: {4: 30, 8: 15}[c], kind="fwd")
    cl = lstm_cuda.REC_FWD_MID_F32_CLUSTER.get(H, 8)
    res = H not in lstm_cuda.REC_FWD_MID_F32_FROM_L2
    fits32 = lstm_cuda.recurrence_mid_f32_fwd_stages(32, cl, -(-H // (8 * cl)), res) > 0
    assert plan == (cl, res, 32 if fits32 else 16, lstm_cuda.mma_tiles(400, 5, 32 if fits32
                                                                        else 16),
                    lstm_cuda.recurrence_mid_f32_smem(H, 32 if fits32 else 16, cl, res, "fwd"))
    for bad in ((192, 32, 4, True), (256, 32, 8, True), (224, 32, 8, True), (288, 16, 8, True),
                (224, 16, 4, True), (H, 48, cluster, resident), (H, rows, 2, True),
                (H, rows, 4, False)):
        with pytest.raises(ValueError, match="lstm_recurrence_fwd_mid_f32: no instance"):
            lstm_cuda.recurrence_mid_f32_smem(*bad, "fwd")
    with pytest.raises(ValueError, match="as does lstm_recurrence_fwd_mid_f32"):
        lstm_cuda.recurrence_mid_f32_smem(64, 16, 8, True, "fwd")


@pytest.mark.parametrize("H", [32, 64, 96, 160, 288])
def test_recurrence_fwd_f32_wrappers_take_plain_version_on_cpu(H):
    """On the CPU the op's f32 forwards (at 32 / 64 and at 96-288) and the
    dispatch, by each name and with the f32 fragment copy handed in or not,
    run the plain twin bit for bit and launch nothing; under grad mode an
    operand that requires grad is refused."""
    T, D, B, G, cd = 5, 2, 6, 2, torch.float32
    xg, valid, w, _, _, _ = recurrence_case(T, D, B, H, G, cd, torch.device("cpu"), "holes",
                                            seed=H)
    want = recurrence_fwd(xg, valid, w, G, cd)
    name = "lstm_recurrence_fwd_f32" if H <= 64 else "lstm_recurrence_fwd_mid_f32"
    assert lstm_cuda.recurrence_fwd_kernel(H, cd) == name
    wrapper = getattr(lstm_cuda, name)
    wrappers = (wrapper, lstm_cuda.lstm_recurrence_fwd)
    before = [f.launches for f in wrappers]
    wf = lstm_cuda.recurrence_fragments(w, cd)
    assert (wf is None) == (H <= 64)
    calls = [wrapper(xg, valid, w, G, cd)] + [
        lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd, kernel=k, wf=wf)
        for k in (None, name)]
    if wf is not None:
        calls.append(wrapper(xg, valid, w, G, cd, wf=wf))
    for got in calls:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [f.launches for f in wrappers] == before
    with pytest.raises(RuntimeError, match="no autograd graph"):
        wrapper(xg.clone().requires_grad_(), valid, w, G, cd)
    with torch.no_grad():
        wrapper(xg, valid, w.clone().requires_grad_(), G, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["lengths", "holes"])
@pytest.mark.parametrize("T", [24, 3, 1])
@pytest.mark.parametrize("H,G,B,D", [(64, 5, 60, 2), (64, 1, 50, 2), (64, 2, 20, 1),
                                     (64, 1, 9, 3), (32, 3, 24, 2), (32, 1, 13, 1),
                                     (32, 5, 35, 3), (64, 5, 400, 2)])
def test_recurrence_fwd_f32_matches_plain_on_card(cuda_device, H, G, B, D, T, mask):
    """The op's f32 forward at H = 32 / 64 (three tf32 passes) against its
    plain twin at 1e-4 x max(1, max|ref|): masks from lengths and with
    holes, D = 1, 2 and 3, G = 1, 2, 3 and 5 (groups of 12, 50, 10, 9, 8, 13,
    7 and 80 rows: a short last tile inside most groups), T = 1, 3 and 24;
    the same bits twice. The dispatch hands ``lstm_recurrence_fwd`` to it
    and its wrapper counts the launches; the dispatcher counts none."""
    cd = torch.float32
    xg, valid, w, _, _, _ = recurrence_case(T, D, B, H, G, cd, cuda_device, mask, seed=T + B + H)
    want = recurrence_fwd(xg, valid, w, G, cd)
    assert lstm_cuda.recurrence_fwd_kernel(H, cd) == "lstm_recurrence_fwd_f32"
    wrappers = (lstm_cuda.lstm_recurrence_fwd_f32, lstm_cuda.lstm_recurrence_fwd)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd)
    _close(got, want, 1e-4)
    again = lstm_cuda.lstm_recurrence_fwd_f32(xg, valid, w, G, cd)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("G,mask", [(5, "lengths"), (5, "holes"), (1, "lengths")])
def test_recurrence_fwd_f32_at_the_main_path_shape_on_card(cuda_device, G, mask):
    """The f32 recurrence-backend step's forward at its run shape (400 rows,
    D = 2, T = 1500, H = 64; 5 weight groups in layer 0, 1 in layer 1)
    against the plain twin at 1e-4 x max(1, max|ref|)."""
    cd = torch.float32
    xg, valid, w, _, _, _ = recurrence_case(1500, 2, 400, 64, G, cd, cuda_device, mask, seed=G)
    _close(lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd),
           recurrence_fwd(xg, valid, w, G, cd), 1e-4)


@pytest.mark.cuda
def test_recurrence_fwd_f32_refuses_on_card(cuda_device):
    """The f32 forward at 32 / 64 refuses bf16 and the widths it does not
    take, before any launch; a batch of no row launches nothing; the
    dispatcher refuses an unknown kernel name (nothing falls back)."""
    cd = torch.float32
    xg, valid, w, _, _, _ = recurrence_case(4, 2, 8, 64, 1, cd, cuda_device, "holes")
    wrapper = lstm_cuda.lstm_recurrence_fwd_f32
    before = wrapper.launches
    with pytest.raises(ValueError, match="lstm_recurrence_fwd_f32 kernel takes compute dtype"):
        wrapper(xg, valid, w.to(torch.bfloat16), 1, torch.bfloat16)
    wide = recurrence_case(4, 2, 8, 128, 1, cd, cuda_device, "holes")
    with pytest.raises(ValueError, match="lstm_recurrence_fwd_f32 kernel takes compute dtype"):
        wrapper(wide[0], wide[1], wide[2], 1, cd)
    cut = lambda t: t[:, :, :0].contiguous()  # noqa: E731
    assert wrapper(cut(xg), cut(valid), w, 1, cd)[0].shape == (4, 2, 0, 64)
    with pytest.raises(ValueError, match="no forward kernel named"):
        lstm_cuda.lstm_recurrence_fwd(xg, valid, w, 1, cd, kernel="fast")
    torch.cuda.synchronize()
    assert wrapper.launches == before


def _fwd_mid_f32_instances():
    """(H, blocks a cluster, resident, row tile) of every instance of the
    op's f32 forward at 96-288."""
    return [(H, c, r, rows) for (c, r), widths in lstm_cuda.REC_FWD_MID_F32_INSTANCES.items()
            for H in widths for rows in lstm_cuda.REC_FWD_MID_F32_ROWS
            if lstm_cuda.recurrence_mid_f32_fwd_stages(rows, c, -(-H // (8 * c)), r)]


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,T,mask", [(1, 30, 300, "lengths"), (5, 40, 300, "holes"),
                                        (5, 65, 1, "lengths"), (3, 27, 7, "off")])
@pytest.mark.parametrize("H,cluster,resident,rows", _fwd_mid_f32_instances())
def test_recurrence_fwd_mid_f32_matches_plain_on_card(cuda_device, monkeypatch, H, cluster,
                                                      resident, rows, G, B, T, mask):
    """Every instance of the op's f32 forward at 96-288 (blocks a cluster,
    fragments resident or read from L2, row tile; pinned with monkeypatch on
    the plan's tables) against its plain twin at 1e-4 x max(1, max|ref|):
    masks from lengths, with holes (an all-off and an all-on row) and all
    off; T = 1, 7 and 300; groups of 30, 8, 13 and 9 rows, which leave short
    row tiles; with the fragment copy handed in and built by the wrapper;
    the same bits twice. Its wrapper counts the launches; the cluster
    forward never launches."""
    monkeypatch.setattr(lstm_cuda, "REC_FWD_MID_F32_CLUSTER", {H: cluster})
    monkeypatch.setattr(lstm_cuda, "REC_FWD_MID_F32_FROM_L2", () if resident else (H,))
    monkeypatch.setattr(lstm_cuda, "REC_FWD_MID_F32_ROWS", (rows,))
    cd = torch.float32
    xg, valid, w, _, _, _ = recurrence_case(T, 2, B, H, G, cd, cuda_device,
                                            "holes" if mask == "off" else mask,
                                            seed=H + T + G)
    if mask == "off":
        valid = torch.zeros_like(valid)
    assert lstm_cuda.recurrence_fwd_kernel(H, cd) == "lstm_recurrence_fwd_mid_f32"
    wrappers = (lstm_cuda.lstm_recurrence_fwd_mid_f32, lstm_cuda.lstm_recurrence_fwd)
    before = [f.launches for f in wrappers]
    wf = lstm_cuda.recurrence_fragments(w, cd)
    got = lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd, wf=wf)
    again = lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close(got, recurrence_fwd(xg, valid, w, G, cd), 1e-4)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("H,mask", [(128, "lengths"), (128, "holes"), (256, "lengths"),
                                    (96, "holes")])
def test_recurrence_fwd_mid_f32_at_the_main_path_shape_on_card(cuda_device, H, mask):
    """The one-layer f32 model at embedding 128 on the recurrence backend at
    its run shape (400 rows in 5 groups, D = 2, T = 1500), the same rows at
    256 and at 96, on the dispatch's plan: against the plain twin at 1e-4 x
    max(1, max|ref|), the same bits twice; the dispatcher counts no launch
    of its own."""
    cd, G = torch.float32, 5
    xg, valid, w, _, _, _ = recurrence_case(1500, 2, 400, H, G, cd, cuda_device, mask, seed=H)
    want = recurrence_fwd(xg, valid, w, G, cd)
    got = lstm_cuda.lstm_recurrence_fwd(xg, valid, w, G, cd)
    assert all(torch.equal(a, b) for a, b in zip(got, lstm_cuda.lstm_recurrence_fwd(
        xg, valid, w, G, cd, wf=lstm_cuda.recurrence_f32_weights(w))))
    _close(got, want, 1e-4)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_recurrence_fwd.launches == 0


@pytest.mark.cuda
def test_recurrence_fwd_mid_f32_refuses_on_card(cuda_device, monkeypatch):
    """The op's f32 forward at 96-288 asked for by name refuses bf16, the
    widths it does not take, a wrong fragment copy and a plan with no
    instance, before any launch; a batch of no row launches nothing."""
    cd = torch.float32
    xg, valid, w, _, _, _ = recurrence_case(4, 2, 10, 128, 2, cd, cuda_device, "holes")
    wrapper = lstm_cuda.lstm_recurrence_fwd_mid_f32
    before = wrapper.launches
    with pytest.raises(ValueError, match="as does lstm_recurrence_fwd_mid_f32"):
        wrapper(xg, valid, w.to(torch.bfloat16), 2, torch.bfloat16)
    small = recurrence_case(4, 2, 10, 64, 2, cd, cuda_device, "holes")
    with pytest.raises(ValueError, match="as does lstm_recurrence_fwd_mid_f32"):
        wrapper(small[0], small[1], small[2], 2, cd)
    with pytest.raises(ValueError, match="wf must be a contiguous"):
        wrapper(xg, valid, w, 2, cd, wf=lstm_cuda.recurrence_mma_weights(w.to(torch.bfloat16)))
    cut = lambda t: t[:, :, :0].contiguous()  # noqa: E731
    assert wrapper(cut(xg), cut(valid), w, 2, cd)[0].shape == (4, 2, 0, 128)
    monkeypatch.setattr(lstm_cuda, "REC_FWD_MID_F32_CLUSTER", {128: 2})
    with pytest.raises(ValueError, match="no instance"):
        wrapper(xg, valid, w, 2, cd)
    torch.cuda.synchronize()
    assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("embedding", [64, 80])
def test_recurrence_backend_f32_steps_on_card(cuda_device, monkeypatch, embedding):
    """The f32 two-layer model on the recurrence backend at the manuscript
    width (E = H = 64) and at embedding 80 (run at 96): its forward is the
    f32 tensor-core forward of those widths (``lstm_recurrence_fwd_f32`` at
    64, ``lstm_recurrence_fwd_mid_f32`` at 96; the dispatcher counts none);
    its gradients equal the CPU plain path's (1e-4 x max(1, max|grad|))."""
    from intrepppid_tpu_torch.ops import lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(lstm, "DEFAULT_BACKEND", "recurrence")
    cd = torch.float32
    Hp = lstm_cuda.recurrence_width(embedding, cd)
    new = lstm_cuda.recurrence_fwd_kernel(Hp, cd)
    assert new == ("lstm_recurrence_fwd_f32" if embedding == 64 else "lstm_recurrence_fwd_mid_f32")
    wrappers = (getattr(lstm_cuda, new), lstm_cuda.lstm_recurrence_fwd)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=cd, embedding_size=embedding)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 0]
    want = model_grads(torch.device("cpu"), dtype=cd, embedding_size=embedding)
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= 1e-4 * max(
            1.0, float(ref.abs().max())), name


# ---- the bf16 resident forward at its k8-tail shapes and the f32 wgrad's 64-row tile
# the bf16 resident shapes (H, E) the tensor-core forward took from
# bilstm_fwd.cu, whose K = E + H is 8 mod 16 at five of them (a k8 step)
K8_FWD_SHAPES = ((8, 8), (8, 16), (16, 8), (24, 24), (24, 48), (40, 40), (40, 80), (48, 80),
                 (48, 112), (56, 56), (56, 112))
# the f32 layers' (Hp, E_parts) that took the wgrad's 64-row tile from
# bilstm_wgrad.cu, with the tile's source columns (E + H rounded up to 32)
NARROW_WGRAD_SHAPES = (((8,), 16, 32), ((8, 8), 16, 32), ((16,), 16, 32), ((16, 16), 16, 64),
                       ((40,), 48, 96), ((40, 40), 48, 128), ((48,), 48, 96),
                       ((48, 48), 48, 160), ((72,), 80, 160), ((80,), 80, 160))


@pytest.mark.parametrize("H,E", K8_FWD_SHAPES)
def test_fwd_mma_takes_the_k8_shapes(H, E):
    """Each of the 11 shapes is a tensor-core forward instance where
    the deleted ``bilstm_fwd.cu`` took it before (its plan,
    ``_cuda_core_fwd_plan``, so no layer changed its route): one warp per 8 units (one warp a block at
    H = 8), the three-stage ring padded to an odd number of 16 bytes a row
    (16 elements where K % 16 == 8); the resident route takes the layer at
    its own widths, one input part and, where it halves into parts of 8,
    two."""
    bf16, K = torch.bfloat16, E + H
    for E_parts in ([E], [E // 2, E // 2]) if (E // 2) % 8 == 0 else ([E],):
        _cuda_core_fwd_plan(E_parts, H, bf16)
        assert lstm_cuda.fwd_kernel(E_parts, H, bf16) == "bilstm_fwd_mma"
        assert lstm_cuda.fwd_mma_plan(E_parts, H, bf16) == (
            4 * H, 3 * 8 * (K + (16 if K % 16 else 8)) * 2)
        if H % 16:  # no f32 forward at H % 16 == 8 since bilstm_fwd.cu went
            with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
                lstm_cuda.fwd_kernel(E_parts, H, torch.float32)
        else:
            assert lstm_cuda.fwd_kernel(E_parts, H, torch.float32) == "bilstm_fwd_f32"
    assert (K % 16 == 8) == ((H, E) in ((8, 16), (16, 8), (24, 48), (40, 80), (56, 112)))


def test_fwd_mma_k8_wrappers_take_plain_versions_on_cpu():
    """On the CPU the tensor-core forward's wrappers and the dispatch run the
    plain twin bit for bit at a k8-tail shape (H = 24, E = 24 + 24: K = 72)
    and at H = 56, counting no launch."""
    cd = torch.bfloat16
    wrappers = (lstm_cuda.bilstm_layer_fwd, lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_layer_fwd_mma, lstm_cuda.bilstm_layer_fwd_train_mma)
    before = [f.launches for f in wrappers]
    for E_parts, H, G in (([24, 24], 24, 1), ([56], 56, 3)):
        parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(5, 9, E_parts, H, G, cd,
                                                               torch.device("cpu"), seed=H)
        args = (parts, lengths, w_ih, w_hh, bias, cd)
        want = bidir_layer(*args, with_states=True)
        for got in (lstm_cuda.bilstm_layer_fwd_train_mma(*args),
                    lstm_cuda.bilstm_layer_fwd_train(*args)):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        for got in (lstm_cuda.bilstm_layer_fwd_mma(*args), lstm_cuda.bilstm_layer_fwd(*args)):
            assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want[:4]))
    assert [f.launches for f in wrappers] == before


@pytest.mark.parametrize("E_parts,H,N", NARROW_WGRAD_SHAPES)
def test_wgrad_f32_narrow_tile_plan(E_parts, H, N):
    """The f32 layers at H % 32 == 16 take the 3xTF32 wgrad with 64 gate
    rows (a divisor of 4H) by the whole E + H row rounded up to 32 columns,
    two blocks an SM: at the train shape (400 rows, T = 1500; layer 0 in 5
    groups, the stacked layer in 1) the split fills whole waves of 264
    blocks, and at layer 0 of the model at embedding 80 (E = H = 80) five
    gate tiles in 21 splits, 1,050 blocks in four waves. The stages fit two
    blocks in an SM's shared memory (three at 160 columns, four below)."""
    f32 = torch.float32
    lstm_cuda.wgrad_f32_check(list(E_parts), H, f32)
    assert lstm_cuda.wgrad_kernel(list(E_parts), H, f32) == "bilstm_wgrad_f32"
    tile = lstm_cuda.wgrad_f32_tile(E_parts, H)
    assert tile == (64, N) and lstm_cuda.wgrad_f32_blocks(tile) == 2
    assert (N - 32) < sum(E_parts) + H <= N and (4 * H) % 64 == 0
    assert lstm_cuda.wgrad_f32_stages(tile) == (3 if N == 160 else 4)
    assert 2 * (lstm_cuda.wgrad_f32_smem(tile) + lstm_cuda.BLOCK_SMEM_RESERVE) <= \
        lstm_cuda.SM_SMEM
    G = 5 if len(E_parts) == 1 else 1
    m_tiles, n_tiles, splits = lstm_cuda.wgrad_f32_plan(1500, 400, G, E_parts, H, 132)
    assert (m_tiles, n_tiles) == (4 * H // 64, 1)
    blocks = m_tiles * n_tiles * 2 * G * splits
    assert blocks <= lstm_cuda.WGRAD_F32_MAX_WAVES * 2 * 132
    if (tuple(E_parts), H) in (((80,), 80), ((72,), 80)):
        assert (splits, blocks, -(-blocks // 264)) == (21, 1050, 4)
    else:
        assert blocks % 264 == 0
    # the bf16 layers keep their own kernel; a width past 160 columns takes
    # several column tiles of 160, the last masked
    assert lstm_cuda.wgrad_kernel(list(E_parts), H, torch.bfloat16) == "bilstm_wgrad_mma"
    assert lstm_cuda.wgrad_f32_tile([208], 48) == (64, 160)
    assert lstm_cuda.wgrad_f32_plan(30, 20, 1, [208], 48, 132)[:2] == (3, 2)


def test_wgrad_f32_tiles_and_their_plans():
    """H % 32 == 0 keeps the 128 x 128 tile (one block an SM), its plans as
    before; the tiles timed against the 64-row one at E = H = 80 (128 x
    160, its last gate tile masked; 64 x 64, its last column tile masked)
    are built and planned with their own blocks an SM; a tile that is not
    built is refused, and H % 16 != 0 in f32 still is."""
    f32 = torch.float32
    for E_parts, H in (([64], 64), ([256, 256], 256), ([32, 32], 32), ([128], 128)):
        assert lstm_cuda.wgrad_f32_tile(E_parts, H) == (128, 128)
        assert lstm_cuda.wgrad_f32_plan(1500, 400, 5, E_parts, H, 132)[:2] == \
            lstm_cuda.wgrad_mma_plan(1500, 400, 5, E_parts, H)[:2]
    assert lstm_cuda.wgrad_f32_blocks((128, 128)) == 1
    assert lstm_cuda.wgrad_f32_smem((128, 128)) == lstm_cuda.WGRAD_F32_SMEM
    assert set(lstm_cuda.WGRAD_F32_TILES) == {(128, 128), (128, 160), (64, 32), (64, 64),
                                              (64, 96), (64, 128), (64, 160)}
    assert lstm_cuda.wgrad_f32_plan(1500, 400, 5, [80], 80, 132, (128, 160))[:2] == (3, 1)
    assert lstm_cuda.wgrad_f32_plan(1500, 400, 5, [80], 80, 132, (64, 64))[:2] == (5, 3)
    for tile in lstm_cuda.WGRAD_F32_TILES:
        assert lstm_cuda.wgrad_f32_smem(tile) <= lstm_cuda.SMEM_LIMIT
    with pytest.raises(ValueError, match="H % 16 == 0"):
        lstm_cuda.wgrad_f32_check([24], 24, f32)
    cpu = torch.device("cpu")
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(4, 6, [8], 16, 2, f32, cpu)
    hs_f, hs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, f32)[:2]
    dgc = torch.zeros(2, 4, 6, 64)
    with pytest.raises(ValueError, match="built for the tiles"):
        lstm_cuda.bilstm_wgrad_f32(dgc, parts, hs_f, hs_b, 2, tile=(64, 48))


@pytest.mark.parametrize("tile", [None, (64, 32), (128, 160)])
def test_wgrad_f32_narrow_tile_wrappers_take_plain_versions_on_cpu(tile):
    """On the CPU the f32 wgrad's wrapper (at its own tile or one pinned)
    and the dispatch run the plain twin bit for bit at H = 16, E = 8 + 8,
    counting no launch."""
    f32, cpu = torch.float32, torch.device("cpu")
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(5, 6, [8, 8], 16, 2, f32, cpu)
    hs_f, hs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, f32)[:2]
    dgc = torch.rand(2, 5, 6, 64, generator=torch.Generator().manual_seed(3)) * 2 - 1
    ref = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, 2)
    wrappers = (lstm_cuda.bilstm_wgrad, lstm_cuda.bilstm_wgrad_f32)
    before = [f.launches for f in wrappers]
    for got in (lstm_cuda.bilstm_wgrad_f32(dgc, parts, hs_f, hs_b, 2, tile=tile),
                lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, 2)):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert [f.launches for f in wrappers] == before


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 5, 1])
@pytest.mark.parametrize("H,E", K8_FWD_SHAPES)
def test_fwd_mma_k8_shapes_match_plain_on_card(cuda_device, T, H, E):
    """Each new instance of the tensor-core forward against its plain twin
    in bf16 at 3e-2 x max(1, max|ref|), both variants: one input part (two
    where E > H, as the stacked layers have), lengths mixing 0, 1, T and random
    values, 27 rows in 3 groups of 9 (a short last tile in each group), and
    rows 8-15 short of T; T = 30, 5 and 1. The dispatch hands the forward
    to it (its wrappers count the launches) and the two variants give the
    same hs bits."""
    cd, B, G = torch.bfloat16, 27, 3
    E_parts = [E // 2] * 2 if E > H else [E]  # the stacked layers' two parts
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device,
                                                           seed=T + H + E)
    lengths[8:16] = torch.clamp(lengths[8:16], max=max(1, T // 3))
    args = (parts, lengths, w_ih, w_hh, bias, cd)
    want = bidir_layer(*args, with_states=True)
    wrappers = (lstm_cuda.bilstm_layer_fwd, lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_layer_fwd_mma, lstm_cuda.bilstm_layer_fwd_train_mma)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.bilstm_layer_fwd_train(*args)
    ev = lstm_cuda.bilstm_layer_fwd(*args)
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [0, 0, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("E_parts,H", [([56], 56), ([56, 56], 56)])
def test_fwd_mma_at_56_at_the_main_path_shape_on_card(cuda_device, E_parts, H):
    """Both layers of the bf16 model at embedding 56 at their run shape
    (400 rows, T = 1500; layer 0 in 5 groups with the main path's lengths,
    the stacked layer in 1): both variants against the plain twin at 3e-2 x
    max(1, max|ref|), the same bits twice."""
    cd, T, B = torch.bfloat16, 1500, 400
    G = 5 if len(E_parts) == 1 else 1
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device,
                                                           seed=len(E_parts))
    lengths = _main_path_lengths(lengths, G, T)
    args = (parts, lengths, w_ih, w_hh, bias, cd)
    want = bidir_layer(*args, with_states=True)
    got = lstm_cuda.bilstm_layer_fwd_train(*args)
    _close(got, want, 3e-2)
    _close(lstm_cuda.bilstm_layer_fwd(*args), want[:4], 3e-2)
    assert all(torch.equal(a, b) for a, b in zip(lstm_cuda.bilstm_layer_fwd_train_mma(*args),
                                                 got))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(30, 27), (1, 27), (3, 400)])
@pytest.mark.parametrize("E_parts,H,N", NARROW_WGRAD_SHAPES)
def test_wgrad_f32_narrow_tile_matches_plain_on_card(cuda_device, T, B, E_parts, H, N):
    """The f32 wgrad's 64-row tile against its plain twin at 1e-4 x max(1,
    max|ref|) at each of the 10 f32 shapes it took: 27 rows in 3 groups
    (layer 0's grouping; 1 for the stacked layer), T = 1 (every h_prev past
    an end), and T = 3 at 400 rows (more splits than positions). The
    dispatch hands ``bilstm_wgrad`` to it (its wrapper counts the launches,
    the dispatcher's stays)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = torch.float32
    G = 3 if len(E_parts) == 1 else 1
    if B == 400:
        G = 5 if G == 3 else 1
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, list(E_parts), H, G, cd,
                                                           cuda_device, seed=T + B + H)
    hs_f, hs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd)[:2]
    g = torch.Generator(device=cuda_device).manual_seed(H)
    dgc = torch.rand(2, T, B, 4 * H, generator=g, device=cuda_device) * 2 - 1
    want = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
    before = (lstm_cuda.bilstm_wgrad.launches, lstm_cuda.bilstm_wgrad_f32.launches)
    _close(lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, G), want, 1e-4)
    torch.cuda.synchronize()
    assert (lstm_cuda.bilstm_wgrad.launches, lstm_cuda.bilstm_wgrad_f32.launches) == (
        before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(64, 160), (128, 160), (64, 64), (64, 32), (128, 128)])
def test_wgrad_f32_tiles_at_80_match_plain_on_card(cuda_device, tile):
    """Layer 0 of the f32 model at embedding 80 (E = H = 80, 4H = 320) at
    each tile it can be pinned to: 64 x 160 (the dispatch's), 128 x 160 and
    128 x 128 with the last gate tile masked, 64 x 64 and 64 x 32 with the
    last column tile masked; 40 rows in 5 groups, T = 24, at 1e-4 x max(1,
    max|ref|). The card holds two blocks of a 64-row tile on an SM and one
    of a 128-row one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd, T, B, G = torch.float32, 24, 40, 5
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, [80], 80, G, cd, cuda_device,
                                                           seed=7)
    hs_f, hs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd)[:2]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    dgc = torch.rand(2, T, B, 320, generator=g, device=cuda_device) * 2 - 1
    want = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
    _close(lstm_cuda.bilstm_wgrad_f32(dgc, parts, hs_f, hs_b, G, tile=tile), want, 1e-4)
    lib = lstm_cuda._kernels("bilstm_wgrad_f32")
    assert lib.bilstm_wgrad_f32_occupancy(*tile) == lstm_cuda.wgrad_f32_blocks(tile)


@pytest.mark.cuda
def test_bf16_model_at_embedding_56_on_card(cuda_device):
    """The bf16 two-layer model at embedding 56: both layers' forwards (the
    train variant in the step) on the tensor-core forward's <56, 56> and
    <56, 112> instances, never ``bilstm_fwd.cu``; its gradients equal the
    CPU plain path's at 2^-7 x max(1, max|grad|)."""
    cd = torch.bfloat16
    wrappers = (lstm_cuda.bilstm_layer_fwd_train_mma, lstm_cuda.bilstm_layer_fwd_train,
                lstm_cuda.bilstm_layer_fwd)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=cd, embedding_size=56)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 0, 0]
    want = model_grads(torch.device("cpu"), dtype=cd, embedding_size=56)
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= 2 ** -7 * max(
            1.0, float(ref.abs().max())), name


@pytest.mark.cuda
def test_f32_model_at_embedding_80_wgrad_on_card(cuda_device):
    """The f32 two-layer model at embedding 80: layer 0's weight gradients
    (E = H = 80) on the 3xTF32 wgrad's 64-row tile and the stacked layer's
    (run wide at 96) on its 128-row one, so the f32 wgrad launches twice and
    ``bilstm_wgrad.cu`` never; its gradients equal the CPU plain path's at
    1e-4 x max(1, max|grad|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = torch.float32
    assert lstm_cuda.wgrad_f32_tile([80], 80) == (64, 160)
    assert lstm_cuda.wgrad_f32_tile([80, 80], 96) == (128, 128)
    wrappers = (lstm_cuda.bilstm_wgrad_f32, lstm_cuda.bilstm_wgrad)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=cd, embedding_size=80)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 0]
    want = model_grads(torch.device("cpu"), dtype=cd, embedding_size=80)
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= 1e-4 * max(
            1.0, float(ref.abs().max())), name


# ---- the bf16 sweep at H = 16-64 whatever (E + H) % 32, the op's f32 wgrad
# the shapes the bf16 tensor-core sweep took from bilstm_bwd.cu (the first
# two: the grid's layers at (16, (8,)) and the bf16 model at embedding 16's
# stacked layer) and two more it takes at K % 32 == 16
ANY_K_SWEEP_SHAPES = (([8], 16), ([16, 16], 16), ([8, 8], 32), ([24], 48))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 5, 1])
@pytest.mark.parametrize("E_parts,H,G,B,ny,final", [
    ([8], 16, 5, 30, 2, True), ([8], 16, 3, 27, 0, False), ([16, 16], 16, 1, 13, 2, True),
    ([16, 16], 16, 3, 27, 1, False), ([16, 16], 16, 1, 27, 0, True),
    ([8, 8], 32, 3, 27, 2, False), ([8, 8], 32, 1, 9, 1, True), ([24], 48, 3, 27, 2, True),
    ([24], 48, 5, 45, 0, False)])
def test_sweep_mma_at_any_k_matches_plain_on_card(cuda_device, T, E_parts, H, G, B, ny, final):
    """The bf16 tensor-core sweep at H % 16 == 0 with (E + H) % 32 == 16
    (K = 24, 48, 48, 72, run to the next multiple of 32 over zero columns)
    against its plain twin at 2^-7 x max(1, max|ref|): its <16, 32>
    instance and the run-time <0, 0> build (``generic=True``), 1 and 2 input
    parts, 0-2 dy streams, with and without final-state cotangents, 27 rows
    in 3 groups of 9 (a short last tile in each), lengths mixing 0, 1, T and
    random values, rows 8-15 short of T; T = 30, 5 and 1. The dispatch
    hands ``bilstm_bwd`` to it (its wrapper counts the launches, the CUDA
    cores' never)."""
    cd = torch.bfloat16
    assert lstm_cuda.sweep_kernel(E_parts, H, cd) == "bilstm_bwd_mma"
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, cd,
                                                                 cuda_device, seed=T + B + H)
    lengths[8:16] = torch.clamp(lengths[8:16], max=max(1, T // 3))
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                               with_states=True)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny],
            dhn if final else None, dcn if final else None, cd)
    want = bidir_layer_sweep(*args)
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    before = (lstm_cuda.bilstm_bwd.launches, lstm_cuda.bilstm_bwd_mma.launches)
    _close(flat(lstm_cuda.bilstm_bwd(*args)), flat(want), 2.0 ** -7)
    _close(flat(lstm_cuda.bilstm_bwd_mma(*args, generic=True)), flat(want), 2.0 ** -7)
    torch.cuda.synchronize()
    assert (lstm_cuda.bilstm_bwd.launches, lstm_cuda.bilstm_bwd_mma.launches) == (
        before[0], before[1] + 2)


@pytest.mark.cuda
def test_sweep_mma_at_16_at_the_main_path_shape_on_card(cuda_device):
    """The stacked layer of the bf16 model at embedding 16 at its run
    shape: E = 16 + 16, H = 16, 400 rows in one group, T = 1500, two dy
    streams a direction, the main path's lengths: the <16, 32> instance and
    the run-time build against the plain twin at 2^-7 x max(1, max|ref|),
    each the same bits twice."""
    cd, T, B, G = torch.bfloat16, 1500, 400, 1
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [16, 16], 16, G, cd,
                                                                 cuda_device, seed=16)
    lengths = _main_path_lengths(lengths, 5, T)
    hs_f, hs_b, _, _, cs_f, cs_b = lstm_cuda.bilstm_layer_fwd_train(parts, lengths, w_ih, w_hh,
                                                                    bias, cd)
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn,
            cd)
    flat = lambda r: r[0] + r[1] + r[2:]  # noqa: E731
    want = flat(bidir_layer_sweep(*args))
    for generic in (False, True):
        got = flat(lstm_cuda.bilstm_bwd_mma(*args, generic=generic))
        again = flat(lstm_cuda.bilstm_bwd_mma(*args, generic=generic))
        assert all(torch.equal(a, b) for a, b in zip(again, got))
        _close(got, want, 2.0 ** -7)


@pytest.mark.cuda
def test_bf16_model_at_embedding_16_on_card(cuda_device):
    """The bf16 two-layer model at embedding 16: both layers' sweeps on the
    tensor-core sweep (layer 0 at E = H = 16, the stacked layer at
    16 + 16: K = 48), never ``bilstm_bwd.cu``; its gradients equal the CPU
    plain path's at 2^-7 x max(1, max|grad|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = torch.bfloat16
    wrappers = (lstm_cuda.bilstm_bwd_mma, lstm_cuda.bilstm_bwd)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=cd, embedding_size=16)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 0]
    want = model_grads(torch.device("cpu"), dtype=cd, embedding_size=16)
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= 2.0 ** -7 * max(
            1.0, float(ref.abs().max())), name


@pytest.mark.cuda
@pytest.mark.parametrize("T", [300, 2, 1])
@pytest.mark.parametrize("G,B", [(1, 27), (5, 45)])
@pytest.mark.parametrize("H", [32, 64, 96, 128, 288, 512])
def test_recurrence_wgrad_f32_matches_plain_on_card(cuda_device, H, G, B, T):
    """The f32 tensor-core recurrence wgrad (three tf32 passes) against its
    plain twin at 1e-4 x max(1, max|ref|), at its dispatch tile and the
    other one: H = 32 and 96 (a half-zero last column tile), 64, 128, 288
    and 512, D = 2, one group of 27 rows and 5 of 9 (neither a whole 32-row
    K-tile), T = 300, 2 (one row per batch row) and 1 (no row: zeros, no
    launch). The dispatch hands ``lstm_recurrence_wgrad`` to it; the
    CUDA-core kernel's count stays."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd, D = torch.float32, 2
    assert lstm_cuda.recurrence_wgrad_kernel(H, cd) == "lstm_recurrence_wgrad_f32"
    g = torch.Generator(device=cuda_device).manual_seed(T + H + B)
    hs = torch.rand(T, D, B, H, generator=g, device=cuda_device) * 2 - 1
    dxg = torch.rand(T, D, B, 4 * H, generator=g, device=cuda_device) * 2 - 1
    want = recurrence_wgrad(hs, dxg, G, cd)
    before = (lstm_cuda.lstm_recurrence_wgrad.launches,
              lstm_cuda.lstm_recurrence_wgrad_f32.launches)
    _close([lstm_cuda.lstm_recurrence_wgrad(hs, dxg, G, cd)], [want], 1e-4)
    for tile_n in lstm_cuda.REC_WGRAD_F32_BLOCKS:
        _close([lstm_cuda.lstm_recurrence_wgrad_f32(hs, dxg, G, cd, tile_n=tile_n)], [want], 1e-4)
    torch.cuda.synchronize()
    launched = 3 if T > 1 else 0
    assert (lstm_cuda.lstm_recurrence_wgrad.launches,
            lstm_cuda.lstm_recurrence_wgrad_f32.launches) == (before[0], before[1] + launched)


@pytest.mark.cuda
def test_recurrence_wgrad_f32_edges_on_card(cuda_device):
    """More splits than positions would allow (T = 3 at 400 rows in one
    group: the split stops at the K-tiles), an empty batch (zeros, no
    launch); bf16 and an unbuilt tile raise; the CUDA-core kernel asked for
    by name agrees and counts on its own wrapper."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = torch.float32
    T, D, B, H, G = 3, 1, 400, 64, 1
    g = torch.Generator(device=cuda_device).manual_seed(0)
    hs = torch.rand(T, D, B, H, generator=g, device=cuda_device) * 2 - 1
    dxg = torch.rand(T, D, B, 4 * H, generator=g, device=cuda_device) * 2 - 1
    want = recurrence_wgrad(hs, dxg, G, cd)
    splits = lstm_cuda.recurrence_wgrad_f32_plan(T, B, D, G, H, lstm_cuda._sm_count(cuda_device))[2]
    assert 1 <= splits <= -(-(T - 1) * B // 32)
    _close([lstm_cuda.lstm_recurrence_wgrad_f32(hs, dxg, G, cd)], [want], 1e-4)
    before = (lstm_cuda.lstm_recurrence_wgrad.launches,
              lstm_cuda.lstm_recurrence_wgrad_f32.launches)
    dw = lstm_cuda.lstm_recurrence_wgrad_f32(hs[:, :, :0].contiguous(),
                                             dxg[:, :, :0].contiguous(), 1, cd)
    torch.cuda.synchronize()
    assert dw.shape == (D, 1, H, 4 * H) and not dw.any()
    _close([lstm_cuda.lstm_recurrence_wgrad(hs, dxg, G, cd, kernel="lstm_recurrence_wgrad")],
           [want], 1e-4)
    torch.cuda.synchronize()
    assert (lstm_cuda.lstm_recurrence_wgrad.launches,
            lstm_cuda.lstm_recurrence_wgrad_f32.launches) == (before[0] + 1, before[1])
    with pytest.raises(ValueError, match="lstm_recurrence_wgrad_f32 kernel takes compute dtype"):
        lstm_cuda.lstm_recurrence_wgrad_f32(hs, dxg, G, torch.bfloat16)
    with pytest.raises(ValueError, match="built for 64 x"):
        lstm_cuda.lstm_recurrence_wgrad_f32(hs, dxg, G, cd, tile_n=96)


@pytest.mark.cuda
@pytest.mark.parametrize("embedding", [64, 128])
def test_recurrence_backend_f32_wgrad_on_card(cuda_device, monkeypatch, embedding):
    """The f32 two-layer model on the recurrence backend at embedding 64
    and 128: both layers' weight gradients on the f32 tensor-core wgrad,
    never the CUDA-core one; its gradients equal the CPU plain path's
    (1e-4 x max(1, max|grad|))."""
    from intrepppid_tpu_torch.ops import lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(lstm, "DEFAULT_BACKEND", "recurrence")
    cd = torch.float32
    wrappers = (lstm_cuda.lstm_recurrence_wgrad_f32, lstm_cuda.lstm_recurrence_wgrad,
                lstm_cuda.bilstm_wgrad_f32)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=cd, embedding_size=embedding)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 0, 0]
    want = model_grads(torch.device("cpu"), dtype=cd, embedding_size=embedding)
    for name, grad in got.items():
        ref = want[name].float()
        assert float((grad.float().cpu() - ref).abs().max()) <= 1e-4 * max(
            1.0, float(ref.abs().max())), name


# ------------------------------------------------------- the training loop
class TinyModule:
    """``fit``'s three iterators over seeded quintuplet batches (vocab 38,
    T = 32): 3 batches of 4 pairs and a tail of 2 an epoch, 2 val, 2 test."""

    def __init__(self, seed=0):
        import numpy as np

        rng = np.random.default_rng(seed)

        def batch(B):
            out = {}
            for k in ("p1", "p2", "anchor", "positive", "negative"):
                a = rng.integers(1, 38, (B, 32)).astype(np.int32)
                for i, n in enumerate(rng.integers(1, 33, B)):
                    a[i, n:] = 0
                out[k] = a
            out["label"] = (np.arange(B) % 2).astype(np.int32)
            return out

        self.train = [batch(4) for _ in range(3)] + [batch(2)]
        self.val, self.test = [batch(4) for _ in range(2)], [batch(4) for _ in range(2)]

    def train_batches(self, epoch):
        return iter(self.train)

    def val_batches(self):
        return iter(self.val)

    def test_batches(self):
        return iter(self.test)


@pytest.mark.cuda
def test_fit_and_resume_on_card(cuda_device, tmp_path):
    """A 3-epoch ``fit`` of a tiny bf16 model (embedding 16, SWA on, every
    checkpoint kept) on the card's tensor-core kernels, then a fresh
    trainer's ``fit`` from the epoch-0 checkpoint in a copy of the
    directory: its final weights and SWA average within 2^-7 x max(1,
    max|w|) of the straight run's, and ``test("best")`` finite."""
    import shutil

    from intrepppid_tpu_torch.train import Trainer

    def trainer(path):
        net = intrepppid_network(4, vocab_size=38, embedding_size=16, num_epochs=3,
                                 compute_dtype=torch.bfloat16, device=cuda_device, seed=0)
        return Trainer(net, path, "m", seed=0, keep_all_checkpoints=True)

    dm = TinyModule()
    wrappers = (lstm_cuda.bilstm_layer_fwd_train_mma, lstm_cuda.bilstm_bwd_mma,
                lstm_cuda.bilstm_wgrad_mma, lstm_cuda.bilstm_layer_fwd_mma)
    before = [f.launches for f in wrappers]
    straight = trainer(tmp_path / "a")
    straight.fit(dm)
    test = straight.test(dm, "best")
    torch.cuda.synchronize()
    assert all(f.launches > b for f, b in zip(wrappers, before))
    assert all(torch.isfinite(torch.tensor(v)) for v in test.values())
    epoch0 = next((tmp_path / "a").glob("m-epoch=00-*")).name
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    resumed = trainer(tmp_path / "b")
    resumed.fit(dm, checkpoint_path=tmp_path / "b" / epoch0)
    assert resumed.global_step == straight.global_step == 12
    assert resumed.swa.n_averaged == straight.swa.n_averaged == 2
    got = dict(resumed.net.named_parameters())
    for name, p in straight.net.named_parameters():
        for a, b in ((got[name], p), (resumed.swa.avg_params[name], straight.swa.avg_params[name])):
            err = float((a.detach().float() - b.detach().float()).abs().max())
            assert err <= 2.0 ** -7 * max(1.0, float(b.detach().abs().max())), name
