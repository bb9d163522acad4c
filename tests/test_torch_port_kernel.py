"""The port's LSTM kernel wrappers (``intrepppid_tpu_torch/ops/lstm_cuda.py``:
the eval and train forward, the backward sweep, the weight gradients, the
wide route's input gates, cluster forward and lite sweep, the time-major
recurrence op's forward, sweep and weight gradient, the bf16
tensor-core forwards (the wide one too), sweeps and weight gradients, and
the f32 tensor-core forward, sweeps and weight gradients in three tf32
passes, with the dispatch that picks them), their plain
PyTorch versions (``ops/lstm.py``, ``ops/lstm_recurrence.py``) and the
autograd units (``ops/lstm_stack.py``, ``FusedLSTMRecurrence``), without JAX.

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
    before = lstm_cuda.bilstm_layer_fwd.launches
    got = lstm_cuda.bilstm_layer_fwd(*args, torch.float32)
    want = bidir_layer(*args, torch.float32)
    assert lstm_cuda.bilstm_layer_fwd.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "E_parts,H,dtype,ok",
    [
        ([64], 64, torch.float32, True),
        ([64, 64], 64, torch.float32, True),   # 192 KB of f32 weights fits
        ([64, 64], 64, torch.bfloat16, True),
        ([32, 32], 32, torch.float32, True),
        ([128, 128], 128, torch.float32, False),  # weights past shared memory
        ([60], 64, torch.bfloat16, False),        # not a 16-byte multiple
        ([64], 66, torch.float32, False),
    ],
)
def test_launch_plan(E_parts, H, dtype, ok):
    if not ok:
        with pytest.raises(ValueError, match="bilstm kernel"):
            lstm_cuda.launch_plan(E_parts, H, dtype)
        return
    threads, rows, smem = lstm_cuda.launch_plan(E_parts, H, dtype)
    assert threads % H == 0 and threads <= 256 and rows == threads // H * 4
    assert smem <= lstm_cuda.SMEM_LIMIT


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


def test_forward_rows_per_thread_fills_one_wave():
    # 400 train rows at H = 64: 16-row tiles give 50 blocks, 8-row 100
    assert lstm_cuda.fwd_rows_per_thread(400, 64, 132) == 2
    # 800 serve rows would need 200 blocks of 8 rows: two waves, so 16
    assert lstm_cuda.fwd_rows_per_thread(800, 64, 132) == 4
    assert lstm_cuda.launch_plan([64], 64, torch.float32, 2)[1] == 8


def test_wgrad_check():
    lstm_cuda.wgrad_check([64, 64], 64)
    lstm_cuda.wgrad_check([32], 32)
    with pytest.raises(ValueError, match="bilstm_wgrad kernel"):
        lstm_cuda.wgrad_check([64], 24)  # 4H not a multiple of 64


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


def test_train_wrappers_take_plain_versions_on_cpu():
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(
        6, 4, [8, 8], 8, 2, torch.float32, torch.device("cpu"))
    counts = [f.launches for f in (lstm_cuda.bilstm_layer_fwd_train, lstm_cuda.bilstm_bwd,
                                   lstm_cuda.bilstm_wgrad)]
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
    assert [f.launches for f in (lstm_cuda.bilstm_layer_fwd_train, lstm_cuda.bilstm_bwd,
                                 lstm_cuda.bilstm_wgrad)] == counts


def test_wide_wrappers_take_plain_versions_on_cpu():
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(
        6, 4, [32, 32], 32, 2, torch.float32, torch.device("cpu"))
    wrappers = (lstm_cuda.bilstm_gates, lstm_cuda.bilstm_fwd_wide,
                lstm_cuda.bilstm_fwd_wide_train, lstm_cuda.bilstm_bwd_lite)
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
    forward's 80-row tiles cover layer 0's five groups of 80 and layer 1's
    400 rows in one wave; the sweep's tiles are capped by shared memory,
    so it takes the smallest tile of its fewest waves."""
    sixteen = lambda R, smem: 16  # noqa: E731
    assert lstm_cuda.wide_plan("fwd", 400, 5, 256, sixteen)[:2] == (10, 5)
    assert lstm_cuda.wide_plan("fwd", 400, 1, 256, sixteen)[:2] == (7, 8)
    R, tiles, smem = lstm_cuda.wide_plan("bwd", 400, 5, 256, sixteen)
    assert (R, tiles) == (4, 15) and smem <= lstm_cuda.SMEM_LIMIT
    assert lstm_cuda.wide_plan("bwd", 400, 1, 256, sixteen)[:2] == (7, 8)
    assert lstm_cuda.wide_smem("bwd", 256, 10) > lstm_cuda.SMEM_LIMIT
    # more room on the card: the smallest tile that fits one wave
    assert lstm_cuda.wide_plan("fwd", 400, 1, 128, lambda R, smem: 64)[0] == 2
    assert lstm_cuda.wide_tiles(400, 5, 4) == 15 and lstm_cuda.wide_tiles(50, 1, 2) == 4


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
        ([16], 64, torch.bfloat16, None),   # K = 80: neither sweep takes it
        ([64], 60, torch.bfloat16, None),
    ],
)
def test_sweep_kernel_by_shape_and_dtype(E_parts, H, dtype, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="bilstm_bwd_mma kernel takes bfloat16"):
            lstm_cuda.sweep_kernel(E_parts, H, dtype)
        return
    assert lstm_cuda.sweep_kernel(E_parts, H, dtype) == kernel
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
                                                  ([16, 16], 32, 1, 128)])
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
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd(*rargs, kernel="lstm_recurrence_bwd"), dxg)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        lstm_cuda.lstm_recurrence_bwd_mma(xg, valid, w.clone().requires_grad_(), *rargs[3:])
    assert [f.launches for f in wrappers] == before


@pytest.mark.parametrize("H,dtype,kernel", [
    (64, torch.bfloat16, "lstm_recurrence_bwd_mma"), (32, torch.bfloat16, "lstm_recurrence_bwd_mma"),
    (64, torch.float32, "lstm_recurrence_bwd_f32"), (32, torch.float32, "lstm_recurrence_bwd_f32"),
    (128, torch.bfloat16, "lstm_recurrence_bwd"), (256, torch.bfloat16, "lstm_recurrence_bwd"),
    (96, torch.bfloat16, "lstm_recurrence_bwd"), (256, torch.float32, "lstm_recurrence_bwd"),
    (96, torch.float32, "lstm_recurrence_bwd"), (128, torch.float32, "lstm_recurrence_bwd"),
    (48, torch.bfloat16, None), (48, torch.float32, None), (64, torch.float16, None)])
def test_recurrence_sweep_kernel_by_width_and_dtype(H, dtype, kernel):
    """bf16 at H = 32 / 64 takes the tensor-core sweep, f32 there its three
    tf32 passes (whose pre-split weights fit one block), and the cluster
    sweep keeps H >= 96 in either dtype."""
    if kernel is None:
        with pytest.raises(ValueError, match="lstm_recurrence_bwd_mma takes bfloat16"):
            lstm_cuda.recurrence_sweep_kernel(H, dtype)
        return
    assert lstm_cuda.recurrence_sweep_kernel(H, dtype) == kernel
    if kernel.endswith("mma"):
        assert lstm_cuda.recurrence_mma_smem(H) <= lstm_cuda.SMEM_LIMIT // 2  # two blocks an SM
    if kernel.endswith("f32"):
        assert lstm_cuda.recurrence_f32_smem(H) <= lstm_cuda.SMEM_LIMIT



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
        ([80], 80, torch.float32, "bilstm_fwd"),       # f32 past H = 64: the CUDA-core forward
        ([128, 128], 128, torch.float32, None),        # too wide for any
        ([32], 64, torch.bfloat16, "bilstm_fwd"),      # (H, E) not instantiated
        ([60], 64, torch.bfloat16, None),               # parts not multiples of 8
        ([128, 128], 128, torch.bfloat16, None),        # too wide for either
    ],
)
def test_fwd_kernel_by_shape_and_dtype(E_parts, H, dtype, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="bilstm kernel.*; bilstm_fwd_mma kernel takes"):
            lstm_cuda.fwd_kernel(E_parts, H, dtype)
        return
    assert lstm_cuda.fwd_kernel(E_parts, H, dtype) == kernel
    assert lstm_cuda.layer_route(E_parts, H, dtype) == "resident"


@pytest.mark.parametrize("H,E", lstm_cuda.FWD_MMA_SHAPES)
def test_fwd_mma_plan(H, E):
    """One warp per 8 hidden units; a step's x chunks within the kernel's
    per-thread constant; the three-stage [x ; h] ring within a block's
    static shared memory; K whole k16 steps; one and two input parts."""
    for E_parts in ([E], [E // 2, E // 2]) if (E // 2) % 8 == 0 else ([E],):
        threads, smem = lstm_cuda.fwd_mma_plan(E_parts, H, torch.bfloat16)
        assert threads == 4 * H <= lstm_cuda.MAX_THREADS
        assert E <= lstm_cuda.FWD_MMA_MAX_CHUNKS * threads  # 8 rows x E / 8 chunks
        assert (E + H) % 16 == 0 and smem <= 48 * 1024 <= lstm_cuda.SMEM_LIMIT
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
        ([80], 80, torch.float32, "bilstm_wgrad"),     # H % 32 != 0 keeps the CUDA-core kernel
        ([16], 16, torch.float32, "bilstm_wgrad"),
        ([64], 24, torch.float32, None),
    ],
)
def test_wgrad_kernel_by_shape_and_dtype(E_parts, H, dtype, kernel):
    if kernel is None:
        with pytest.raises(ValueError, match="bilstm_wgrad kernel.*; bilstm_wgrad_mma kernel"):
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
                lstm_cuda.bilstm_layer_fwd_train(parts, lengths, w_ih, w_hh, bias, cd,
                                                 kernel="bilstm_fwd")):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for got in (lstm_cuda.bilstm_layer_fwd_mma(parts, lengths, w_ih, w_hh, bias, cd),
                lstm_cuda.bilstm_layer_fwd(parts, lengths, w_ih, w_hh, bias, cd)):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want[:4]))
    hs_f, hs_b, _, _, cs_f, cs_b = want
    dgc = bidir_layer_sweep(parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
                            dy[:1], dy[2:3], dhn, dcn, cd)[2]
    ref = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, 2)
    for got in (lstm_cuda.bilstm_wgrad_mma(dgc, parts, hs_f, hs_b, 2),
                lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, 2, kernel="bilstm_wgrad")):
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
    (64, torch.float32, "lstm_recurrence_wgrad"), (256, torch.float32, "lstm_recurrence_wgrad"),
    (48, torch.bfloat16, None), (64, torch.float16, None)])
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


# ------- the f32 tensor-core forward and recurrence sweep (three tf32 passes)
@pytest.mark.parametrize("E_parts,H,rows,smem", [
    ([64], 64, 8, 147968), ([64, 64], 64, 8, 217600), ([64, 64], 64, 16, 230400),
    ([64], 64, 16, 156672), ([32], 32, 8, 41472), ([32, 32], 32, 16, 66560),
    ([16], 16, 16, 15360), ([48], 48, 8, 86528)])
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
    assert smem <= lstm_cuda.SMEM_LIMIT and threads <= lstm_cuda.MAX_THREADS
    assert rows * E // 4 <= lstm_cuda.FWD_F32_MAX_CHUNKS * threads
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.fwd_f32_plan(E_parts, H, torch.bfloat16, rows)
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.fwd_f32_plan(E_parts, H, torch.float32, 32)
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.fwd_f32_plan([40], 80, torch.float32, rows)
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
    for plan in (lstm_cuda.fwd_mma_plan, lstm_cuda.launch_plan):
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
    tensor-core forward keeps that route at its own width; a layer it did
    not take is resident at its own width now only where ``bilstm_fwd_f32``
    takes it (``fwd_f32_plan`` no longer waits on ``launch_plan``), and bf16
    keeps its kernel; the new kernel takes each model shape in f32."""
    for H in range(8, 272, 8):
        for E_parts in ([8], [16], [24], [32], [40], [48], [64], [96], [120], [128], [256],
                        [32, 32], [48, 48], [64, 64], [128, 128], [256, 256]):
            for dtype in (torch.float32, torch.bfloat16):
                route, Hp, Ep = _route_and_width(E_parts, H, dtype)
                own = (route, Hp, Ep) == ("resident", H, tuple(E_parts))
                if (_resident_before_f32_forward(E_parts, H, dtype)
                        and _has_wgrad(E_parts, H, dtype)):
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
                    lstm_cuda.launch_plan(E_parts, H, dtype)


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
                lstm_cuda.bilstm_layer_fwd_train(parts, lengths, w_ih, w_hh, bias, cd),
                lstm_cuda.bilstm_layer_fwd_train(parts, lengths, w_ih, w_hh, bias, cd,
                                                 kernel="bilstm_fwd_f32")):
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
    assert torch.equal(lstm_cuda.lstm_recurrence_bwd(*rargs, kernel="lstm_recurrence_bwd"), dxg)
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
        ([256], 256, torch.float32, "bilstm_gates"),          # f32 keeps the CUDA-core kernel
        ([128, 128], 128, torch.float32, "bilstm_gates"),
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
        (256, torch.float32, "bilstm_bwd_lite"),   # f32 keeps the CUDA-core sweep
        (128, torch.float32, "bilstm_bwd_lite"),
        (192, torch.bfloat16, "bilstm_bwd_lite"),  # m16 tiles not even over 8 warps
        (96, torch.bfloat16, "bilstm_bwd_lite"),   # no whole 8-unit groups a block
        (32, torch.bfloat16, "bilstm_bwd_lite"),
        (80, torch.bfloat16, None),
        (288, torch.float32, "bilstm_bwd_lite"),   # the 288-thread instance
        (288, torch.bfloat16, "bilstm_bwd_lite"),
        (320, torch.float32, None),
        (256, torch.float16, None),
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
    tensor-core ones in bf16."""
    for H0 in range(8, 272, 8):
        for E_parts in ([8], [16], [32], [48], [64], [96], [128], [256], [512],
                        [32, 32], [64, 64], [128, 128], [256, 256]):
            route, H, Ep = _route_and_width(E_parts, H0, dtype)
            assert route == _route_without_the_wide_dispatch(E_parts, H0, dtype), (E_parts, H0)
            if route != "wide":
                continue
            gates, lite = lstm_cuda.gates_kernel(Ep, H, dtype), lstm_cuda.lite_kernel(H, dtype)
            bf16 = dtype == torch.bfloat16
            assert gates == ("bilstm_gates_mma" if bf16 else "bilstm_gates")
            assert lite == ("bilstm_bwd_lite_mma" if bf16 and H in (128, 256)
                            else "bilstm_bwd_lite")
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
    wrappers = (lstm_cuda.bilstm_gates, lstm_cuda.bilstm_gates_mma, lstm_cuda.bilstm_bwd_lite,
                lstm_cuda.bilstm_bwd_lite_mma)
    before = [f.launches for f in wrappers]
    want = input_gates(parts, w_ih, bias, cd)
    for got in (lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd),
                lstm_cuda.bilstm_gates(parts, w_ih, bias, cd, kernel="bilstm_gates")):
        assert torch.equal(got, want)
    hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(want, lengths, w_hh, cd, with_states=True)
    args = (want, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:2], dy[2:], dhn, dcn, cd)
    ref = bidir_layer_sweep_lite(*args)
    for got in (lstm_cuda.bilstm_bwd_lite_mma(*args),
                lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")):
        assert torch.equal(got, ref)
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
        (256, torch.float32, "bilstm_fwd_wide"),   # f32 keeps the CUDA-core forward
        (128, torch.float32, "bilstm_fwd_wide"),
        (192, torch.bfloat16, "bilstm_fwd_wide"),  # 8 warps not even over 3 unit groups
        (96, torch.bfloat16, "bilstm_fwd_wide"),   # no whole 8-unit groups a block
        (32, torch.bfloat16, "bilstm_fwd_wide"),
        (80, torch.bfloat16, None),
        (288, torch.float32, "bilstm_fwd_wide"),   # the 288-thread instance
        (288, torch.bfloat16, "bilstm_fwd_wide"),
        (320, torch.float32, None),
        (256, torch.float16, None),
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
    one in bf16 at H = 128 and 256), and every layer whose widths are whole
    128-row gate tiles and 8-column parts takes a tensor-core wgrad (f32
    too), in bf16 every layer with H % 8 == 0 (the masked last gate tile);
    the others keep ``bilstm_wgrad.cu``. Each at the layer's padded shape,
    where every layer has a weight-gradient kernel."""
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
                    "bilstm_fwd_wide_mma" if bf16 and H in (128, 256) else "bilstm_fwd_wide")
            wgrad = lstm_cuda.wgrad_kernel(Ep, H, dtype)
            if H % 32 == 0 or (bf16 and H % 8 == 0):
                assert wgrad == ("bilstm_wgrad_mma" if bf16 else "bilstm_wgrad_f32"), (E_parts, H)
            else:
                assert wgrad == "bilstm_wgrad", (E_parts, H)
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
    wrappers = (lstm_cuda.bilstm_fwd_wide, lstm_cuda.bilstm_fwd_wide_train,
                lstm_cuda.bilstm_fwd_wide_mma, lstm_cuda.bilstm_fwd_wide_train_mma,
                lstm_cuda.bilstm_wgrad, lstm_cuda.bilstm_wgrad_f32)
    before = [f.launches for f in wrappers]
    xg = input_gates(parts, w_ih, bias, cd)
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    for got in (lstm_cuda.bilstm_fwd_wide_train_mma(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")):
        assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    for got in (lstm_cuda.bilstm_fwd_wide_mma(xg, lengths, w_hh, cd),
                lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide")):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want[:4]))
    f32 = layer_case(5, 6, [32, 32], 32, 2, torch.float32, torch.device("cpu"))
    parts32 = f32[0]
    hs_f, hs_b = bidir_layer(*f32[:5], torch.float32)[:2]
    dgc = torch.rand(2, 5, 6, 128, generator=torch.Generator().manual_seed(1)) * 2 - 1
    ref = bidir_layer_wgrad(dgc, parts32, hs_f, hs_b, 2)
    for got in (lstm_cuda.bilstm_wgrad_f32(dgc, parts32, hs_f, hs_b, 2),
                lstm_cuda.bilstm_wgrad(dgc, parts32, hs_f, hs_b, 2, kernel="bilstm_wgrad")):
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
    fwd = {"bilstm_fwd": lstm_cuda.bilstm_layer_fwd_train,
           "bilstm_fwd_f32": lstm_cuda.bilstm_layer_fwd_train_f32}[
        lstm_cuda.fwd_kernel([16], 16, torch.float32)]
    before = (fwd.launches, sweep.launches, lstm_cuda.bilstm_wgrad.launches)
    got = model_grads(cuda_device)
    torch.cuda.synchronize()
    after = (fwd.launches, sweep.launches, lstm_cuda.bilstm_wgrad.launches)
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
    tiles. At H = 80 (layer 0 of a model at embedding 80) the forward and
    wgrad are CUDA-core ones, and the sweep is ``bilstm_bwd.cu`` in bf16 and
    the one-stage 3xTF32 sweep in f32."""
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
    wrapper = {"bilstm_fwd": lstm_cuda.bilstm_layer_fwd,
               "bilstm_fwd_mma": lstm_cuda.bilstm_layer_fwd_mma,
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
    leave short row tiles inside each group. In bf16 the gates and (at
    H = 128 and 256) the forward and the sweep are the tensor-core kernels,
    counted on their own wrappers, and the CUDA-core ones are held by name
    too; in f32 wgrad is the 3xTF32 kernel at every width here."""
    T = 24
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, E_parts, H, G, dtype,
                                                                 cuda_device)
    tol = 1e-4 if dtype == torch.float32 else 3e-2

    def close(got, want):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert float((a.float() - b.float()).abs().max()) <= tol * max(
                1.0, float(b.float().abs().max()))

    wrappers = (lstm_cuda.bilstm_gates, lstm_cuda.bilstm_fwd_wide,
                lstm_cuda.bilstm_fwd_wide_train, lstm_cuda.bilstm_bwd_lite,
                lstm_cuda.bilstm_gates_mma, lstm_cuda.bilstm_bwd_lite_mma,
                lstm_cuda.bilstm_fwd_wide_mma, lstm_cuda.bilstm_fwd_wide_train_mma,
                lstm_cuda.bilstm_wgrad, lstm_cuda.bilstm_wgrad_mma, lstm_cuda.bilstm_wgrad_f32)
    before = [f.launches for f in wrappers]
    xg = lstm_cuda.bilstm_gates(parts, w_ih, bias, dtype)
    close([xg], [input_gates(parts, w_ih, bias, dtype)])
    gates_mma = lstm_cuda.gates_kernel(E_parts, H, dtype) == "bilstm_gates_mma"
    lite_mma = lstm_cuda.lite_kernel(H, dtype) == "bilstm_bwd_lite_mma"
    fwd_mma = lstm_cuda.wide_fwd_kernel(H, dtype) == "bilstm_fwd_wide_mma"
    assert gates_mma == (dtype == torch.bfloat16)
    assert lite_mma == fwd_mma == (dtype == torch.bfloat16 and H in (128, 256))
    ref = bidir_recurrence(xg, lengths, w_hh, dtype, with_states=True)
    close(lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype), ref)
    close(lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, dtype), ref[:4])
    if fwd_mma:
        close(lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype, kernel="bilstm_fwd_wide"),
              ref)
        close(lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, dtype, kernel="bilstm_fwd_wide"),
              ref[:4])
    hs_f, hs_b, _, _, cs_f, cs_b = ref
    ny = 2 if len(E_parts) == 1 else 1
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[2:2 + ny], dhn, dcn, dtype)
    dgates = bidir_layer_sweep_lite(*args)
    close([lstm_cuda.bilstm_bwd_lite(*args)], [dgates])
    if gates_mma:
        close([lstm_cuda.bilstm_gates(parts, w_ih, bias, dtype, kernel="bilstm_gates")],
              [input_gates(parts, w_ih, bias, dtype)])
    if lite_mma:
        close([lstm_cuda.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite")], [dgates])
    dgc = dgates.to(dtype)
    close(lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, G),
          bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G))
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert [f.launches - b for f, b in zip(wrappers, before)] == [
        1, 1, 1, 1, int(gates_mma), int(lite_mma), int(fwd_mma), int(fwd_mma), 0, int(bf16),
        int(not bf16)]


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
    """A model at embedding 128 (H = 128) takes the wide route on the card;
    its gradients equal the CPU plain path's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert lstm_cuda.layer_route([128], 128, torch.float32) == "wide"
    before = (lstm_cuda.bilstm_gates.launches, lstm_cuda.bilstm_fwd_wide_train.launches,
              lstm_cuda.bilstm_bwd_lite.launches, lstm_cuda.bilstm_layer_fwd_train.launches)
    got = model_grads(cuda_device, embedding_size=128)
    torch.cuda.synchronize()
    after = (lstm_cuda.bilstm_gates.launches, lstm_cuda.bilstm_fwd_wide_train.launches,
             lstm_cuda.bilstm_bwd_lite.launches, lstm_cuda.bilstm_layer_fwd_train.launches)
    assert [a - b for a, b in zip(after, before)] == [4, 2, 2, 0]
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
    bits in both; the CUDA-core kernel by name agrees too."""
    cd, H, T, B = torch.bfloat16, 256, 1500, 400
    parts, lengths, w_ih, w_hh, bias, _, _, _ = layer_case(T, B, E_parts, H, G, cd, cuda_device)
    xg = lstm_cuda.bilstm_gates_mma(parts, w_ih, bias, cd)
    del parts
    want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
    wrappers = (lstm_cuda.bilstm_fwd_wide, lstm_cuda.bilstm_fwd_wide_train,
                lstm_cuda.bilstm_fwd_wide_mma, lstm_cuda.bilstm_fwd_wide_train_mma)
    before = [f.launches for f in wrappers]
    got = lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
    ev = lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, cd)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [0, 0, 1, 1]
    _close(got, want, 3e-2)
    _close(ev, want[:4], 3e-2)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    del got, ev
    _close(lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, cd, kernel="bilstm_fwd_wide"),
           want, 3e-2)
    torch.cuda.synchronize()
    assert lstm_cuda.bilstm_fwd_wide_train.launches == before[1] + 1


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
    _close(lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, G, kernel="bilstm_wgrad"), want, 1e-4)
    torch.cuda.synchronize()
    assert lstm_cuda.bilstm_wgrad.launches == before[0] + 1


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
    wrappers = (lstm_cuda.bilstm_fwd_wide_train, lstm_cuda.bilstm_fwd_wide_train_mma,
                lstm_cuda.bilstm_gates_mma, lstm_cuda.bilstm_bwd_lite_mma,
                lstm_cuda.bilstm_wgrad_mma, lstm_cuda.bilstm_layer_fwd_train_mma)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=torch.bfloat16, embedding_size=128)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [0, 2, 4, 2, 2, 0]
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
    with pytest.raises(ValueError, match="bilstm kernel"):
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

    # the sweep's and wgrad's launches count on the wrapper of the kernel the
    # dispatch names
    sweep = getattr(lstm_cuda, lstm_cuda.recurrence_sweep_kernel(H, dtype))
    wgrad = getattr(lstm_cuda, lstm_cuda.recurrence_wgrad_kernel(H, dtype))
    wrappers = (lstm_cuda.lstm_recurrence_fwd, sweep, wgrad)
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
    and 13 rows, with and without ``dhs`` / ``dcn``; the cluster sweep asked
    for by name agrees too."""
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
    _close([lstm_cuda.lstm_recurrence_bwd(*args, kernel="lstm_recurrence_bwd")], [want], 3e-2)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_recurrence_bwd.launches == before[0] + 1


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
    ([32, 32], 32, 1, 13), ([16, 16], 16, 4, 20), ([48], 48, 1, 11)])
def test_fwd_mma_matches_plain_on_card(cuda_device, T, E_parts, H, G, B):
    """The tensor-core forward against its plain twin in bf16, both
    variants: 1 and 2 input parts, weight groups of 5, 6, 8, 9, 11, 13 and
    50 rows (short tiles inside each group), rows of length 0, 1 and T, and
    rows 8-15 short of T so a tile stops at its longest row. The dispatch
    hands ``bilstm_layer_fwd(_train)`` to it; the CUDA-core forward asked
    for by name agrees too."""
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
    _close(lstm_cuda.bilstm_layer_fwd_train(*args, kernel="bilstm_fwd"), want, 3e-2)
    _close(lstm_cuda.bilstm_layer_fwd(*args, kernel="bilstm_fwd"), want[:4], 3e-2)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1, 2, 2]


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
    _close(lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, G, kernel="bilstm_wgrad"), want, 3e-2)
    torch.cuda.synchronize()
    assert lstm_cuda.bilstm_wgrad.launches == before[0] + 1


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
    with pytest.raises(ValueError, match="no forward kernel named"):
        lstm_cuda.bilstm_layer_fwd(parts, lengths, w_ih, w_hh, bias, cd, kernel="fast")
    with pytest.raises(ValueError, match="no weight-gradient kernel named"):
        lstm_cuda.bilstm_wgrad(torch.zeros(2, 4, 10, 256, dtype=cd, device=cuda_device), parts,
                               hs.new_zeros(4, 10, 64), hs.new_zeros(4, 10, 64), 2, kernel="x")


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
    _close(lstm_cuda.bilstm_layer_fwd_train(*args, kernel="bilstm_fwd"), want, 1e-4)
    _close(lstm_cuda.bilstm_layer_fwd(*args, kernel="bilstm_fwd"), want[:4], 1e-4)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1, 2, 2]


@pytest.mark.cuda
def test_fwd_f32_edges_on_card(cuda_device):
    """An empty batch launches nothing; T = 0 gives zero final states; bf16
    operands, H = 80 and an unknown kernel name raise in the f32 wrappers
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
    wide = layer_case(4, 10, [40], 80, 2, cd, cuda_device)
    with pytest.raises(ValueError, match="bilstm_fwd_f32 kernel takes float32"):
        lstm_cuda.bilstm_layer_fwd_train_f32(*wide[:5], cd)
    with pytest.raises(ValueError, match="no forward kernel named"):
        lstm_cuda.bilstm_layer_fwd(parts, lengths, w_ih, w_hh, bias, cd, kernel="fast")


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
    _close([lstm_cuda.lstm_recurrence_bwd(*args, kernel="lstm_recurrence_bwd")], [want], 1e-4)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_recurrence_bwd.launches == before[0] + 1


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
    kernels' 288-thread instance runs, past it the global-weight one."""
    assert lstm_cuda.recurrence_width(H, dtype) == Hp
    T, D, B, G = 12, 2, 10, 2
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    xg, valid, w, dhs, dhn, dcn = recurrence_case(T, D, B, H, G, dtype, cuda_device, "holes",
                                                  seed=H)
    before = lstm_cuda.lstm_recurrence_fwd.launches
    outs, grads = [], []
    for dev in (cuda_device, torch.device("cpu")):
        xg_r = xg.to(dev).clone().requires_grad_()
        w_r = w.to(dev).clone().requires_grad_()
        out = fused_lstm_recurrence(xg_r, valid.to(dev), w_r, G, dtype)
        torch.autograd.backward(out, [t.to(dev) for t in (dhs, dhn, dcn)])
        outs.append([t.detach().cpu() for t in out])
        grads.append([xg_r.grad.cpu(), w_r.grad.cpu()])
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_recurrence_fwd.launches == before + 1
    _close(outs[0], outs[1], tol)
    _close(grads[0], grads[1], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_layer_model_at_embedding_80_on_card(cuda_device, dtype):
    """The default two-layer model at embedding 80: layer 0 resident (the
    one-stage sweep in f32, ``bilstm_bwd.cu`` in bf16), the stacked layer
    padded to 96 on the wide route; its gradients equal the CPU plain
    path's (1e-4 x max(1, max|grad|) in f32, 2^-7 in bf16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dtype == torch.float32
    wrappers = (lstm_cuda.bilstm_bwd_f32_onestage, lstm_cuda.bilstm_bwd,
                lstm_cuda.bilstm_bwd_lite)
    before = [f.launches for f in wrappers]
    got = model_grads(cuda_device, dtype=dtype, embedding_size=80)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [int(f32), int(not f32), 1]
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
    1500. The dispatch hands ``bilstm_wgrad`` to it; ``bilstm_wgrad.cu`` by
    name agrees too."""
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
    _close(lstm_cuda.bilstm_wgrad(dgc, parts, hs_f, hs_b, G, kernel="bilstm_wgrad"), want, 3e-2)
    torch.cuda.synchronize()
    assert (lstm_cuda.bilstm_wgrad.launches, lstm_cuda.bilstm_wgrad_mma.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_kernels_at_288_match_plain_on_card(cuda_device, dtype, T):
    """The CUDA-core wide forward (both variants) and lite sweep at H = 288
    (their 288-thread instances: the bf16 layers JAX's lite plan takes past
    256, padded to 288) against their plain twins: 60 rows in 5 weight
    groups, ragged lengths, two dy streams; the row tiles ``wide_plan``
    picks. 1e-4 x max(1, max|ref|) in f32, 3e-2 in bf16."""
    H, G, B = 288, 5, 60
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    parts, lengths, w_ih, w_hh, bias, dy, dhn, dcn = layer_case(T, B, [H], H, G, dtype,
                                                                 cuda_device, seed=T)
    assert lstm_cuda.wide_fwd_kernel(H, dtype) == "bilstm_fwd_wide"
    assert lstm_cuda.lite_kernel(H, dtype) == "bilstm_bwd_lite"
    xg = input_gates(parts, w_ih, bias, dtype)
    want = bidir_recurrence(xg, lengths, w_hh, dtype, with_states=True)
    wrappers = (lstm_cuda.bilstm_fwd_wide, lstm_cuda.bilstm_fwd_wide_train,
                lstm_cuda.bilstm_bwd_lite)
    before = [f.launches for f in wrappers]
    _close(lstm_cuda.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype), want, tol)
    _close(lstm_cuda.bilstm_fwd_wide(xg, lengths, w_hh, dtype), want[:4], tol)
    hs_f, hs_b, _, _, cs_f, cs_b = want
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, tuple(dy[:2]), tuple(dy[2:]), dhn, dcn,
            dtype)
    _close([lstm_cuda.bilstm_bwd_lite(*args)], [bidir_layer_sweep_lite(*args)], tol)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1, 1]


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
