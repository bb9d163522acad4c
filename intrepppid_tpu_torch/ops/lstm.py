"""Bidirectional multi-layer LSTM (`intrepppid_tpu/ops/lstm.py:87-217`).

The plain PyTorch versions of the layer kernels live here: the CPU path and
the references the CUDA kernels (``ops/lstm_cuda.py``) are held against on
the card.

* ``input_gates`` — the input projection of both directions, f32 (the
  gates kernel; the TPU kernels form it in their body, ``_xg2``);
* ``bidir_recurrence`` — the recurrence over those gates; with
  ``with_states`` it also returns the cell streams, as the train variant of
  the TPU forward kernel does (``with_states=True``). ``bidir_layer`` is
  the two together: one layer's forward;
* ``bidir_layer_sweep_lite`` — the reverse-time sweep over the gate
  streams, returning the masked f32 gate cotangents, as the lite backward
  (``lstm_pallas_layer.py:723 _bwd_pallas_lite``) does; ``input_grads``
  forms the input-side gradients from them;
* ``bidir_layer_sweep`` (the two above) and ``bidir_layer_wgrad`` — the two
  halves of the layer's backward (``lstm_pallas_packed.py:750
  _bwd_pallas_packed``): the sweep, and the weight-gradient products over
  its gate cotangent stream; ``bidir_layer_bwd`` runs both.

``bilstm`` runs the stack on one of two backends (``DEFAULT_BACKEND``, or
per call; ``"auto"`` takes ``"layer"`` up to 288 units a layer and
``"recurrence"`` past that, ``resolve_backend``). ``"layer"``: under
autograd through ``ops/lstm_stack.py`` (one
``torch.autograd.Function`` over the whole stack, in the role of
``pallas_bilstm_stack``), otherwise layer by layer through
``lstm_cuda.layer_fwd``. ``"recurrence"``: per layer the hoisted input
projection in PyTorch and the time-major recurrence op
(``ops/lstm_recurrence.py``), the counterpart of the JAX package's
``_bidir_layer`` (its ``backend="scan"`` path). Both take the plain
versions for CPU tensors and the kernels for CUDA tensors.

Semantics, shared by every version and by the JAX package:

* gate order i, f, g, o; torch weight layout ``w_ih (2, 4H, E)`` and
  ``w_hh (2, 4H, H)``, or grouped ``w_hh (2, G, 4H, H)`` with the batch
  group-major and ``B % G == 0`` (one weight-dropped matrix per encoder
  call); the bias is ``b_ih + b_hh`` summed in f32;
* matmul operands are in the compute dtype and accumulate in f32; the
  input gates, h and c are f32; the streams ``hs``/``cs`` are stored in the
  compute dtype;
* a position updates the state iff ``pos < length`` for both directions:
  the reverse direction stays at zero until position ``length - 1``, rows
  of length 0 keep zero state, and the streams hold the frozen state past
  the length (zero for the reverse direction);
* the backward recomputes the gates from x and the stored ``h_prev`` /
  ``c_prev`` (``c_prev`` rounded to the compute dtype, as the TPU kernel
  stores it); ``dh`` and ``dc`` pass through frozen positions unchanged;
  the gate cotangents are f32, rounded to the compute dtype for ``dh``,
  dx and the weight gradients, and summed unrounded for ``dbias``;
* the layer above takes the two directions as two feature parts, so the
  2H concat is only built for the returned ``y``; the backward returns the
  input cotangent per part and per direction, unsummed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

LayerParams = Dict[str, torch.Tensor]
Streams = Tuple[torch.Tensor, ...]

# The stack's backend when a call passes "auto": "auto" (by width: the layer
# kernels, or the time-major recurrence op where a layer is wider than the
# layer route takes, ``resolve_backend``), "layer" or "recurrence". Override
# per call or through this module global, as the JAX package's
# ``ops/lstm.py:DEFAULT_BACKEND``; the models call ``bilstm`` without a
# backend, so the global selects their path.
DEFAULT_BACKEND = "auto"
BACKENDS = ("layer", "recurrence")


def resolve_backend(backend: str, H: Optional[int] = None) -> str:
    """The backend a stack runs on: ``backend``, or for ``"auto"`` the
    module's ``DEFAULT_BACKEND``; "auto" there picks by the stack's widest
    layer ``H``: ``"recurrence"`` past ``lstm_cuda.WIDE_MAX_THREADS`` (288,
    the widest layer the layer route takes, padded or not), where the JAX
    package's ``"auto"`` runs its scan, else ``"layer"`` (also when no width
    is given). A choice by shape, made before any launch. ``"layer"`` named
    explicitly still refuses a layer past 288."""
    from intrepppid_tpu_torch.ops.lstm_cuda import WIDE_MAX_THREADS

    if backend == "auto":
        backend = DEFAULT_BACKEND
    if backend == "auto":
        backend = "recurrence" if H is not None and H > WIDE_MAX_THREADS else "layer"
    if backend not in BACKENDS:
        raise ValueError(f"bilstm backend must be \"auto\" or one of {BACKENDS}, got {backend!r}")
    return backend


def _operand(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    # round to the compute dtype, then multiply in f32: the products of two
    # bf16 values are exact in f32, so this is bf16 operands with f32
    # accumulation
    return t.to(compute_dtype).float()


def grouped_w_hh(w_hh: torch.Tensor) -> torch.Tensor:
    """``w_hh`` as ``(2, G, 4H, H)``; an ungrouped ``(2, 4H, H)`` is G = 1."""
    return w_hh if w_hh.dim() == 4 else w_hh.unsqueeze(1)


def _valid(T: int, lengths: torch.Tensor, dev) -> torch.Tensor:
    """``(T, 2, B, 1)`` bool: step s updates the forward direction at
    position s and the reverse direction at position T-1-s."""
    steps = torch.arange(T, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    return torch.stack(
        [steps[:, None] < lengths[None, :], (T - 1 - steps)[:, None] < lengths[None, :]],
        dim=1,
    ).unsqueeze(-1)


def input_gates(x_parts, w_ih, bias, compute_dtype) -> torch.Tensor:
    """The input projection of both directions, ``xg (2, T, B, 4H)`` f32:
    ``xg[d] = concat(x_parts) @ w_ih[d]^T + bias[d]``, compute-dtype
    operands, f32 sums."""
    x = torch.cat([_operand(p, compute_dtype) for p in x_parts], dim=-1)
    xg = torch.einsum("tbe,dge->dtbg", x, _operand(w_ih, compute_dtype))
    return (xg + bias.float()[:, None, None, :]).contiguous()


def _recurrent(h: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """``h (2, B, H)`` times the group's ``W_hh^T`` ``(2, G, H, 4H)``."""
    D, B, H = h.shape
    G = w_hh_t.shape[1]
    return torch.matmul(h.reshape(D, G, B // G, H), w_hh_t).reshape(D, B, -1)


def _check_groups(B: int, w_hh: torch.Tensor) -> int:
    G = w_hh.shape[1]
    if B % G:
        raise ValueError(f"batch {B} is not a multiple of the {G} weight groups")
    return G


def bidir_recurrence(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
    with_states: bool = False,
) -> Streams:
    """The recurrence of one bidirectional layer over its input gates.

    :param xg: ``(2, T, B, 4H)`` f32 input gates (``input_gates``).
    :param lengths: ``(B,)`` int — positions ``>= length`` freeze the state.
    :param w_hh: ``(2, 4H, H)`` or ``(2, G, 4H, H)``; direction 0 forward,
        1 reverse.
    :returns: ``hs_f, hs_b (T, B, H)`` in ``compute_dtype`` and ``hn, cn
        (2, B, H)`` f32; with ``with_states`` also ``cs_f, cs_b (T, B, H)``
        in ``compute_dtype``.
    """
    _, T, B, H4 = xg.shape
    H = H4 // 4
    dev = xg.device
    w_hh = grouped_w_hh(w_hh)
    _check_groups(B, w_hh)
    w_hh_t = _operand(w_hh, compute_dtype).transpose(-1, -2)  # (2, G, H, 4H)
    valid = _valid(T, lengths, dev)

    h = torch.zeros(2, B, H, dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    hs = torch.empty(2, T, B, H, dtype=compute_dtype, device=dev)
    cs = torch.empty_like(hs) if with_states else None
    for s in range(T):
        # the reverse direction's step s reads position T-1-s
        gates = torch.stack([xg[0, s], xg[1, T - 1 - s]]) + _recurrent(
            _operand(h, compute_dtype), w_hh_t)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = torch.where(valid[s], h_new, h)
        c = torch.where(valid[s], c_new, c)
        hs[0, s] = h[0]
        hs[1, T - 1 - s] = h[1]
        if cs is not None:
            cs[0, s] = c[0]
            cs[1, T - 1 - s] = c[1]
    if cs is not None:
        return hs[0], hs[1], h, c, cs[0], cs[1]
    return hs[0], hs[1], h, c


def bidir_layer(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
    with_states: bool = False,
) -> Streams:
    """One bidirectional layer in plain PyTorch (differentiable by autograd):
    ``bidir_recurrence`` over ``input_gates``.

    :param x_parts: 1 or 2 time-major ``(T, B, E_i)`` tensors whose feature
        concat is the layer input.
    :param w_ih: ``(2, 4H, E)``; ``bias``: ``(2, 4H)`` f32; the other
        operands and the returns as for ``bidir_recurrence``.
    """
    return bidir_recurrence(input_gates(x_parts, w_ih, bias, compute_dtype), lengths, w_hh,
                            compute_dtype, with_states)


def prev_states(s_f: torch.Tensor, s_b: torch.Tensor) -> torch.Tensor:
    """``(2, T, B, H)`` state before each position: the forward direction's
    at position p is ``s_f[p-1]`` (zero at p = 0), the reverse direction's
    ``s_b[p+1]`` (zero at p = T-1)."""
    zero = torch.zeros_like(s_f[:1])
    return torch.stack([torch.cat([zero, s_f[:-1]]), torch.cat([s_b[1:], zero])])


def bidir_layer_sweep_lite(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    cs_f: torch.Tensor,
    cs_b: torch.Tensor,
    dyf: Sequence[torch.Tensor],
    dyb: Sequence[torch.Tensor],
    dhn: Optional[torch.Tensor],
    dcn: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """The backward sweep of one layer over its input gates: an explicit
    reverse loop over time.

    Each direction walks its positions in the reverse of its forward order.
    Per step it recomputes the gates as ``xg + h_prev @ W_hh^T`` from the
    stored previous state, adds the dy streams, forms the masked gate
    cotangent ``dgates`` (f32), and carries ``dh = dgc @ W_hh`` back with
    ``dgc`` the cotangent rounded to the compute dtype.

    :param xg: ``(2, T, B, 4H)`` f32 input gates, as the forward used them.
    :param dyf, dyb: 0, 1 or 2 unsummed ``(T, B, H)`` cotangent streams of
        ``hs_f`` and ``hs_b`` (summed in f32 here).
    :param dhn, dcn: ``(2, B, H)`` f32 cotangents of the final states, or
        None for zero.
    :returns: ``dgates (2, T, B, 4H)`` f32, zero at masked positions.
    """
    _, T, B, H4 = xg.shape
    H = H4 // 4
    dev = xg.device
    w_hh_c = _operand(grouped_w_hh(w_hh), compute_dtype)  # (2, G, 4H, H)
    G = _check_groups(B, w_hh_c)
    w_hh_t = w_hh_c.transpose(-1, -2)
    hp = prev_states(hs_f, hs_b).float()  # (2, T, B, H), compute-dtype values
    cp = prev_states(cs_f, cs_b).float()
    lengths = lengths.to(device=dev, dtype=torch.int64)

    def dy_sum(streams, pos):
        out = torch.zeros(B, H, dtype=torch.float32, device=dev)
        for st in streams:
            out = out + st[pos].float()
        return out

    dh = torch.zeros(2, B, H, device=dev) if dhn is None else dhn.float().clone()
    dc = torch.zeros(2, B, H, device=dev) if dcn is None else dcn.float().clone()
    dgates_all = torch.empty(2, T, B, H4, dtype=torch.float32, device=dev)
    for s in range(T):
        # the forward direction's sweep ran position s at step s, so its
        # backward takes position T-1-s now; the reverse direction's the other way
        pos = (T - 1 - s, s)
        h_prev = torch.stack([hp[0, pos[0]], hp[1, pos[1]]])
        c_prev = torch.stack([cp[0, pos[0]], cp[1, pos[1]]])
        dy = torch.stack([dy_sum(dyf, pos[0]), dy_sum(dyb, pos[1])])
        m = torch.stack([pos[0] < lengths, pos[1] < lengths]).unsqueeze(-1).float()

        gates = torch.stack([xg[0, pos[0]], xg[1, pos[1]]]) + _recurrent(h_prev, w_hh_t)
        ig = torch.sigmoid(gates[..., :H])
        f = torch.sigmoid(gates[..., H:2 * H])
        gg = torch.tanh(gates[..., 2 * H:3 * H])
        o = torch.sigmoid(gates[..., 3 * H:])
        c_new = f * c_prev + ig * gg
        dh = dh + dy
        tc = torch.tanh(c_new)
        dc_t = dc + dh * o * (1.0 - tc * tc)
        dgates = torch.cat([
            dc_t * gg * ig * (1.0 - ig) * m,
            dc_t * c_prev * f * (1.0 - f) * m,
            dc_t * ig * (1.0 - gg * gg) * m,
            dh * tc * o * (1.0 - o) * m,
        ], dim=-1)  # (2, B, 4H) f32
        dgates_all[0, pos[0]] = dgates[0]
        dgates_all[1, pos[1]] = dgates[1]
        dgc = _operand(dgates, compute_dtype)
        dhp = torch.matmul(dgc.reshape(2, G, B // G, H4), w_hh_c).reshape(2, B, H)
        dh = dhp + dh * (1.0 - m)
        dc = dc_t * f * m + dc * (1.0 - m)
    return dgates_all


def input_grads(
    dgates: torch.Tensor,
    w_ih: torch.Tensor,
    E_parts: Sequence[int],
) -> Tuple[Streams, Streams, torch.Tensor, torch.Tensor]:
    """The input-side gradients of a layer from its f32 gate cotangents:
    ``dgc = dgates`` rounded to ``w_ih``'s dtype (the compute dtype),
    ``dx[d] = dgc[d] @ w_ih[d]`` per input part and direction (compute-dtype
    products, in the compute dtype, as the JAX lite mode's XLA GEMMs,
    ``lstm_pallas_layer.py:1076-1090``), and ``dbias`` the f32 sum of the
    unrounded ``dgates`` (``:1109-1114``).

    :returns: ``(dxf, dxb, dgc (2, T, B, 4H), dbias (2, 4H))``, ``dxf``/
        ``dxb`` one ``(T, B, E_i)`` tensor per part.
    """
    dbias = dgates.sum(dim=(1, 2))
    dgc = dgates.to(w_ih.dtype)
    dx = [torch.matmul(dgc[d], w_ih[d]) for d in range(2)]  # (T, B, E) each
    dxf = tuple(t.contiguous() for t in dx[0].split(list(E_parts), dim=-1))
    dxb = tuple(t.contiguous() for t in dx[1].split(list(E_parts), dim=-1))
    return dxf, dxb, dgc, dbias


def bidir_layer_sweep(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    cs_f: torch.Tensor,
    cs_b: torch.Tensor,
    dyf: Sequence[torch.Tensor],
    dyb: Sequence[torch.Tensor],
    dhn: Optional[torch.Tensor],
    dcn: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
) -> Tuple[Streams, Streams, torch.Tensor, torch.Tensor]:
    """The backward sweep of one layer from its inputs: the gates
    recomputed by ``input_gates``, ``bidir_layer_sweep_lite`` over them,
    then ``input_grads``.

    :returns: ``(dxf, dxb, dgc, dbias)``: ``dxf``/``dxb`` one ``(T, B,
        E_i)`` tensor per input part in the compute dtype (the forward and
        the reverse direction's contributions), ``dgc (2, T, B, 4H)`` in the
        compute dtype (the weight-gradient products' operand), and ``dbias
        (2, 4H)`` f32, summed from the unrounded gate cotangents.
    """
    dgates = bidir_layer_sweep_lite(
        input_gates(x_parts, w_ih, bias, compute_dtype), lengths, w_hh,
        hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, compute_dtype)
    return input_grads(dgates, w_ih.to(compute_dtype), [p.shape[-1] for p in x_parts])


def bidir_layer_wgrad(
    dgc: torch.Tensor,
    x_parts: Sequence[torch.Tensor],
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight gradients from the sweep's gate cotangent stream:
    ``dW_ih[d] = sum_{t,b} dgc[d,t,b] (x) x[t,b]`` and ``dW_hh[d,g] =
    sum_{t, b in g} dgc[d,t,b] (x) h_prev[d,t,b]``, compute-dtype operands
    with f32 accumulation.

    :returns: ``dW_ih (2, 4H, E)`` and ``dW_hh (2, G, 4H, H)``, f32 (with
        no input part, ``dW_ih`` is ``(2, 4H, 0)``).
    """
    T, B = dgc.shape[1:3]
    d = dgc.float()
    x = (torch.cat([p.float() for p in x_parts], dim=-1) if x_parts
         else d.new_zeros((T, B, 0)))
    dw_ih = torch.einsum("dtbg,tbe->dge", d, x)
    hp = prev_states(hs_f, hs_b).float()
    G = groups
    dw_hh = torch.einsum(
        "dtnbg,dtnbh->dngh",
        d.reshape(2, T, G, B // G, -1), hp.reshape(2, T, G, B // G, -1),
    )
    return dw_ih, dw_hh


def bidir_layer_bwd(
    x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
    dyf, dyb, dhn, dcn, compute_dtype,
) -> Tuple[Streams, Streams, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole plain layer backward, ``bidir_layer_sweep`` then
    ``bidir_layer_wgrad``, with the contract of the TPU kernel row 2:
    ``(dxf, dxb, dW_ih (2,4H,E), dW_hh (2,G,4H,H), dbias (2,4H))``."""
    dxf, dxb, dgc, dbias = bidir_layer_sweep(
        x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
        dyf, dyb, dhn, dcn, compute_dtype,
    )
    dw_ih, dw_hh = bidir_layer_wgrad(dgc, x_parts, hs_f, hs_b, grouped_w_hh(w_hh).shape[1])
    return dxf, dxb, dw_ih, dw_hh, dbias


def stack_layer_weights(
    lp: LayerParams, compute_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel operands of one layer: ``w_ih``/``w_hh`` in the compute dtype
    and the f32 bias ``b_ih + b_hh``, all direction-stacked and contiguous."""
    return (
        lp["w_ih"].to(compute_dtype).contiguous(),
        lp["w_hh"].to(compute_dtype).contiguous(),
        (lp["b_ih"].float() + lp["b_hh"].float()).contiguous(),
    )


def bidir_layer_recurrence(
    lp: LayerParams, x: torch.Tensor, lengths: torch.Tensor, compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bidirectional layer over the time-major recurrence op
    (`intrepppid_tpu/ops/lstm.py:87-180 _bidir_layer`): the input projection
    of both directions in PyTorch (compute-dtype operands, f32 sums, plus
    the f32 bias), direction 1 flipped in time, ``valid`` from the lengths,
    ``fused_lstm_recurrence``, then the un-flip and the 2H concat.
    Gradients reach ``w_ih``, the biases and ``x`` through autograd around
    the op.

    :param x: ``(B, T, E)``; ``lengths`` ``(B,)``.
    :returns: ``(y (B, T, 2H) f32, hn (2, B, H), cn (2, B, H))``.
    """
    from intrepppid_tpu_torch.ops.lstm_recurrence import fused_lstm_recurrence

    B, T, _ = x.shape
    w_hh = grouped_w_hh(lp["w_hh"])
    G = _check_groups(B, w_hh)
    bias = lp["b_ih"].float() + lp["b_hh"].float()
    # (T, 2, B, E): direction 1 reads time reversed
    xt = torch.stack([x, x.flip(1)]).permute(2, 0, 1, 3)
    w_ih_t = _operand(lp["w_ih"], compute_dtype).transpose(-1, -2)  # (2, E, 4H)
    xg = torch.matmul(_operand(xt, compute_dtype), w_ih_t) + bias[None, :, None, :]
    valid = _valid(T, lengths, x.device).squeeze(-1)
    w = w_hh.to(compute_dtype).transpose(-1, -2).contiguous()  # (2, G, H, 4H)
    hs, hn, cn = fused_lstm_recurrence(xg.contiguous(), valid, w, G, compute_dtype)
    y = torch.cat([hs[:, 0].transpose(0, 1), hs[:, 1].transpose(0, 1).flip(1)], dim=-1)
    return y, hn, cn


def bilstm(
    layers: List[LayerParams],
    x: torch.Tensor,
    max_len: Optional[Union[torch.Tensor, int]] = None,
    compute_dtype: torch.dtype = torch.float32,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the stacked bidirectional LSTM.

    :param layers: one mapping per layer with direction-stacked tensors
        ``w_ih (2, 4H, in)``, ``w_hh (2, 4H, H)`` or ``(2, G, 4H, H)``,
        ``b_ih``/``b_hh (2, 4H)``.
    :param x: embedded input ``(B, T, E)``.
    :param max_len: a scalar or a per-row ``(B,)`` vector of lengths;
        ``None`` runs the full window.
    :returns: ``(y (B, T, 2H), hn (2L, B, H), cn (2L, B, H))`` with ``hn`` in
        torch order ``[l0_fwd, l0_bwd, l1_fwd, l1_bwd, ...]``.

    :param backend: ``"layer"``, ``"recurrence"`` or ``"auto"`` (the module
        global ``DEFAULT_BACKEND``, which defaults to "auto": the layer
        kernels up to 288 units a layer, the recurrence op past that;
        ``resolve_backend``).

    On the layer backend, with grad mode on and any operand requiring grad,
    the stack runs as one ``BiLSTMStack`` autograd unit
    (``ops/lstm_stack.py``); otherwise as the eval forward, layer by layer,
    each on the route its shapes give it (``lstm_cuda.layer_route``). On the
    recurrence backend each layer is ``bidir_layer_recurrence``, and ``y``
    is f32.
    """
    from intrepppid_tpu_torch.ops.lstm_cuda import layer_fwd
    from intrepppid_tpu_torch.ops.lstm_stack import bilstm_stack

    B, T, _ = x.shape
    if max_len is None:
        max_len = T
    lengths = torch.as_tensor(max_len, dtype=torch.int32, device=x.device)
    lengths = lengths.broadcast_to((B,)).contiguous()
    widest = max((lp["w_hh"].shape[-1] for lp in layers), default=None)
    if resolve_backend(backend, widest) == "recurrence":
        y, hns, cns = x, [], []
        for lp in layers:
            y, hn, cn = bidir_layer_recurrence(lp, y, lengths, compute_dtype)
            hns.append(hn)
            cns.append(cn)
        return y, torch.cat(hns), torch.cat(cns)
    x_tm = x.to(compute_dtype).transpose(0, 1).contiguous()
    operands = [x] + [t for lp in layers for t in lp.values()]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        hs_f, hs_b, hn, cn = bilstm_stack(layers, x_tm, lengths, compute_dtype)
        y = torch.cat([hs_f, hs_b], dim=-1).transpose(0, 1)
        return y, hn, cn
    parts: Tuple[torch.Tensor, ...] = (x_tm,)
    hns, cns = [], []
    for lp in layers:
        w_ih, w_hh, bias = stack_layer_weights(lp, compute_dtype)
        hs_f, hs_b, hn, cn = layer_fwd(parts, lengths, w_ih, w_hh, bias, compute_dtype)
        parts = (hs_f, hs_b)
        hns.append(hn)
        cns.append(cn)
    y = torch.cat(parts, dim=-1).transpose(0, 1)
    return y, torch.cat(hns), torch.cat(cns)
