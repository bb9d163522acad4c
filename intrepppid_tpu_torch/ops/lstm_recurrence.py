"""The masked LSTM recurrence over precomputed, time-major input gates
(`intrepppid_tpu/ops/lstm_pallas.py` counterpart: ``_fwd_pallas`` /
``_bwd_pallas`` and the public ``fused_lstm_recurrence``).

The plain PyTorch versions live here, step by step as the TPU kernel bodies
``_fwd_kernel`` / ``_bwd_kernel`` compute; the CUDA kernels
(``csrc/lstm_recurrence_{fwd,bwd,wgrad}.cu``, wrappers in
``ops/lstm_cuda.py``) are held against them on the card, and CPU tensors
take them.

* ``recurrence_fwd`` — the forward: ``hs, cs, hn, cn``;
* ``recurrence_sweep`` — the reverse-time sweep with gate recompute: the
  masked f32 gate cotangents ``dxg``;
* ``recurrence_wgrad`` — ``dW = sum_s h_prev[s]^T @ dxg[s]`` per direction
  and weight group, from the rounded operands;
* ``recurrence_bwd`` — the two together, the TPU backward kernel's contract
  ``(dxg, dw)``;
* ``FusedLSTMRecurrence`` / ``fused_lstm_recurrence`` — the autograd unit
  (the JAX package's ``custom_vjp``).

The op's contract, which differs from the layer kernels' (``ops/lstm.py``):

* ``xg (T, D, B, 4H)`` f32, time-major with the directions inside time; the
  caller has already flipped the reverse direction in time, so every
  direction walks s = 0 .. T-1; gate order i, f, g, o;
* ``valid (T, D, B)`` bool or int, any pattern: a step with ``valid == 0``
  leaves h and c as they were (the mask is data, not a length);
* ``w (D, G, H, 4H)``: the recurrent weights pre-transposed, in the compute
  dtype, one matrix per direction and weight group; the batch is
  group-major and ``B % G == 0``;
* ``h`` is rounded to the compute dtype for ``h @ w``, sums are f32; ``hs``,
  ``cs``, ``hn``, ``cn`` are f32 whatever the compute dtype;
* the backward recomputes the gates from ``hs[s-1]`` and the unrounded
  ``cs[s-1]`` (zero at s = 0), adds ``dhs[s]`` to the carried ``dh``, masks
  the gate cotangents with ``valid`` and passes ``dh`` and ``dc`` through a
  frozen step unchanged; ``dxg`` is the masked f32 cotangent, unrounded; it
  and ``h_prev`` are rounded to the compute dtype for ``dh_prev`` and for
  ``dW``, whose sums are f32; ``dw`` comes back in ``w``'s dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from intrepppid_tpu_torch.ops.lstm import _operand


def _shapes(xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, G: int):
    T, D, B, H4 = xg.shape
    H = H4 // 4
    if H4 != 4 * H or tuple(w.shape) != (D, G, H, H4):
        raise ValueError(
            f"recurrence: xg {tuple(xg.shape)} needs w of shape (D, G, H, 4H) = "
            f"{(D, G, H, 4 * H)}, got {tuple(w.shape)}")
    if tuple(valid.shape) != (T, D, B):
        raise ValueError(f"recurrence: valid must be (T, D, B) = {(T, D, B)}, "
                         f"got {tuple(valid.shape)}")
    if B % G:
        raise ValueError(f"recurrence: batch {B} is not a multiple of the {G} weight groups")
    return T, D, B, H


def _gates(xg_s: torch.Tensor, h: torch.Tensor, wc: torch.Tensor, cd) -> torch.Tensor:
    """``xg_s (D, B, 4H)`` plus, per direction and group, ``round(h) @ w``."""
    D, B, H = h.shape
    G = wc.shape[1]
    return xg_s + torch.matmul(_operand(h, cd).reshape(D, G, B // G, H), wc).reshape(D, B, -1)


def recurrence_fwd(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, G: int, compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward recurrence (``lstm_pallas.py:116 _fwd_kernel``).

    :returns: ``hs, cs (T, D, B, H)`` and ``hn, cn (D, B, H)``, all f32.
    """
    T, D, B, H = _shapes(xg, valid, w, G)
    wc = _operand(w, compute_dtype)
    on = (valid != 0).unsqueeze(-1)
    h = torch.zeros(D, B, H, dtype=torch.float32, device=xg.device)
    c = torch.zeros_like(h)
    hs = torch.empty(T, D, B, H, dtype=torch.float32, device=xg.device)
    cs = torch.empty_like(hs)
    for s in range(T):
        i, f, g, o = _gates(xg[s].float(), h, wc, compute_dtype).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = torch.where(on[s], h_new, h)
        c = torch.where(on[s], c_new, c)
        hs[s] = h
        cs[s] = c
    return hs, cs, h, c


def recurrence_sweep(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: Optional[torch.Tensor], dhn: Optional[torch.Tensor], dcn: Optional[torch.Tensor],
    G: int, compute_dtype: torch.dtype,
) -> torch.Tensor:
    """The reverse-time sweep of ``lstm_pallas.py:185 _bwd_kernel`` without
    its ``dW`` sums: ``dxg (T, D, B, 4H)`` f32, zero at masked steps.
    ``dhs``, ``dhn`` and ``dcn`` may be None for zero."""
    T, D, B, H = _shapes(xg, valid, w, G)
    cd = compute_dtype
    wc = _operand(w, cd)
    wc_t = wc.transpose(-1, -2)  # (D, G, 4H, H)
    zero = torch.zeros(D, B, H, dtype=torch.float32, device=xg.device)
    dh = zero.clone() if dhn is None else dhn.float().clone()
    dc = zero.clone() if dcn is None else dcn.float().clone()
    dxg = torch.empty(T, D, B, 4 * H, dtype=torch.float32, device=xg.device)
    for s in reversed(range(T)):
        h_prev = hs[s - 1] if s else zero
        c_prev = cs[s - 1] if s else zero
        gates = _gates(xg[s].float(), h_prev, wc, cd)
        ig = torch.sigmoid(gates[..., :H])
        f = torch.sigmoid(gates[..., H:2 * H])
        gg = torch.tanh(gates[..., 2 * H:3 * H])
        o = torch.sigmoid(gates[..., 3 * H:])
        c_new = f * c_prev + ig * gg
        if dhs is not None:
            dh = dh + dhs[s].float()
        m = (valid[s] != 0).unsqueeze(-1).float()
        tc = torch.tanh(c_new)
        dc_t = dc + dh * o * (1.0 - tc * tc)
        dgates = torch.cat([
            dc_t * gg * ig * (1.0 - ig),
            dc_t * c_prev * f * (1.0 - f),
            dc_t * ig * (1.0 - gg * gg),
            dh * tc * o * (1.0 - o),
        ], dim=-1) * m
        dxg[s] = dgates
        dhp = torch.matmul(_operand(dgates, cd).reshape(D, G, B // G, 4 * H), wc_t)
        dh = dhp.reshape(D, B, H) + dh * (1.0 - m)
        dc = dc_t * f * m + dc * (1.0 - m)
    return dxg


def recurrence_wgrad(hs: torch.Tensor, dxg: torch.Tensor, G: int,
                     compute_dtype: torch.dtype) -> torch.Tensor:
    """``dw[d, g] = sum_{s >= 1, b in g} round(hs[s-1, d, b])^T (x)
    round(dxg[s, d, b])``, f32 sums: ``(D, G, H, 4H)`` f32. Step 0's
    ``h_prev`` is zero, so it adds nothing."""
    T, D, B, H = hs.shape
    hp = _operand(hs[:-1], compute_dtype).reshape(T - 1, D, G, B // G, H)
    dg = _operand(dxg[1:], compute_dtype).reshape(T - 1, D, G, B // G, 4 * H)
    return torch.einsum("tdnbh,tdnbj->dnhj", hp, dg)


def recurrence_bwd(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: Optional[torch.Tensor], dhn: Optional[torch.Tensor], dcn: Optional[torch.Tensor],
    G: int, compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole plain backward (``lstm_pallas.py:274 _bwd_pallas`` and the
    cast of ``:358``): ``(dxg (T, D, B, 4H) f32, dw (D, G, H, 4H)`` in
    ``w``'s dtype``)``."""
    dxg = recurrence_sweep(xg, valid, w, hs, cs, dhs, dhn, dcn, G, compute_dtype)
    return dxg, recurrence_wgrad(hs, dxg, G, compute_dtype).to(w.dtype)


def _padded(xg: torch.Tensor, w: torch.Tensor, H: int, Hp: int):
    """``xg (T, D, B, 4H)`` and ``w (D, G, H, 4H)`` at Hp units (the same
    tensors where Hp == H): every gate block grown by zeros, and ``w``'s h
    rows too (``lstm_cuda.pad_layer`` says why the padded units stay 0 and
    add nothing)."""
    from intrepppid_tpu_torch.ops.lstm_cuda import pad_gate_rows, pad_units

    return pad_gate_rows(xg, H, Hp, -1), pad_units(pad_gate_rows(w, H, Hp, -1), H, Hp, -2)


class FusedLSTMRecurrence(torch.autograd.Function):
    """``apply(xg, valid, w, G, compute_dtype) -> (hs, hn, cn)``: gradients
    for ``xg`` and ``w``, none for ``valid``; ``cs`` is saved for the
    backward and not returned. CPU tensors run the plain versions above,
    CUDA tensors the kernels (``ops/lstm_cuda.py``) or raise. Both run at
    ``lstm_cuda.recurrence_width(H)``: a width the kernels do not take is
    padded with zero units, and what comes back is cut to H. Past the
    card's widest (``REC_MAX_H``) a CUDA tensor raises and a CPU tensor
    runs the plain versions unpadded. On the card the forward and the sweep
    read one fragment copy of the weights (``lstm_cuda.recurrence_fragments``),
    built once here and saved for the backward, from 96 units:
    ``recurrence_mma_weights`` in bf16, ``recurrence_f32_weights`` in
    f32."""

    @staticmethod
    def forward(ctx, xg, valid, w, G, compute_dtype):
        from intrepppid_tpu_torch.ops.lstm_cuda import (
            lstm_recurrence_fwd,
            recurrence_fragments,
            recurrence_width,
        )

        ctx.set_materialize_grads(False)
        H = w.shape[-2]
        Hp = recurrence_width(H, compute_dtype, on_card=xg.is_cuda)
        xg_k, w_k = _padded(xg, w, H, Hp)
        wf = recurrence_fragments(w_k.detach(), compute_dtype) if xg.is_cuda else None
        hs, cs, hn, cn = lstm_recurrence_fwd(xg_k, valid, w_k, G, compute_dtype, wf=wf)
        ctx.save_for_backward(xg, valid, w, hs, cs)
        ctx.G, ctx.compute_dtype, ctx.wf = G, compute_dtype, wf
        if Hp == H:
            return hs, hn, cn
        return tuple(t[..., :H].contiguous() for t in (hs, hn, cn))

    @staticmethod
    def backward(ctx, dhs, dhn, dcn):
        from intrepppid_tpu_torch.ops.lstm_cuda import (
            lstm_recurrence_bwd,
            lstm_recurrence_wgrad,
            pad_units,
            unpad_gate_rows,
        )

        xg, valid, w, hs, cs = ctx.saved_tensors
        G, cd = ctx.G, ctx.compute_dtype
        H, Hp = w.shape[-2], hs.shape[-1]
        xg_k, w_k = _padded(xg, w, H, Hp)

        def f32(t):
            return None if t is None else pad_units(t.float(), H, Hp).contiguous()

        dxg = lstm_recurrence_bwd(xg_k, valid, w_k, hs, cs, f32(dhs), f32(dhn), f32(dcn), G, cd,
                                  wf=ctx.wf)
        dw = None
        if ctx.needs_input_grad[2]:
            dw = lstm_recurrence_wgrad(hs, dxg, G, cd)
            dw = unpad_gate_rows(dw, H, Hp, -1)[..., :H, :].contiguous().to(w.dtype)
        return unpad_gate_rows(dxg, H, Hp, -1), None, dw, None, None


def fused_lstm_recurrence(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, G: int = 1,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the masked LSTM recurrence over precomputed input gates.

    :param xg: ``(T, D, B, 4H)`` float32 — ``x @ W_ih^T + b`` per direction,
        with the reverse direction's time axis already flipped.
    :param valid: ``(T, D, B)`` bool or int — state-update mask per step.
    :param w: ``(D, G, H, 4H)`` — recurrent weights, pre-transposed, in
        ``compute_dtype``.
    :returns: ``(hs (T, D, B, H) f32, hn (D, B, H) f32, cn (D, B, H) f32)``.
    """
    return FusedLSTMRecurrence.apply(xg, valid, w, G, compute_dtype)
