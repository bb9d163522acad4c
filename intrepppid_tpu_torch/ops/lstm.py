"""Bidirectional multi-layer LSTM (`intrepppid_tpu/ops/lstm.py:87-217`).

``bidir_layer`` is the plain PyTorch layer: the CPU path and the reference
that the CUDA kernel (``ops/lstm_cuda.py``) is held against on the card.
``bilstm`` runs the stack through ``lstm_cuda.bilstm_layer_fwd``, which
takes this plain layer for CPU tensors and the kernel for CUDA tensors.

Semantics, shared by both versions and by the JAX package:

* gate order i, f, g, o; torch weight layout ``w_ih (4H, in)``,
  ``w_hh (4H, H)``; the bias is ``b_ih + b_hh`` summed in f32;
* matmul operands are in the compute dtype and accumulate in f32; h and c
  are f32; the layer outputs ``hs_f``/``hs_b`` are in the compute dtype;
* a position updates the state iff ``pos < length`` for both directions:
  the reverse direction stays at zero until position ``length - 1``, rows
  of length 0 keep zero state, and outputs past the length hold the frozen
  state (zero for the reverse direction);
* the layer above takes the two directions as two feature parts, so the
  2H concat is only built for the returned ``y``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

LayerParams = Dict[str, torch.Tensor]


def bidir_layer(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bidirectional layer in plain PyTorch.

    :param x_parts: 1 or 2 time-major ``(T, B, E_i)`` tensors whose feature
        concat is the layer input.
    :param lengths: ``(B,)`` int — positions ``>= length`` freeze the state.
    :param w_ih: ``(2, 4H, E)``; ``w_hh``: ``(2, 4H, H)``; ``bias``:
        ``(2, 4H)`` f32, direction 0 forward and 1 reverse.
    :returns: ``hs_f, hs_b (T, B, H)`` in ``compute_dtype`` and
        ``hn, cn (2, B, H)`` f32.
    """
    T, B = x_parts[0].shape[:2]
    H = w_hh.shape[-1]
    dev = x_parts[0].device

    def operand(t: torch.Tensor) -> torch.Tensor:
        # round to the compute dtype, then multiply in f32: the products of
        # two bf16 values are exact in f32, so this is bf16 operands with
        # f32 accumulation
        return t.to(compute_dtype).float()

    x = torch.cat([operand(p) for p in x_parts], dim=-1)
    # hoisted input projection for both directions: (T, 2, B, 4H), with the
    # reverse direction's rows flipped in time so step s reads row s
    xg = torch.einsum("tbe,dge->tdbg", x, operand(w_ih))
    xg += bias.float()[None, :, None, :]
    xg[:, 1] = xg[:, 1].flip(0)
    w_hh_t = operand(w_hh).transpose(1, 2)  # (2, H, 4H)

    steps = torch.arange(T, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    valid = torch.stack(
        [steps[:, None] < lengths[None, :], (T - 1 - steps)[:, None] < lengths[None, :]],
        dim=1,
    ).unsqueeze(-1)  # (T, 2, B, 1)

    h = torch.zeros(2, B, H, dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    hs = torch.empty(2, T, B, H, dtype=compute_dtype, device=dev)
    for s in range(T):
        gates = xg[s] + torch.bmm(operand(h), w_hh_t)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = torch.where(valid[s], h_new, h)
        c = torch.where(valid[s], c_new, c)
        hs[0, s] = h[0]
        hs[1, T - 1 - s] = h[1]
    return hs[0], hs[1], h, c


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


def bilstm(
    layers: List[LayerParams],
    x: torch.Tensor,
    max_len: Optional[Union[torch.Tensor, int]] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the stacked bidirectional LSTM.

    :param layers: one mapping per layer with direction-stacked tensors
        ``w_ih (2, 4H, in)``, ``w_hh (2, 4H, H)``, ``b_ih``/``b_hh (2, 4H)``.
    :param x: embedded input ``(B, T, E)``.
    :param max_len: a scalar or a per-row ``(B,)`` vector of lengths;
        ``None`` runs the full window.
    :returns: ``(y (B, T, 2H), hn (2L, B, H), cn (2L, B, H))`` with ``hn`` in
        torch order ``[l0_fwd, l0_bwd, l1_fwd, l1_bwd, ...]``.
    """
    from intrepppid_tpu_torch.ops.lstm_cuda import bilstm_layer_fwd

    B, T, _ = x.shape
    if max_len is None:
        max_len = T
    lengths = torch.as_tensor(max_len, dtype=torch.int32, device=x.device)
    lengths = lengths.broadcast_to((B,)).contiguous()
    parts: Tuple[torch.Tensor, ...] = (
        x.to(compute_dtype).transpose(0, 1).contiguous(),
    )
    hns, cns = [], []
    for lp in layers:
        w_ih, w_hh, bias = stack_layer_weights(lp, compute_dtype)
        hs_f, hs_b, hn, cn = bilstm_layer_fwd(
            parts, lengths, w_ih, w_hh, bias, compute_dtype
        )
        parts = (hs_f, hs_b)
        hns.append(hn)
        cns.append(cn)
    y = torch.cat(parts, dim=-1).transpose(0, 1)
    return y, torch.cat(hns), torch.cat(cns)
