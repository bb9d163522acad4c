"""The bidirectional LSTM stack as one autograd unit
(`intrepppid_tpu/ops/lstm_pallas_layer.py:1124-1283 pallas_bilstm_stack`).

``BiLSTMStack`` runs every layer's train forward on the layer's route
(``lstm_cuda.layer_fwd``: outputs plus cell streams, at the layer's padded
width and cut back to its H units) and saves the x parts, lengths,
weights, ``hs`` and ``cs`` of each layer. Its backward walks the layers top
down: each layer's sweep on the same route and its weight gradients
(``lstm_cuda.layer_bwd``: the resident sweep, or the input gates, the lite
sweep and the input-side products; then ``bilstm_wgrad``). An upper
layer's input cotangent stays unsummed: its part-0 contributions from both
directions, ``(dxf[0], dxb[0])``, become the lower layer's two ``hs_f``
cotangent streams, and ``(dxf[1], dxb[1])`` its ``hs_b`` streams, summed in
f32 inside the lower sweep (``:1255-1256``).
Only layer 0's input cotangent is summed here. The top layer's ``hs``
cotangents arrive as None when the caller reads only ``hn`` (the train step
reads ``hn[-1]``); the sweep then takes no dy stream at all.

CPU tensors run the plain forward and backward inside the same Function;
CUDA tensors run the kernels or raise (``ops/lstm_cuda.py``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from intrepppid_tpu_torch.ops.lstm import LayerParams, grouped_w_hh
from intrepppid_tpu_torch.ops.lstm_cuda import layer_bwd, layer_fwd

_PER_LAYER = 7  # saved per layer: w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b


class BiLSTMStack(torch.autograd.Function):
    """``apply(x, lengths, compute_dtype, *weights)`` with ``x (T, B, E)``
    time-major in the compute dtype, ``lengths (B,)`` int32 and, per layer,
    ``w_ih (2, 4H, E_l)``, ``w_hh (2, 4H, H)`` or ``(2, G, 4H, H)`` and the
    f32 ``bias = b_ih + b_hh (2, 4H)``, in any float dtype (cast to the
    compute dtype inside; their gradients come back in their own dtype).

    Returns ``(hs_f, hs_b)`` of the top layer ``(T, B, H)`` in the compute
    dtype and ``hn, cn (2L, B, H)`` f32 in torch order."""

    @staticmethod
    def forward(ctx, x, lengths, compute_dtype, *weights):
        ctx.set_materialize_grads(False)
        cd = compute_dtype
        parts: Tuple[torch.Tensor, ...] = (x,)
        saved: List[torch.Tensor] = []
        hns, cns, shapes = [], [], []
        for l in range(len(weights) // 3):
            w_ih, w_hh, bias = weights[3 * l:3 * l + 3]
            shapes.append(tuple(w_hh.shape))
            w_ih_c = w_ih.to(cd).contiguous()
            w_hh_c = grouped_w_hh(w_hh).to(cd).contiguous()
            b = bias.float().contiguous()
            hs_f, hs_b, hn, cn, cs_f, cs_b = layer_fwd(
                parts, lengths, w_ih_c, w_hh_c, b, cd, with_states=True
            )
            saved += [w_ih_c, w_hh_c, b, hs_f, hs_b, cs_f, cs_b]
            hns.append(hn)
            cns.append(cn)
            parts = (hs_f, hs_b)
        ctx.save_for_backward(x, lengths, *saved)
        ctx.compute_dtype = cd
        ctx.w_hh_shapes = shapes
        ctx.weight_dtypes = [w.dtype for w in weights]
        return parts[0], parts[1], torch.cat(hns), torch.cat(cns)

    @staticmethod
    def backward(ctx, g_hs_f, g_hs_b, g_hn, g_cn):
        cd = ctx.compute_dtype
        x, lengths, *saved = ctx.saved_tensors
        L = len(saved) // _PER_LAYER

        def stream(g, like):
            return (torch.zeros_like(like) if g is None else g.to(cd)).contiguous()

        top = saved[(L - 1) * _PER_LAYER:]
        if g_hs_f is None and g_hs_b is None:
            dyf: Sequence[torch.Tensor] = ()
            dyb: Sequence[torch.Tensor] = ()
        else:
            dyf, dyb = (stream(g_hs_f, top[3]),), (stream(g_hs_b, top[4]),)
        grads: List[torch.Tensor] = [None] * (3 * L)
        dx = None
        for l in reversed(range(L)):
            w_ih, w_hh, b, hs_f, hs_b, cs_f, cs_b = saved[l * _PER_LAYER:(l + 1) * _PER_LAYER]
            if l == 0:
                parts: Tuple[torch.Tensor, ...] = (x,)
            else:
                parts = tuple(saved[(l - 1) * _PER_LAYER + 3:(l - 1) * _PER_LAYER + 5])
            dhn = None if g_hn is None else g_hn[2 * l:2 * l + 2].float().contiguous()
            dcn = None if g_cn is None else g_cn[2 * l:2 * l + 2].float().contiguous()
            dxf, dxb, dw_ih, dw_hh, dbias = layer_bwd(
                parts, lengths, w_ih, w_hh, b, hs_f, hs_b, cs_f, cs_b,
                dyf, dyb, dhn, dcn, cd,
            )
            dt = ctx.weight_dtypes[3 * l:3 * l + 3]
            grads[3 * l] = dw_ih.to(dt[0])
            grads[3 * l + 1] = dw_hh.reshape(ctx.w_hh_shapes[l]).to(dt[1])
            grads[3 * l + 2] = dbias.to(dt[2])
            if l > 0:
                dyf, dyb = (dxf[0], dxb[0]), (dxf[1], dxb[1])
            else:
                dx = (dxf[0] + dxb[0]).to(x.dtype)
        return (dx, None, None, *grads)


def bilstm_stack(
    layers: List[LayerParams],
    x_tm: torch.Tensor,
    lengths: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``BiLSTMStack`` over the layers' direction-stacked parameters; the
    bias ``b_ih + b_hh`` is formed outside, so autograd hands both the same
    gradient."""
    weights: List[torch.Tensor] = []
    for lp in layers:
        weights += [lp["w_ih"], lp["w_hh"], lp["b_ih"].float() + lp["b_hh"].float()]
    return BiLSTMStack.apply(x_tm, lengths, compute_dtype, *weights)
