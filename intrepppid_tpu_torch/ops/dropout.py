"""Stochastic regularisation and the embedding lookup
(`intrepppid_tpu/ops/dropout.py:28-60, 129-156`).

* ``dropout`` — inverted dropout of activations (``nn.Dropout``);
* ``dropconnect_weight`` — per-element weight dropout (DropConnect);
* ``variational_weight`` — per-row weight dropout (variational dropout),
  which the reference keeps active at eval;
* ``embedding_dropout`` — AWD-LSTM embedding dropout: one Bernoulli mask
  over whole vocabulary rows, then the lookup.

All masks scale the kept values by ``1/(1-p)`` and are the identity at
``p == 0``, and all but the variational mask when not training. Random
bits come from an explicit ``torch.Generator`` on the tensors' device; the
JAX package's ``jax.random`` keys give other bits, so the two agree in
distribution, not bitwise. The JAX package's one-hot-GEMM ``embedding_gather`` and its VJP
were a TPU workaround; here the lookup is a plain ``F.embedding``, gathered
from the f32 table so its gradient accumulates in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _keep(shape, p: float, like: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=like.device) < (1.0 - p)


def _keep_rows(shape, p: float, like: torch.Tensor, gen: Optional[torch.Generator],
               rows: Tuple[int, int]) -> torch.Tensor:
    """The keep-mask of this process's rows of a global batch: the mask is
    drawn at the global batch's ``total`` real rows, as one process would
    draw it, and rows ``[offset, offset + B)`` are kept; filler rows past
    ``total`` keep everything (their weight is 0)."""
    offset, total = rows
    keep = _keep((total,) + tuple(shape[1:]), p, like, gen)[offset:offset + shape[0]]
    fill = shape[0] - keep.shape[0]
    if fill:
        keep = torch.cat([keep, keep.new_ones((fill,) + tuple(shape[1:]))])
    return keep


def dropout(x: torch.Tensor, p: float, train: bool,
            gen: Optional[torch.Generator] = None,
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout; the identity when ``not train`` or ``p == 0``.
    With ``rows = (offset, total)`` the rows of ``x`` are rows ``offset``
    on of a global batch of ``total`` real rows split over processes, and
    they take their rows of the mask drawn for the whole."""
    if not train or p == 0.0:
        return x
    keep = _keep(x.shape, p, x, gen) if rows is None else _keep_rows(x.shape, p, x, gen, rows)
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def dropconnect_weight(w: torch.Tensor, p: float, train: bool,
                       gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-element weight dropout (``F.dropout(raw_w, p, training=train)`` in
    the reference's ``WeightDrop``); the identity in eval."""
    return dropout(w, p, train, gen)


def variational_weight(w: torch.Tensor, p: float,
                       gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-row weight dropout (Gal & Ghahramani variational dropout): one
    keep-mask of shape ``(rows, 1)`` expanded across the columns, kept rows
    scaled by ``1/(1-p)``. Not gated on ``train``: the reference applies it
    with ``training=True`` (`intrepppid/utils/weightdrop.py:94`), so it is
    active at eval too. The identity at ``p == 0``."""
    if p == 0.0:
        return w
    return torch.where(_keep((w.shape[0], 1), p, w, gen), w / (1.0 - p), 0.0).to(w.dtype)


def embedding_lookup(
    table: torch.Tensor,
    ids: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
    padding_idx: int = 0,
) -> torch.Tensor:
    """Rows of ``table`` for ``ids`` ``(B, T)`` -> ``(B, T, E)`` in
    ``out_dtype``.

    The rows are gathered from the table as it is and then cast, which gives
    the same values as casting the table first, and keeps the table's
    gradient in its own dtype. The ``padding_idx`` row is forced to zero in
    the result even when the table's row is not zero, as it may not be in a
    converted checkpoint.
    """
    out = F.embedding(ids, table)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)


def embedding_dropout(
    table: torch.Tensor,
    ids: torch.Tensor,
    p: float,
    train: bool,
    gen: Optional[torch.Generator] = None,
    out_dtype: Optional[torch.dtype] = None,
    groups: int = 1,
    padding_idx: int = 0,
) -> torch.Tensor:
    """AWD-LSTM embedding dropout: drop whole token types.

    A keep-mask of shape ``(vocab, 1)`` over the table, kept rows scaled by
    ``1/(1-p)``, then :func:`embedding_lookup`. With ``groups > 1`` the rows
    of ``ids`` are G stacked encoder calls (group-major) and each call draws
    its own mask, as the reference re-draws it on every forward.
    """
    if not train or p == 0.0:
        return embedding_lookup(table, ids, out_dtype, padding_idx)
    V = table.shape[0]
    keep = _keep((groups, V, 1), p, table, gen)
    tables = torch.where(keep, table / (1.0 - p), 0.0).to(table.dtype)  # (G, V, E)
    B = ids.shape[0]
    # one gather over the G masked tables: call g's ids index rows g*V + id
    offsets = torch.arange(groups, device=ids.device).repeat_interleave(B // groups) * V
    out = F.embedding(ids + offsets[:, None], tables.reshape(groups * V, -1))
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
