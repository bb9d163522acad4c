"""Embedding lookup (`intrepppid_tpu/ops/dropout.py:129-156` counterpart).

Only the eval path is ported: embedding dropout is the identity there.
The JAX package's one-hot-GEMM ``embedding_gather`` was a TPU workaround;
here the lookup is a plain ``F.embedding``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def embedding_lookup(
    table: torch.Tensor,
    ids: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
    padding_idx: int = 0,
) -> torch.Tensor:
    """Rows of ``table`` for ``ids`` ``(B, T)`` -> ``(B, T, E)``.

    The table is cast to ``out_dtype`` before the gather, as the JAX lookup
    does. The ``padding_idx`` row is forced to zero in the result even when
    the table's row is not zero, as it may not be in a converted checkpoint.
    """
    if out_dtype is not None:
        table = table.to(out_dtype)
    out = F.embedding(ids, table)
    return out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
