"""PPI/OMA dataset helpers (`intrepppid_tpu/data/ppi_oma.py` counterpart).

Only the length-bucket ladder is ported so far; the HDF5 datasets come
with the training slice.
"""
from __future__ import annotations

from typing import List


def default_buckets(trunc_len: int) -> List[int]:
    """Bucket ladder: powers of two up to trunc_len, always ending at it."""
    buckets = []
    b = 128
    while b < trunc_len:
        buckets.append(b)
        b *= 2
    buckets.append(trunc_len)
    return buckets
