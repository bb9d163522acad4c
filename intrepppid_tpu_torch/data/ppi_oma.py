"""PPI/OMA dataset helpers (`intrepppid_tpu/data/ppi_oma.py` counterpart).

The length-bucket ladder and the documented encode path are ported; the
HDF5 datasets are not (ROADMAP.md, queue A).
"""
from __future__ import annotations

from typing import List

import numpy as np


def default_buckets(trunc_len: int) -> List[int]:
    """Bucket ladder: powers of two up to trunc_len, always ending at it."""
    buckets = []
    b = 128
    while b < trunc_len:
        buckets.append(b)
        b *= 2
    buckets.append(trunc_len)
    return buckets


class IntrepppidDataset:
    """Only the static encode path so far
    (`intrepppid_tpu/data/ppi_oma.py:116-145`)."""

    @staticmethod
    def static_encode(
        trunc_len: int,
        spp,
        seq: str,
        sp: bool = True,
        pad: bool = True,
        sampling: bool = True,
        sos: bool = False,
        eos: bool = False,
    ) -> np.ndarray:
        """Token ids of ``seq``: cut to ``trunc_len`` residues, encoded with
        the SentencePiece model ``spp`` (or, with ``sp=False``, the
        amino-acid table of ``data/utils.py``), and with ``pad`` cut and
        zero-padded to ``trunc_len`` tokens."""
        seq = seq[:trunc_len]
        if sp:
            toks = spp.encode(seq, enable_sampling=sampling, alpha=0.1, nbest_size=-1)
            if sos:
                toks = [spp.bos_id()] + toks
            if eos:
                toks = toks + [spp.eos_id()]
            toks = np.array(toks, np.int64)
        else:
            from intrepppid_tpu_torch.data.utils import encode_seq

            toks = np.array(encode_seq(seq), np.int64)
        if pad:
            toks = toks[:trunc_len]
            out = np.zeros(trunc_len, np.int64)
            out[: len(toks)] = toks
            return out
        return toks
