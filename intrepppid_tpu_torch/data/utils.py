"""Host-side batch helpers and the amino-acid fallback codec
(`intrepppid_tpu/data/utils.py` counterpart).

The codec is a 22-symbol IUPAC table with PAD = 0; the ambiguous codes
B / Z / X resolve to a random constituent amino acid. It tokenises without
a SentencePiece model (the ``sp=False`` path of ``static_encode``).
"""
from __future__ import annotations

import random
from typing import List, Optional

import numpy as np

AAS = [
    "PAD",
    "A", "R", "N", "D", "C", "Q", "E", "G", "H", "I", "L",
    "K", "M", "F", "P", "S", "T", "W", "Y", "V", "O", "U",
]
_AA_INDEX = {aa: i for i, aa in enumerate(AAS)}

WOBBLE_AAS = {
    "B": ["D", "N"],
    "Z": ["Q", "E"],
    "X": [
        "A", "R", "N", "D", "C", "Q", "E", "G", "H", "I",
        "L", "K", "M", "F", "P", "S", "T", "W", "Y", "V",
    ],
}


def get_aa_code(aa: str, rng: Optional[random.Random] = None) -> Optional[int]:
    """One amino-acid character -> its integer code; an ambiguous code
    picks uniformly among its constituents."""
    if aa in _AA_INDEX:
        return _AA_INDEX[aa]
    if aa in WOBBLE_AAS:
        choices = WOBBLE_AAS[aa]
        pick = (rng or random).randint(0, len(choices) - 1)
        return _AA_INDEX[choices[pick]]
    return None


def encode_seq(seq: str, rng: Optional[random.Random] = None) -> List[int]:
    """String of amino acids -> list of integer codes."""
    return [get_aa_code(aa, rng) for aa in seq]


def repeat_pad_rows(x: np.ndarray, size: int) -> np.ndarray:
    """Pad axis 0 up to exactly ``size`` rows by repeating the last row.

    The serving engine and the infer CLI pad a tail batch to their batch
    shape this way and drop the pad rows' outputs, so every dispatch has
    one of a few shapes."""
    pad = size - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
