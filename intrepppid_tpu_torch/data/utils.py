"""Host-side batch helpers (`intrepppid_tpu/data/utils.py` counterpart)."""
from __future__ import annotations

import numpy as np


def repeat_pad_rows(x: np.ndarray, size: int) -> np.ndarray:
    """Pad axis 0 up to exactly ``size`` rows by repeating the last row.

    The serving engine pads a tail chunk to its batch rung this way and
    slices the pad rows' outputs off, so every dispatch has one of two
    batch shapes."""
    pad = size - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
