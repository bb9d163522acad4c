"""SentencePiece-compatible tokenizer facade.

Drop-in equivalent of the ``sentencepiece.SentencePieceProcessor`` surface
the reference uses (`intrepppid/data/ppi_oma.py:313,375,377-381`,
`cli/infer.py:96`): ``encode(text, enable_sampling=, alpha=, nbest_size=)``,
``bos_id()``, ``eos_id()``, plus the module-level RNG seeding the reference
calls as ``sp.set_random_generator_seed(seed)`` (`ppi_oma.py:550`).

Backed by the native C++ engine (intrepppid_tpu_torch/native) when buildable,
else the pure-Python engine (data/spm/unigram.py). Both implement Viterbi
and full-lattice subword-regularisation sampling over SentencePiece unigram
``.model`` files. Also exposes a batch encode that pads to ``trunc_len`` in
native code — the production input-pipeline path.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from intrepppid_tpu_torch.data.spm.unigram import UnigramTokenizer
from intrepppid_tpu_torch.native import load_spm_library

_pending_seed: Optional[int] = None
_live_processors: list = []


def set_random_generator_seed(seed: int) -> None:
    """Module-level seed, parity with ``sentencepiece.set_random_generator_seed``.

    Applies to already-constructed processors and to ones constructed later.
    """
    global _pending_seed
    _pending_seed = seed
    for proc in _live_processors:
        proc.seed(seed)


class SentencePieceTokenizer:
    def __init__(self, model_file):
        model_file = str(model_file)
        self._py = UnigramTokenizer.from_file(model_file)
        self._lib = load_spm_library()
        self._handle = None
        if self._lib is not None:
            handle = self._lib.spm_load(model_file.encode())
            if handle:
                self._handle = ctypes.c_void_p(handle)
            else:
                self._lib = None
        _live_processors.append(self)
        if _pending_seed is not None:
            self.seed(_pending_seed)

    # ------------------------------------------------------------ control API
    def seed(self, seed: int) -> None:
        self._py.set_random_generator_seed(seed)
        if self._handle is not None:
            self._lib.spm_seed(self._handle, ctypes.c_uint64(seed & (2**64 - 1)))

    def set_random_generator_seed(self, seed: int) -> None:
        self.seed(seed)

    def vocab_size(self) -> int:
        return self._py.vocab_size()

    def validate_vocab_size(self, vocab_size: int) -> None:
        """Fail loudly when the model has more pieces than the embedding table.

        Token ids >= ``vocab_size`` would index past the embedding — on the
        card that is a device-side assert that poisons the CUDA context for
        the rest of the process, so it is caught here on the host.
        """
        n = self.vocab_size()
        if n > vocab_size:
            raise ValueError(
                f"sentencepiece model defines {n} pieces but vocab_size="
                f"{vocab_size}: token ids would index past the embedding "
                f"table. Pass vocab_size >= {n}."
            )

    def bos_id(self) -> int:
        return self._py.bos_id

    def eos_id(self) -> int:
        return self._py.eos_id

    def unk_id(self) -> int:
        return self._py.unk_id

    def pad_id(self) -> int:
        return self._py.pad_id

    @property
    def uses_native(self) -> bool:
        return self._handle is not None

    def lattice_cache_stats(self) -> dict:
        """Native per-sequence lattice-cache counters (all zero when the
        cache is disabled via ``INTREPPPID_TPU_LATTICE_CACHE_MB=0`` or the
        pure-Python engine is active)."""
        if self._handle is None:
            return {"entries": 0, "bytes": 0, "hits": 0, "misses": 0}
        vals = [ctypes.c_int64(0) for _ in range(4)]
        self._lib.spm_lattice_cache_stats(
            self._handle, *(ctypes.byref(v) for v in vals)
        )
        return dict(
            zip(("entries", "bytes", "hits", "misses"),
                (v.value for v in vals))
        )

    # ---------------------------------------------------------------- encode
    def encode(
        self,
        text: str,
        enable_sampling: bool = False,
        alpha: float = 0.1,
        nbest_size: int = -1,
    ) -> List[int]:
        if self._handle is not None:
            raw = self._py.normalize_utf8(text)
            max_out = len(raw) + 1
            out = (ctypes.c_int * max_out)()
            n = self._lib.spm_encode(
                self._handle, raw, len(raw), int(enable_sampling),
                ctypes.c_float(alpha), out, max_out,
            )
            if n >= 0:
                return list(out[:n])
            # fall through to python on failure
        return self._py.encode(
            text, enable_sampling=enable_sampling, alpha=alpha, nbest_size=nbest_size
        )

    def encode_batch_padded(
        self,
        texts: Sequence[str],
        trunc_len: int,
        enable_sampling: bool = False,
        alpha: float = 0.1,
        sos: bool = False,
        eos: bool = False,
        workers: int = 0,
    ) -> np.ndarray:
        """Encode many sequences into a zero-padded ``(n, trunc_len)`` int32
        array: char-truncate to ``trunc_len`` -> encode -> optional BOS/EOS ->
        token-truncate+pad — the reference's ``static_encode`` semantics
        (`intrepppid/data/ppi_oma.py:347-392`) vectorised in native code.

        ``workers`` > 1 shards the batch across that many C++ threads (the
        reference's ``DataLoader(num_workers=...)`` equivalent,
        `intrepppid/data/ppi_oma.py:611-620`). Sampling draws one RNG stream
        per sequence, derived from (seed, running sequence counter), so
        results are identical for any thread count.
        """
        n = len(texts)
        out = np.zeros((n, trunc_len), np.int32)
        if n == 0:
            return out
        if self._handle is not None and not sos and not eos:
            norm = self._py.normalize_utf8_batch(texts, trunc_len)
            blob = b"".join(norm)
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum([len(b) for b in norm], out=offsets[1:])
            rc = self._lib.spm_encode_batch(
                self._handle,
                blob,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n,
                int(enable_sampling),
                ctypes.c_float(alpha),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                trunc_len,
                max(int(workers), 1),
            )
            if rc == 0:
                return out
            out[:] = 0
        for i, t in enumerate(texts):
            toks = self.encode(t[:trunc_len], enable_sampling=enable_sampling, alpha=alpha)
            if sos:
                toks = [self.bos_id()] + toks
            if eos:
                toks = toks + [self.eos_id()]
            toks = toks[:trunc_len]
            out[i, : len(toks)] = toks
        return out


# Back-compat alias mirroring the sentencepiece class name used in the
# reference so ported user code reads naturally.
SentencePieceProcessor = SentencePieceTokenizer
