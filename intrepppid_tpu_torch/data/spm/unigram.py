"""Pure-Python unigram-LM tokeniser engine (SentencePiece-compatible).

Implements the two encode modes the reference uses
(`intrepppid/data/ppi_oma.py:375`):

* deterministic Viterbi segmentation (``enable_sampling=False`` — val/test),
* subword-regularised sampling with ``alpha`` (inverse temperature) over the
  full lattice (``enable_sampling=True, alpha=0.1, nbest_size=-1`` — train),
  via forward-filtering / backward-sampling, exactly the algorithm
  SentencePiece's ``Lattice::Sample`` uses (Kudo 2018, arXiv:1804.10959).

Unknown characters map to the model's ``unk_id`` with the SentencePiece
unknown penalty (score = min_piece_score - 10.0). CONTROL/UNUSED pieces are
never matched in text. BYTE pieces are never matched either, but when the
model defines them (``byte_fallback=true`` models carry all 256), an
out-of-vocabulary character encodes to the BYTE pieces of its UTF-8 bytes
instead of ``unk_id`` — SentencePiece substitutes at output time, after
the lattice search, and so do we (sentencepiece
``SentencePieceProcessor``-level byte fallback). A char whose bytes are
not all present stays ``unk_id``.

Normalisation: when the model carries a ``precompiled_charsmap``, its
compiled rewrite rules are applied exactly (darts-clone double-array
longest-prefix over bytes — ``data/spm/charsmap.py``, validated against
the HF Rust ``Precompiled`` normalizer). Without one, the common specs
are approximated by name: for ``nmt_nfkc``/``nmt_nfkc_cf`` the NMT
override rules from sentencepiece's ``Builder::BuildNmtNFKCMap``
(control chars removed, exotic whitespace to ASCII space) are applied
before NFKC (+casefold for ``_cf``); other non-identity specs get plain
NFKC. Identity on amino acid sequences, the domain of this framework.

This is the reference implementation and test oracle; the C++ engine in
``intrepppid_tpu_torch/native`` is the production path (same algorithms).
"""
from __future__ import annotations

import math
import unicodedata
from typing import List, Optional

import numpy as np

from intrepppid_tpu_torch.data.spm.proto import (
    BYTE,
    CONTROL,
    UNUSED,
    SpmModel,
    load_model,
)

_WS = "▁"  # ▁
_UNK_PENALTY = 10.0

# NMT normalization overrides from sentencepiece Builder::BuildNmtNFKCMap
# (builder.cc): applied to source characters BEFORE NFKC, like the compiled
# charsmap where these entries replace the NFKC-derived ones.
_NMT_TO_SPACE = frozenset([
    0x0009, 0x000A, 0x000C, 0x000D,  # tab, LF, FF, CR
    0x1680,                          # ogham space mark
    0x200B, 0x200C, 0x200D,          # zero-width space / non-joiner / joiner
    0x200E, 0x200F,                  # LTR / RTL marks
    0x2028, 0x2029,                  # line / paragraph separator
    0x2581,                          # lower one-eighth block (spm's meta char)
    0xFEFF, 0xFFFD,                  # BOM, replacement char
])
_NMT_REMOVE = frozenset(
    list(range(0x0001, 0x0009)) + [0x000B]
    + list(range(0x000E, 0x0020)) + [0x007F, 0x008F, 0x009F]
)


class UnigramTokenizer:
    def __init__(self, model: SpmModel):
        self.model = model
        self.pieces = model.pieces
        self.unk_id = model.unk_id
        self.bos_id = model.bos_id
        self.eos_id = model.eos_id
        self.pad_id = model.pad_id
        self._rng = np.random.default_rng()
        self._charsmap = None  # lazy PrecompiledCharsmap (normalize())

        # byte-fallback table: UTF-8 byte value -> BYTE piece id ("<0xNN>")
        self.byte_ids: dict = {}
        for idx, p in enumerate(self.pieces):
            if (
                p.type == BYTE
                and len(p.piece) == 6
                and p.piece.startswith("<0x")
                and p.piece.endswith(">")
                # malformed hex (e.g. "<0xZZ>") is ignored, not fatal —
                # mirrors the native engine's hex-validity guard
                and all(c in "0123456789abcdefABCDEF" for c in p.piece[3:5])
            ):
                self.byte_ids[int(p.piece[3:5], 16)] = idx

        # char-keyed nested-dict trie: node = {char: node, 0: (id, score)}
        self.trie: dict = {}
        self.max_piece_len = 1
        min_score = 0.0
        for idx, p in enumerate(self.pieces):
            if p.type in (CONTROL, UNUSED, BYTE):
                continue
            if idx == self.unk_id:
                continue
            node = self.trie
            for ch in p.piece:
                node = node.setdefault(ch, {})
            node[0] = (idx, p.score)
            self.max_piece_len = max(self.max_piece_len, len(p.piece))
            min_score = min(min_score, p.score)
        self.unk_score = min_score - _UNK_PENALTY

    @classmethod
    def from_file(cls, path) -> "UnigramTokenizer":
        return cls(load_model(path))

    # ------------------------------------------------------------ normalise
    def _get_charsmap(self):
        if self._charsmap is None:
            from intrepppid_tpu_torch.data.spm.charsmap import PrecompiledCharsmap

            self._charsmap = PrecompiledCharsmap(
                self.model.normalizer.precompiled_charsmap
            )
        return self._charsmap

    def normalize_utf8(self, text: str) -> bytes:
        """``normalize`` without the str round-trip: UTF-8 bytes out.

        The native-engine facade feeds raw bytes to C++, so on the hot
        batch path this avoids decoding and re-encoding every sequence —
        with a charsmap whose rules don't touch the text (amino-acid
        sequences), it is one numpy screen over the encoded bytes."""
        spec = self.model.normalizer
        if spec.precompiled_charsmap and not (
            spec.remove_extra_whitespaces
            or spec.add_dummy_prefix
            or spec.escape_whitespaces
        ):
            return self._get_charsmap().normalize_bytes(text.encode("utf-8"))
        return self.normalize(text).encode("utf-8")

    def normalize_utf8_batch(self, texts, trunc_len=None):
        """Batch :meth:`normalize_utf8` with ONE vectorized charsmap
        screen over the concatenated bytes: when no byte of the whole
        batch can start a rule (every training batch, for amino-acid
        corpora), the per-sequence cost is just the UTF-8 encode."""
        spec = self.model.normalizer
        if trunc_len is not None:
            texts = [t[:trunc_len] for t in texts]
        if spec.precompiled_charsmap and not (
            spec.remove_extra_whitespaces
            or spec.add_dummy_prefix
            or spec.escape_whitespaces
        ):
            raw = [t.encode("utf-8") for t in texts]
            cm = self._get_charsmap()
            blob = b"".join(raw)
            if blob and cm._start_mask[np.frombuffer(blob, np.uint8)].any():
                raw = [cm.normalize_bytes(r) for r in raw]
            return raw
        return [self.normalize(t).encode("utf-8") for t in texts]

    def normalize(self, text: str) -> str:
        spec = self.model.normalizer
        if spec.precompiled_charsmap:
            # exact path: the model ships its compiled rewrite rules —
            # apply them (longest-prefix over bytes, sentencepiece
            # normalizer.cc) instead of approximating by spec name. The
            # compiled map already contains every rule of the named spec
            # (casefolding included for *_cf), so nothing else applies.
            text = self._get_charsmap().normalize(text)
        elif spec.name.startswith("nmt_nfkc"):
            text = "".join(
                " " if ord(c) in _NMT_TO_SPACE
                else "" if ord(c) in _NMT_REMOVE
                else c
                for c in text
            )
            text = unicodedata.normalize("NFKC", text)
            if spec.name.endswith("_cf"):
                text = text.casefold()
        elif spec.name not in ("identity",):
            text = unicodedata.normalize("NFKC", text)
        if spec.remove_extra_whitespaces:
            text = " ".join(text.split())
        if spec.add_dummy_prefix and text:
            text = " " + text
        if spec.escape_whitespaces:
            text = text.replace(" ", _WS)
        return text

    # -------------------------------------------------------------- lattice
    def _edges(self, s: str):
        """edges[i] = list of (end, piece_id, score) for matches starting at i,
        always including the single-char unknown fallback."""
        n = len(s)
        edges: List[List[tuple]] = [[] for _ in range(n)]
        for i in range(n):
            node = self.trie
            matched_single = False
            for j in range(i, min(i + self.max_piece_len, n)):
                node = node.get(s[j])
                if node is None:
                    break
                hit = node.get(0)
                if hit is not None:
                    edges[i].append((j + 1, hit[0], hit[1]))
                    if j == i:
                        matched_single = True
            if not matched_single:
                edges[i].append((i + 1, self.unk_id, self.unk_score))
        return edges

    def set_random_generator_seed(self, seed: int) -> None:
        """Equivalent of ``sentencepiece.set_random_generator_seed``
        (`intrepppid/data/ppi_oma.py:550`)."""
        self._rng = np.random.default_rng(seed)

    def encode(
        self,
        text: str,
        enable_sampling: bool = False,
        alpha: float = 0.1,
        nbest_size: int = -1,
        rng: Optional[np.random.Generator] = None,
    ) -> List[int]:
        """Tokenise ``text`` to piece ids.

        ``nbest_size`` is accepted for API parity; sampling always draws from
        the full lattice (the reference always passes ``nbest_size=-1``).
        """
        s = self.normalize(text)
        n = len(s)
        if n == 0:
            return []
        edges = self._edges(s)
        if enable_sampling:
            segs = self._sample(s, edges, alpha, rng or self._rng)
        else:
            segs = self._viterbi(s, edges)
        return self._emit(s, segs)

    def _emit(self, s: str, segs: List[tuple]) -> List[int]:
        """Segments ``(pid, start, end)`` -> ids, with SentencePiece's
        output-time byte fallback: an unk segment whose chars' UTF-8 bytes
        all have BYTE pieces becomes those byte ids instead of unk."""
        out: List[int] = []
        for pid, i, j in segs:
            if pid == self.unk_id and self.byte_ids:
                bts = s[i:j].encode("utf-8")
                ids = [self.byte_ids.get(b) for b in bts]
                if all(x is not None for x in ids):
                    out.extend(ids)
                    continue
            out.append(pid)
        return out

    def _viterbi(self, s: str, edges) -> List[tuple]:
        n = len(s)
        best = [-math.inf] * (n + 1)
        back: List[Optional[tuple]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == -math.inf:
                continue
            for end, pid, score in edges[i]:
                cand = best[i] + score
                if cand > best[end]:
                    best[end] = cand
                    back[end] = (i, pid)
        out = []
        pos = n
        while pos > 0:
            i, pid = back[pos]
            out.append((pid, i, pos))
            pos = i
        out.reverse()
        return out

    def _sample(self, s: str, edges, alpha: float, rng: np.random.Generator) -> List[tuple]:
        n = len(s)
        # forward: log-sum-exp of alpha-scaled path scores ending at i
        fwd = [-math.inf] * (n + 1)
        fwd[0] = 0.0
        incoming: List[List[tuple]] = [[] for _ in range(n + 1)]
        for i in range(n):
            for end, pid, score in edges[i]:
                incoming[end].append((i, pid, score))
        for end in range(1, n + 1):
            acc = -math.inf
            for i, pid, score in incoming[end]:
                if fwd[i] == -math.inf:
                    continue
                val = fwd[i] + alpha * score
                acc = val if acc == -math.inf else (
                    max(acc, val) + math.log1p(math.exp(-abs(acc - val)))
                )
            fwd[end] = acc
        # backward: sample incoming edge with prob ∝ exp(fwd[i] + α·score)
        out = []
        pos = n
        while pos > 0:
            cands = [
                (i, pid, fwd[i] + alpha * score)
                for i, pid, score in incoming[pos]
                if fwd[i] != -math.inf
            ]
            logz = cands[0][2]
            for _, _, lw in cands[1:]:
                logz = max(logz, lw) + math.log1p(math.exp(-abs(logz - lw)))
            probs = np.array([math.exp(lw - logz) for _, _, lw in cands])
            probs /= probs.sum()
            k = int(rng.choice(len(cands), p=probs))
            i, pid, _ = cands[k]
            out.append((pid, i, pos))
            pos = i
        out.reverse()
        return out

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx].piece

    def vocab_size(self) -> int:
        return len(self.pieces)
