"""Precompiled-charsmap normalization (sentencepiece parity).

A sentencepiece ``NormalizerSpec`` ships its compiled rewrite rules as
``precompiled_charsmap``: a blob laid out as

    [uint32 LE trie_size_bytes | darts-clone double-array trie | blob]

where the trie maps UTF-8 byte strings to offsets into ``blob`` of
NUL-terminated replacement strings. Normalization is a longest-prefix
rewrite over the raw byte stream: at each position the longest trie match
is substituted by its replacement; positions with no match copy one UTF-8
character unchanged (sentencepiece ``normalizer.cc::NormalizePrefix``).

The double array is darts-clone's (Yata's) unit encoding:

    label   = unit & 0x800000FF     (byte label; bit 31 poisons value units)
    has_leaf= (unit >> 8) & 1       (this node stores a value)
    offset  = (unit >> 10) << ((unit & (1 << 9)) >> 6)
    value   = unit & 0x7FFFFFFF     (at the node's label-0 slot)

and traversal XORs: ``child_pos = node_pos ^ offset ^ byte``, with the
value unit of a node at ``node_pos ^ offset``.

The reference consumes real sentencepiece models whose normalizers carry
these blobs (`intrepppid/data/ppi_oma.py:313`); this reader makes the
``.model``-compatible surface honor them exactly instead of approximating
by spec name. Validated byte-for-byte against the HF `tokenizers` Rust
``Precompiled`` normalizer on generated fixtures
(`tests/test_tokenizer_golden.py`).
"""
from __future__ import annotations

import struct

import numpy as np


def _utf8_len(b: int) -> int:
    if b < 0x80:
        return 1
    if (b >> 5) == 0x6:
        return 2
    if (b >> 4) == 0xE:
        return 3
    if (b >> 3) == 0x1E:
        return 4
    return 1


class PrecompiledCharsmap:
    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("charsmap blob too short")
        (tsize,) = struct.unpack("<I", blob[:4])
        if 4 + tsize > len(blob) or tsize % 4:
            raise ValueError("charsmap trie size out of range")
        self._units = np.frombuffer(blob[4 : 4 + tsize], dtype="<u4").astype(
            np.int64
        )
        self._norm = blob[4 + tsize :]
        # byte -> "can start a rule" mask, read off the root's transitions.
        # A position whose byte fails the trie's FIRST step can never begin
        # a match, so whole spans of such bytes copy through unchanged —
        # normalize_bytes screens with this before any per-byte Python.
        self._start_mask = np.zeros(256, dtype=bool)
        if len(self._units):
            root_off = self._offset(int(self._units[0]))
            for b in range(256):
                p = root_off ^ b
                if p < len(self._units) and (
                    int(self._units[p]) & 0x800000FF
                ) == b:
                    self._start_mask[b] = True

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def longest_match(self, data: bytes, pos: int):
        """(match_length, replacement_bytes) of the longest rule at
        ``pos``; (0, None) when no rule matches."""
        units = self._units
        n_units = len(units)
        if n_units == 0:
            return 0, None
        node_pos = self._offset(int(units[0]))
        best_len, best_val = 0, -1
        for i in range(pos, len(data)):
            c = data[i]
            node_pos ^= c
            if node_pos >= n_units:
                break
            unit = int(units[node_pos])
            if (unit & 0x800000FF) != c:
                break
            node_pos ^= self._offset(unit)
            if (unit >> 8) & 1:
                if node_pos >= n_units:
                    break
                best_len = i - pos + 1
                best_val = int(units[node_pos]) & 0x7FFFFFFF
        if best_len == 0:
            return 0, None
        end = self._norm.find(b"\0", best_val)
        if end < 0:
            end = len(self._norm)
        return best_len, self._norm[best_val:end]

    def _normalize_walk(self, data: bytes, i: int, out: bytearray) -> bytes:
        """The plain sequential walk from position ``i`` (sentencepiece
        ``normalizer.cc``): longest rule match or copy one UTF-8 char."""
        n = len(data)
        while i < n:
            ln, rep = self.longest_match(data, i)
            if ln > 0:
                out += rep
                i += ln
            else:
                # no rule: copy one UTF-8 character unchanged. A byte
                # sequence that is not valid UTF-8 is replaced by U+FFFD,
                # one byte consumed per replacement — sentencepiece's
                # normalizer.cc NormalizePrefix fallback (ADVICE r3:
                # unreachable via normalize(), but normalize_bytes is
                # public and must not pass malformed bytes through).
                cl = _utf8_len(data[i])
                if i + cl > n:
                    cl = 1
                piece = data[i : i + cl]
                if data[i] >= 0x80:
                    try:
                        piece.decode("utf-8")
                    except UnicodeDecodeError:
                        piece, cl = b"\xef\xbf\xbd", 1
                out += piece
                i += cl
        return bytes(out)

    def normalize_bytes(self, data: bytes) -> bytes:
        if not data:
            return data
        # vectorized screen: if no byte of the text can take the trie's
        # first transition, no rule can match at ANY position and the
        # sequential walk is the identity — one numpy pass instead of a
        # per-char Python loop. This is the hot case for this framework
        # (amino-acid sequences under real-world charsmaps whose rules
        # rewrite whitespace/compatibility chars).
        arr = np.frombuffer(data, dtype=np.uint8)
        if not self._start_mask[arr].any():
            if arr.max(initial=0) < 0x80:
                return data  # pure ASCII is always valid UTF-8
            try:
                data.decode("utf-8")
                return data
            except UnicodeDecodeError:
                pass  # malformed bytes: walk for the U+FFFD fallback
        return self._normalize_walk(data, 0, bytearray())

    def normalize(self, text: str) -> str:
        return self.normalize_bytes(text.encode("utf-8")).decode(
            "utf-8", errors="replace"
        )
