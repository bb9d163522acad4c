"""A zstd decoder (RFC 8878) in Python and numpy, for the port's reader of
the JAX package's orbax checkpoints (``train/orbax_read.py``): tensorstore
compresses their OCDBT nodes and their zarr chunks with zstd, and the
card's machine has no zstd package.

``decompress(data)`` decodes every frame in ``data`` (skippable frames are
skipped) and returns the concatenated content:

* raw, RLE and compressed blocks; the window and the block size limits;
* literals raw, RLE, Huffman-compressed (weights direct or FSE-compressed,
  one stream or four with the jump table) and treeless (the previous
  block's Huffman table);
* sequences in predefined, RLE, FSE and repeat modes for the literal
  lengths, offsets and match lengths, their bitstream read backwards; the
  repeat offsets from (1, 4, 8), shifted when the literal length is 0;
* the frame content size and the XXH64 content checksum, verified when the
  frame carries them.

A frame that needs a dictionary is refused, and so is any malformed input:
everything raises ``ZstdError`` (a ``ValueError``).

The bitstreams are read through ``_windows``: for each byte offset, the
64-bit little-endian word that starts there, built once with numpy, so a
read of up to 56 bits is one list lookup, a shift and a mask.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 1 << 17
PAD = 64  # zero bits below every backward bitstream (reads past its start)


class ZstdError(ValueError):
    """Malformed or unsupported zstd input."""


# ------------------------------------------------------------- bitstreams
def _windows(stream) -> list:
    """``w[i]``: the 64-bit little-endian word at byte ``i`` of eight zero
    bytes followed by ``stream`` (zero past its end)."""
    b = np.zeros(len(stream) + 16, np.uint64)
    b[8:8 + len(stream)] = np.frombuffer(stream, np.uint8)
    n = len(stream) + 8
    w = b[:n].copy()
    for k in range(1, 8):
        w |= b[k:k + n] << np.uint64(8 * k)
    return w.tolist()


def _backward_start(stream) -> int:
    """The bit position (in ``_windows`` coordinates) just below the end
    marker, the highest set bit of the last byte."""
    if not len(stream) or stream[-1] == 0:
        raise ZstdError("a backward bitstream must end in a marker bit")
    return PAD + 8 * (len(stream) - 1) + stream[-1].bit_length() - 1


class _Backward:
    """Reads a bitstream from its end toward its start; bits before the
    start read as zeros, and ``pos < PAD`` then tells the overflow."""

    __slots__ = ("w", "pos")

    def __init__(self, stream):
        self.w = _windows(stream)
        self.pos = _backward_start(stream)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        if p < 0:
            raise ZstdError("a bitstream was read far past its start")
        self.pos = p
        return (self.w[p >> 3] >> (p & 7)) & ((1 << n) - 1)


# -------------------------------------------------------------------- FSE
def _fse_header(src, pos: int, max_symbol: int, max_log: int) -> Tuple[int, list, int]:
    """An FSE table description at ``src[pos:]``: (accuracy log, normalized
    counts, position after it)."""
    val = int.from_bytes(bytes(src[pos:pos + 512]), "little")
    bit = 4
    log = (val & 15) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    norm: list = []
    while remaining > 1:
        if len(norm) > max_symbol:
            raise ZstdError("FSE table describes too many symbols")
        top = (2 * threshold - 1) - remaining
        low = (val >> bit) & (threshold - 1)
        if low < top:
            count = low
            bit += nbits - 1
        else:
            count = (val >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= top
            bit += nbits
        count -= 1  # -1: a probability below 1, counted as 1
        remaining -= -count if count < 0 else count
        norm.append(count)
        if count == 0:
            while True:
                repeat = (val >> bit) & 3
                bit += 2
                norm.extend([0] * repeat)
                if repeat != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(norm) > max_symbol + 1:
        raise ZstdError("FSE table probabilities do not sum to its size")
    end = pos + ((bit + 7) >> 3)
    if end > len(src):
        raise ZstdError("FSE table description runs past its block")
    return log, norm, end


def _fse_table(norm: list, log: int) -> Tuple[list, list, list]:
    """The decoding table of a normalized distribution: per state its
    symbol, the bits to read and the base of the next state."""
    size = 1 << log
    syms = [0] * size
    high = size - 1
    nxt = list(norm)
    for s, c in enumerate(norm):
        if c == -1:
            syms[high] = s
            high -= 1
            nxt[s] = 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            syms[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE table spread did not close")
    nbs = [0] * size
    bases = [0] * size
    for u in range(size):
        x = nxt[syms[u]]
        nxt[syms[u]] = x + 1
        nb = log - (x.bit_length() - 1)
        nbs[u] = nb
        bases[u] = (x << nb) - size
    return syms, nbs, bases


def _rle_table(symbol: int) -> Tuple[list, list, list]:
    return [symbol], [0], [0]


LL_NORM = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
           2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
ML_NORM = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
           1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
           -1, -1, -1, -1, -1]
OF_NORM = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
           -1, -1, -1, -1, -1]
# (max symbol, max accuracy log, predefined table) of LL, OF, ML
_KINDS = ((35, 9, _fse_table(LL_NORM, 6)), (31, 8, _fse_table(OF_NORM, 5)),
          (52, 9, _fse_table(ML_NORM, 6)))
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                             2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                1027, 2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


# ---------------------------------------------------------------- Huffman
def _huffman_weights_fse(src) -> list:
    """Huffman weights compressed by FSE: two states read in turns from one
    backward bitstream, until a read runs past its start."""
    log, norm, pos = _fse_header(src, 0, 255, 6)
    syms, nbs, bases = _fse_table(norm, log)
    br = _Backward(src[pos:])
    s1, s2 = br.read(log), br.read(log)
    out = []
    while len(out) < 255:
        out.append(syms[s1])
        s1 = bases[s1] + br.read(nbs[s1])
        if br.pos < PAD:
            out.append(syms[s2])
            return out
        out.append(syms[s2])
        s2 = bases[s2] + br.read(nbs[s2])
        if br.pos < PAD:
            out.append(syms[s1])
            return out
    raise ZstdError("too many Huffman weights")


def _huffman_table(blk, pos: int) -> Tuple[Tuple[list, list, int], int]:
    """A Huffman tree description at ``blk[pos:]``: ((symbol per table
    index, bits per table index, max bits), position after it)."""
    head = blk[pos]
    pos += 1
    if head < 128:
        weights = _huffman_weights_fse(blk[pos:pos + head])
        pos += head
    else:
        n = head - 127
        raw = blk[pos:pos + (n + 1) // 2]
        pos += (n + 1) // 2
        weights = [(raw[i // 2] >> 4) if i % 2 == 0 else (raw[i // 2] & 15) for i in range(n)]
    if pos > len(blk) or len(weights) > 255 or max(weights, default=0) > 11:
        raise ZstdError("malformed Huffman tree description")
    total = sum(1 << (w - 1) for w in weights if w)
    if not total:
        raise ZstdError("Huffman tree without weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        raise ZstdError("Huffman weights do not complete a tree")
    weights.append(rest.bit_length())
    w = np.asarray(weights)
    order = np.lexsort((np.arange(len(w)), w))
    order = order[w[order] > 0]
    counts = 1 << (w[order] - 1)
    syms = np.repeat(order, counts).tolist()
    bits = np.repeat(max_bits + 1 - w[order], counts).tolist()
    return (syms, bits, max_bits), pos


def _huffman_stream(stream, n: int, table, out: bytearray) -> None:
    """Decode ``n`` literals of one backward Huffman stream into ``out``;
    the stream must be consumed exactly."""
    syms, bits, max_bits = table
    w = _windows(stream)
    pos = _backward_start(stream)
    mask = (1 << max_bits) - 1
    buf = bytearray(n)
    for i in range(n):
        p = pos - max_bits
        v = (w[p >> 3] >> (p & 7)) & mask
        buf[i] = syms[v]
        pos -= bits[v]
    if pos != PAD:
        raise ZstdError("a Huffman stream was not consumed exactly")
    out += buf


# ---------------------------------------------------------------- blocks
class _FrameState:
    """What a block may take from earlier blocks of its frame."""

    __slots__ = ("huffman", "tables", "reps")

    def __init__(self):
        self.huffman = None
        self.tables = [None, None, None]  # LL, OF, ML
        self.reps = [1, 4, 8]


def _literals(blk, st: _FrameState) -> Tuple[bytes, int]:
    b0 = blk[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:  # raw or RLE
        if fmt in (0, 2):
            size, pos = b0 >> 3, 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (blk[1] << 4), 2
        else:
            size, pos = (b0 >> 4) + (blk[1] << 4) + (blk[2] << 12), 3
        if kind == 0:
            if pos + size > len(blk):
                raise ZstdError("raw literals run past their block")
            return bytes(blk[pos:pos + size]), pos + size
        return bytes([blk[pos]]) * size, pos + 1
    head_bytes = (3, 3, 4, 5)[fmt]
    h = int.from_bytes(bytes(blk[:head_bytes]), "little")
    bits = (10, 10, 14, 18)[fmt]
    regen = (h >> 4) & ((1 << bits) - 1)
    comp = (h >> (4 + bits)) & ((1 << bits) - 1)
    pos, end = head_bytes, head_bytes + comp
    if end > len(blk) or regen > BLOCK_MAX:
        raise ZstdError("compressed literals run past their block")
    if kind == 2:
        st.huffman, pos = _huffman_table(blk, pos)
    elif st.huffman is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    out = bytearray()
    if fmt == 0:
        _huffman_stream(blk[pos:end], regen, st.huffman, out)
    else:
        if pos + 6 > end:
            raise ZstdError("four literal streams without their jump table")
        s1, s2, s3 = (int.from_bytes(bytes(blk[pos + 2 * i:pos + 2 * i + 2]), "little")
                      for i in range(3))
        seg = (regen + 3) // 4
        sizes = (s1, s2, s3, end - pos - 6 - s1 - s2 - s3)
        if sizes[3] <= 0 or regen - 3 * seg < 0:
            raise ZstdError("malformed four-stream literals")
        p = pos + 6
        for i, size in enumerate(sizes):
            _huffman_stream(blk[p:p + size], seg if i < 3 else regen - 3 * seg,
                            st.huffman, out)
            p += size
    return bytes(out), end


def _sequences(blk, pos: int, st: _FrameState) -> list:
    """The block's sequences as (literal length, match length, offset),
    the repeat offsets resolved."""
    b0 = blk[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + blk[pos + 1], pos + 2
    else:
        nseq, pos = blk[pos + 1] + (blk[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != len(blk):
            raise ZstdError("bytes after an empty sequences section")
        return []
    modes = blk[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    tables = []
    for i, shift in enumerate((6, 4, 2)):
        mode = (modes >> shift) & 3
        max_symbol, max_log, predefined = _KINDS[i]
        if mode == 0:
            t = predefined
        elif mode == 1:
            if blk[pos] > max_symbol:
                raise ZstdError("RLE sequence symbol out of range")
            t = _rle_table(blk[pos])
            pos += 1
        elif mode == 2:
            log, norm, pos = _fse_header(blk, pos, max_symbol, max_log)
            t = _fse_table(norm, log)
        else:
            t = st.tables[i]
            if t is None:
                raise ZstdError("repeat mode without an earlier table")
        st.tables[i] = t
        tables.append(t)
    (ll_syms, ll_nbs, ll_bases), (of_syms, of_nbs, of_bases), (ml_syms, ml_nbs, ml_bases) = tables

    br = _Backward(blk[pos:])
    read = br.read
    ll_s, of_s, ml_s = (read(len(t[0]).bit_length() - 1) for t in tables)
    r1, r2, r3 = st.reps
    seqs = []
    for i in range(nseq):
        of_code = of_syms[of_s]
        ll_code = ll_syms[ll_s]
        ml_code = ml_syms[ml_s]
        if of_code > 31:
            raise ZstdError("offset code out of range")
        off = (1 << of_code) + read(of_code)
        ml = ML_BASE[ml_code] + read(ML_BITS[ml_code])
        ll = LL_BASE[ll_code] + read(LL_BITS[ll_code])
        if off > 3:
            off -= 3
            r1, r2, r3 = off, r1, r2
        else:
            idx = off if ll else off + 1
            if idx == 1:
                off = r1
            elif idx == 2:
                off = r2
                r1, r2 = r2, r1
            elif idx == 3:
                off = r3
                r1, r2, r3 = r3, r1, r2
            else:
                off = r1 - 1
                if off == 0:
                    raise ZstdError("a repeat offset of 0")
                r1, r2, r3 = off, r1, r2
        seqs.append((ll, ml, off))
        if i != nseq - 1:
            ll_s = ll_bases[ll_s] + read(ll_nbs[ll_s])
            ml_s = ml_bases[ml_s] + read(ml_nbs[ml_s])
            of_s = of_bases[of_s] + read(of_nbs[of_s])
    if br.pos != PAD:
        raise ZstdError("the sequence bitstream was not consumed exactly")
    st.reps = [r1, r2, r3]
    return seqs


def _compressed_block(blk, out: bytearray, st: _FrameState, frame_start: int) -> None:
    literals, pos = _literals(blk, st)
    if pos >= len(blk):
        raise ZstdError("a compressed block without its sequences section")
    lp = 0
    for ll, ml, off in _sequences(blk, pos, st):
        if lp + ll > len(literals):
            raise ZstdError("a sequence takes more literals than the block has")
        out += literals[lp:lp + ll]
        lp += ll
        start = len(out) - off
        if start < frame_start:
            raise ZstdError("an offset reaches before the frame's start")
        if off >= ml:
            out += out[start:start + ml]
        else:
            chunk = out[start:]
            out += (chunk * (ml // off + 1))[:ml]
    out += literals[lp:]


# ----------------------------------------------------------------- frames
def _frame(data, pos: int, out: bytearray) -> int:
    fhd = data[pos]
    pos += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        raise ZstdError("reserved bit set in a frame header")
    window = None
    if not single:
        wd = data[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[fhd & 3]
    if int.from_bytes(bytes(data[pos:pos + did_size]), "little"):
        raise ZstdError("frames that need a dictionary are not supported")
    pos += did_size
    fcs_size = (single, 2, 4, 8)[fcs_flag]
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(bytes(data[pos:pos + fcs_size]), "little") + (256 if fcs_size == 2 else 0)
        pos += fcs_size
    if single:
        window = fcs
    block_max = min(window, BLOCK_MAX)
    start = len(out)
    st = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("a frame ends inside a block header")
        h = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            raise ZstdError("reserved block type")
        if size > block_max:
            raise ZstdError("a block over the frame's block size limit")
        if kind == 1:
            if pos >= len(data):
                raise ZstdError("an RLE block without its byte")
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            if pos + size > len(data):
                raise ZstdError("a block runs past its data")
            if kind == 0:
                out += data[pos:pos + size]
            else:
                before = len(out)
                _compressed_block(data[pos:pos + size], out, st, start)
                if len(out) - before > block_max:
                    raise ZstdError("a block decodes past the block size limit")
            pos += size
        if last:
            break
    if fcs is not None and len(out) - start != fcs:
        raise ZstdError("frame content size mismatch")
    if fhd & 4:
        if pos + 4 > len(data):
            raise ZstdError("a frame ends before its checksum")
        want = int.from_bytes(bytes(data[pos:pos + 4]), "little")
        if xxh64(memoryview(out)[start:]) & 0xFFFFFFFF != want:
            raise ZstdError("frame content checksum mismatch")
        pos += 4
    return pos


def decompress(data) -> bytes:
    """The content of every zstd frame in ``data``, concatenated."""
    data = memoryview(bytes(data))
    out = bytearray()
    pos = 0
    if not len(data):
        raise ZstdError("no zstd frame")
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("trailing bytes after the last frame")
        magic = int.from_bytes(bytes(data[pos:pos + 4]), "little")
        if magic & SKIPPABLE_MASK == SKIPPABLE:
            pos += 8 + int.from_bytes(bytes(data[pos + 4:pos + 8]), "little")
            if pos > len(data):
                raise ZstdError("a skippable frame runs past its data")
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        try:
            pos = _frame(data, pos + 4, out)
        except IndexError as e:
            raise ZstdError("a frame ends early") from e
    return bytes(out)


# ------------------------------------------------------------------ XXH64
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M, 31) * _P1) & _M


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (zstd's content checksum is its low 32 bits)."""
    data = bytes(data)
    n = len(data)
    p = 0
    if n >= 32:
        v1, v2, v3, v4 = (seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed, (seed - _P1) & _M
        stripes = n // 32
        lanes: List[int] = np.frombuffer(data, "<u8", count=4 * stripes).tolist()
        for i in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M
        p = 32 * stripes
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h
