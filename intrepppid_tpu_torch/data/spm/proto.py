"""Minimal protobuf wire-format reader/writer for SentencePiece model files.

The reference depends on the SentencePiece C++ library for tokenisation
(`intrepppid/data/ppi_oma.py:313,375`). That library is not a dependency of
this framework; instead we parse the ``.model`` protobuf directly (the
format is stable and public: sentencepiece_model.proto) and run our own
unigram engine (see unigram.py / the native C++ engine).

Only the fields needed for *encoding* are modelled:

ModelProto:
  field 1 (repeated message) pieces: SentencePiece
      field 1 (string) piece
      field 2 (float)  score
      field 3 (enum)   type  — NORMAL=1, UNKNOWN=2, CONTROL=3,
                               USER_DEFINED=4, UNUSED=5, BYTE=6
  field 2 (message) trainer_spec   — unk_id=40, bos_id=41, eos_id=42, pad_id=43
  field 3 (message) normalizer_spec — name=1, precompiled_charsmap=2,
                               add_dummy_prefix=3, remove_extra_whitespaces=4,
                               escape_whitespaces=5

Unknown fields are skipped (reader) / omitted (writer), so models produced
by real SentencePiece trainers load fine.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


@dataclass
class SentencePieceEntry:
    piece: str
    score: float
    type: int = NORMAL


@dataclass
class NormalizerSpec:
    name: str = "identity"
    add_dummy_prefix: bool = False
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    # serialized darts-clone trie + replacement blob (sentencepiece
    # normalizer_spec field 2); empty = no compiled rules
    precompiled_charsmap: bytes = b""


@dataclass
class SpmModel:
    pieces: List[SentencePieceEntry] = field(default_factory=list)
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    normalizer: NormalizerSpec = field(default_factory=NormalizerSpec)


# ---------------------------------------------------------------- wire level

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int) triples."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _parse_piece(buf: bytes) -> SentencePieceEntry:
    piece, score, ptype = "", 0.0, NORMAL
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == 2:
            piece = val.decode("utf-8")
        elif fnum == 2 and wtype == 5:
            score = struct.unpack("<f", val)[0]
        elif fnum == 3 and wtype == 0:
            ptype = val
    return SentencePieceEntry(piece, score, ptype)


def _parse_trainer_spec(buf: bytes) -> dict:
    ids = {}
    for fnum, wtype, val in _iter_fields(buf):
        if wtype == 0 and fnum in (40, 41, 42, 43):
            # these are int32; negative values are varint-encoded as 2^64-x
            if val >= 1 << 63:
                val -= 1 << 64
            ids[{40: "unk_id", 41: "bos_id", 42: "eos_id", 43: "pad_id"}[fnum]] = val
    return ids


def _parse_normalizer_spec(buf: bytes) -> NormalizerSpec:
    spec = NormalizerSpec()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == 2:
            spec.name = val.decode("utf-8")
        elif fnum == 2 and wtype == 2:
            spec.precompiled_charsmap = val
        elif fnum == 3 and wtype == 0:
            spec.add_dummy_prefix = bool(val)
        elif fnum == 4 and wtype == 0:
            spec.remove_extra_whitespaces = bool(val)
        elif fnum == 5 and wtype == 0:
            spec.escape_whitespaces = bool(val)
    return spec


def load_model(path) -> SpmModel:
    with open(path, "rb") as f:
        buf = f.read()
    return parse_model(buf)


def parse_model(buf: bytes) -> SpmModel:
    model = SpmModel()
    trainer_ids = {}
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == 2:
            model.pieces.append(_parse_piece(val))
        elif fnum == 2 and wtype == 2:
            trainer_ids = _parse_trainer_spec(val)
        elif fnum == 3 and wtype == 2:
            model.normalizer = _parse_normalizer_spec(val)

    # Special ids: prefer explicit trainer_spec values, fall back to piece
    # types (the UNKNOWN piece is the unk id; CONTROL pieces are bos/eos by
    # SentencePiece convention).
    unk = [i for i, p in enumerate(model.pieces) if p.type == UNKNOWN]
    controls = [i for i, p in enumerate(model.pieces) if p.type == CONTROL]
    model.unk_id = trainer_ids.get("unk_id", unk[0] if unk else 0)
    model.bos_id = trainer_ids.get("bos_id", controls[0] if controls else -1)
    model.eos_id = trainer_ids.get(
        "eos_id", controls[1] if len(controls) > 1 else -1
    )
    model.pad_id = trainer_ids.get("pad_id", -1)
    return model


# -------------------------------------------------------------------- writer

def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    return _write_varint((fnum << 3) | wtype) + payload


def _serialize_piece(p: SentencePieceEntry) -> bytes:
    raw = p.piece.encode("utf-8")
    body = _field(1, 2, _write_varint(len(raw)) + raw)
    body += _field(2, 5, struct.pack("<f", p.score))
    body += _field(3, 0, _write_varint(p.type))
    return body


def serialize_model(model: SpmModel) -> bytes:
    out = b""
    for p in model.pieces:
        body = _serialize_piece(p)
        out += _field(1, 2, _write_varint(len(body)) + body)
    trainer = b""
    for fnum, val in ((40, model.unk_id), (41, model.bos_id), (42, model.eos_id), (43, model.pad_id)):
        enc = val if val >= 0 else (1 << 64) + val
        trainer += _field(fnum, 0, _write_varint(enc))
    out += _field(2, 2, _write_varint(len(trainer)) + trainer)
    norm = _field(1, 2, _write_varint(len(model.normalizer.name.encode())) + model.normalizer.name.encode())
    if model.normalizer.precompiled_charsmap:
        cm = model.normalizer.precompiled_charsmap
        norm += _field(2, 2, _write_varint(len(cm)) + cm)
    norm += _field(3, 0, _write_varint(int(model.normalizer.add_dummy_prefix)))
    norm += _field(4, 0, _write_varint(int(model.normalizer.remove_extra_whitespaces)))
    norm += _field(5, 0, _write_varint(int(model.normalizer.escape_whitespaces)))
    out += _field(3, 2, _write_varint(len(norm)) + norm)
    return out


def save_model(model: SpmModel, path) -> None:
    with open(path, "wb") as f:
        f.write(serialize_model(model))
