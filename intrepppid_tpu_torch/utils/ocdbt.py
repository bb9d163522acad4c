"""A read-only OCDBT key-value store over a directory: the layout
tensorstore writes under an orbax checkpoint of the JAX package
(``train/orbax_read.py`` reads the arrays in it).

The database's ``manifest.ocdbt`` holds its configuration, a table of
data files and its versions; the newest version names the root of a
b-tree whose leaves hold the keys, each value inline or as a reference
(file, offset, length) into a data file. Every manifest and node is
``magic (u32, big-endian) | length (u64) | version (varint) | compression
(varint) | body | crc32c (u32)``, its body zstd-compressed where the
compression says so (``utils/zstd.py``); each checksum and each length
is verified, and so are the version's key, node-byte and value-byte
counts against the tree read.

Data file paths are relative to the directory (a base path, such as
``ocdbt.process_0/`` where orbax's per-process databases put their data,
then a relative one). A version, compression, manifest kind or node
height this reader does not know is refused with ``ValueError``: nothing
is guessed.

    store = OcdbtStore(path)
    store.list()          # the keys, sorted
    store.read("params.w/0.0")
"""
from __future__ import annotations

from pathlib import Path, PurePosixPath
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from intrepppid_tpu_torch.utils import zstd

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
MISSING = (1 << 64) - 1  # offset and length of an empty root
HEADER_BYTES = 12  # magic (u32, big-endian), length (u64, little-endian)
STATISTICS = ("num_keys", "num_tree_bytes", "num_indirect_value_bytes")


def _crc32c_table() -> np.ndarray:
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = np.where(c & 1, (c >> 1) ^ np.uint32(0x82F63B78), c >> 1)
    return c.astype(np.uint32)


_CRC_TABLE = _crc32c_table().tolist()


def crc32c(data) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Forward reader of a decoded body."""

    __slots__ = ("b", "pos")

    def __init__(self, b: bytes):
        self.b = b
        self.pos = 0

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.pos >= len(self.b) or shift > 63:
                raise ValueError("OCDBT: a varint runs past its data")
            byte = self.b[self.pos]
            self.pos += 1
            v |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                return v

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        return self.take(1)[0]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.b):
            raise ValueError("OCDBT: a field runs past its data")
        out = self.b[self.pos:self.pos + n]
        self.pos += n
        return out

    def end(self, what: str) -> None:
        if self.pos != len(self.b):
            raise ValueError(f"OCDBT: {len(self.b) - self.pos} bytes after the {what}")


def _decode(raw: bytes, magic: int, what: str) -> bytes:
    """The verified body of a manifest or node."""
    if len(raw) < HEADER_BYTES + 6:
        raise ValueError(f"OCDBT: the {what} is too short")
    got_magic = int.from_bytes(raw[:4], "big")
    length = int.from_bytes(raw[4:HEADER_BYTES], "little")
    if got_magic != magic:
        raise ValueError(f"OCDBT: the {what} has magic {got_magic:#010x}, not {magic:#010x}")
    if length != len(raw):
        raise ValueError(f"OCDBT: the {what} says {length} bytes, holds {len(raw)}")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"OCDBT: the {what}'s crc32c does not match")
    r = _Reader(raw[:-4])
    r.pos = HEADER_BYTES
    version = r.varint()
    if version != FORMAT_VERSION:
        raise ValueError(f"OCDBT: unknown format version {version} of the {what}")
    compression = r.varint()
    body = raw[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"OCDBT: unknown compression {compression} of the {what}")


def _data_files(r: _Reader) -> List[str]:
    """A table of data file paths (prefix-compressed, each a base path
    then a relative one), as paths relative to the database."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    paths: List[str] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev) or base[i] > prefix[i] + suffix[i]:
            raise ValueError("OCDBT: malformed data file table")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        path = prev.decode()
        if path and (path.startswith("/") or ".." in PurePosixPath(path).parts):
            raise ValueError(f"OCDBT: data file {path!r} lies outside the database")
        paths.append(path)
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """A node's prefix-compressed keys (and an interior node's subtree
    common prefix lengths)."""
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys: List[bytes] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError("OCDBT: malformed node keys")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    for i, c in enumerate(common):
        if c > len(keys[i]):
            raise ValueError("OCDBT: a subtree prefix longer than its key")
    return keys, common


Ref = Tuple[str, int, int]  # (data file, offset, length)


class OcdbtStore:
    """The newest version of the OCDBT database in ``root``."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        manifest = self.root / MANIFEST
        if not manifest.is_file():
            raise ValueError(f"OCDBT: {self.root} holds no {MANIFEST}")
        r = _Reader(_decode(manifest.read_bytes(), MANIFEST_MAGIC, "manifest"))
        self.config = self._config(r)
        files = _data_files(r)
        n = r.varint()
        cols = dict(generation=r.varints(n), height=[r.u8() for _ in range(n)],
                    file=r.varints(n), offset=r.varints(n), length=r.varints(n),
                    num_keys=r.varints(n), num_tree_bytes=r.varints(n),
                    num_indirect_value_bytes=r.varints(n),
                    commit_time=[int.from_bytes(r.take(8), "little") for _ in range(n)])
        m = r.varint()  # references to version tree nodes: older versions
        self.version_nodes = dict(
            generation=r.varints(m), file=r.varints(m), offset=r.varints(m),
            length=r.varints(m), num_generations=r.varints(m),
            commit_time=[int.from_bytes(r.take(8), "little") for _ in range(m)],
            height=[r.u8() for _ in range(m)])
        r.end("manifest")
        if not n:
            raise ValueError(f"OCDBT: {self.root} has no version")
        newest = max(range(n), key=lambda i: cols["generation"][i])
        self.version = {k: v[newest] for k, v in cols.items()}
        self._index: Dict[bytes, Union[bytes, Ref]] = {}
        self._seen = dict.fromkeys(STATISTICS, 0)
        v = self.version
        self.root_ref: Optional[Ref] = None  # None: the version is empty
        if (v["offset"], v["length"]) != (MISSING, MISSING):
            self.root_ref = (self._file(files, v["file"]), v["offset"], v["length"])
            self._walk(self.root_ref, b"", v["height"])
        for k, seen in self._seen.items():
            if seen != v[k]:
                raise ValueError(f"OCDBT: the version counts {v[k]} {k}, the tree {seen}")

    @staticmethod
    def _config(r: _Reader) -> dict:
        cfg = {"uuid": r.take(16).hex()}
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"OCDBT: manifest kind {kind} (numbered manifests) is not read")
        cfg["max_inline_value_bytes"] = r.varint()
        cfg["max_decoded_node_bytes"] = r.varint()
        cfg["version_tree_arity_log2"] = r.u8()
        method = r.varint()
        if method == 0:
            cfg["compression"] = None
        elif method == 1:
            cfg["compression"] = {"id": "zstd",
                                  "level": int.from_bytes(r.take(4), "little", signed=True)}
        else:
            raise ValueError(f"OCDBT: unknown compression method {method} in the config")
        return cfg

    @staticmethod
    def _file(files: List[str], i: int) -> str:
        if i >= len(files):
            raise ValueError(f"OCDBT: data file {i} is not in the table")
        return files[i]

    def _bytes(self, ref: Ref) -> bytes:
        path, offset, length = ref
        with open(self.root / path, "rb") as f:
            f.seek(offset)
            raw = f.read(length)
        if len(raw) != length:
            raise ValueError(f"OCDBT: {path} ends before {offset} + {length}")
        return raw

    def node(self, ref: Ref, height: int) -> dict:
        """The b-tree node at ``ref``, decoded and checked to be at
        ``height``: ``{"height", "entries"}``, a leaf entry ``{"key",
        "value"}`` (inline bytes or a reference), an interior one ``{"key",
        "subtree_common_prefix", "location", "statistics"}``. Keys are
        relative to the prefix the path from the root has gathered."""
        body = _decode(self._bytes(ref), BTREE_MAGIC, "b-tree node")
        if len(body) > self.config["max_decoded_node_bytes"]:
            raise ValueError("OCDBT: a node over the configured decoded size")
        r = _Reader(body)
        if r.u8() != height:
            raise ValueError("OCDBT: a node's height is not its parent's less one")
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        entries = []
        if height == 0:
            lengths = r.varints(n)
            kinds = r.varints(n)
            if any(k > 1 for k in kinds):
                raise ValueError("OCDBT: unknown value kind")
            indirect = [i for i, k in enumerate(kinds) if k]
            where = dict(zip(indirect, zip(r.varints(len(indirect)), r.varints(len(indirect)))))
            for i, key in enumerate(keys):
                if kinds[i]:
                    f, off = where[i]
                    value: Union[bytes, Ref] = (self._file(files, f), off, lengths[i])
                else:
                    value = r.take(lengths[i])
                entries.append({"key": key, "value": value})
            r.end("leaf node")
        else:
            cols = [r.varints(n) for _ in range(6)]
            r.end("interior node")
            for i, key in enumerate(keys):
                entries.append({
                    "key": key, "subtree_common_prefix": key[:common[i]],
                    "location": (self._file(files, cols[0][i]), cols[1][i], cols[2][i]),
                    "statistics": dict(zip(STATISTICS, (cols[3][i], cols[4][i], cols[5][i])))})
        return {"height": height, "entries": entries}

    def _walk(self, ref: Ref, prefix: bytes, height: int) -> None:
        self._seen["num_tree_bytes"] += ref[2]
        for e in self.node(ref, height)["entries"]:
            if height:
                self._walk(e["location"], prefix + e["subtree_common_prefix"], height - 1)
                continue
            if not isinstance(e["value"], bytes):
                self._seen["num_indirect_value_bytes"] += e["value"][2]
            self._seen["num_keys"] += 1
            self._index[prefix + e["key"]] = e["value"]

    def list(self) -> List[str]:
        return sorted(k.decode() for k in self._index)

    def get(self, key: str) -> Optional[bytes]:
        """The value of ``key``, or ``None`` where the store has none."""
        value = self._index.get(key.encode())
        if value is None or isinstance(value, bytes):
            return value
        return self._bytes(value)

    def read(self, key: str) -> bytes:
        value = self.get(key)
        if value is None:
            raise KeyError(key)
        return value
