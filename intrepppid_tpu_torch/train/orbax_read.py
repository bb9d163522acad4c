"""Read the JAX package's orbax checkpoint directories without JAX: the
counterpart of its ``CheckpointManager.restore``
(`intrepppid_tpu/train/checkpoint.py:108-112`).

``ocp.PyTreeCheckpointer().save`` writes a directory holding ``_METADATA``
(JSON: each leaf's key path and value type, ``use_ocdbt``, ``use_zarr3``)
and an OCDBT key-value store (``utils/ocdbt.py``) in which each leaf is a
zarr v2 array: ``<path>/.zarray`` (JSON: shape, chunks, dtype, order,
compressor, fill value) and one value a chunk, ``<path>/<i>.<j>...``
(``<path>/0`` for a 0-d array), zstd frames (``utils/zstd.py``) or raw
bytes. ``<path>`` is the leaf's key path joined by ``.``.

``restore_orbax(path)`` rebuilds the tree: dicts, lists where the key path
steps through a sequence (``opt_state.<i>``), numpy arrays, and numpy
scalars for leaves saved as Python scalars. A directory this module cannot
read (no ``_METADATA``, ``use_zarr3``, no OCDBT, a compressor, filter,
dtype or value type it does not know) raises ``refusal``'s ``ValueError``,
which names the JAX package's export.
"""
from __future__ import annotations

import itertools
import json
import math
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

import numpy as np

from intrepppid_tpu_torch.utils import zstd
from intrepppid_tpu_torch.utils.ocdbt import OcdbtStore

METADATA = "_METADATA"
ARRAY_TYPES = ("np.ndarray", "jax.Array")
SEQUENCE_KEY, DICT_KEY = 1, 2  # orbax's key types in _METADATA


def refusal(path, reason: str) -> ValueError:
    """The error for a checkpoint directory the port cannot read."""
    return ValueError(
        f"{path}: {reason}. The port reads its own checkpoint directories (a state.pt "
        "inside) and the JAX package's orbax ones (_METADATA, OCDBT, zarr v2 arrays, zstd "
        "or no compressor). Convert this one where JAX runs, with `python -m "
        f"intrepppid_tpu export torch_ckpt --checkpoint_path {path} --out_path "
        "model.ckpt`, and load the .ckpt."
    )


def is_orbax_checkpoint(path) -> bool:
    """Whether ``path`` is an orbax checkpoint directory (it holds
    ``_METADATA``), readable or not."""
    return (Path(path) / METADATA).is_file()


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):
        named = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}
        if value not in named:
            raise ValueError(f"fill value {value!r}")
        return named[value]
    return value


def read_zarr(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``, any chunk grid, C or F
    order, zstd or no compressor; chunks the store lacks take the fill
    value."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, filters "
                         f"{meta.get('filters')}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor.get('id')!r}")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{name}: order {order!r}")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as e:
        raise ValueError(f"{name}: dtype {meta['dtype']!r}") from e
    if dtype.kind not in "biuf" or dtype.fields is not None:
        raise ValueError(f"{name}: dtype {meta['dtype']!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value")), dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        raw = store.get(f"{name}/{sep.join(map(str, idx)) or '0'}")
        if raw is None:
            continue
        data = zstd.decompress(raw) if compressor is not None else raw
        if len(data) != math.prod(chunks) * dtype.itemsize:
            raise ValueError(f"{name}: a chunk of {len(data)} bytes")
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    return out


def _listify(node):
    """Dicts keyed by sequence positions -> lists, depth first."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"sequence positions {sorted(node)}")
        return [node[i] for i in range(len(node))]
    return node


def restore_orbax(path, select: Optional[Iterable[str]] = None) -> Dict[str, Any]:
    """The tree an orbax ``PyTreeCheckpointer`` saved in ``path``; with
    ``select``, only those top-level keys."""
    path = Path(path)
    if not is_orbax_checkpoint(path):
        raise refusal(path, f"not an orbax checkpoint directory (no {METADATA})")
    meta = json.loads((path / METADATA).read_text())
    if meta.get("use_zarr3"):
        raise refusal(path, "its arrays are zarr v3 (use_zarr3)")
    if not meta.get("use_ocdbt"):
        raise refusal(path, "its arrays are not in an OCDBT store (use_ocdbt false)")
    wanted = set(select) if select is not None else None
    try:
        store = OcdbtStore(path)
        tree: Dict[Any, Any] = {}
        for entry in meta["tree_metadata"].values():
            keys = entry["key_metadata"]
            if wanted is not None and keys[0]["key"] not in wanted:
                continue
            value_meta = entry["value_metadata"]
            kind = value_meta["value_type"]
            if value_meta.get("skip_deserialize") or kind not in ARRAY_TYPES + ("scalar",):
                raise ValueError(f"value type {kind!r}")
            value = read_zarr(store, ".".join(k["key"] for k in keys))
            if kind == "scalar":
                value = value[()]
            node = tree
            steps = [int(k["key"]) if k["key_type"] == SEQUENCE_KEY else k["key"] for k in keys]
            if any(k["key_type"] not in (SEQUENCE_KEY, DICT_KEY) for k in keys):
                raise ValueError(f"key types {[k['key_type'] for k in keys]}")
            for step in steps[:-1]:
                node = node.setdefault(step, {})
            node[steps[-1]] = value
    except (ValueError, KeyError) as e:
        raise refusal(path, f"unreadable ({e})") from e
    return _listify(tree)
