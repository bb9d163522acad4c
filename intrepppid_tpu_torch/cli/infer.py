"""Inference CLI: ``python -m intrepppid_tpu_torch infer from_csv``
(`intrepppid_tpu/cli/infer.py` counterpart).

Scores a CSV of interaction-id pairs (``itx_id,id_a,id_b``) against a FASTA
of sequences and writes ``itx_id,probability`` rows in input order. The
surface is the JAX CLI's:

* an in-memory or low-memory sequence library; low-memory mode uses LMDB
  when the ``lmdb`` package is present, else a built-in sqlite3 key-value
  store (same on-disk workflow, no extra dependency),
* an optional live UniProt REST fallback with a 1 s rate limit and a
  deleted-accession memo,
* gzip for the CSV and the FASTA,
* batched scoring: rows are grouped into ``--batch_size`` batches, bucketed
  on the token length, and the tail batch is repeat-padded to the batch
  shape; pairs whose sequences cannot be resolved are reported and skipped,
* deterministic tokenisation unless ``--sampling true``; the sequence
  library is tokenised in chunks by the native engine,
* the network is always built with ``use_projection=True``, as the
  reference does at inference.

On the card: weights come from a reference-layout ``.ckpt`` or a checkpoint
directory, the port's or the JAX package's
(``utils/convert.py:load_reference_checkpoint``), int32 ids are copied from
pinned host memory, the forward runs under ``torch.no_grad()``, and the
host writes batch k's rows while the card computes batch k+1. It runs on
``--device`` (default ``cuda``); there is no silent CPU fallback.
``--n_data_parallel N`` scores each batch on N replicas, one a card
(``serve/engine.py:score_on_replicas``), with ``--batch_size`` rounded up to
a multiple of N. The JAX CLI's ``steps_per_dispatch`` and its bit-plane
wire format answered the TPU host link and are left out.
"""
from __future__ import annotations

import csv
import gzip
import json
import os
import shutil
import sqlite3
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np


def stream_fasta(fasta_path) -> Iterator[Tuple[str, str]]:
    """``(name, sequence)`` records of a FASTA file (``.gz`` allowed)."""
    opener = gzip.open if str(fasta_path).endswith(".gz") else open
    with opener(str(fasta_path), "rt") as f:
        name, sequence = None, None
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if sequence:
                    yield name, sequence
                name = line[1:]
                sequence = ""
            elif sequence is not None:
                sequence += line
        if sequence:
            yield name, sequence


class _UniprotFetcher:
    def __init__(self):
        self.deleted = set()

    def get(self, uniprot_ac: str) -> Optional[str]:
        if uniprot_ac in self.deleted:
            print(
                f'Failed to get sequence for "{uniprot_ac}" from UniProt '
                "(it was likely deleted)"
            )
            return None
        import requests

        time.sleep(1)
        r = requests.get(f"https://rest.uniprot.org/uniprotkb/{uniprot_ac}.fasta")
        if r.status_code == 200:
            seq = "".join(line.strip() for line in r.text.split("\n")[1:])
            if not seq:
                self.deleted.add(uniprot_ac)
                return None
            print(f'Found sequence for "{uniprot_ac}" via UniProt')
            return seq
        print(f'Failed to get sequence for "{uniprot_ac}" from UniProt')
        return None


class _KVStore:
    """Key-value token cache: LMDB when available, sqlite3 otherwise."""

    def __init__(self, db_path):
        try:
            import lmdb

            self._env = lmdb.open(str(db_path))
            self._env.set_mapsize(1024**4)
            self._sqlite = None
        except ImportError:
            Path(db_path).mkdir(parents=True, exist_ok=True)
            self._env = None
            self._sqlite = sqlite3.connect(str(Path(db_path) / "seqs.sqlite3"))
            self._sqlite.execute(
                "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v TEXT)"
            )

    def put(self, key: str, value: str) -> None:
        if self._env is not None:
            with self._env.begin(write=True) as txn:
                txn.put(key.encode(), value.encode())
        else:
            self._sqlite.execute(
                "INSERT OR REPLACE INTO kv VALUES (?, ?)", (key, value)
            )
            self._sqlite.commit()

    def get(self, key: str) -> Optional[str]:
        if self._env is not None:
            with self._env.begin() as txn:
                v = txn.get(key.encode())
            return v.decode() if v is not None else None
        row = self._sqlite.execute(
            "SELECT v FROM kv WHERE k = ?", (key,)
        ).fetchone()
        return row[0] if row else None

    def close(self) -> None:
        if self._env is not None:
            self._env.close()
        if self._sqlite is not None:
            self._sqlite.close()


class Infer:
    @staticmethod
    def from_csv(
        interactions_path: Path,
        sequences_path: Path,
        weights_path: Path,
        spm_path: Path,
        out_path: Path,
        trunc_len: int = 1500,
        low_memory: bool = False,
        db_path: Optional[Path] = None,
        dont_populate_db: bool = False,
        get_from_uniprot: bool = False,
        batch_size: int = 64,
        sampling: bool = False,
        vocab_size: int = 250,
        embedding_size: int = 64,
        rnn_num_layers: int = 2,
        bi_reduce: str = "last",
        n_data_parallel: int = 1,
        device: str = "cuda",
    ):
        """Score protein pairs from a CSV (columns itx_id,id_a,id_b) using a
        FASTA sequence library; writes itx_id,probability CSV.

        ``weights_path`` is a reference-layout ``.ckpt`` (what ``python -m
        intrepppid_tpu export torch_ckpt`` writes) or a checkpoint
        directory of the port's ``Trainer.fit``. ``--device`` picks the
        card (``cuda``, ``cuda:1``) or ``cpu``."""
        import torch

        from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataset, default_buckets
        from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
        from intrepppid_tpu_torch.data.utils import repeat_pad_rows
        from intrepppid_tpu_torch.models.factory import intrepppid_network
        from intrepppid_tpu_torch.parallel import replica_devices, replicate
        from intrepppid_tpu_torch.serve.engine import score_on_replicas
        from intrepppid_tpu_torch.utils.convert import load_reference_checkpoint, load_weights
        from intrepppid_tpu_torch.utils.device import resolve_device

        # before any file is read: a machine without a card, or with fewer
        # cards than replicas, refuses here
        dev = resolve_device(device)
        n_dp = int(n_data_parallel)
        replica_devices(dev, n_dp)
        spp = SentencePieceTokenizer(spm_path)
        spp.validate_vocab_size(vocab_size)
        # The reference always builds the net with use_projection=True at
        # inference.
        net = intrepppid_network(
            0,
            vocab_size=vocab_size,
            embedding_size=embedding_size,
            rnn_num_layers=rnn_num_layers,
            bi_reduce=bi_reduce,
            use_projection=True,
            device=dev,
        ).eval()
        load_weights(net, load_reference_checkpoint(weights_path, rnn_num_layers))
        replicas = replicate(net, n_dp)
        # every batch splits evenly over the replicas
        batch_size = -(-int(batch_size) // n_dp) * n_dp

        def encode(seq: str) -> list:
            return IntrepppidDataset.static_encode(
                trunc_len, spp, seq, sampling=sampling
            ).tolist()

        def encode_stream(named_iter):
            """Tokenise a (name, seq) stream in CHUNK-sized batches through
            the native engine (C++ threads; exactly ``static_encode``'s
            deterministic semantics): the sequence-library build is the
            host-bound phase at proteome scale. Per-sequence ``encode``
            when subword sampling is opted in (``--sampling true``): the
            batch path draws per-sequence RNG streams, not the per-call
            stream."""
            if sampling or not spp.uses_native:
                for name, seq in named_iter:
                    yield name, encode(seq)
                return
            w = os.cpu_count() or 1
            names, seqs = [], []

            def flush():
                rows = spp.encode_batch_padded(seqs, trunc_len, workers=w)
                yield from zip(names, (r.tolist() for r in rows))

            CHUNK = 1024
            for name, seq in named_iter:
                names.append(name)
                seqs.append(seq)
                if len(names) >= CHUNK:
                    yield from flush()
                    names, seqs = [], []
            if names:
                yield from flush()

        uniprot = _UniprotFetcher() if get_from_uniprot else None

        # ------------------------------------------------ sequence library
        auto_db = False
        store = None
        if low_memory:
            if db_path is None:
                db_path = tempfile.mkdtemp(prefix="intrepppid_")
                auto_db = True
            store = _KVStore(db_path)
            if not dont_populate_db:
                print("Building sequence db...")
                for name, toks in encode_stream(stream_fasta(sequences_path)):
                    store.put(name, json.dumps(toks))

            def get_embed(name: str) -> Optional[np.ndarray]:
                v = store.get(name)
                if v is not None:
                    return np.array(json.loads(v), np.int32)
                if uniprot is not None:
                    seq = uniprot.get(name)
                    if seq is not None:
                        toks = encode(seq)
                        store.put(name, json.dumps(toks))
                        return np.array(toks, np.int32)
                return None

        else:
            embeddings = {}
            for name, toks in encode_stream(stream_fasta(sequences_path)):
                embeddings[name] = np.array(toks, np.int32)

            def get_embed(name: str) -> Optional[np.ndarray]:
                if name in embeddings:
                    return embeddings[name]
                if uniprot is not None:
                    seq = uniprot.get(name)
                    if seq is not None:
                        embeddings[name] = np.array(encode(seq), np.int32)
                        return embeddings[name]
                return None

        # ------------------------------------------------------ batched IO
        opener = gzip.open if str(interactions_path).endswith(".gz") else open
        mode = "rt" if str(interactions_path).endswith(".gz") else "r"
        buckets = default_buckets(trunc_len)

        def dispatch(rows_buf):
            """Enqueue one fixed-shape batch: rows bucket-padded on T and
            repeat-padded on B to exactly ``batch_size`` (the pad rows'
            outputs are dropped at write time). Returns the ids, the
            probabilities on the devices (not yet synchronised) and the
            pinned host buffers they were copied from, which must stay
            alive until they are read."""
            maxlen = 1
            for _, ea, eb in rows_buf:
                maxlen = max(maxlen, int(np.sum(ea != 0)), int(np.sum(eb != 0)))
            T = next((b for b in buckets if maxlen <= b), trunc_len)
            xa = np.stack([ea[:T] for _, ea, _ in rows_buf])
            xb = np.stack([eb[:T] for _, _, eb in rows_buf])
            if len(rows_buf) < batch_size:
                xa = repeat_pad_rows(xa, batch_size)
                xb = repeat_pad_rows(xb, batch_size)
            host = torch.from_numpy(np.stack([xa, xb]).astype(np.int32, copy=False))
            probs, hosts = score_on_replicas(replicas, host)
            return [itx_id for itx_id, _, _ in rows_buf], probs, hosts

        n_done = 0
        try:
            with open(out_path, "w", newline="") as f_out:
                writer = csv.DictWriter(f_out, fieldnames=["itx_id", "probability"])
                pending = deque()  # (ids, in-flight device probs, host buffers)

                def drain(leave: int = 0) -> None:
                    """Copy finished batches back and write their CSV rows,
                    leaving ``leave`` in flight: the host's CSV and lookup
                    work overlaps the card computing the trailing batch
                    (``.cpu()`` is the sync point). FIFO order == input
                    order, like the reference's output."""
                    nonlocal n_done
                    while len(pending) > leave:
                        ids, probs, _hosts = pending.popleft()
                        probs = np.concatenate([p.cpu().numpy() for p in probs])
                        # zip truncates the repeat-padded tail rows
                        for itx_id, p in zip(ids, probs):
                            writer.writerow({"itx_id": itx_id, "probability": float(p)})
                        n_done += len(ids)

                for rows_buf in _iter_row_batches(
                    interactions_path, get_embed, batch_size, opener, mode
                ):
                    pending.append(dispatch(rows_buf))
                    drain(leave=1)
                drain()
        finally:
            # auto-created low-memory DBs are scratch space: removed, as the
            # reference does
            if store is not None:
                store.close()
            if auto_db:
                shutil.rmtree(db_path, ignore_errors=True)
        print(f"Scored {n_done} pairs -> {out_path}")
        return n_done


def _iter_row_batches(interactions_path, get_embed, batch_size, opener, mode):
    """Stream scoreable (itx_id, embed_a, embed_b) rows in input order,
    grouped into ``batch_size`` lists (the final list may be shorter).
    Pairs with unresolvable sequences are reported and skipped, exactly
    like the reference."""
    with opener(str(interactions_path), mode) as f_in:
        reader = csv.DictReader(f_in, fieldnames=["itx_id", "id_a", "id_b"])
        buf = []
        for row in reader:
            embed_a = get_embed(row["id_a"])
            embed_b = get_embed(row["id_b"])
            if embed_a is None or embed_b is None:
                missing = [
                    rid
                    for rid, e in ((row["id_a"], embed_a), (row["id_b"], embed_b))
                    if e is None
                ]
                # str(): a short CSV row leaves id_b as None, which must
                # land in the skip report, not crash the formatting of it
                print(
                    f"Can't compute pair id: {row['itx_id']} "
                    f"(missing sequences: {', '.join(map(str, missing))})"
                )
                continue
            buf.append((row["itx_id"], embed_a, embed_b))
            if len(buf) >= batch_size:
                yield buf
                buf = []
        if buf:
            yield buf
