"""Online scoring engine: pairs of protein sequences -> probabilities
(`intrepppid_tpu/serve/engine.py:54-313` counterpart).

It holds one network and tokenizer resident on the device and scores
request-time pairs:

* deterministic tokenization (subword sampling off unless ``sampling``),
* an LRU token cache keyed on the raw sequence,
* length buckets (``data/ppi_oma.py:default_buckets``) and a two-rung batch
  ladder: requests up to ``batch_size`` pairs dispatch at that shape, larger
  ones chunk at ``bulk_batch_size``; a part-full chunk is repeat-padded and
  the pad rows' outputs are sliced off,
* int32 ids copied from pinned host memory, and the sigmoid on the device,
* all chunks of a request are enqueued before any result is copied back, so
  host tokenization of chunk i+1 overlaps the device's work on chunk i.

``n_data_parallel`` N > 1 keeps one replica of the network on each of the
cards ``cuda:0`` to ``cuda:N-1`` (N replicas on the one CPU with a CPU
network; more than the machine's cards raises): each dispatch's rows split
into N contiguous shards, every shard is launched before any result is
read, and the probabilities come back in row order. No collective is
needed; each shard runs to the whole dispatch's longest lengths, so it
scores as the whole dispatch would. ``batch_size`` and ``bulk_batch_size``
round up to a multiple of N. Thread-safe: requests serialize on an
internal lock.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from intrepppid_tpu_torch.data.ppi_oma import default_buckets
from intrepppid_tpu_torch.data.utils import repeat_pad_rows
from intrepppid_tpu_torch.parallel import replicate
from intrepppid_tpu_torch.utils.convert import load_weights


def score_on_replicas(replicas: Sequence[torch.nn.Module], host: torch.Tensor
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Enqueue the pair probabilities of ``host``'s ids ``(2, B, T)`` int32,
    B a multiple of the replica count: replica i scores the i-th contiguous
    shard of rows, every shard launched before any is read, each run to the
    whole batch's longest lengths. Returns the shards' probabilities on
    their devices (not yet synchronised), in row order, and the host
    buffers they were copied from, which must stay alive until they are
    read."""
    # one replica computes the lengths from the ids it holds
    lengths = (host != 0).sum(-1).amax(-1).tolist() if len(replicas) > 1 else None
    probs, hosts = [], []
    for net, part in zip(replicas, torch.tensor_split(host, len(replicas), dim=1)):
        dev = next(net.parameters()).device
        part = part.contiguous()
        if dev.type == "cuda":
            part = part.pin_memory()
        ids = part.to(dev, non_blocking=True)
        with torch.inference_mode():
            probs.append(torch.sigmoid(net(ids[0], ids[1], gen=net.eval_generator(),
                                           group_lengths=lengths)).reshape(-1))
        hosts.append(part)
    return probs, hosts


class ScoringEngine:
    def __init__(
        self,
        net,
        params: Optional[Dict[str, torch.Tensor]],
        tokenizer,
        *,
        trunc_len: int = 1500,
        batch_size: int = 16,
        bulk_batch_size: int = 400,
        sampling: bool = False,
        token_cache_size: int = 65536,
        n_data_parallel: int = 1,
    ):
        """``net`` is the port's network on its device; ``params`` a
        ``state_dict`` to load into it, or None to serve its weights as
        they are."""
        # fail loudly if the tokenizer can emit ids past the embedding
        # table (a device-side assert on the card)
        validate = getattr(tokenizer, "validate_vocab_size", None)
        if validate is not None:
            validate(net.cfg.encoder.vocab_size)
        self.net = net.eval()
        if params is not None:
            load_weights(self.net, params)
        n_dp = int(n_data_parallel)
        self.replicas = replicate(self.net, n_dp)
        self.device = next(self.replicas[0].parameters()).device
        self.spp = tokenizer
        self.trunc_len = int(trunc_len)
        self.batch_size = int(batch_size)
        # bulk shape for >batch_size requests; 0 disables the ladder, and it
        # is never smaller than the small shape
        self.bulk_batch_size = max(int(bulk_batch_size), self.batch_size)
        if int(bulk_batch_size) <= 0:
            self.bulk_batch_size = 0
        # every dispatch splits evenly over the replicas
        self.batch_size = -(-self.batch_size // n_dp) * n_dp
        if self.bulk_batch_size:
            self.bulk_batch_size = max(-(-self.bulk_batch_size // n_dp) * n_dp, self.batch_size)
        self.n_data_parallel = n_dp
        self.sampling = bool(sampling)
        self.buckets = default_buckets(self.trunc_len)
        self._lock = threading.Lock()
        # raw sequence -> (trunc_len,) int32 token row; deterministic path only
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._cache_cap = int(token_cache_size)

    # ------------------------------------------------------------- device
    def _probs(self, xa: np.ndarray, xb: np.ndarray
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Enqueue one dispatch over the replicas (``score_on_replicas``)."""
        host = torch.from_numpy(np.stack([xa, xb]).astype(np.int32, copy=False))
        return score_on_replicas(self.replicas, host)

    # ------------------------------------------------------------ tokenize
    def _encode_many(self, seqs: Sequence[str]) -> List[np.ndarray]:
        """Token rows for ``seqs`` (each ``(trunc_len,)`` int32), via the
        LRU cache; misses are encoded in one batch."""
        workers = os.cpu_count() or 1
        if self.sampling:
            # sampling draws fresh subwords per call — never cache
            rows = self.spp.encode_batch_padded(
                list(seqs), self.trunc_len, enable_sampling=True,
                workers=workers,
            )
            return [rows[i] for i in range(len(seqs))]
        out: List[np.ndarray] = [None] * len(seqs)  # type: ignore[list-item]
        miss_seq: List[str] = []
        pending: dict = {}
        for i, s in enumerate(seqs):
            hit = self._cache.get(s)
            if hit is not None:
                self._cache.move_to_end(s)
                out[i] = hit
            elif s in pending:
                pending[s].append(i)
            else:
                pending[s] = [i]
                miss_seq.append(s)
        if miss_seq:
            rows = self.spp.encode_batch_padded(
                miss_seq, self.trunc_len, workers=workers
            )
            for s, row in zip(miss_seq, rows):
                row = np.asarray(row, np.int32)
                for i in pending[s]:
                    out[i] = row
                self._cache[s] = row
            while len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
        return out

    # -------------------------------------------------------------- reload
    def swap_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Load a new ``state_dict`` (same architecture) with zero downtime:
        it waits for an in-flight ``score_pairs`` on the engine lock and
        keeps the token cache (tokenization is model-independent)."""
        with self._lock:
            for net in self.replicas:
                load_weights(net, params)

    # ------------------------------------------------------------- preload
    def preload(self, named_seqs) -> int:
        """Warm the token cache from a ``(name, sequence)`` iterable so
        request-time tokenization is a pure cache hit; returns the number
        of sequences cached. A no-op under ``sampling``."""
        if self.sampling:
            return 0
        n = 0
        CHUNK = 1024
        buf: List[str] = []

        def flush():
            nonlocal n
            if not buf:
                return
            # the cache is shared with in-flight score_pairs calls
            with self._lock:
                self._encode_many(buf)
            n += len(buf)
            buf.clear()

        for _, seq in named_seqs:
            buf.append(seq)
            if len(buf) >= CHUNK:
                flush()
        flush()
        return n

    # -------------------------------------------------------------- warmup
    def warmup(self) -> None:
        """Run the worst-case dispatch shapes (full small batch and, with
        the ladder on, full bulk batch, at the top length bucket) once
        before serving, so no request pays the kernel build or the
        library initialisation."""
        row = np.ones((self.trunc_len,), np.int32)
        sizes = [self.batch_size]
        if self.bulk_batch_size > self.batch_size:
            sizes.append(self.bulk_batch_size)
        for b in sizes:
            xa = np.tile(row, (b, 1))
            with self._lock:
                for probs in self._probs(xa, xa)[0]:
                    probs.cpu()

    # --------------------------------------------------------------- score
    def score_pairs(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """Probabilities for ``[(seq_a, seq_b), ...]`` — float32, one per
        pair, in input order. Empty input returns an empty array."""
        if not pairs:
            return np.zeros((0,), np.float32)
        with self._lock:
            flat: List[str] = []
            for a, b in pairs:
                flat.append(a)
                flat.append(b)
            rows = self._encode_many(flat)
            in_flight = []  # (device probs, host buffers, true rows)
            bulk = self.bulk_batch_size
            lo = 0
            while lo < len(pairs):
                left = len(pairs) - lo
                B = (
                    bulk
                    if bulk > self.batch_size and left > self.batch_size
                    else self.batch_size
                )
                chunk = rows[2 * lo : 2 * (lo + B)]
                lo += B
                xa = np.stack(chunk[0::2])
                xb = np.stack(chunk[1::2])
                maxlen = max(
                    1,
                    int(np.max(np.sum(xa != 0, axis=1))),
                    int(np.max(np.sum(xb != 0, axis=1))),
                )
                T = next(
                    (t for t in self.buckets if maxlen <= t), self.trunc_len
                )
                xa, xb = xa[:, :T], xb[:, :T]
                true = xa.shape[0]
                if true < B:
                    xa = repeat_pad_rows(xa, B)
                    xb = repeat_pad_rows(xb, B)
                in_flight.append((*self._probs(xa, xb), true))
            parts = [
                np.concatenate([p.cpu().numpy() for p in dev]).astype(np.float32)[:true]
                for dev, _host, true in in_flight
            ]
        return np.concatenate(parts)
