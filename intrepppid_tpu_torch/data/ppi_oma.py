"""Quintuplet dataset and data module over INTREPPPID-format HDF5 files
(`intrepppid_tpu/data/ppi_oma.py` counterpart).

Schema (reference `docs/data.rst:22-119`): compound tables ``sequences``
(name, sequence), ``orthologs`` (ortholog_group_id, protein_id) and
``interactions/c{K}/c{K}_{split}`` (protein_id1, protein_id2,
omid_protein_id, omid_id, label). One function, :func:`read_split`, reads
them; it imports ``h5py`` in its body, so importing this module needs no
``h5py`` and building a dataset without it raises ``ImportError``.

The batches are the JAX data module's, value for value: numpy ``int32``
dicts of p1/p2/anchor/positive/negative ``(B, T_bucket)`` and label
``(B,)``. Every random stream advances as the JAX module's does:

* each split draws its orthologue members from its own
  ``random.Random``: train ``seed``, val ``seed + 1``, test ``seed + 2``;
  an item draws its positive before its negative;
* the tokenizer's sampling stream comes from ``(seed, running sequence
  counter)``, so a batch encodes the same strings in the same order (p1,
  p2, anchor, positive, negative), the ``""`` placeholders of rows whose
  anchor is missing and the ``"M"`` negatives included;
* the train order is shuffled by ``np.random.default_rng(seed + 1000 *
  (epoch + 1))``.

Under a process group of P > 1 processes (``parallel/``), process ``p``
makes its contiguous rows of every global batch (``shard_batch_rows``),
and every batch carries ``_global_rows`` (the global batch's real rows)
and, where P does not divide the batch, a ``weight`` that is 0 on the
repeated filler rows, as the JAX module's batches do. Each process's
tokenizer and orthologue streams are offset by ``1009 * process_index``;
the shuffle order is not. The JAX module pins multi-process batches to the
top length bucket, a TPU shape rule; here each process keeps its own
batch's bucket, and the trainer pads every process's token arrays to the
widest one of the step and gives each encoder call the global batch's
longest length, so a step computes what one process would on the global
batch. One process makes exactly the batches it made before.
"""
from __future__ import annotations

import random
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
from intrepppid_tpu_torch.parallel.mesh import process_count, process_index

Interaction = Tuple[str, str, str, int, bool]


def default_buckets(trunc_len: int) -> List[int]:
    """Bucket ladder: powers of two up to trunc_len, always ending at it."""
    buckets = []
    b = 128
    while b < trunc_len:
        buckets.append(b)
        b *= 2
    buckets.append(trunc_len)
    return buckets


def read_split(dataset_path, c_type: int, split: str
               ) -> Tuple[List[Interaction], Dict[str, str], Dict[int, List[str]]]:
    """One split's interactions ``(protein_id1, protein_id2,
    omid_protein_id, omid_id, label)``, every sequence by name, and the
    members of each orthologue group, in file order, from an INTREPPPID
    HDF5 file."""
    import h5py

    interactions: List[Interaction] = []
    sequences: Dict[str, str] = {}
    omid_members: Dict[int, List[str]] = defaultdict(list)
    with h5py.File(Path(dataset_path), "r") as f:
        for row in f["interactions"][f"c{c_type}"][f"c{c_type}_{split}"][:]:
            interactions.append((
                row["protein_id1"].decode("utf8"),
                row["protein_id2"].decode("utf8"),
                row["omid_protein_id"].decode("utf8"),
                int(row["omid_id"]),
                bool(row["label"]),
            ))
        for row in f["sequences"][:]:
            sequences[row["name"].decode("utf8")] = row["sequence"].decode("utf8")
        for row in f["orthologs"][:]:
            omid_members[int(row["ortholog_group_id"])].append(row["protein_id"].decode("utf8"))
    return interactions, sequences, omid_members


class IntrepppidDataset:
    """Random-access quintuplet dataset of one split (API parity with the
    reference): sampling (subword regularisation) on for train only; the
    positive is a random member of the anchor's orthologue group (at most 5
    tries, ``"M"`` when none has a sequence); a missing anchor makes anchor
    and positive fall back to p1's tokens; the negative is a random member
    of a uniformly drawn group."""

    def __init__(
        self,
        dataset_path,
        c_type: int,
        split: str,
        model_file,
        trunc_len: int = 1000,
        sos: bool = False,
        eos: bool = False,
        negative_omid: bool = False,
        seed: Optional[int] = None,
        tokenizer: Optional[SentencePieceTokenizer] = None,
    ):
        self.trunc_len = trunc_len
        self.dataset_path = Path(dataset_path)
        self.c_type = c_type
        self.split = split
        self.sampling = split not in ("test", "val")
        self.sos = sos
        self.eos = eos
        self.negative_omid = negative_omid
        self.spp = tokenizer or SentencePieceTokenizer(model_file)
        self.rng = random.Random(seed)
        self.interactions, self.sequences, self.omid_members = read_split(
            self.dataset_path, c_type, split)
        self.omid_ids = sorted(self.omid_members.keys())

    # ------------------------------------------------------------- encoding
    @staticmethod
    def static_encode(
        trunc_len: int,
        spp,
        seq: str,
        sp: bool = True,
        pad: bool = True,
        sampling: bool = True,
        sos: bool = False,
        eos: bool = False,
    ) -> np.ndarray:
        """Token ids of ``seq``: cut to ``trunc_len`` residues, encoded with
        the SentencePiece model ``spp`` (or, with ``sp=False``, the
        amino-acid table of ``data/utils.py``), and with ``pad`` cut and
        zero-padded to ``trunc_len`` tokens."""
        seq = seq[:trunc_len]
        if sp:
            toks = spp.encode(seq, enable_sampling=sampling, alpha=0.1, nbest_size=-1)
            if sos:
                toks = [spp.bos_id()] + toks
            if eos:
                toks = toks + [spp.eos_id()]
            toks = np.array(toks, np.int64)
        else:
            from intrepppid_tpu_torch.data.utils import encode_seq

            toks = np.array(encode_seq(seq), np.int64)
        if pad:
            toks = toks[:trunc_len]
            out = np.zeros(trunc_len, np.int64)
            out[: len(toks)] = toks
            return out
        return toks

    def encode(self, seq: str, sp: bool = True, pad: bool = True) -> np.ndarray:
        return self.static_encode(
            self.trunc_len, self.spp, seq, sp, pad, self.sampling, self.sos, self.eos
        )

    # ------------------------------------------------------------- sampling
    def get_omid_members(self, omid: int) -> List[str]:
        return self.omid_members.get(omid, [])

    def _pick_member_sequence(self, omid: int) -> str:
        """Random group member's sequence; <=5 tries; 'M' fallback."""
        rows = self.get_omid_members(omid)
        seq = None
        i = 0
        while seq is None and i < 5 and rows:
            member = rows[self.rng.randrange(len(rows))]
            seq = self.sequences.get(member)
            i += 1
        return seq if seq is not None else "M"

    def get_omid_member(self, omid: int) -> np.ndarray:
        return self.encode(self._pick_member_sequence(omid), sp=True, pad=True)

    def _negative_omid_id(self) -> int:
        return self.omid_ids[self.rng.randrange(len(self.omid_ids))]

    # ---------------------------------------------------------- item access
    def get_sequences_for_item(self, idx: int):
        """Raw sequence strings for one quintuplet (pre-tokenisation)."""
        p1, p2, omid_pid, omid_id, label = self.interactions[idx]
        p1_seq = self.sequences[p1]
        p2_seq = self.sequences[p2]
        anchor_seq = self.sequences.get(omid_pid)
        if anchor_seq is None:
            # missing orthologue: anchor & positive fall back to p1
            positive_seq = None
        else:
            positive_seq = self._pick_member_sequence(omid_id)
        negative_seq = (
            self._pick_member_sequence(self._negative_omid_id())
            if self.negative_omid
            else None
        )
        return p1_seq, p2_seq, anchor_seq, positive_seq, negative_seq, label

    def __getitem__(self, idx: int):
        p1_seq, p2_seq, anchor_seq, positive_seq, negative_seq, label = (
            self.get_sequences_for_item(idx)
        )
        p1 = self.encode(p1_seq)
        p2 = self.encode(p2_seq)
        if anchor_seq is None:
            anchor = p1
            positive = p1
        else:
            anchor = self.encode(anchor_seq)
            positive = self.encode(positive_seq)
        if self.negative_omid:
            negative = self.encode(negative_seq)
            return p1, p2, anchor, positive, negative, np.int64(label)
        return p1, p2, anchor, positive, np.int64(label)

    def __len__(self) -> int:
        return len(self.interactions)


def _process_info() -> Tuple[int, int]:
    """``(process_count, process_index)`` of this process's group; (1, 0)
    without one."""
    return process_count(), process_index()


def shard_batch_rows(indices, process_count: int, process_index: int):
    """This process's contiguous rows of one global batch: process ``p``
    takes rows ``[p * Bl, (p + 1) * Bl)``, ``Bl = ceil(B / P)``, so the
    slices in process order are the global batch. Every process makes the
    same number of rows: where ``B`` does not divide evenly, a short (or
    empty) slice repeats a row, and every process gets a ``weight`` vector
    (1 real, 0 repeated) that masks the repeats out of losses, gradients
    and metrics. Returns ``(local_indices, weight or None)``; the weight is
    None exactly when no process needed filler."""
    indices = np.asarray(indices)
    n = len(indices)
    bl = -(-n // process_count)
    local = indices[process_index * bl:(process_index + 1) * bl]
    if bl * process_count == n:
        return local, None
    weight = np.ones(bl, np.float32)
    weight[len(local):] = 0.0
    if len(local) < bl:
        pad_src = local[-1:] if len(local) else indices[-1:]
        local = np.concatenate([local, np.repeat(pad_src, bl - len(local))])
    return local, weight


class IntrepppidDataModule:
    """Batched quintuplet pipeline (reference `ppi_oma.py:518-643`).

    ``train_batches(epoch)`` / ``val_batches()`` / ``test_batches()`` yield
    dicts of numpy arrays: p1/p2/anchor/positive/negative ``(B, T_bucket)``
    int32 and label ``(B,)`` int32, ``T_bucket`` the smallest bucket length
    that holds the batch's longest token row. Train shuffles per epoch;
    sampling (subword regularisation + orthologue draws) re-randomises per
    epoch like the reference's per-``__getitem__`` draws. All 5 x B
    sequences of a batch tokenise in one native call over ``workers``
    threads. ``cache_eval_tokens=True`` keeps the val and test batches
    after their first pass (their tokens are deterministic, but the
    orthologue draws then stay at their first values).
    """

    def __init__(
        self,
        batch_size: int,
        dataset_path,
        c_type: int,
        trunc_len: int,
        workers: int,
        vocab_size: int,
        model_file,
        seed: int,
        sos: bool,
        eos: bool,
        negative_omid: bool = False,
        bucket_lengths: Optional[Sequence[int]] = None,
        cache_eval_tokens: bool = False,
    ):
        self.batch_size = batch_size
        self.dataset_path = dataset_path
        self.c_type = c_type
        self.trunc_len = trunc_len
        self.workers = workers
        self.vocab_size = vocab_size
        self.model_file = model_file
        self.seed = seed
        self.sos = sos
        self.eos = eos
        self.negative_omid = negative_omid
        self.buckets = sorted(bucket_lengths or default_buckets(trunc_len))
        self.cache_eval_tokens = cache_eval_tokens
        self._eval_cache: Dict[str, list] = {}

        self.tokenizer = SentencePieceTokenizer(model_file)
        self.tokenizer.validate_vocab_size(vocab_size)
        # each process's tokenizer and orthologue streams are its own (0 for
        # process 0 and alone); the shuffle order is not offset, as every
        # process must take its rows of the same global batches
        self._shard_seed_offset = 1009 * _process_info()[1]
        # sp.set_random_generator_seed parity (:550)
        self.tokenizer.seed(seed + self._shard_seed_offset)

        self.dataset_train: Optional[IntrepppidDataset] = None
        self.dataset_val: Optional[IntrepppidDataset] = None
        self.dataset_test: Optional[IntrepppidDataset] = None

    def setup(self, stage=None) -> None:
        common = dict(
            dataset_path=self.dataset_path,
            c_type=self.c_type,
            model_file=self.model_file,
            trunc_len=self.trunc_len,
            sos=self.sos,
            eos=self.eos,
            negative_omid=self.negative_omid,
            tokenizer=self.tokenizer,
        )
        off = self._shard_seed_offset
        self.dataset_train = IntrepppidDataset(split="train", seed=self.seed + off, **common)
        self.dataset_val = IntrepppidDataset(split="val", seed=self.seed + 1 + off, **common)
        self.dataset_test = IntrepppidDataset(split="test", seed=self.seed + 2 + off, **common)

    # -------------------------------------------------------------- helpers
    @property
    def steps_per_epoch(self) -> int:
        n = len(self.dataset_train)
        return (n + self.batch_size - 1) // self.batch_size

    def _bucket_len(self, longest: int) -> int:
        for b in self.buckets:
            if longest <= b:
                return b
        return self.buckets[-1]

    def _make_batch(
        self, ds: IntrepppidDataset, indices: np.ndarray, sampling: bool
    ) -> Dict[str, np.ndarray]:
        B = len(indices)
        groups = {k: [] for k in ("p1", "p2", "anchor", "positive", "negative")}
        fallback_anchor = []  # rows where anchor/positive must copy p1 tokens
        labels = np.zeros(B, np.int32)
        for j, idx in enumerate(indices):
            p1_seq, p2_seq, anchor_seq, positive_seq, negative_seq, label = (
                ds.get_sequences_for_item(int(idx))
            )
            labels[j] = int(label)
            groups["p1"].append(p1_seq)
            groups["p2"].append(p2_seq)
            if anchor_seq is None:
                fallback_anchor.append(j)
                groups["anchor"].append("")
                groups["positive"].append("")
            else:
                groups["anchor"].append(anchor_seq)
                groups["positive"].append(positive_seq)
            groups["negative"].append(negative_seq if negative_seq is not None else "M")

        all_seqs = (
            groups["p1"] + groups["p2"] + groups["anchor"] + groups["positive"]
            + groups["negative"]
        )
        toks = self.tokenizer.encode_batch_padded(
            all_seqs,
            trunc_len=self.trunc_len,
            enable_sampling=sampling,
            sos=self.sos,
            eos=self.eos,
            workers=self.workers,
        )
        # bucket on true token lengths (chars are only an upper bound)
        longest = int(np.max(np.sum(toks != 0, axis=1))) if toks.size else 1
        toks = toks[:, :self._bucket_len(max(longest, 1))]
        batch = {
            "p1": toks[0:B],
            "p2": toks[B : 2 * B],
            "anchor": toks[2 * B : 3 * B].copy(),
            "positive": toks[3 * B : 4 * B].copy(),
            "label": labels,
        }
        if self.negative_omid:
            batch["negative"] = toks[4 * B : 5 * B]
        for j in fallback_anchor:
            # reference reuses p1's *token ids* for anchor & positive (:484-487)
            batch["anchor"][j] = batch["p1"][j]
            batch["positive"][j] = batch["p1"][j]
        return batch

    def _iter_split(
        self, ds: IntrepppidDataset, shuffle: bool, sampling: bool, epoch: int,
        cache_key: Optional[str] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        n = len(ds)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(self.seed + 1000 * (epoch + 1)).shuffle(order)
        if cache_key is not None and cache_key in self._eval_cache:
            yield from self._eval_cache[cache_key]
            return
        pc, pid = _process_info()
        cache = [] if cache_key is not None else None
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            global_rows = len(idx)
            weight = None
            if pc > 1:
                idx, weight = shard_batch_rows(idx, pc, pid)
            batch = self._make_batch(ds, idx, sampling)
            if weight is not None:
                batch["weight"] = weight
            if pc > 1:
                # the global batch's real rows, the same on every process:
                # the epoch means weight each batch by them
                batch["_global_rows"] = np.int64(global_rows)
            if cache is not None:
                cache.append(batch)
            yield batch
        if cache is not None:
            self._eval_cache[cache_key] = cache

    def train_batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        return self._iter_split(self.dataset_train, shuffle=True, sampling=True, epoch=epoch)

    def train_eval_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """The train split under eval semantics: no shuffle, deterministic
        tokenisation (subword sampling off), for scoring a checkpoint on its
        training data (the eval CLI's ``--split train``)."""
        return self._iter_split(self.dataset_train, shuffle=False, sampling=False, epoch=0)

    def val_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._iter_split(
            self.dataset_val, shuffle=False, sampling=False, epoch=0,
            cache_key="val" if self.cache_eval_tokens else None,
        )

    def test_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._iter_split(
            self.dataset_test, shuffle=False, sampling=False, epoch=0,
            cache_key="test" if self.cache_eval_tokens else None,
        )
