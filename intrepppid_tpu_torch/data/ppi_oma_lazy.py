"""Lazy (per-item HDF5 access) quintuplet dataset variants
(`intrepppid_tpu/data/ppi_oma_lazy.py` counterpart, value for value).

Rebuild of the reference's second-generation classes ``IntrepppidDataset2``
/ ``IntrepppidDataModule2`` (`intrepppid/data/ppi_oma.py:30-271`), which
read rows from the HDF5 on every ``__getitem__`` instead of eager-loading —
the low-RAM option for very large corpora. Differences from the reference:

* the reference's member-retry loop has an inverted condition
  (``while len(seq) == 0 or i > 5`` — runs at most once; SURVEY.md
  Appendix A #12). Implemented here with the evidently intended semantics
  (retry while empty, up to 5 times);
* sequence lookups are indexed via an in-RAM ``name -> row`` offset map
  built once (h5py has no server-side ``read_where``); sequences stay on
  disk.
"""
from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataset
from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer


class IntrepppidDataset2:
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
        import h5py

        self.dataset_path = Path(dataset_path)
        self.c_type = c_type
        self.split = split
        self.trunc_len = trunc_len
        self.sampling = split not in ("test", "val")
        self.sos = sos
        self.eos = eos
        self.negative_omid = negative_omid
        self.spp = tokenizer or SentencePieceTokenizer(model_file)
        import random

        self.rng = random.Random(seed)

        self._h5 = h5py.File(self.dataset_path, "r")
        self._itx = self._h5["interactions"][f"c{c_type}"][f"c{c_type}_{split}"]
        # row-offset index for name-based sequence lookup (kept small: ids only)
        names = self._h5["sequences"]["name"][:]
        self._seq_row: Dict[str, int] = {
            n.decode("utf8"): i for i, n in enumerate(names)
        }
        # orthogroup membership ids only
        og = self._h5["orthologs"][:]
        from collections import defaultdict

        self.omid_members: Dict[int, List[str]] = defaultdict(list)
        for row in og:
            self.omid_members[int(row["ortholog_group_id"])].append(
                row["protein_id"].decode("utf8")
            )
        self.omid_ids = sorted(self.omid_members.keys())

    def close(self):
        self._h5.close()

    @lru_cache(maxsize=65536)
    def get_sequence(self, name: str) -> Optional[str]:
        row = self._seq_row.get(name)
        if row is None:
            return None
        return self._h5["sequences"][row]["sequence"].decode("utf8")

    def encode(self, seq: str) -> np.ndarray:
        return IntrepppidDataset.static_encode(
            self.trunc_len, self.spp, seq, True, True, self.sampling, self.sos, self.eos
        )

    def get_omid_member(self, omid: int) -> np.ndarray:
        rows = self.omid_members.get(omid, [])
        seq = None
        i = 0
        # intended retry semantics (reference loop condition is inverted,
        # Appendix A #12)
        while (seq is None or len(seq) == 0) and i < 5 and rows:
            member = rows[self.rng.randrange(len(rows))]
            seq = self.get_sequence(member)
            i += 1
        if not seq:
            seq = "M"
        return self.encode(seq)

    def __getitem__(self, idx: int):
        row = self._itx[idx]
        p1 = row["protein_id1"].decode("utf8")
        p2 = row["protein_id2"].decode("utf8")
        omid_pid = row["omid_protein_id"].decode("utf8")
        omid_id = int(row["omid_id"])
        label = bool(row["label"])

        p1_seq = self.encode(self.get_sequence(p1))
        p2_seq = self.encode(self.get_sequence(p2))
        anchor_raw = self.get_sequence(omid_pid)
        if anchor_raw is None:
            anchor = p1_seq
            positive = p1_seq
        else:
            anchor = self.encode(anchor_raw)
            positive = self.get_omid_member(omid_id)
        if self.negative_omid:
            neg_id = self.omid_ids[self.rng.randrange(len(self.omid_ids))]
            negative = self.get_omid_member(neg_id)
            return p1_seq, p2_seq, anchor, positive, negative, np.int64(label)
        return p1_seq, p2_seq, anchor, positive, np.int64(label)

    def __len__(self) -> int:
        return self._itx.shape[0]


class IntrepppidDataModule2:
    """Lazy-datamodule counterpart (`intrepppid/data/ppi_oma.py:176-271`)."""

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
    ):
        self.batch_size = batch_size
        self.kwargs = dict(
            dataset_path=dataset_path,
            c_type=c_type,
            model_file=model_file,
            trunc_len=trunc_len,
            sos=sos,
            eos=eos,
            negative_omid=negative_omid,
        )
        self.seed = seed
        self.tokenizer = SentencePieceTokenizer(model_file)
        self.tokenizer.validate_vocab_size(vocab_size)
        self.tokenizer.seed(seed)
        self.dataset_train = None
        self.dataset_val = None
        self.dataset_test = None

    def setup(self, stage=None) -> None:
        self.dataset_train = IntrepppidDataset2(
            split="train", seed=self.seed, tokenizer=self.tokenizer, **self.kwargs
        )
        self.dataset_val = IntrepppidDataset2(
            split="val", seed=self.seed + 1, tokenizer=self.tokenizer, **self.kwargs
        )
        self.dataset_test = IntrepppidDataset2(
            split="test", seed=self.seed + 2, tokenizer=self.tokenizer, **self.kwargs
        )

    def _batches(self, ds, shuffle=False, epoch=0):
        order = np.arange(len(ds))
        if shuffle:
            np.random.default_rng(self.seed + 1000 * (epoch + 1)).shuffle(order)
        for start in range(0, len(ds), self.batch_size):
            items = [ds[int(i)] for i in order[start : start + self.batch_size]]
            if len(items[0]) == 6:
                keys = ("p1", "p2", "anchor", "positive", "negative", "label")
            else:
                keys = ("p1", "p2", "anchor", "positive", "label")
            batch = {
                k: np.stack(col).astype(np.int32) for k, col in zip(keys, zip(*items))
            }
            yield batch

    def train_batches(self, epoch: int = 0):
        return self._batches(self.dataset_train, shuffle=True, epoch=epoch)

    def val_batches(self):
        return self._batches(self.dataset_val)

    def test_batches(self):
        return self._batches(self.dataset_test)
