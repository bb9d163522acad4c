"""Legacy CSV-based orthologue triplet dataset (`intrepppid/data/oma.py`;
`intrepppid_tpu/data/oma.py` counterpart, value for value).

Anchor/positive/negative triplets from a CSV with columns
``anchor, positive, negative`` plus a ``upkb_ac -> sequence`` CSV;
80/10/10 positional split with a seeded train shuffle (:38-47). Exported
for parity with `intrepppid/data/__init__.py:17`; unused by the shipped
training entry points (RAPPPID-era pretraining path).
"""
from __future__ import annotations

import csv
import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataset
from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer


class OmaTripletDataset:
    def __init__(
        self,
        triplets_path,
        sequences_path,
        model_file,
        trunc_len: int = 1000,
        split: Optional[str] = None,
        seed: int = 8675309,
        sos: bool = False,
        eos: bool = False,
        tokenizer: Optional[SentencePieceTokenizer] = None,
    ):
        self.trunc_len = trunc_len
        self.split = split
        self.sampling = split not in ("test", "val")
        self.sos = sos
        self.eos = eos
        self.spp = tokenizer or SentencePieceTokenizer(model_file)

        self.sequences: Dict[str, str] = {}
        with open(sequences_path, newline="") as f:
            for row in csv.DictReader(f):
                self.sequences[row["upkb_ac"]] = row["sequence"]

        rows: List[tuple] = []
        with open(triplets_path, newline="") as f:
            for row in csv.DictReader(f):
                rows.append((row["anchor"], row["positive"], row["negative"]))

        # Tenth-based positional split exactly as the reference
        # (`intrepppid/data/oma.py:44-51`): one_tenth = n // 10,
        # train = rows[:8*one_tenth], val = rows[8*one_tenth:9*one_tenth],
        # test = rows[9*one_tenth:]. Deliberate delta: the reference
        # shuffles train with an UNSEEDED `sample(frac=1.0)`; we seed the
        # shuffle so runs are reproducible (membership is identical).
        one_tenth = len(rows) // 10
        if split == "train":
            rows = rows[: one_tenth * 8]
            random.Random(seed).shuffle(rows)
        elif split == "val":
            rows = rows[one_tenth * 8 : one_tenth * 9]
        elif split == "test":
            rows = rows[one_tenth * 9 :]
        self.triplets = rows

    def encode(self, seq: str) -> np.ndarray:
        return IntrepppidDataset.static_encode(
            self.trunc_len, self.spp, seq, True, True, self.sampling, self.sos, self.eos
        )

    def __getitem__(self, idx: int):
        anchor, positive, negative = self.triplets[idx]
        return (
            self.encode(self.sequences[anchor]),
            self.encode(self.sequences[positive]),
            self.encode(self.sequences[negative]),
        )

    def __len__(self) -> int:
        return len(self.triplets)


class OmaTripletDataModule:
    def __init__(
        self,
        batch_size: int,
        triplets_path,
        sequences_path,
        model_file,
        trunc_len: int,
        workers: int = 0,
        seed: int = 8675309,
        sos: bool = False,
        eos: bool = False,
    ):
        self.batch_size = batch_size
        self.kwargs = dict(
            triplets_path=triplets_path,
            sequences_path=sequences_path,
            model_file=model_file,
            trunc_len=trunc_len,
            seed=seed,
            sos=sos,
            eos=eos,
        )
        self.dataset_train = None
        self.dataset_val = None
        self.dataset_test = None

    def setup(self, stage=None) -> None:
        self.dataset_train = OmaTripletDataset(split="train", **self.kwargs)
        self.dataset_val = OmaTripletDataset(split="val", **self.kwargs)
        self.dataset_test = OmaTripletDataset(split="test", **self.kwargs)

    def _batches(self, ds: OmaTripletDataset) -> Iterator[Dict[str, np.ndarray]]:
        for start in range(0, len(ds), self.batch_size):
            items = [ds[i] for i in range(start, min(start + self.batch_size, len(ds)))]
            yield {
                "anchor": np.stack([a for a, _, _ in items]).astype(np.int32),
                "positive": np.stack([p for _, p, _ in items]).astype(np.int32),
                "negative": np.stack([n for _, _, n in items]).astype(np.int32),
            }

    def train_batches(self, epoch: int = 0):
        return self._batches(self.dataset_train)

    def val_batches(self):
        return self._batches(self.dataset_val)

    def test_batches(self):
        return self._batches(self.dataset_test)
