"""Legacy pair-only HDF5 dataset (`intrepppid/data/ppi.py` —
``RapppidDataset2`` :27 / ``RapppidDataModule2`` :102;
`intrepppid_tpu/data/ppi.py` counterpart, value for value).

Pair + label interactions without orthologue columns. The reference
variant re-opens the HDF5 per item; here interactions load eagerly (they
are small) while keeping the same sample semantics. Exported for parity
with `intrepppid/data/__init__.py:18`; unused by shipped entry points.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataset
from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer


class RapppidDataset:
    def __init__(
        self,
        dataset_path,
        c_type: int,
        split: str,
        model_file,
        trunc_len: int = 1000,
        sos: bool = False,
        eos: bool = False,
        tokenizer: Optional[SentencePieceTokenizer] = None,
    ):
        import h5py

        self.trunc_len = trunc_len
        self.split = split
        self.sampling = split not in ("test", "val")
        self.sos = sos
        self.eos = eos
        self.spp = tokenizer or SentencePieceTokenizer(model_file)

        self.interactions = []
        self.sequences = {}
        with h5py.File(dataset_path, "r") as f:
            for row in f["interactions"][f"c{c_type}"][f"c{c_type}_{split}"][:]:
                self.interactions.append(
                    (
                        row["protein_id1"].decode("utf8"),
                        row["protein_id2"].decode("utf8"),
                        bool(row["label"]),
                    )
                )
            for row in f["sequences"][:]:
                self.sequences[row["name"].decode("utf8")] = row["sequence"].decode(
                    "utf8"
                )

    def encode(self, seq: str) -> np.ndarray:
        return IntrepppidDataset.static_encode(
            self.trunc_len, self.spp, seq, True, True, self.sampling, self.sos, self.eos
        )

    def __getitem__(self, idx: int):
        p1, p2, label = self.interactions[idx]
        return self.encode(self.sequences[p1]), self.encode(self.sequences[p2]), np.int64(label)

    def __len__(self) -> int:
        return len(self.interactions)


# Name parity with the reference's second-generation class.
RapppidDataset2 = RapppidDataset


class RapppidDataModule2:
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
    ):
        self.batch_size = batch_size
        self.kwargs = dict(
            dataset_path=dataset_path,
            c_type=c_type,
            model_file=model_file,
            trunc_len=trunc_len,
            sos=sos,
            eos=eos,
        )
        self.seed = seed
        self.tokenizer = SentencePieceTokenizer(model_file)
        self.tokenizer.validate_vocab_size(vocab_size)
        self.dataset_train = None
        self.dataset_val = None
        self.dataset_test = None

    def setup(self, stage=None) -> None:
        self.dataset_train = RapppidDataset(
            split="train", tokenizer=self.tokenizer, **self.kwargs
        )
        self.dataset_val = RapppidDataset(
            split="val", tokenizer=self.tokenizer, **self.kwargs
        )
        self.dataset_test = RapppidDataset(
            split="test", tokenizer=self.tokenizer, **self.kwargs
        )

    def _batches(self, ds, shuffle=False, epoch=0) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(ds))
        if shuffle:
            np.random.default_rng(self.seed + 1000 * (epoch + 1)).shuffle(order)
        for start in range(0, len(ds), self.batch_size):
            items = [ds[int(i)] for i in order[start : start + self.batch_size]]
            yield {
                "p1": np.stack([a for a, _, _ in items]).astype(np.int32),
                "p2": np.stack([b for _, b, _ in items]).astype(np.int32),
                "label": np.array([l for _, _, l in items], np.int32),
            }

    def train_batches(self, epoch: int = 0):
        return self._batches(self.dataset_train, shuffle=True, epoch=epoch)

    def val_batches(self):
        return self._batches(self.dataset_val)

    def test_batches(self):
        return self._batches(self.dataset_test)
