"""Dataset CLI: build and inspect INTREPPPID-format HDF5 datasets
(`intrepppid_tpu/cli/data.py` counterpart: the same files, summaries and
errors). ``h5py`` is imported inside the commands that read or write HDF5.

Added capability: the reference documents its HDF5 schema
(`docs/data.rst:22-119`) and distributes ready-made datasets, but ships no
tool to build one from a user's own data — anyone with new interactions
must hand-roll the HDF5. ``data build`` converts plain CSV + FASTA inputs
into a train-ready dataset in that exact schema (the same one this
framework's `data/ppi_oma.py` and the reference's PyTables reader consume);
``data inspect`` summarizes an existing file.

Inputs for ``build``:

* ``--sequences_path`` — FASTA (optionally gzipped) of protein sequences;
  record names are the protein ids.
* ``--interactions_path`` — CSV WITH HEADER, columns ``protein_id1``,
  ``protein_id2``, ``omid_protein_id``, ``omid_id``, ``label`` and
  optionally ``split`` (train/val/test). Without a ``split`` column rows
  are split by seeded shuffle into ``--train_frac``/``--val_frac``/rest.
* ``--orthologs_path`` — CSV WITH HEADER, columns ``ortholog_group_id``,
  ``protein_id`` (e.g. an OMA group export). Required unless
  ``--allow_empty_orthologs true``: the quintuplet trainer samples
  negatives from these groups (`intrepppid/data/ppi_oma.py:489-492`) and
  cannot run without at least one.
"""
from __future__ import annotations

import csv
import gzip
import json
from pathlib import Path
from typing import Optional

import numpy as np

_ITX_COLS = ("protein_id1", "protein_id2", "omid_protein_id", "omid_id", "label")


def _opener(path):
    if str(path).endswith(".gz"):
        return gzip.open(str(path), "rt")
    return open(str(path), "r")


def _parse_label(v: str) -> bool:
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y"):
        return True
    if s in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"label must be boolean-like, got {v!r}")


def _str_dtype(values, minimum: int = 1) -> str:
    n = max([minimum] + [len(v.encode()) for v in values])
    return f"S{n}"


class Data:
    @staticmethod
    def build(
        sequences_path: Path,
        interactions_path: Path,
        out_path: Path,
        orthologs_path: Optional[Path] = None,
        c_type: int = 3,
        train_frac: float = 0.8,
        val_frac: float = 0.1,
        seed: int = 0,
        trunc_len: int = 0,
        allow_empty_orthologs: bool = False,
    ) -> dict:
        """Build an INTREPPPID-format HDF5 dataset from CSV + FASTA; returns
        (and prints) a summary dict. ``--trunc_len N`` > 0 truncates stored
        sequences to N chars (the trainer truncates at tokenization time
        anyway; storing less shrinks the file)."""
        import h5py

        from intrepppid_tpu_torch.cli.infer import stream_fasta

        sequences = {}
        for name, seq in stream_fasta(sequences_path):
            name = name.split()[0]  # FASTA headers may carry descriptions
            sequences[name] = seq[:trunc_len] if trunc_len > 0 else seq
        if not sequences:
            raise ValueError(f"no sequences parsed from {sequences_path}")

        with _opener(interactions_path) as f:
            reader = csv.DictReader(f)
            missing = [c for c in _ITX_COLS if c not in (reader.fieldnames or [])]
            if missing:
                raise ValueError(
                    f"interactions CSV must have header columns {_ITX_COLS}; "
                    f"missing {missing}"
                )
            has_split = "split" in (reader.fieldnames or [])
            rows = []
            for i, row in enumerate(reader):
                for pid_col in ("protein_id1", "protein_id2"):
                    if row[pid_col] not in sequences:
                        raise ValueError(
                            f"interactions row {i}: {pid_col}="
                            f"{row[pid_col]!r} not in the FASTA"
                        )
                split = row["split"].strip().lower() if has_split else None
                if has_split and split not in ("train", "val", "test"):
                    raise ValueError(
                        f"interactions row {i}: split must be "
                        f"train/val/test, got {row['split']!r}"
                    )
                rows.append(
                    (
                        row["protein_id1"],
                        row["protein_id2"],
                        row["omid_protein_id"],
                        int(row["omid_id"]),
                        _parse_label(row["label"]),
                        split,
                    )
                )
        if not rows:
            raise ValueError(f"no interaction rows in {interactions_path}")

        if not has_split:
            rng = np.random.default_rng(seed)
            order = rng.permutation(len(rows))
            n_train = int(len(rows) * train_frac)
            n_val = int(len(rows) * val_frac)
            assign = {}
            for rank, idx in enumerate(order):
                assign[idx] = (
                    "train" if rank < n_train
                    else "val" if rank < n_train + n_val
                    else "test"
                )
            rows = [r[:5] + (assign[i],) for i, r in enumerate(rows)]

        orthologs = []
        if orthologs_path is not None:
            with _opener(orthologs_path) as f:
                reader = csv.DictReader(f)
                need = ("ortholog_group_id", "protein_id")
                if any(c not in (reader.fieldnames or []) for c in need):
                    raise ValueError(
                        f"orthologs CSV must have header columns {need}"
                    )
                for row in reader:
                    orthologs.append(
                        (int(row["ortholog_group_id"]), row["protein_id"])
                    )
        if not orthologs and not allow_empty_orthologs:
            raise ValueError(
                "no orthologue groups: the quintuplet trainer samples "
                "negatives from them and cannot run without at least one. "
                "Pass --orthologs_path, or --allow_empty_orthologs true "
                "for a pair-only (non-trainable) dataset."
            )
        n_ortho_no_seq = sum(1 for _, p in orthologs if p not in sequences)
        if n_ortho_no_seq:
            print(
                f"note: {n_ortho_no_seq} orthologue rows reference proteins "
                "absent from the FASTA (the training path retries, then "
                "falls back, reference parity)"
            )

        pid_dt = _str_dtype(
            list(sequences)
            + [r[2] for r in rows]
            + [p for _, p in orthologs]
        )
        itx_dtype = np.dtype(
            [
                ("protein_id1", pid_dt),
                ("protein_id2", pid_dt),
                ("omid_protein_id", pid_dt),
                ("omid_id", np.int64),
                ("label", np.bool_),
            ]
        )
        seq_dtype = np.dtype(
            [("name", pid_dt), ("sequence", _str_dtype(sequences.values()))]
        )
        ortho_dtype = np.dtype(
            [("ortholog_group_id", np.int64), ("protein_id", pid_dt)]
        )

        by_split = {"train": [], "val": [], "test": []}
        for p1, p2, om_p, om_id, label, split in rows:
            by_split[split].append(
                (p1.encode(), p2.encode(), om_p.encode(), om_id, label)
            )

        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(out_path, "w") as f:
            f.create_dataset(
                "sequences",
                data=np.array(
                    [(n.encode(), s.encode()) for n, s in sequences.items()],
                    dtype=seq_dtype,
                ),
            )
            f.create_dataset(
                "orthologs",
                data=np.array(
                    [(g, p.encode()) for g, p in orthologs], dtype=ortho_dtype
                ),
            )
            grp = f.create_group("interactions").create_group(f"c{c_type}")
            for split, split_rows in by_split.items():
                grp.create_dataset(
                    f"c{c_type}_{split}",
                    data=np.array(split_rows, dtype=itx_dtype),
                )

        summary = {
            "out_path": str(out_path),
            "c_type": c_type,
            "n_sequences": len(sequences),
            "n_ortholog_rows": len(orthologs),
            "n_ortholog_groups": len({g for g, _ in orthologs}),
            "splits": {k: len(v) for k, v in by_split.items()},
        }
        print(json.dumps(summary))
        return summary

    @staticmethod
    def train_spm(
        input_path: Path,
        out_path: Path,
        vocab_size: int = 250,
        max_piece_len: int = 16,
        seed_size: int = 8000,
        max_rounds: int = 16,
    ) -> dict:
        """Train a unigram tokenizer model from a corpus (FASTA by
        ``.fasta``/``.fa`` extension, else one sequence per line; gzip ok)
        and save it as a sentencepiece-format ``.model`` — no external
        tools (the reference's workflow needs Google's ``spm_train``).
        The trainer is exact-EM pure Python/numpy: right-sized for
        protein-scale corpora (a few MB); see
        `intrepppid_tpu_torch/data/spm/trainer.py` for the algorithm and its
        validation oracles."""
        from intrepppid_tpu_torch.data.spm.proto import save_model
        from intrepppid_tpu_torch.data.spm.trainer import (
            TrainerConfig,
            train_unigram_model,
        )

        name = str(input_path).lower()
        if name.endswith(".gz"):  # rstrip would eat a char-set, not ".gz"
            name = name[: -len(".gz")]
        if name.endswith((".fasta", ".fa")):
            from intrepppid_tpu_torch.cli.infer import stream_fasta

            sentences = [seq for _, seq in stream_fasta(input_path)]
        else:
            with _opener(input_path) as f:
                sentences = [ln.strip() for ln in f if ln.strip()]
        cfg = TrainerConfig(
            vocab_size=vocab_size,
            max_piece_len=max_piece_len,
            seed_size=seed_size,
            max_rounds=max_rounds,
        )
        model, result = train_unigram_model(sentences, cfg)
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        save_model(model, out_path)
        summary = {
            "out_path": str(out_path),
            "n_sentences": len(sentences),
            "vocab_size": len(model.pieces),
            "n_multi_char_pieces": sum(
                1 for p in model.pieces if len(p.piece) > 1
            ),
            "em_iterations": len(result.objectives),
            "final_log_likelihood": result.objectives[-1],
        }
        print(json.dumps(summary))
        return summary

    @staticmethod
    def inspect(dataset_path: Path) -> dict:
        """Summarize an INTREPPPID-format HDF5: sequence/orthologue counts,
        per-c_type split sizes, label balance, sequence-length stats."""
        import h5py

        out: dict = {"dataset_path": str(dataset_path)}
        with h5py.File(dataset_path, "r") as f:
            seqs = f["sequences"][:]
            lens = [len(r["sequence"]) for r in seqs]
            out["n_sequences"] = len(seqs)
            out["seq_len"] = {
                "min": int(min(lens)),
                "median": float(np.median(lens)),
                "max": int(max(lens)),
            }
            ortho = f["orthologs"][:]
            out["n_ortholog_rows"] = len(ortho)
            out["n_ortholog_groups"] = len(
                {int(r["ortholog_group_id"]) for r in ortho}
            )
            out["interactions"] = {}
            for c_name, grp in f["interactions"].items():
                splits = {}
                for ds_name, table in grp.items():
                    arr = table[:]
                    splits[ds_name] = {
                        "rows": len(arr),
                        "positive_frac": (
                            float(np.mean(arr["label"])) if len(arr) else 0.0
                        ),
                    }
                out["interactions"][c_name] = splits
        print(json.dumps(out))
        return out
