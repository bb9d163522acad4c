"""The rest of the port's data layer against the JAX package's, on the CPU,
exactly: the legacy data modules (``data/oma.py``, ``data/ppi.py``,
``data/ppi_oma_lazy.py``), the SentencePiece trainer
(``data/spm/trainer.py``) and the ``data`` CLI (``cli/data.py``: ``build``,
``inspect``, ``train_spm``).

Every comparison is exact: batch keys, dtypes, shapes and values over two
training epochs (subword sampling on, each tokenizer seeded alike on both
sides) and every eval iterator; the trainer's pieces, scores and EM
objectives and the ``.model`` bytes; the built HDF5 tables, the summaries
and the validation errors. The JAX CLIs run in-process.
"""
import csv
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from intrepppid_tpu.cli.data import Data as JaxData
from intrepppid_tpu.data import oma as jax_oma
from intrepppid_tpu.data import ppi as jax_ppi
from intrepppid_tpu.data import ppi_oma_lazy as jax_lazy
from intrepppid_tpu.data.spm.trainer import TrainerConfig as JaxTrainerConfig
from intrepppid_tpu.data.spm.trainer import train_unigram_model as jax_train_unigram_model
from intrepppid_tpu_torch.__main__ import main as port_main
from intrepppid_tpu_torch.cli.data import Data
from intrepppid_tpu_torch.data import (
    IntrepppidDataModule,
    IntrepppidDataModule2,
    OmaTripletDataModule,
    RapppidDataModule2,
)
from intrepppid_tpu_torch.data.oma import OmaTripletDataset
from intrepppid_tpu_torch.data.spm.proto import save_model
from intrepppid_tpu_torch.data.spm.trainer import TrainerConfig, train_unigram_model
from test_data_build import _write_inputs
from test_spm_trainer import _corpus
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
H5, SPM = FIXTURES / "tiny.h5", FIXTURES / "tiny_spm.model"
SEED = 8675309


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def passes(dm):
    """Two training epochs, then val and test."""
    return {"train0": list(dm.train_batches(0)), "train1": list(dm.train_batches(1)),
            "val": list(dm.val_batches()), "test": list(dm.test_batches())}


def assert_same_passes(port_dm, jax_dm):
    got, want = passes(port_dm), passes(jax_dm)
    for name in want:
        assert_same_batches(got[name], want[name])


# ------------------------------------------------------------------ oma.py
def write_triplets(path, n=23, seed=0):
    """``n`` CSV triplets over 10 proteins and their sequences (the inputs
    of ``tests/test_data.py``'s ``OmaTripletDataModule`` cases)."""
    rng = np.random.default_rng(seed)
    prots = [f"Q{i}" for i in range(10)]
    with open(path / "seqs.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["upkb_ac", "sequence"])
        for p in prots:
            w.writerow([p, "".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"),
                                              size=int(rng.integers(3, 40))))])
    with open(path / "trip.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["anchor", "positive", "negative"])
        for _ in range(n):
            w.writerow(rng.choice(prots, size=3, replace=False))
    return dict(triplets_path=path / "trip.csv", sequences_path=path / "seqs.csv",
                model_file=SPM)


def test_oma_triplet_batches_match_jax(tmp_path):
    """The tenth-based split (23 rows: 16 / 2 / 5) and every batch; the
    train split's seeded shuffle and sampling on."""
    kw = dict(batch_size=4, trunc_len=32, seed=SEED, **write_triplets(tmp_path))
    port_dm, jax_dm = OmaTripletDataModule(**kw), jax_oma.OmaTripletDataModule(**kw)
    for dm in (port_dm, jax_dm):
        dm.setup()
        for ds in (dm.dataset_train, dm.dataset_val, dm.dataset_test):
            ds.spp.seed(SEED)
    assert [len(d) for d in (port_dm.dataset_train, port_dm.dataset_val,
                             port_dm.dataset_test)] == [16, 2, 5]
    assert_same_passes(port_dm, jax_dm)
    kw.pop("batch_size")
    kw.pop("seed")
    for split in ("train", "val", "test"):
        assert OmaTripletDataset(split=split, **kw).triplets == jax_oma.OmaTripletDataset(
            split=split, **kw).triplets


# ------------------------------------------------------------------ ppi.py
def test_rapppid_batches_match_jax():
    kw = dict(batch_size=8, dataset_path=H5, c_type=3, trunc_len=32, workers=0,
              vocab_size=38, model_file=SPM, seed=SEED, sos=False, eos=False)
    port_dm, jax_dm = RapppidDataModule2(**kw), jax_ppi.RapppidDataModule2(**kw)
    for dm in (port_dm, jax_dm):
        dm.setup()
        dm.tokenizer.seed(SEED)
    assert_same_passes(port_dm, jax_dm)
    assert set(next(iter(port_dm.val_batches()))) == {"p1", "p2", "label"}


# --------------------------------------------------------- ppi_oma_lazy.py
@pytest.mark.parametrize("negative_omid", [True, False])
def test_lazy_batches_match_jax(negative_omid):
    kw = dict(batch_size=8, dataset_path=H5, c_type=3, trunc_len=48, workers=0,
              vocab_size=38, model_file=SPM, seed=SEED, sos=False, eos=False,
              negative_omid=negative_omid)
    port_dm, jax_dm = IntrepppidDataModule2(**kw), jax_lazy.IntrepppidDataModule2(**kw)
    for dm in (port_dm, jax_dm):
        dm.setup()
    try:
        assert_same_passes(port_dm, jax_dm)
        assert len(next(iter(port_dm.val_batches()))) == (6 if negative_omid else 5)
    finally:
        for dm in (port_dm, jax_dm):
            for ds in (dm.dataset_train, dm.dataset_val, dm.dataset_test):
                ds.close()


@pytest.mark.parametrize("cls", [IntrepppidDataModule, IntrepppidDataModule2,
                                 RapppidDataModule2])
def test_undersized_vocab_raises(cls):
    with pytest.raises(ValueError, match="vocab_size"):
        cls(batch_size=4, dataset_path=H5, c_type=3, trunc_len=32, workers=0,
            vocab_size=32, model_file=SPM, seed=0, sos=False, eos=False)


# --------------------------------------------------------- spm/trainer.py
@pytest.fixture(scope="module")
def trained():
    """Both trainers on ``tests/test_spm_trainer.py``'s corpus and
    configuration."""
    corpus = _corpus(np.random.default_rng(99))
    cfg = dict(vocab_size=80, max_piece_len=8, seed_size=2000, max_rounds=12)
    return (corpus, train_unigram_model(corpus, TrainerConfig(**cfg)),
            jax_train_unigram_model(corpus, JaxTrainerConfig(**cfg)))


def test_spm_trainer_matches_jax(trained, tmp_path):
    """Pieces, scores and EM objectives equal; the saved models byte for
    byte."""
    _, (model, result), (jmodel, jresult) = trained
    assert result.pieces == jresult.pieces
    assert result.objectives == jresult.objectives
    assert [(e.piece, e.score, e.type) for e in model.pieces] == [
        (e.piece, e.score, e.type) for e in jmodel.pieces]
    from intrepppid_tpu.data.spm.proto import save_model as jax_save_model

    save_model(model, tmp_path / "port.model")
    jax_save_model(jmodel, tmp_path / "jax.model")
    assert (tmp_path / "port.model").read_bytes() == (tmp_path / "jax.model").read_bytes()


def test_train_spm_matches_jax(trained, tmp_path):
    """``data train_spm`` on a text corpus and on a FASTA: the same summary
    and ``.model`` bytes as the JAX CLI's."""
    corpus = trained[0]
    text = tmp_path / "corpus.txt"
    text.write_text("\n".join(corpus[:60]) + "\n")
    fasta = tmp_path / "corpus.fasta"
    fasta.write_text("".join(f">s{i} x\n{s[:30]}\n{s[30:]}\n" for i, s in enumerate(corpus[:40])))
    kw = dict(vocab_size=60, max_piece_len=6, seed_size=1000, max_rounds=8)
    for inp in (text, fasta):
        got = Data.train_spm(input_path=inp, out_path=tmp_path / "port.model", **kw)
        want = JaxData.train_spm(input_path=inp, out_path=tmp_path / "jax.model", **kw)
        assert {**got, "out_path": None} == {**want, "out_path": None}
        assert (tmp_path / "port.model").read_bytes() == (tmp_path / "jax.model").read_bytes()


# ------------------------------------------------------------- cli/data.py
def tables(path):
    import h5py

    with h5py.File(path, "r") as f:
        out = {"sequences": f["sequences"][:], "orthologs": f["orthologs"][:]}
        for c, grp in f["interactions"].items():
            for name, table in grp.items():
                out[f"{c}/{name}"] = table[:]
    return out


def assert_same_file(got, want):
    a, b = tables(got), tables(want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("with_split, seed", [(False, 11), (True, 0), (False, 7)])
def test_build_and_inspect_match_jax(tmp_path, with_split, seed):
    """``build`` from CSV and FASTA, with and without a split column (then a
    seeded split), and ``inspect``: the same tables, summary and dict."""
    fasta, itx, ortho = _write_inputs(tmp_path, with_split=with_split)
    kw = dict(sequences_path=fasta, interactions_path=itx, orthologs_path=ortho, c_type=3,
              seed=seed)
    got = Data.build(out_path=tmp_path / "port.h5", **kw)
    want = JaxData.build(out_path=tmp_path / "jax.h5", **kw)
    assert {**got, "out_path": None} == {**want, "out_path": None}
    assert_same_file(tmp_path / "port.h5", tmp_path / "jax.h5")
    got, want = Data.inspect(tmp_path / "port.h5"), JaxData.inspect(tmp_path / "jax.h5")
    assert {**got, "dataset_path": None} == {**want, "dataset_path": None}


def test_build_refuses_what_jax_refuses(tmp_path):
    """An unknown protein, a missing header column and no orthologue groups
    raise the JAX CLI's errors; ``allow_empty_orthologs`` builds a pair-only
    file as it does."""
    fasta, itx, ortho = _write_inputs(tmp_path)
    bad = tmp_path / "bad.csv"
    bad.write_text("protein_id1,protein_id2,omid_protein_id,omid_id,label\n"
                   "NOPE,Q0001,Q0002,500,1\n")
    noheader = tmp_path / "nohdr.csv"
    noheader.write_text("a,b\n1,2\n")
    cases = [dict(interactions_path=bad, orthologs_path=ortho),
             dict(interactions_path=noheader, orthologs_path=ortho),
             dict(interactions_path=itx)]
    for case in cases:
        errors = []
        for data in (Data, JaxData):
            with pytest.raises(ValueError) as err:
                data.build(sequences_path=fasta, out_path=tmp_path / "x.h5", **case)
            errors.append(str(err.value))
        assert errors[0] == errors[1]
    kw = dict(sequences_path=fasta, interactions_path=itx, allow_empty_orthologs=True)
    got = Data.build(out_path=tmp_path / "port.h5", **kw)
    want = JaxData.build(out_path=tmp_path / "jax.h5", **kw)
    assert got["n_ortholog_rows"] == 0
    assert {**got, "out_path": None} == {**want, "out_path": None}
    assert_same_file(tmp_path / "port.h5", tmp_path / "jax.h5")


def test_data_cli_dispatch(tmp_path):
    """``data build`` and ``data inspect`` through the port's CLI
    dispatcher; the built file trains through the port's data module."""
    fasta, itx, ortho = _write_inputs(tmp_path)
    out = tmp_path / "cli.h5"
    port_main(["data", "build", "--sequences_path", str(fasta), "--interactions_path",
               str(itx), "--orthologs_path", str(ortho), "--out_path", str(out)])
    info = port_main(["data", "inspect", "--dataset_path", str(out)])
    assert info == JaxData.inspect(out)
    dm = IntrepppidDataModule(4, out, 3, 48, 0, 38, SPM, SEED, False, False, True)
    dm.setup()
    batch = next(iter(dm.train_batches(0)))
    assert batch["p1"].shape[0] == 4 and set(batch) >= {"anchor", "negative", "label"}


def test_the_modules_import_without_h5py():
    """With ``h5py`` hidden the data package, the legacy modules and the
    ``data`` CLI import; reading a dataset then raises ``ImportError``."""
    code = f"""
import sys
sys.modules["h5py"] = None
import intrepppid_tpu_torch.data
from intrepppid_tpu_torch.__main__ import main
from intrepppid_tpu_torch.cli.data import Data
from intrepppid_tpu_torch.data import RapppidDataModule2
from intrepppid_tpu_torch.data.ppi_oma_lazy import IntrepppidDataset2
from intrepppid_tpu_torch.data.spm import trainer
refused = 0
dm = RapppidDataModule2(8, {str(H5)!r}, 3, 32, 0, 38, {str(SPM)!r}, 0, False, False)
for call in (dm.setup, lambda: IntrepppidDataset2({str(H5)!r}, 3, "val", {str(SPM)!r}),
             lambda: Data.inspect({str(H5)!r})):
    try:
        call()
    except ImportError:
        refused += 1
print(refused)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3"
