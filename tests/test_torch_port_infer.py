"""The port's ``infer from_csv`` CLI (``cli/infer.py``) and its encode path
against the JAX package, on the CPU.

The same FASTA, CSV and reference-layout ``.ckpt`` (seeded JAX params,
written by the JAX package's exporter) go through
``intrepppid_tpu.cli.infer.Infer.from_csv`` and the port's with
``device="cpu"``: the same ids in the same order and probabilities to
1e-5 (both sum in f32, in another order). The CSV holds 11 scoreable rows
(batch 4: two full batches and a repeat-padded tail), a row with a missing
id and a short row; variants run ``low_memory=True`` and gzipped inputs.
``static_encode`` is held token for token.
"""
import csv
import gzip
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from intrepppid_tpu.cli.infer import Infer as JaxInfer
from intrepppid_tpu.data.ppi_oma import IntrepppidDataset as JaxDataset
from intrepppid_tpu.data.tokenizer import SentencePieceTokenizer as JaxTokenizer
from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.utils.torch_convert import save_torch_checkpoint
from intrepppid_tpu_torch.__main__ import main as port_main
from intrepppid_tpu_torch.cli.infer import Infer, _KVStore, stream_fasta
from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataset
from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

SPM = Path(__file__).parent / "fixtures" / "tiny_spm.model"
AAS = "ACDEFGHIKLMNPQRSTVWY"
MODEL = dict(vocab_size=38, embedding_size=16, rnn_num_layers=2)
TRUNC, BATCH = 64, 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """FASTA (plain and .gz), CSV (plain and .gz), .ckpt, and the JAX CLI's
    scores on the plain files."""
    tmp = tmp_path_factory.mktemp("infer")
    rng = np.random.default_rng(3)
    seqs = {f"P{i:02d}": "".join(rng.choice(list(AAS), int(rng.integers(5, 90))))
            for i in range(9)}
    fasta = tmp / "seqs.fasta"
    # wrapped sequence lines, as real FASTA files have
    fasta.write_text("".join(f">{n}\n{s[:40]}\n{s[40:]}\n" for n, s in seqs.items()))
    names = list(seqs)
    rows = [(f"itx{i}", names[int(rng.integers(9))], names[int(rng.integers(9))])
            for i in range(11)]
    lines = [",".join(r) for r in rows]
    lines.insert(3, "itx_missing,P00,NOPE")
    lines.insert(7, "itx_short,P01")
    pairs = tmp / "pairs.csv"
    pairs.write_text("\n".join(lines) + "\n")
    for path in (fasta, pairs):
        with gzip.open(str(path) + ".gz", "wt") as f:
            f.write(path.read_text())
    params = jax_network(0, use_projection=True, **MODEL).init(jax.random.PRNGKey(5))
    ckpt = tmp / "model.ckpt"
    save_torch_checkpoint(jax.tree_util.tree_map(np.asarray, params), ckpt)
    ref_out = tmp / "ref.csv"
    n = JaxInfer.from_csv(pairs, fasta, ckpt, SPM, ref_out, trunc_len=TRUNC, batch_size=BATCH,
                          **MODEL)
    assert n == 11
    return {"tmp": tmp, "fasta": fasta, "pairs": pairs, "ckpt": ckpt,
            "ref": read_scores(ref_out), "ids": [r[0] for r in rows]}


def read_scores(path):
    with open(path, newline="") as f:
        return [(r[0], float(r[1])) for r in csv.reader(f)]


def assert_same_scores(got, ref):
    assert [i for i, _ in got] == [i for i, _ in ref]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in ref], atol=1e-5)
    assert all(0.0 < p < 1.0 for _, p in got)


@pytest.mark.parametrize("variant", ["plain", "low_memory", "gz", "low_memory_gz_db"])
def test_from_csv_matches_jax_cli(files, variant, capsys):
    out = files["tmp"] / f"out_{variant}.csv"
    gz = "gz" in variant
    pairs = Path(str(files["pairs"]) + (".gz" if gz else ""))
    fasta = Path(str(files["fasta"]) + (".gz" if gz else ""))
    kw = dict(trunc_len=TRUNC, batch_size=BATCH, device="cpu", **MODEL)
    if variant.startswith("low_memory"):
        kw["low_memory"] = True
    if variant == "low_memory_gz_db":
        kw["db_path"] = files["tmp"] / "db"
    n = Infer.from_csv(pairs, fasta, files["ckpt"], SPM, out, **kw)
    got = read_scores(out)
    assert n == 11 == len(got) and [i for i, _ in got] == files["ids"]
    assert_same_scores(got, files["ref"])
    said = capsys.readouterr().out
    assert "Can't compute pair id: itx_missing (missing sequences: NOPE)" in said
    assert "Can't compute pair id: itx_short (missing sequences: None)" in said
    assert f"Scored 11 pairs -> {out}" in said
    if variant == "low_memory_gz_db":
        # a kept database is reused without the FASTA
        out2 = files["tmp"] / "out_reuse.csv"
        Infer.from_csv(pairs, files["tmp"] / "no_such.fasta", files["ckpt"], SPM, out2,
                       dont_populate_db=True, **kw)
        assert_same_scores(read_scores(out2), files["ref"])


def test_from_csv_low_memory_matches_jax_low_memory(files):
    """The JAX CLI's own low-memory run on the gzipped files gives the
    scores the port's gives."""
    ref_out, out = files["tmp"] / "ref_lm.csv", files["tmp"] / "out_lm.csv"
    args = (str(files["pairs"]) + ".gz", str(files["fasta"]) + ".gz", files["ckpt"], SPM)
    kw = dict(trunc_len=TRUNC, batch_size=BATCH, low_memory=True, **MODEL)
    JaxInfer.from_csv(*args, ref_out, **kw)
    Infer.from_csv(*args, out, device="cpu", **kw)
    assert_same_scores(read_scores(out), read_scores(ref_out))


def test_from_csv_through_the_command_line(files):
    """``python -m intrepppid_tpu_torch infer from_csv`` with flags, a batch
    that is not filled once (batch 16 > 11 rows: one repeat-padded batch)."""
    out = files["tmp"] / "out_cli.csv"
    n = port_main(["infer", "from_csv", "--interactions_path", str(files["pairs"]),
                   "--sequences_path", str(files["fasta"]), "--weights_path",
                   str(files["ckpt"]), "--spm_path", str(SPM), "--out_path", str(out),
                   "--trunc_len", str(TRUNC), "--batch_size", "16", "--vocab_size", "38",
                   "--embedding_size", "16", "--device", "cpu"])
    assert n == 11
    assert_same_scores(read_scores(out), files["ref"])


def test_from_csv_refusals(files, monkeypatch):
    args = (files["pairs"], files["fasta"], files["ckpt"], SPM, files["tmp"] / "never.csv")
    # more replicas than the machine's cards
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="n_data_parallel=2 exceeds the 1 cards"):
            Infer.from_csv(*args, n_data_parallel=2, **MODEL)
    # an orbax checkpoint directory needs JAX to read: refused with the way out
    with pytest.raises(ValueError, match="export torch_ckpt"):
        Infer.from_csv(files["pairs"], files["fasta"], files["tmp"], SPM, args[4],
                       device="cpu", **MODEL)
    with pytest.raises(ValueError, match="vocab"):
        Infer.from_csv(*args, device="cpu", vocab_size=20, embedding_size=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Infer.from_csv(*args, **MODEL)
    assert not args[4].exists()


@pytest.mark.parametrize("kw", [dict(sampling=False), dict(sampling=False, pad=False),
                                dict(sampling=False, sos=True, eos=True),
                                dict(sp=False), dict(sp=False, pad=False)])
def test_static_encode_matches_jax(kw):
    port, ref = SentencePieceTokenizer(SPM), JaxTokenizer(SPM)
    rng = np.random.default_rng(1)
    for n in (1, 17, 64, 150):
        # the amino-acid table's ambiguous codes draw at random: leave them out
        seq = "".join(rng.choice(list(AAS), n))
        got = IntrepppidDataset.static_encode(TRUNC, port, seq, **kw)
        want = JaxDataset.static_encode(TRUNC, ref, seq, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_stream_fasta_and_kvstore(files):
    records = list(stream_fasta(files["fasta"]))
    assert records == list(stream_fasta(str(files["fasta"]) + ".gz")) and len(records) == 9
    assert all(set(s) <= set(AAS) and "\n" not in s for _, s in records)
    store = _KVStore(files["tmp"] / "kv")
    store.put("a", "[1, 2]")
    store.put("a", "[3]")
    assert store.get("a") == "[3]" and store.get("b") is None
    store.close()
