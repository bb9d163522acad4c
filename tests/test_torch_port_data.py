"""The port's data module (``data/ppi_oma.py``), input pipeline
(``data/pipeline.py``) and run names (``utils/run_name.py``) against the
JAX package's, on the CPU.

Both data modules read ``tests/fixtures/tiny.h5`` (24 train, 8 val and 8
test interactions of ``c3``; one orthologue member missing from
``sequences``) and a copy of it in which some interactions' anchors are
missing too, with ``tiny_spm.model``: the same batches in the same order,
exactly (keys, ``int32``, bucket lengths, values), over two training epochs
with subword sampling on and every eval iterator, for ``negative_omid`` on
and off.
"""
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from intrepppid_tpu.data import pipeline as jax_pipeline
from intrepppid_tpu.data.ppi_oma import IntrepppidDataModule as JaxDataModule
from intrepppid_tpu.data.ppi_oma import IntrepppidDataset as JaxDataset
from intrepppid_tpu.utils.run_name import generate_passphrase as jax_passphrase
from intrepppid_tpu_torch.data import pipeline
from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataModule, IntrepppidDataset
from intrepppid_tpu_torch.utils.run_name import generate_passphrase, generate_run_name
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
H5, SPM = FIXTURES / "tiny.h5", FIXTURES / "tiny_spm.model"
SEED = 8675309
ARGS = dict(batch_size=8, c_type=3, trunc_len=64, vocab_size=38, model_file=SPM, seed=SEED,
            sos=False, eos=False)


@pytest.fixture(scope="module")
def h5_files(tmp_path_factory):
    """``tiny.h5`` and a copy whose every third interaction of each split
    names an anchor that ``sequences`` lacks (anchor and positive then fall
    back to p1's tokens, and the batch encodes ``""`` placeholders)."""
    import shutil

    import h5py

    path = tmp_path_factory.mktemp("data") / "missing_anchors.h5"
    shutil.copy(H5, path)
    with h5py.File(path, "r+") as f:
        for split in ("train", "val", "test"):
            table = f["interactions"]["c3"][f"c3_{split}"]
            rows = table[:]
            rows["omid_protein_id"][::3] = b"NO_SUCH_PROTEIN"
            table[...] = rows
    return {"tiny": H5, "missing_anchors": path}


def modules(negative_omid, workers=0, path=H5, **kw):
    out = []
    for cls in (JaxDataModule, IntrepppidDataModule):
        dm = cls(workers=workers, negative_omid=negative_omid, dataset_path=path, **ARGS, **kw)
        dm.setup()
        out.append(dm)
    return out


def passes(dm):
    """Every iterator in the order a run reads them: two training epochs,
    val, test and the train split under eval semantics."""
    return {"train_0": list(dm.train_batches(0)), "train_1": list(dm.train_batches(1)),
            "val": list(dm.val_batches()), "test": list(dm.test_batches()),
            "train_eval": list(dm.train_eval_batches())}


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), b
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32, (b, k)
            assert g[k].shape == w[k].shape, (b, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"batch {b} {k}")


@pytest.mark.parametrize("data", ["tiny", "missing_anchors"])
@pytest.mark.parametrize("negative_omid", [True, False])
def test_batches_match_jax(negative_omid, data, h5_files):
    jdm, dm = modules(negative_omid, path=h5_files[data])
    assert dm.steps_per_epoch == jdm.steps_per_epoch == 3
    assert dm.buckets == jdm.buckets
    want, got = passes(jdm), passes(dm)
    for name in want:
        assert_same_batches(got[name], want[name])
    keys = {"p1", "p2", "anchor", "positive", "label"} | ({"negative"} if negative_omid else set())
    assert set(got["train_0"][0]) == keys
    # sampling moves the training tokens between epochs; the order moves too
    assert any(not np.array_equal(a["p1"], b["p1"])
               for a, b in zip(got["train_0"], got["train_1"]))
    # every batch takes the smallest bucket that holds its longest row
    for b in got["train_0"] + got["test"]:
        assert b["p1"].shape[1] == dm._bucket_len(max(int((b[k] != 0).sum(1).max())
                                                      for k in keys - {"label"}))


@pytest.mark.parametrize("data", ["tiny", "missing_anchors"])
@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("negative_omid", [True, False])
def test_items_match_jax(split, negative_omid, data, h5_files):
    """``get_sequences_for_item`` and ``__getitem__`` index by index, with
    the orthologue draws and (on train) the sampled tokens; the fixture's
    missing member and the copy's missing anchors take their fallbacks."""
    kw = dict(dataset_path=h5_files[data], c_type=3, split=split, model_file=SPM,
              trunc_len=64, negative_omid=negative_omid, seed=SEED)
    jds, ds = JaxDataset(**kw), IntrepppidDataset(**kw)
    jds.spp.seed(SEED)
    ds.spp.seed(SEED)
    assert len(ds) == len(jds) and ds.omid_ids == jds.omid_ids
    assert ds.interactions == jds.interactions and ds.sequences == jds.sequences
    assert dict(ds.omid_members) == dict(jds.omid_members)
    assert any("MISSING1" in m for m in ds.omid_members.values())
    fallbacks = 0
    for idx in range(len(ds)):
        want = jds.get_sequences_for_item(idx)
        assert ds.get_sequences_for_item(idx) == want
        fallbacks += want[2] is None
    assert (fallbacks > 0) == (data == "missing_anchors")
    for idx in range(len(ds)):
        want, got = jds[idx], ds[idx]
        assert len(got) == len(want) == (6 if negative_omid else 5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype


def test_eval_token_cache_repeats_the_first_pass():
    _, dm = modules(True, cache_eval_tokens=True)
    first = list(dm.val_batches()), list(dm.test_batches())
    second = list(dm.val_batches()), list(dm.test_batches())
    for a, b in zip(first, second):
        assert_same_batches(b, a)
    assert set(dm._eval_cache) == {"val", "test"}


def test_tokenizer_threads_change_no_batch():
    _, one = modules(True, workers=0)
    _, two = modules(True, workers=2)
    a, b = passes(one), passes(two)
    for name in a:
        assert_same_batches(b[name], a[name])


def test_the_module_imports_without_h5py_and_a_dataset_then_raises():
    code = f"""
import sys
sys.modules["h5py"] = None
from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataModule
dm = IntrepppidDataModule(8, {str(H5)!r}, 3, 64, 0, 38, {str(SPM)!r}, 0, False, False)
try:
    dm.setup()
except ImportError:
    print("refused")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"


# ------------------------------------------------------------ the pipeline
def numbered(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise ValueError(f"upstream failed at {i}")
        yield {"p1": np.full((2, 3), i, np.int32), "label": np.array([i, -i], np.int32)}


def test_host_prefetch_yields_what_jax_yields():
    got = list(pipeline.host_prefetch(numbered(7), size=2))
    want = list(jax_pipeline.host_prefetch(numbered(7), size=2))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_host_prefetch_reraises_an_upstream_error():
    it = pipeline.host_prefetch(numbered(5, fail_at=3), size=2)
    assert [int(b["p1"][0, 0]) for b in (next(it), next(it), next(it))] == [0, 1, 2]
    with pytest.raises(ValueError, match="upstream failed at 3"):
        next(it)


def test_an_abandoned_pipeline_stops_its_thread():
    before = set(threading.enumerate())
    it = pipeline.host_prefetch(numbered(1000), size=2)
    next(it)
    started = set(threading.enumerate()) - before
    assert len(started) == 1
    it.close()
    deadline = time.monotonic() + 5.0
    while any(t.is_alive() for t in started) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not any(t.is_alive() for t in started)


def test_prefetch_to_device_on_the_cpu_makes_tensors():
    batches = list(numbered(3))
    got = list(pipeline.prefetch_to_device(iter(batches), "cpu"))
    assert len(got) == 3
    for g, w in zip(got, batches):
        assert g["p1"].dtype == torch.int64 and g["label"].dtype == torch.int32
        for k in w:
            assert g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_run_names():
    assert re.fullmatch(r"\d{2}\.\d{3}-\d{2}\.\d{2}-[a-z]+-[a-z]+", generate_run_name())
    import random

    assert generate_passphrase(3, "_", random.Random(4)) == jax_passphrase(3, "_",
                                                                          random.Random(4))
