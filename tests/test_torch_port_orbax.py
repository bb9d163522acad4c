"""The port's reader of the JAX package's orbax checkpoint directories
(``utils/zstd.py``, ``utils/ocdbt.py``, ``train/orbax_read.py``,
``utils/convert.py:from_jax_state``) and every reader that takes one
(``Trainer.resume`` / ``fit``, ``infer``, ``export``, the train CLI),
against the JAX package, zstandard and tensorstore, on the CPU.

* zstd: frames zstandard writes (random and repetitive bytes, levels -5,
  1, 3 and 19, with and without a checksum, multi-block, concatenated and
  skippable) and the frames tensorstore wrote in a real checkpoint;
* OCDBT: the manifest, every node, the key list and the values against
  ``tensorstore.ocdbt.dump`` and the ocdbt kvstore, on a directory the JAX
  ``CheckpointManager`` writes (E = H = 16, 2 layers) and on databases
  tensorstore writes with deep trees, many versions, no compression;
* zarr: arrays of several chunks, C and F order, zstd or none, fill values;
* ``restore_orbax`` against ``CheckpointManager.restore`` leaf for leaf,
  bit for bit, for every optimizer type with SWA on and off, and on the
  committed fixture
  (``tests/fixtures/jax_orbax_manuscript/``, made by
  ``tools/make_jax_orbax_fixture.py``);
* ``Trainer.resume`` puts every JAX leaf in its place bit for bit, for
  every optimizer type; a
  resume from a JAX run's epoch-1 directory and one more epoch against
  the JAX trainer's resume and epoch, for ``ranger21_xx`` and
  ``adamw_1cycle`` with SWA on, to the tolerance
  ``tests/test_torch_port_fit.py`` holds ``fit`` to (logs rtol 1e-5, atol
  1e-7; weights and SWA average atol 1e-5);
* ``infer from_csv --device cpu`` and ``export torch_ckpt`` on a JAX
  directory against the JAX CLIs (scores within 1e-4, the ``state_dict``
  bit for bit); the refusals name the JAX export;
* the committed fixture's 64 scores within 1e-6 of the JAX engine's, and
  the same weights in a wrong layout (directions or layers swapped) off
  by more than 100 times that.

The JAX trainers share one module-scoped ``fit`` per optimizer type; most
of this file's time is XLA building their steps.
"""
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from intrepppid_tpu.cli.export import Export as JaxExport
from intrepppid_tpu.cli.infer import Infer as JaxInfer
from intrepppid_tpu.optim import SWAConfig as JaxSWAConfig
from intrepppid_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from intrepppid_tpu.train.trainer import Trainer as JaxTrainer
from intrepppid_tpu_torch.__main__ import main as port_main
from intrepppid_tpu_torch.cli.export import Export
from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.serve import ScoringEngine
from intrepppid_tpu_torch.train import CheckpointManager, Trainer
from intrepppid_tpu_torch.train.checkpoint import checkpoint_kind
from intrepppid_tpu_torch.train.orbax_read import read_zarr, restore_orbax
from intrepppid_tpu_torch.utils import zstd
from intrepppid_tpu_torch.utils.convert import load_reference_checkpoint
from intrepppid_tpu_torch.utils.ocdbt import OcdbtStore
from test_torch_port_fit import CLOCK_KEYS, Module, networks, to_port
from test_torch_port_train import EMBED, VOCAB
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
FIXTURE = FIXTURES / "jax_orbax_manuscript"
FIXTURE_SPM = FIXTURES / "jax_orbax_manuscript_spm.model"
SPM = FIXTURES / "tiny_spm.model"
H5 = FIXTURES / "tiny.h5"
REFUSAL = "intrepppid_tpu export torch_ckpt"
# every optimizer type the train CLI takes, each a layout of its own leaf list
OPTIMIZERS = ("ranger21", "ranger21_xx", "adamw", "adamw_1cycle", "adamw_cosine")
# test_torch_port_fit.py's tolerances for fit against JAX
LOG_RTOL, LOG_ATOL, WEIGHT_ATOL = 1e-5, 1e-7, 1e-5


def same_tree(got, want):
    """Leaf for leaf: the same key paths, dtypes and bits."""
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(path)
        assert np.array_equal(a, b), jax.tree_util.keystr(path)
    return len(g)


def untrained_dir(tmp, optimizer_type, swa, seed=3):
    """A checkpoint directory the JAX ``CheckpointManager`` writes for a JAX
    trainer of ``optimizer_type`` at E = H = 16: seeded weights, every
    optimizer leaf seeded (counts 7), step 7, and with ``swa`` an average."""
    jnet, params, _ = networks(optimizer_type, seed=seed)
    jtr = JaxTrainer(jnet, tmp, "m", seed=0, swa=JaxSWAConfig() if swa else None)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    leaves, treedef = jax.tree_util.tree_flatten(jtr.optimizer.init(jtr.params))
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(7, np.asarray(x).dtype) if np.ndim(x) == 0
              else np.abs(rng.normal(0, 0.1, np.shape(x))).astype(np.asarray(x).dtype)
              for x in leaves]
    jtr.opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
    jtr.global_step = 7
    if swa:
        jtr.swa.avg_params = jax.tree_util.tree_map(lambda p: p + 0.01, params)
        jtr.swa.n_averaged = 2
    jtr._save_epoch(1, 0.5)
    return jtr.checkpoints.last_path


@pytest.fixture(scope="module")
def untrained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("untrained")
    return {(opt, swa): untrained_dir(tmp / f"{opt}-{swa}", opt, swa)
            for opt in OPTIMIZERS for swa in (True, False)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per optimizer type, once: the JAX trainer's 3-epoch ``fit`` (SWA on,
    dropout off, every checkpoint kept), a copy of its epoch-1 directory
    (the run's directory ``<tmp>/chkpt/<name>``, with ``hyperparams.json``
    in ``<tmp>``), then the same trainer's resume from that copy and its
    epoch 2: the resumed trainer's step, logs, epoch-2 checkpoint, final
    weights and SWA average."""
    runs = {}

    def run(optimizer_type):
        if optimizer_type in runs:
            return runs[optimizer_type]
        tmp = tmp_path_factory.mktemp(optimizer_type)
        jnet, params, _ = networks(optimizer_type)
        jtr = JaxTrainer(jnet, tmp / "straight", "m", seed=0, keep_all_checkpoints=True,
                         steps_per_dispatch=1)
        jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
        jtr.opt_state = jtr.optimizer.init(jtr.params)
        jtr.fit(Module())
        epoch1 = sorted(p for p in (tmp / "straight").iterdir() if p.is_dir())[1]
        shutil.copytree(epoch1, tmp / "chkpt" / epoch1.name)
        (tmp / "hyperparams.json").write_text(json.dumps({"vocab_size": VOCAB,
                                                          "embedding_size": EMBED}))
        logged = {k: len(v) for k, v in jtr.loggers[0].metrics.items()}
        jtr.fit(Module(), checkpoint_path=tmp / "chkpt" / epoch1.name)
        runs[optimizer_type] = {
            "dir": tmp / "chkpt" / epoch1.name, "start_epoch": jtr.start_epoch,
            "global_step": jtr.global_step, "swa_n": jtr.swa.n_averaged,
            "params": to_port(jtr.params), "swa_avg": to_port(jtr.swa.avg_params),
            "epoch2": to_port(JaxCheckpointManager.restore(jtr.checkpoints.last_path)["params"]),
            "logs": {k: v[logged.get(k, 0):] for k, v in jtr.loggers[0].metrics.items()},
        }
        return runs[optimizer_type]

    return run


# -------------------------------------------------------------------- zstd
repetitive = st.tuples(st.binary(min_size=1, max_size=40), st.integers(1, 400)).map(
    lambda t: t[0] * t[1])
texty = st.lists(st.sampled_from([b"ACDE", b"FGHIK", b"LMNPQ", b"RSTVWY", b"\x00" * 9, b"\n"]),
                 max_size=600).map(b"".join)


@settings(max_examples=80, deadline=None, database=None)
@given(data=st.one_of(st.binary(max_size=3000), repetitive, texty),
       level=st.sampled_from([-5, 1, 3, 19]), checksum=st.booleans())
def test_zstd_decodes_what_zstandard_writes(data, level, checksum):
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_zstd_multi_block_frames(level, checksum):
    """Over 128 KiB, so several blocks (treeless literals, repeat tables,
    repeat offsets across blocks): seeded floats like a checkpoint's, then
    repetitive text."""
    rng = np.random.default_rng(level + 10)
    words = [bytes(rng.integers(97, 123, int(rng.integers(1, 8)), dtype=np.uint8))
             for _ in range(300)]
    data = (rng.normal(0, 0.05, 40_000).astype(np.float32).tobytes()
            + b" ".join(words[i] for i in rng.integers(0, 300, 30_000)))
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert len(data) > 2 * zstd.BLOCK_MAX
    assert zstd.decompress(frame) == data


def test_zstd_concatenated_and_skippable_frames():
    parts = [b"first " * 50, b"", bytes(range(256)) * 3]
    frames = [zstandard.ZstdCompressor(level=3).compress(p) for p in parts]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"skip!"
    assert zstd.decompress(frames[0] + skippable + frames[1] + frames[2]) == b"".join(parts)
    # a frame without its content size, as tensorstore's streaming writes
    stream = zstandard.ZstdCompressor(level=1, write_content_size=False).compressobj()
    frame = stream.compress(b"abc" * 999) + stream.flush()
    assert zstd.decompress(frame) == b"abc" * 999


def test_zstd_refuses_what_it_cannot_decode():
    data = b"protein " * 400
    good = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    corrupt = bytearray(good)
    corrupt[-1] ^= 1  # the checksum
    rng = np.random.default_rng(0)
    samples = [b" ".join(rng.choice([b"MKT", b"AYIA", b"KQRQ", b"ISFV"], 30)) for _ in range(400)]
    dictionary = zstandard.train_dictionary(1024, samples)
    with_dict = zstandard.ZstdCompressor(level=3, dict_data=dictionary).compress(data)
    for bad, why in ((bytes(corrupt), "checksum"), (good[:-9], None), (b"\x00" * 8, "magic"),
                     (with_dict, "dictionary"), (b"", "no zstd frame")):
        with pytest.raises(zstd.ZstdError, match=why):
            zstd.decompress(bad)
    assert isinstance(zstd.ZstdError(), ValueError)
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


def test_zstd_decodes_the_frames_of_a_real_checkpoint(untrained):
    """Every zarr chunk value and every manifest and node body tensorstore
    compressed in a JAX checkpoint directory, against zstandard."""
    path = untrained[("ranger21", True)]
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    frames = [bytes(kv.read(k).result().value) for k in kv.list().result()]
    frames = [f for f in frames if f[:4] == b"\x28\xb5\x2f\xfd"]
    for node in (path / "ocdbt.process_0" / "d").iterdir():
        raw = node.read_bytes()
        if raw[:4] == b"\x0c\xdb\x20\xde":  # a file of b-tree nodes: the first node's body
            frames.append(raw[14:int.from_bytes(raw[4:12], "little") - 4])
    frames.append((path / "manifest.ocdbt").read_bytes()[14:-4])
    assert len(frames) > 40
    for f in frames:
        assert zstd.decompress(f) == zstandard.ZstdDecompressor().decompressobj().decompress(f)


# ------------------------------------------------------------------- OCDBT
def tensorstore_databases(tmp):
    """Databases tensorstore writes with what an orbax directory rarely has:
    a tree many nodes deep (tiny nodes, values indirect past 8 bytes), many
    versions (an arity of 2), no compression, a last version that is
    empty."""
    rng = np.random.default_rng(1)
    out = {}
    for name, config, writes in (
            ("deep", {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 8}, 60),
            ("versions", {"version_tree_arity_log2": 1}, 40),
            ("raw", {"compression": None}, 20)):
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp / name}",
                              "config": config}).result()
        for i in range(writes):
            kv[f"key{int(rng.integers(0, 50)):03d}/" + "x" * int(rng.integers(0, 6))] = bytes(
                rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8))
        out[name] = tmp / name
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp / 'empty'}"}).result()
    kv["a"] = b"1"
    del kv["a"]
    out["empty"] = tmp / "empty"
    return out


def location(ref):
    return f"{ref[0]}:{ref[1]}:{ref[2]}"


def dumped(loc: str) -> str:
    """``kind:base:relative:offset:length`` -> ``base+relative:offset:length``."""
    _, base, rel, off, length = loc.split(":")
    return f"{base}{rel}:{off}:{length}"


def same_nodes(store, fkv, ref, height):
    node = store.node(ref, height)
    want = ts.ocdbt.dump(fkv, f"btreenode::{ref[0]}:{ref[1]}:{ref[2]}").result()
    assert want["height"] == node["height"] == height
    assert len(want["entries"]) == len(node["entries"])
    for e, w in zip(node["entries"], want["entries"]):
        assert e["key"] == w["key"]
        if height:
            assert e["subtree_common_prefix"] == w["subtree_common_prefix"]
            assert location(e["location"]) == dumped(w["location"])
            assert e["statistics"] == w["statistics"]
            same_nodes(store, fkv, e["location"], height - 1)
        elif isinstance(e["value"], bytes):
            assert e["value"] == w["inline_value"]
        else:
            assert location(e["value"]) == dumped(w["indirect_value"])


@pytest.fixture(scope="module")
def databases(untrained, tmp_path_factory):
    return {"jax": untrained[("adamw_1cycle", True)],
            **tensorstore_databases(tmp_path_factory.mktemp("ocdbt"))}


@pytest.mark.parametrize("name", ["jax", "deep", "versions", "raw", "empty"])
def test_ocdbt_matches_tensorstore(databases, name):
    path = databases[name]
    store = OcdbtStore(path)
    fkv = ts.KvStore.open({"driver": "file", "path": f"{path}/"}).result()
    manifest = ts.ocdbt.dump(fkv).result()
    cfg = dict(store.config)
    if cfg["compression"] is not None and cfg["compression"]["level"] == 0:
        cfg["compression"] = {"id": "zstd"}  # the dump leaves the default level out
    assert cfg == manifest["config"]
    newest = manifest["versions"][-1]
    v = store.version
    assert (v["generation"], v["height"], v["commit_time"]) == (
        newest["generation_number"], newest["root_height"], newest["commit_time"])
    assert {k: v[k] for k in newest["root"]["statistics"]} == newest["root"]["statistics"]
    nodes = manifest["version_tree_nodes"]
    assert store.version_nodes["generation"] == [n["generation_number"] for n in nodes]
    assert store.version_nodes["num_generations"] == [n["num_generations"] for n in nodes]
    assert store.version_nodes["height"] == [n["height"] for n in nodes]
    if name == "versions":
        assert len(nodes) > 1
    if "location" not in newest["root"]:
        assert store.root_ref is None and store.list() == [] and name == "empty"
    else:
        assert location(store.root_ref) == dumped(newest["root"]["location"])
        same_nodes(store, fkv, store.root_ref, v["height"])
    if name == "deep":
        assert v["height"] > 2
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    keys = [k.decode() for k in kv.list().result()]
    assert store.list() == sorted(keys)
    for k in keys:
        assert store.read(k) == bytes(kv.read(k).result().value), k
    assert store.get("no such key") is None
    with pytest.raises(KeyError):
        store.read("no such key")


def test_ocdbt_verifies_checksums_and_lengths(untrained, tmp_path):
    path = tmp_path / "copy"
    shutil.copytree(untrained[("ranger21", False)], path)
    raw = bytearray((path / "manifest.ocdbt").read_bytes())
    raw[20] ^= 0x40
    (path / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        OcdbtStore(path)
    (path / "manifest.ocdbt").write_bytes(bytes(raw[:-1]))
    with pytest.raises(ValueError, match="bytes"):
        OcdbtStore(path)
    with pytest.raises(ValueError, match=REFUSAL):
        restore_orbax(path)


# -------------------------------------------------------------------- zarr
@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("compressor", [None, {"id": "zstd", "level": 5}])
def test_read_zarr_matches_tensorstore(tmp_path, order, compressor):
    """A 7 x 5 array in 3 x 2 chunks, written in part (the chunks never
    written hold the fill value)."""
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}"},
            "path": "a.b", "metadata": {"shape": [7, 5], "chunks": [3, 2], "dtype": "<f4",
                                        "order": order, "compressor": compressor,
                                        "fill_value": 1.5}, "create": True}
    arr = ts.open(spec).result()
    arr[1:6, 0:3] = np.arange(15, dtype=np.float32).reshape(5, 3)
    want = arr.read().result()
    got = read_zarr(OcdbtStore(tmp_path), "a.b")
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert (got == 1.5).sum() == 20


# ------------------------------------------------------- the tree, restored
@pytest.mark.parametrize("swa", [True, False], ids=["swa", "no_swa"])
@pytest.mark.parametrize("optimizer_type", OPTIMIZERS)
def test_restore_orbax_equals_the_jax_restore(untrained, optimizer_type, swa):
    path = untrained[(optimizer_type, swa)]
    want = JaxCheckpointManager.restore(path)
    got = restore_orbax(path)
    assert same_tree(got, want) > 50
    assert isinstance(got["opt_state"], list) and ("swa_avg" in got) == swa
    assert checkpoint_kind(path) == "orbax"
    # the weights over 1 KiB are indirect values in the data files
    fkv = ts.KvStore.open({"driver": "file", "path": f"{path}/"}).result()
    root = ts.ocdbt.dump(fkv).result()["versions"][-1]["root"]
    assert root["statistics"]["num_indirect_value_bytes"] > 1024
    assert sorted(restore_orbax(path, ("params", "epoch"))) == ["epoch", "params"]


@pytest.mark.parametrize("optimizer_type", OPTIMIZERS)
def test_resume_puts_every_jax_leaf_in_place(untrained, optimizer_type):
    """Right after ``Trainer.resume``: the weights, each optimizer buffer,
    the step counts and the SWA average equal the JAX state's, bit for
    bit (``from_jax_state``'s cut of the leaf list by the params tree)."""
    path = untrained[(optimizer_type, True)]
    restored = JaxCheckpointManager.restore(path)
    _, _, net = networks(optimizer_type, seed=1)
    tr = Trainer(net, seed=0)
    tr.resume(path)
    assert (tr.start_epoch, tr.global_step, tr.swa.n_averaged) == (2, 7, 2)
    n = len(jax.tree_util.tree_leaves(restored["params"]))
    leaves = restored["opt_state"]
    tree = jax.tree_util.tree_structure(restored["params"])

    def buffer(k):
        return to_port(jax.tree_util.tree_unflatten(tree, leaves[1 + k * n:1 + (k + 1) * n]))

    names = (("grad_ma", "neg_grad_ma", "variance_ma", "slow")
             if optimizer_type.startswith("ranger21") else ("exp_avg", "exp_avg_sq"))
    want = {b: buffer(k) for k, b in enumerate(names)}
    params, avg = to_port(restored["params"]), to_port(restored["swa_avg"])
    for name, p in net.named_parameters():
        assert torch.equal(p.detach(), params[name]), name
        assert torch.equal(tr.swa.avg_params[name], avg[name]), name
        st = tr.optimizer.state[p]
        for b in names:
            assert torch.equal(st[b], want[b][name]), (name, b)
        if not optimizer_type.startswith("ranger21"):
            assert float(st["step"]) == 7.0
    if optimizer_type.startswith("ranger21"):
        assert tr.optimizer.count == 7
    # the live optimizer's hyperparameters stand
    assert [g["direction_stacked"] for g in tr.optimizer.param_groups] == [True, False]


def test_resume_refuses_another_optimizers_state(untrained):
    _, _, net = networks("adamw_1cycle", seed=1)
    with pytest.raises(ValueError, match="leaves"):
        Trainer(net, seed=0).resume(untrained[("ranger21", True)])


@pytest.mark.parametrize("optimizer_type", ["ranger21_xx", "adamw_1cycle"])
def test_resume_from_a_jax_run_matches_the_jax_resume(jax_runs, tmp_path, optimizer_type):
    """``fit`` from the JAX run's epoch-1 directory runs epoch 2 as the JAX
    trainer's resume does: its logs, its checkpoint's weights (before the
    SWA swap), the final weights and the SWA average."""
    run = jax_runs(optimizer_type)
    _, _, net = networks(optimizer_type, seed=1)
    tr = Trainer(net, tmp_path, "m", seed=0)
    tr.fit(Module(), checkpoint_path=run["dir"])
    assert (tr.start_epoch, tr.global_step, tr.swa.n_averaged) == (
        run["start_epoch"], run["global_step"], run["swa_n"]) == (2, 12, 2)
    logs = tr.loggers[0].metrics
    assert sorted(logs) == sorted(run["logs"])
    for k, want in run["logs"].items():
        assert [e["step"] for e in logs[k]] == [e["step"] for e in want], k
        if k not in CLOCK_KEYS:
            np.testing.assert_allclose([e["value"] for e in logs[k]],
                                       [e["value"] for e in want],
                                       rtol=LOG_RTOL, atol=LOG_ATOL, err_msg=k)
    epoch2 = CheckpointManager.restore(tr.checkpoints.last_path)["params"]
    for name, p in net.named_parameters():
        for got, want in ((epoch2[name], run["epoch2"][name]), (p.detach(), run["params"][name]),
                          (tr.swa.avg_params[name], run["swa_avg"][name])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=WEIGHT_ATOL, err_msg=name)


def test_train_cli_resumes_a_jax_run(jax_runs, tmp_path):
    """``train e2e_rnn_triplet --checkpoint_path`` on the JAX run's epoch-1
    directory trains epoch 2 alone."""
    run = jax_runs("adamw_1cycle")
    trainer, test = port_main([
        "train", "e2e_rnn_triplet", str(H5), str(SPM), "3", "3", "8", "--vocab_size", str(VOCAB),
        "--embedding_size", str(EMBED), "--trunc_len", "64", "--optimizer_type", "adamw_1cycle",
        "--checkpoint_path", str(run["dir"]), "--workers", "0", "--precision", "fp32",
        "--seed", "1", "--log_path", str(tmp_path), "--device", "cpu"])
    assert trainer.start_epoch == 2
    assert trainer.global_step == 8 + trainer.net.steps_per_epoch
    assert np.isfinite(test["test_loss"])


# ----------------------------------------------------- infer and export
def test_infer_from_csv_on_a_jax_directory_matches_the_jax_cli(jax_runs, tmp_path):
    run = jax_runs("ranger21_xx")
    rng = np.random.default_rng(4)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    seqs = {f"P{i}": "".join(rng.choice(aas, int(rng.integers(5, 70)))) for i in range(6)}
    fasta, pairs = tmp_path / "s.fasta", tmp_path / "p.csv"
    fasta.write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    names = list(seqs)
    pairs.write_text("".join(f"i{j},{names[int(rng.integers(6))]},{names[int(rng.integers(6))]}\n"
                             for j in range(7)))
    model = dict(trunc_len=32, batch_size=4, vocab_size=VOCAB, embedding_size=EMBED)
    assert JaxInfer.from_csv(pairs, fasta, run["dir"], SPM, tmp_path / "jax.csv", **model) == 7
    args = [a for k, v in model.items() for a in (f"--{k}", str(v))]
    assert port_main(["infer", "from_csv", "--interactions_path", str(pairs), "--sequences_path",
                      str(fasta), "--weights_path", str(run["dir"]), "--spm_path", str(SPM),
                      "--out_path", str(tmp_path / "port.csv"), *args, "--device", "cpu"]) == 7
    got, want = ([line.split(",") for line in (tmp_path / f).read_text().split()]
                 for f in ("port.csv", "jax.csv"))
    assert [r[0] for r in got] == [r[0] for r in want] == [f"i{j}" for j in range(7)]
    np.testing.assert_allclose([float(r[1]) for r in got], [float(r[1]) for r in want],
                               atol=1e-4, rtol=0)


def test_export_of_a_jax_directory_matches_the_jax_export(jax_runs, tmp_path):
    run = jax_runs("ranger21_xx")
    JaxExport().torch_ckpt(run["dir"], tmp_path / "jax.ckpt")
    port_main(["export", "torch_ckpt", "--checkpoint_path", str(run["dir"]), "--out_path",
               str(tmp_path / "port.ckpt")])
    got, want = (torch.load(tmp_path / f, weights_only=True) for f in ("port.ckpt", "jax.ckpt"))
    assert sorted(got) == sorted(want) == ["epoch", "global_step", "hyper_parameters",
                                           "state_dict"]
    assert (got["epoch"], got["global_step"], got["hyper_parameters"]) == (
        want["epoch"], want["global_step"], want["hyper_parameters"]) == (
        1, 8, {"vocab_size": VOCAB, "embedding_size": EMBED})
    assert list(got["state_dict"]) == list(want["state_dict"])
    for k, v in want["state_dict"].items():
        assert got["state_dict"][k].dtype == v.dtype and torch.equal(got["state_dict"][k], v), k


# ---------------------------------------------------------------- refusals
@pytest.fixture(scope="module")
def unreadable(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unreadable")
    tree = {"params": {"w": np.arange(600, dtype=np.float32).reshape(2, 300)}, "epoch": 1}
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(tmp / "zarr3", tree)
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(tmp / "no_ocdbt", tree)
    (tmp / "neither").mkdir()
    (tmp / "neither" / "intrepppid_meta.json").write_text("{}")
    return tmp


@pytest.mark.parametrize("kind,why", [("zarr3", "zarr v3"), ("no_ocdbt", "not in an OCDBT"),
                                      ("neither", r"checkpoint directory \(no")])
def test_unreadable_directories_are_refused_by_every_reader(unreadable, tmp_path, kind, why):
    path = unreadable / kind
    _, _, net = networks("ranger21", seed=1)
    readers = [lambda: load_reference_checkpoint(path), lambda: CheckpointManager.restore(path),
               lambda: Export.torch_ckpt(path, tmp_path / "out.ckpt"),
               lambda: Trainer(net, seed=0).resume(path), lambda: restore_orbax(path)]
    if kind == "neither":
        readers.append(lambda: checkpoint_kind(path))
    for read in readers:
        with pytest.raises(ValueError, match=why) as err:
            read()
        assert REFUSAL in str(err.value)
    assert not (tmp_path / "out.ckpt").exists()


# ------------------------------------------------------ the committed fixture
def test_the_committed_fixture_reads_as_the_jax_restore():
    """``tests/fixtures/jax_orbax_manuscript/``: the manuscript network's
    JAX run after 2 epochs (``ranger21``, SWA), read leaf for leaf as JAX
    reads it, its counts as ``tools/make_jax_orbax_fixture.py`` recorded."""
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert 3_000_000 < size < 6_000_000
    got = restore_orbax(FIXTURE)
    # 29 weight tensors in each of params, swa_avg and Ranger21's four trees
    assert same_tree(got, JaxCheckpointManager.restore(FIXTURE)) == 6 * 29 + 1 + 3
    expected = json.loads((FIXTURES / "jax_orbax_manuscript.json").read_text())
    assert (int(got["epoch"]), int(got["global_step"]), int(got["swa_n"]),
            int(got["opt_state"][0])) == (expected["epoch"], expected["global_step"],
                                          expected["swa_n"], expected["count"])
    assert got["params"]["encoder"]["embedding"].shape == (250, 64)


# the fixture's f32 scores against the JAX engine's: the CPU port gives 0
SCORE_TOL = 1e-6


def fixture_scores(weights):
    """infer's loader's weights through the scoring engine on the CPU in f32,
    on the fixture's 64 pairs: the largest distance from the JAX engine's
    probabilities."""
    scored = json.loads((FIXTURES / "jax_orbax_manuscript.json").read_text())["scored"]
    net = intrepppid_network(0, vocab_size=250, embedding_size=64, use_projection=True,
                             device="cpu")
    engine = ScoringEngine(net, weights, SentencePieceTokenizer(FIXTURE_SPM),
                           trunc_len=scored["trunc_len"], batch_size=len(scored["pairs"]),
                           bulk_batch_size=0)
    got = engine.score_pairs([tuple(p) for p in scored["pairs"]])
    return float(np.abs(np.asarray(got) - np.asarray(scored["probabilities"])).max())


def test_the_fixture_scores_as_the_jax_engine_did():
    assert fixture_scores(load_reference_checkpoint(FIXTURE)) <= SCORE_TOL


def swap_layers(sd):
    out = dict(sd)
    for k in sd:
        if k.startswith("encoder.lstm.0.") and not k.endswith("w_ih"):
            other = k.replace(".0.", ".1.")
            out[k], out[other] = sd[other], sd[k]
    return out


@pytest.mark.parametrize("fault", [
    lambda sd: {k: v.flip(0) if k.startswith("encoder.lstm.") else v for k, v in sd.items()},
    lambda sd: {k: v.flip(0) if k.startswith("encoder.lstm.0.") else v for k, v in sd.items()},
    swap_layers], ids=["directions", "layer0_directions", "layers"])
def test_a_planted_layout_fault_fails_the_fixtures_check(fault):
    """The weights read in a wrong layout (the LSTM directions swapped, or
    the layers) score further from the JAX engine than ``SCORE_TOL``, so the
    check above, and phase orbax's on the card, catch such a reader."""
    assert fixture_scores(fault(load_reference_checkpoint(FIXTURE))) > 100 * SCORE_TOL
