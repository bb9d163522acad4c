"""Ground rules of the port: it imports neither JAX nor the JAX package
(nor orbax, tensorstore or zstandard, which its reader of the JAX
package's checkpoints stands in for), and its entry points run on the card
unless the caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "intrepppid_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "intrepppid_tpu", "orbax", "tensorstore", "zstandard")


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                yield arg.value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_files_to_scan():
    names = {p.name for p in PORT_FILES}
    assert {"lstm.py", "lstm_cuda.py", "lstm_stack.py", "dropout.py", "losses.py",
            "metrics.py", "ranger21.py", "schedules.py", "trainer.py", "engine.py",
            "lstm_recurrence.py", "infer.py", "chip_smoke.py", "pipeline.py", "ppi_oma.py",
            "e2e_triplet.py", "train.py", "evaluate.py", "run_name.py", "mesh.py",
            "profiling.py", "zstd.py", "ocdbt.py", "orbax_read.py"} <= names


# a process in which importing any of FORBIDDEN fails
BLOCKED_IMPORTS = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
"""


def test_the_jax_checkpoint_reader_runs_without_jax():
    """In a process that cannot import JAX, orbax, tensorstore, zstandard or
    the JAX package: the port imports, and reads the committed JAX
    checkpoint (its weights through the loaders, its training state through
    ``Trainer.resume``)."""
    code = BLOCKED_IMPORTS.format(forbidden=FORBIDDEN, root=str(ROOT)) + """
import json
import intrepppid_tpu_torch, intrepppid_tpu_torch.__main__
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.train import Trainer
from intrepppid_tpu_torch.utils.convert import load_reference_checkpoint
fixture = sys.argv[1]
hp = json.load(open(fixture + ".json"))["hyperparameters"]
sd = load_reference_checkpoint(fixture)
net = intrepppid_network(hp["steps_per_epoch"], vocab_size=hp["vocab_size"],
                         embedding_size=hp["embedding_size"], optimizer_type=hp["optimizer_type"],
                         device="cpu")
tr = Trainer(net, seed=0)
tr.resume(fixture)
assert sorted(sd) == sorted(dict(net.named_parameters()))
assert (tr.optimizer.count, tr.global_step, tr.start_epoch) == (6, 6, 2)
try:
    import zstandard
except ImportError:
    print("ok", len(sd))
"""
    fixture = ROOT / "tests" / "fixtures" / "jax_orbax_manuscript"
    out = subprocess.run([sys.executable, "-c", code, str(fixture)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:2] == ["ok", "21"], out.stdout


def kernel_source(name):
    """``csrc/<name>.cu``, followed by the shared kernel header it includes
    (the two f32 sweeps share theirs, ``bilstm_bwd_f32.cuh``)."""
    from intrepppid_tpu_torch.ops import _build

    text = (_build.CSRC / f"{name}.cu").read_text()
    if '#include "bilstm_bwd_f32.cuh"' in text:
        text += (_build.CSRC / "bilstm_bwd_f32.cuh").read_text()
    return text


def test_every_kernel_source_is_built_and_bound():
    """Each CUDA source has a wrapper that loads it by name, and the shared
    header is part of every build's hash."""
    from intrepppid_tpu_torch.ops import _build, lstm_cuda

    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == {"bilstm_bwd", "lstm_recurrence_wgrad", "lstm_recurrence_wgrad_f32",
                       "bilstm_bwd_mma",
                       "lstm_recurrence_bwd_mma", "bilstm_fwd_mma", "bilstm_wgrad_mma",
                       "bilstm_bwd_f32", "lstm_recurrence_wgrad_mma", "bilstm_fwd_f32",
                       "lstm_recurrence_bwd_f32", "bilstm_gates_mma", "bilstm_bwd_lite_mma",
                       "bilstm_fwd_wide_mma", "bilstm_wgrad_f32", "bilstm_bwd_f32_onestage",
                       "lstm_recurrence_fwd_wide_mma", "lstm_recurrence_bwd_wide_mma",
                       "lstm_recurrence_bwd_wide_f32", "lstm_recurrence_fwd_wide_f32",
                       "bilstm_bwd_lite_f32", "bilstm_gates_f32", "bilstm_fwd_wide_f32",
                       "bilstm_bwd_lite_f32_resident", "lstm_recurrence_fwd_mma",
                       "bilstm_bwd_lite_mma_resident", "bilstm_fwd_wide_mma_resident",
                       "bilstm_fwd_wide_f32_resident", "lstm_recurrence_bwd_mid_f32",
                       "lstm_recurrence_bwd_mid_mma", "lstm_recurrence_fwd_mid_mma",
                       "lstm_recurrence_fwd_f32", "lstm_recurrence_fwd_mid_f32"}
    assert sources == set(lstm_cuda._SIGNATURES) == set(lstm_cuda._CONSTANTS)
    # each library's C entry and its error string are named in the sources
    for name, (fn, _) in lstm_cuda._SIGNATURES.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert f"int {fn}(" in text and lstm_cuda._ERROR_STRING[name] in text
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == {"bilstm_common.cuh", "bilstm_mma.cuh",
                                                           "bilstm_bwd_f32.cuh",
                                                           "lstm_recurrence_wide_mma.cuh",
                                                           "lstm_recurrence_wide_f32.cuh"}
    # every constant the wrappers check is exported by its source, and the
    # tensor-core kernels share the fragment header
    for name, (getters, want) in lstm_cuda._CONSTANTS.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert len(getters) == len(want)
        assert all(f"int {g}()" in text for g in getters), name
    for name, mma in (("bilstm_bwd_mma", "mma_bf16("), ("lstm_recurrence_bwd_mma", "mma_bf16("),
                      ("lstm_recurrence_fwd_mma", "mma_bf16("),
                      ("lstm_recurrence_fwd_f32", "mma_tf32("),
                      ("bilstm_fwd_mma", "mma_bf16("), ("bilstm_wgrad_mma", "mma_bf16("),
                      ("lstm_recurrence_wgrad_mma", "mma_bf16("),
                      ("lstm_recurrence_wgrad_f32", "mma_tf32("),
                      ("bilstm_gates_mma", "mma_bf16("), ("bilstm_gates_f32", "mma_tf32("),
                      ("bilstm_bwd_f32", "mma_tf32("), ("bilstm_fwd_f32", "mma_tf32("),
                      ("bilstm_bwd_f32_onestage", "mma_tf32("),
                      ("bilstm_bwd_lite_f32_resident", "mma_tf32("),
                      ("bilstm_bwd_lite_mma_resident", "mma_bf16("),
                      ("bilstm_fwd_wide_mma_resident", "mma_bf16("),
                      ("bilstm_fwd_wide_f32_resident", "mma_tf32("),
                      ("lstm_recurrence_bwd_f32", "mma_tf32("), ("bilstm_wgrad_f32", "mma_tf32(")):
        text = kernel_source(name)
        assert '#include "bilstm_mma.cuh"' in text and mma in text
        assert "cluster" not in text.rsplit("#include", 1)[1]  # no cluster past the header
    # the one-block bf16 lite sweep: the gate product's two chains and the dh
    # product on mma.sync, the latter's A fragments through ldmatrix.trans, its
    # K split over warp pairs that meet at a named barrier, the step tiles
    # through a cp.async ring
    text = kernel_source("bilstm_bwd_lite_mma_resident").rsplit("#include", 1)[1]
    assert text.count("mma_bf16(") == 3 and text.count("ldmatrix_x4_trans(") == 1
    assert "pair_sync(" in text and "bar.sync" in text and "cp_async16(" in text
    # the one-block bf16 wide forward: its gate product's two chains on
    # mma.sync from register fragments, no second product and no shared
    # weight copy, the xg tiles through a cp.async ring
    text = kernel_source("bilstm_fwd_wide_mma_resident").rsplit("#include", 1)[1]
    assert text.count("mma_bf16(") == 2 and "ldmatrix_x4(" in text and "cp_async16(" in text
    assert "ldmatrix_x4_trans(" not in text and "w_s" not in text.split()
    # its f32 twin: the same ring and two chains, the gate product in three
    # tf32 passes on f32 register fragments split where they are used, its B
    # operand one 16-byte shared load a chunk from the f32 h tile (no ldmatrix)
    text = kernel_source("bilstm_fwd_wide_f32_resident").rsplit("#include", 1)[1]
    assert text.count("mma_tf32(") == 3 and text.count("split_tf32(") == 5
    assert "cp_async16(" in text and "ldmatrix" not in text and "w_s" not in text.split()
    # the tensor-core lite sweep keeps the 8-block cluster split: both of its
    # products on mma.sync (the dh product through ldmatrix.trans), the
    # partial sums exchanged through distributed shared memory; so does its
    # instance for uneven unit groups at H = 288 (two more products, the
    # partials read by mapped 32-bit addresses)
    text = (_build.CSRC / "bilstm_bwd_lite_mma.cu").read_text().rsplit("#include", 1)[1]
    assert text.count("mma_bf16(") == 4 and text.count("ldmatrix_x4_trans(") == 2
    assert "map_shared_rank(" in text and "launch_wide(" in text
    assert "recwide::unit_groups(" in text and "recwide::mapa_u32(" in text
    # so does the tensor-core wide forward: its gate product on mma.sync, the
    # new h pushed to every block of the cluster through distributed shared
    # memory; and its instance for uneven unit groups at H = 288 (two more
    # products: one for each of the two groups a warp's items may span)
    text = (_build.CSRC / "bilstm_fwd_wide_mma.cu").read_text()
    assert '#include "bilstm_mma.cuh"' in text
    text = text.rsplit("#include", 1)[1]
    assert text.count("mma_bf16(") == 3 and "map_shared_rank(" in text and "launch_wide(" in text
    assert "recwide::unit_groups(" in text and "bilstm_fwd_wide_mma_uneven_kernel" in text
    # the bf16 recurrence kernels past 288 share their split, weight copy and
    # gate product (mma_bf16 through lstm_recurrence_wide_mma.cuh, which
    # includes the fragment header): both on 8-block clusters, the forward
    # pushing h and the sweep reading the partial dh through distributed
    # shared memory by mapped 32-bit addresses, the sweep's dh product on the
    # same weight fragments transposed in registers
    header = (_build.CSRC / "lstm_recurrence_wide_mma.cuh").read_text()
    assert '#include "bilstm_mma.cuh"' in header and "mma_bf16(" in header
    for name, exchange in (("lstm_recurrence_fwd_wide_mma", "st_dsmem_v4("),
                           ("lstm_recurrence_bwd_wide_mma", "ld_dsmem_f2(")):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "lstm_recurrence_wide_mma.cuh"' in text
        body = text.rsplit("#include", 1)[1]
        assert "gate_mma<" in body and "launch_wide_dirs(" in body and exchange in body
        assert "mapa_u32(" in body and "map_shared_rank(" not in body
    body = (_build.CSRC / "lstm_recurrence_bwd_wide_mma.cu").read_text().rsplit("#include", 1)[1]
    assert "movmatrix_trans(" in body and "mma_a4(" in body
    # the f32 kernels that read one f32 copy of the fragments (the op's
    # sweep and forward past 288, the layer's lite sweep and wide forward)
    # keep that split and exchange on the headers' helpers; their header holds the
    # three tf32 passes (mma3), the split in registers, the chunk loads and
    # the dh product's fragments transposed through movmatrix
    header = (_build.CSRC / "lstm_recurrence_wide_f32.cuh").read_text()
    assert '#include "lstm_recurrence_wide_mma.cuh"' in header
    assert header.count("mma_tf32(") == 3 and "split_tf32(" in header
    assert "movmatrix_trans(" in header and "mma_bf16(" not in header
    for name, exchange, launch in (
            ("lstm_recurrence_bwd_wide_f32", "ld_dsmem_f2(", "launch_wide_dirs("),
            ("lstm_recurrence_fwd_wide_f32", "st_dsmem_v4(", "launch_wide_dirs("),
            ("bilstm_bwd_lite_f32", "ld_dsmem_f2(", "launch_wide("),
            ("bilstm_fwd_wide_f32", "st_dsmem_v4(", "launch_wide("),
            ("lstm_recurrence_bwd_mid_f32", "ld_dsmem_f2(", "cudaLaunchKernelEx(")):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "lstm_recurrence_wide_f32.cuh"' in text
        body = text.rsplit("#include", 1)[1]
        assert "mma_tf32(" not in body and "mma_bf16(" not in body, name
        assert launch in body and exchange in body and "mapa_u32(" in body, name
        assert "map_shared_rank(" not in body, name
    for name in ("lstm_recurrence_bwd_wide_f32", "bilstm_bwd_lite_f32"):
        body = (_build.CSRC / f"{name}.cu").read_text().rsplit("#include", 1)[1]
        assert "dh_fragment(" in body and "mma3(" in body and "chunk_load(" in body, name
    body = (_build.CSRC / "lstm_recurrence_fwd_wide_f32.cu").read_text().rsplit("#include", 1)[1]
    assert "gate_mma_f32<" in body
    # the op's f32 sweep at 96-288: the lite sweep's item deal and both
    # products in three tf32 passes, its clusters of 4 or 8 blocks, the
    # fragments copied into shared memory (resident instances) or read from L2
    body = (_build.CSRC / "lstm_recurrence_bwd_mid_f32.cu").read_text().rsplit("#include", 1)[1]
    assert "dh_fragment(" in body and "mma3(" in body and "deal_items(" in body
    assert "clusterDim.x = CL" in body and "ldg_weight(" in body and "w_s[idx]" in body
    # the op's f32 forward at 96-288: the bf16 forward's schedule (item deal,
    # clusters of 4 or 8 blocks, the new h pushed to every block, the share
    # copied into shared memory or read from L2, xg and mask through a
    # cp.async ring) on the f32 header's fragment copy, its one product in
    # three tf32 passes summed apart, weights and h both split (never one
    # pass)
    text = (_build.CSRC / "lstm_recurrence_fwd_mid_f32.cu").read_text()
    assert '#include "lstm_recurrence_wide_f32.cuh"' in text
    body = text.rsplit("#include", 1)[1]
    assert body.count("mma_tf32(") == 3 and body.count("split4(") == 1
    assert body.count("split_tf32(") == 2 and "deal_items(" in body
    assert "clusterDim.x = CL" in body and "ldg_weight(" in body and "w_s[idx]" in body
    assert "cp_async16_n(" in body and "st_dsmem_v4(" in body and "mapa_u32(" in body
    assert "map_shared_rank(" not in body and "mma_bf16(" not in body
    # the op's bf16 sweep and forward at 96-288: one bf16 pass on the bf16
    # fragment copy (through lstm_recurrence_wide_mma.cuh), each block's share
    # copied once into shared memory, the item deal, clusters of 4 or 8
    # blocks, the sweep's partials and the forward's new h through
    # distributed shared memory by mapped 32-bit addresses; the sweep's dh
    # product on the same fragments transposed in registers, the forward's xg
    # and mask through a cp.async ring
    for name, exchange, own in (("lstm_recurrence_bwd_mid_mma", "ld_dsmem_f2(", "movmatrix_trans("),
                                ("lstm_recurrence_fwd_mid_mma", "st_dsmem_v4(", "cp_async16_n(")):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "lstm_recurrence_wide_mma.cuh"' in text
        body = text.rsplit("#include", 1)[1]
        assert "mma_a4(" in body and "deal_items(" in body and "w_s[idx]" in body, name
        assert "clusterDim.x = CL" in body and exchange in body and "mapa_u32(" in body, name
        assert own in body and "ldmatrix_x4(" in body, name
        assert "mma_tf32(" not in body and "map_shared_rank(" not in body, name
    # the bf16 resident forward ends a K of 8 mod 16 in one m16n8k8 step on
    # an ldmatrix.x1 of the [x ; h] tile (no zero k16 step), its row stride
    # a function of K; the f32 wgrad takes its tile as template parameters,
    # with launch bounds of the tile's blocks an SM
    text = (_build.CSRC / "bilstm_fwd_mma.cu").read_text().rsplit("#include", 1)[1]
    assert text.count("mma_bf16_k8(") == 2 and "ldmatrix_x1(b, " in text
    assert "KS = row_stride(K)" in text and "if constexpr (kTail)" in text
    text = (_build.CSRC / "bilstm_wgrad_f32.cu").read_text().rsplit("#include", 1)[1]
    assert "template <int TM, int TN>" in text
    assert "__launch_bounds__(kThreads, Tile<TM, TN>::kBlocks)" in text
    # the f32 kernels take three tf32 passes a product, never one: the
    # sweep and the forward split both operands; the recurrence sweep splits
    # its weights once while staging them, and its dh product takes the
    # small weights in the m16 tile's rows 8-15 (two mma, four terms); the
    # weight gradient splits each fragment once after loading it (two B
    # fragments, the four A fragments in a loop) and runs its three passes;
    # the one-stage sweep shares the f32 sweep's kernel; the lite sweep with
    # W_hh resident splits both operands of both of its products
    for name, mma, split in (("bilstm_bwd_f32", 6, 12), ("bilstm_bwd_f32_onestage", 6, 12),
                             ("bilstm_bwd_lite_f32_resident", 6, 12),
                             ("bilstm_fwd_f32", 3, 6),
                             ("lstm_recurrence_bwd_f32", 5, 4), ("bilstm_wgrad_f32", 3, 3),
                             ("lstm_recurrence_fwd_f32", 3, 3),
                             ("bilstm_gates_f32", 3, 1)):
        text = kernel_source(name).rsplit("#include", 1)[1]
        assert text.count("mma_tf32(") == mma and text.count("split_tf32(") == split, name


def test_default_device_is_the_card(monkeypatch):
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        intrepppid_network(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:1")
    assert resolve_device("cpu") == torch.device("cpu")
    net = intrepppid_network(0, vocab_size=30, embedding_size=8, device="cpu")
    assert all(p.device.type == "cpu" for p in net.parameters())


def test_infer_default_device_is_the_card(monkeypatch, tmp_path):
    """``Infer.from_csv`` without ``device="cpu"`` refuses on a machine
    without a card, before it reads or writes any file."""
    from intrepppid_tpu_torch.cli.infer import Infer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.csv"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Infer.from_csv(tmp_path / "pairs.csv", tmp_path / "seqs.fasta", tmp_path / "m.ckpt",
                       tmp_path / "spm.model", out)
    assert not out.exists()


@pytest.mark.parametrize("command", ["train", "eval"])
def test_train_and_eval_default_device_is_the_card(monkeypatch, tmp_path, command):
    """``train e2e_rnn_triplet`` and ``eval e2e_rnn_triplet`` without
    ``--device cpu`` refuse on a machine without a card, before they read or
    write any file (the run directories included)."""
    from intrepppid_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    data = ["--ppi_dataset_path", str(tmp_path / "none.h5"), "--sentencepiece_path",
            str(tmp_path / "none.model"), "--c_type", "3"]
    args = {"train": ["train", "e2e_rnn_triplet", *data, "--num_epochs", "1",
                      "--batch_size", "8", "--log_path", str(tmp_path / "logs")],
            "eval": ["eval", "e2e_rnn_triplet", *data, "--checkpoint_path",
                     str(tmp_path / "run" / "chkpt" / "best"),
                     "--out_path", str(tmp_path / "out.json")]}[command]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    assert not any(tmp_path.iterdir())
