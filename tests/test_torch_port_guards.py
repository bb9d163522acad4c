"""Ground rules of the port: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""
import ast
from pathlib import Path

import pytest
import torch
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "intrepppid_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "intrepppid_tpu")


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
            "lstm_recurrence.py", "infer.py", "chip_smoke.py"} <= names


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
    assert sources == {"bilstm_fwd", "bilstm_bwd", "bilstm_wgrad", "bilstm_gates",
                       "bilstm_fwd_wide", "bilstm_bwd_lite", "lstm_recurrence_fwd",
                       "lstm_recurrence_bwd", "lstm_recurrence_wgrad", "bilstm_bwd_mma",
                       "lstm_recurrence_bwd_mma", "bilstm_fwd_mma", "bilstm_wgrad_mma",
                       "bilstm_bwd_f32", "lstm_recurrence_wgrad_mma", "bilstm_fwd_f32",
                       "lstm_recurrence_bwd_f32", "bilstm_gates_mma", "bilstm_bwd_lite_mma",
                       "bilstm_fwd_wide_mma", "bilstm_wgrad_f32", "bilstm_bwd_f32_onestage"}
    assert sources == set(lstm_cuda._SIGNATURES) == set(lstm_cuda._CONSTANTS)
    # each library's C entry and its error string are named in the sources
    for name, (fn, _) in lstm_cuda._SIGNATURES.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert f"int {fn}(" in text and lstm_cuda._ERROR_STRING[name] in text
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == {"bilstm_common.cuh", "bilstm_mma.cuh",
                                                           "bilstm_bwd_f32.cuh"}
    # every constant the wrappers check is exported by its source, and the
    # tensor-core kernels share the fragment header
    for name, (getters, want) in lstm_cuda._CONSTANTS.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert len(getters) == len(want)
        assert all(f"int {g}()" in text for g in getters), name
    for name, mma in (("bilstm_bwd_mma", "mma_bf16("), ("lstm_recurrence_bwd_mma", "mma_bf16("),
                      ("bilstm_fwd_mma", "mma_bf16("), ("bilstm_wgrad_mma", "mma_bf16("),
                      ("lstm_recurrence_wgrad_mma", "mma_bf16("),
                      ("bilstm_gates_mma", "mma_bf16("),
                      ("bilstm_bwd_f32", "mma_tf32("), ("bilstm_fwd_f32", "mma_tf32("),
                      ("bilstm_bwd_f32_onestage", "mma_tf32("),
                      ("lstm_recurrence_bwd_f32", "mma_tf32("), ("bilstm_wgrad_f32", "mma_tf32(")):
        text = kernel_source(name)
        assert '#include "bilstm_mma.cuh"' in text and mma in text
        assert "cluster" not in text.rsplit("#include", 1)[1]  # no cluster past the header
    # the tensor-core lite sweep keeps the 8-block cluster split: both of its
    # products on mma.sync (the dh product through ldmatrix.trans), the
    # partial sums exchanged through distributed shared memory
    text = (_build.CSRC / "bilstm_bwd_lite_mma.cu").read_text().rsplit("#include", 1)[1]
    assert text.count("mma_bf16(") == 2 and "ldmatrix_x4_trans(" in text
    assert "map_shared_rank(" in text and "launch_wide(" in text
    # so does the tensor-core wide forward: its gate product on mma.sync, the
    # new h pushed to every block of the cluster through distributed shared memory
    text = (_build.CSRC / "bilstm_fwd_wide_mma.cu").read_text()
    assert '#include "bilstm_mma.cuh"' in text
    text = text.rsplit("#include", 1)[1]
    assert text.count("mma_bf16(") == 1 and "map_shared_rank(" in text and "launch_wide(" in text
    # the CUDA-core cluster kernels dispatch each width to a block instance
    # (256 threads, 288, and for the recurrence op up to 1024 threads with
    # its weight slices read from the global copy)
    for name in ("bilstm_fwd_wide", "bilstm_bwd_lite", "lstm_recurrence_fwd",
                 "lstm_recurrence_bwd"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        recurrence = name.startswith("lstm_")
        assert ("dispatch_wide<true>(" in text) == recurrence, name
        assert ("kGlobalW" in text) == recurrence and "__launch_bounds__(kThreads, 1)" in text
    # the f32 kernels take three tf32 passes a product, never one: the
    # sweep and the forward split both operands; the recurrence sweep splits
    # its weights once while staging them, and its dh product takes the
    # small weights in the m16 tile's rows 8-15 (two mma, four terms); the
    # weight gradient splits each fragment once after loading it (two B
    # fragments, the four A fragments in a loop) and runs its three passes;
    # the one-stage sweep shares the f32 sweep's kernel
    for name, mma, split in (("bilstm_bwd_f32", 6, 12), ("bilstm_bwd_f32_onestage", 6, 12),
                             ("bilstm_fwd_f32", 3, 6),
                             ("lstm_recurrence_bwd_f32", 5, 4), ("bilstm_wgrad_f32", 3, 3)):
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
