"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own into
``intrepppid_tpu_torch/build/<name>-<hash>.so`` (the directory is
gitignored), one ``nvcc`` process per source, all started together. The
hash of the source names the library, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built at import: the first call that
needs a kernel builds it. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas -v report (registers, shared memory, spills) of each built library,
# kept beside it as <name>-<hash>.log
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
        "kernels of intrepppid_tpu_torch are built from csrc/ at first use"
    )


def _target(src: Path) -> Path:
    # the shared headers are part of every source's hash
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def _start(src: Path, nvcc: str) -> Tuple[Path, Path, Optional[subprocess.Popen]]:
    out = _target(src)
    if out.exists():
        return src, out, None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return src, out, proc


def build(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Build ``csrc/<name>.cu`` for each name (all sources when None) in
    parallel; return each name's library path. Raises on a failed build."""
    srcs = sorted(CSRC.glob("*.cu"))
    if names is not None:
        srcs = [CSRC / f"{n}.cu" for n in names]
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = [_start(s, nvcc) for s in srcs]
    paths, failures = {}, []
    for src, out, proc in jobs:
        if proc is not None:
            log, _ = proc.communicate()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"{src.name}:\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        log_file = out.with_suffix(".log")
        build_logs[src.stem] = log_file.read_text() if log_file.exists() else ""
        paths[src.stem] = out
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
