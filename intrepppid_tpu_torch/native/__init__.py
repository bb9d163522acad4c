"""Native (C++) tokenizer engine, loaded via ctypes.

A copy of ``intrepppid_tpu/native`` built with ``g++`` directly (no
``make``, which a minimal image may lack) into ``native/build/`` on first
use. When no compiler is available the loader returns None and callers use
the pure-Python engine (``data/spm/unigram.py``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).parent
_SRC = _HERE / "spm_unigram.cc"
_LIB_PATH = _HERE / "build" / "libspm_unigram.so"
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_attempted = False


def build_native(force: bool = False) -> bool:
    """Compile the native library. Returns True on success."""
    if _LIB_PATH.exists() and not force:
        if _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
            return True
    _LIB_PATH.parent.mkdir(exist_ok=True)
    # build under a private name, then rename: a concurrent loader in
    # another process never sees a half-written library
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        subprocess.run(
            [cxx, *_CXXFLAGS, "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False


def load_spm_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the tokenizer library; None if unavailable.

    Set ``INTREPPPID_TPU_NO_NATIVE=1`` to force the pure-Python engine.
    """
    global _lib, _build_attempted
    if os.environ.get("INTREPPPID_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _build_attempted:
            return None
        _build_attempted = True
        if not build_native():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            # stale or foreign-architecture binary: rebuild once
            if not build_native(force=True):
                return None
            try:
                lib = ctypes.CDLL(str(_LIB_PATH))
            except OSError:
                return None
        lib.spm_load.restype = ctypes.c_void_p
        lib.spm_load.argtypes = [ctypes.c_char_p]
        lib.spm_free.argtypes = [ctypes.c_void_p]
        lib.spm_seed.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        for fn in ("spm_vocab_size", "spm_unk_id", "spm_bos_id", "spm_eos_id",
                   "spm_pad_id"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.spm_lattice_cache_stats.restype = None
        lib.spm_lattice_cache_stats.argtypes = [
            ctypes.c_void_p, *(ctypes.POINTER(ctypes.c_int64),) * 4,
        ]
        lib.spm_encode.restype = ctypes.c_int
        lib.spm_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.spm_encode_batch.restype = ctypes.c_int
        lib.spm_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib
