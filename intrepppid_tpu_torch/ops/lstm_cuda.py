"""The bidirectional LSTM layer forward as a hand-written CUDA kernel.

``bilstm_layer_fwd`` is the counterpart of the JAX package's eval-mode
layer kernels, ``intrepppid_tpu/ops/lstm_pallas_packed.py:392
_fwd_pallas_packed`` (``with_states=False``, used at 2H == 128) and
``intrepppid_tpu/ops/lstm_pallas_layer.py:376 _fwd_pallas`` (other widths).
The kernel is ``csrc/bilstm_fwd.cu``; its header says what bounds it on the
card and how it is laid out. Its plain twin is ``ops/lstm.py:bidir_layer``.

For a CPU tensor the wrapper runs the plain twin. For a CUDA tensor it
launches the kernel, or raises for a shape, dtype or layout the kernel does
not take; it never falls back. ``bilstm_layer_fwd.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from intrepppid_tpu_torch.ops import _build
from intrepppid_tpu_torch.ops.lstm import bidir_layer as bilstm_layer_fwd_plain

# shared memory one block may use on Hopper (bytes)
SMEM_LIMIT = 232448
# the kernel's compile-time constants (kRows, kMaxChunks, kMaxThreads in
# csrc/bilstm_fwd.cu); checked against the built library when it loads
ROWS_PER_THREAD, MAX_CHUNKS, MAX_THREADS = 4, 4, 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("bilstm_fwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bilstm_layer_fwd.restype = i
        lib.bilstm_layer_fwd.argtypes = [i, p, p, i, i, p, p, p, p, p, p, p, p,
                                         i, i, i, i, i, p]
        lib.bilstm_error_string.restype = ctypes.c_char_p
        lib.bilstm_error_string.argtypes = [i]
        built = (lib.bilstm_rows_per_thread(), lib.bilstm_max_chunks(),
                 lib.bilstm_max_threads())
        if built != (ROWS_PER_THREAD, MAX_CHUNKS, MAX_THREADS):
            raise RuntimeError(
                f"csrc/bilstm_fwd.cu was built with (kRows, kMaxChunks, "
                f"kMaxThreads) = {built}; ops/lstm_cuda.py plans launches for "
                f"{(ROWS_PER_THREAD, MAX_CHUNKS, MAX_THREADS)}"
            )
        _lib = lib
    return _lib


def launch_plan(E_parts: Sequence[int], H: int,
                dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(threads, rows_per_block, smem_bytes)`` for a layer, or ValueError
    for a shape the kernel does not take."""
    size = torch.empty((), dtype=dtype).element_size()
    vec = 16 // size
    if H % 4 or H > MAX_THREADS:
        raise ValueError(f"bilstm kernel needs H % 4 == 0 and H <= {MAX_THREADS}, got H={H}")
    if any(e <= 0 or e % vec for e in E_parts):
        raise ValueError(
            f"bilstm kernel needs each input part's width to be a positive "
            f"multiple of {vec} for {dtype}, got {list(E_parts)}"
        )
    E = sum(E_parts)
    groups = MAX_THREADS // H
    threads, rows = H * groups, groups * ROWS_PER_THREAD

    def a16(n: int) -> int:
        return (n + 15) // 16 * 16

    smem = a16(E * 4 * H * size) + a16(H * 4 * H * size) + 2 * rows * (E + H) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"bilstm kernel: E={E}, H={H} in {dtype} needs {smem} bytes of "
            f"shared memory, more than the {SMEM_LIMIT} a block may use"
        )
    if rows * E // vec > MAX_CHUNKS * threads:
        raise ValueError(f"bilstm kernel: input width E={E} too wide for H={H}")
    return threads, rows, smem


def bilstm_layer_fwd(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bidirectional LSTM layer, time-major.

    :param x_parts: 1 or 2 ``(T, B, E_i)`` tensors in ``compute_dtype``.
    :param lengths: ``(B,)`` int32.
    :param w_ih: ``(2, 4H, E)`` and ``w_hh`` ``(2, 4H, H)`` in
        ``compute_dtype``; ``bias`` ``(2, 4H)`` f32 (``b_ih + b_hh``).
    :returns: ``hs_f, hs_b (T, B, H)`` in ``compute_dtype``, ``hn, cn
        (2, B, H)`` f32.
    """
    x_parts = tuple(x_parts)
    if not x_parts[0].is_cuda:
        return bilstm_layer_fwd_plain(x_parts, lengths, w_ih, w_hh, bias, compute_dtype)
    if compute_dtype not in _DTYPE_CODES:
        raise ValueError(f"bilstm kernel takes float32 or bfloat16, got {compute_dtype}")
    if len(x_parts) not in (1, 2):
        raise ValueError(f"bilstm kernel takes 1 or 2 input parts, got {len(x_parts)}")
    dev = x_parts[0].device
    T, B = x_parts[0].shape[:2]
    H = w_hh.shape[-1]

    def check(name, t, shape, dtype):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(
                f"bilstm kernel: {name} must be a contiguous {dtype} tensor of "
                f"shape {tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device} (contiguous={t.is_contiguous()})"
            )

    for k, p in enumerate(x_parts):
        check(f"x_parts[{k}]", p, (T, B, p.shape[-1]), compute_dtype)
    E_parts = [p.shape[-1] for p in x_parts]
    check("w_ih", w_ih, (2, 4 * H, sum(E_parts)), compute_dtype)
    check("w_hh", w_hh, (2, 4 * H, H), compute_dtype)
    check("bias", bias, (2, 4 * H), torch.float32)
    check("lengths", lengths, (B,), torch.int32)

    threads, _, smem = launch_plan(E_parts, H, compute_dtype)
    lib = _kernels()
    hs_f = torch.empty((T, B, H), dtype=compute_dtype, device=dev)
    hs_b = torch.empty_like(hs_f)
    hn = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    cn = torch.empty_like(hn)
    if B == 0:
        return hs_f, hs_b, hn, cn
    x1 = x_parts[1] if len(x_parts) == 2 else None
    with torch.cuda.device(dev):
        err = lib.bilstm_layer_fwd(
            _DTYPE_CODES[compute_dtype],
            x_parts[0].data_ptr(), x1.data_ptr() if x1 is not None else None,
            E_parts[0], E_parts[1] if x1 is not None else 0,
            lengths.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(),
            hs_f.data_ptr(), hs_b.data_ptr(), hn.data_ptr(), cn.data_ptr(),
            T, B, H, threads, smem, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"bilstm_layer_fwd launch failed: CUDA error {err} "
            f"({lib.bilstm_error_string(err).decode()})"
        )
    bilstm_layer_fwd.launches += 1
    return hs_f, hs_b, hn, cn


bilstm_layer_fwd.launches = 0
