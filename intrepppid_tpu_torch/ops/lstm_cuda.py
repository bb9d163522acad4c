"""The bidirectional LSTM layer's hand-written CUDA kernels and wrappers.

Each layer takes one of two routes, fixed by its shapes and dtype before
any launch (``layer_route``), as the JAX package's ``pick_plan`` picks its
packed, fused or lite kernels. A layer no route takes at its own widths
runs at ``padded_width`` and ``padded_parts``: each gate block grown by
zero units and each input part by zero columns (``pad_layer``;
``layer_fwd`` and ``layer_bwd`` pad and cut back), the pair with the fewest
extra multiply-adds that a route takes, so every layer of 1 <= H <= 288
units has a route, every width the JAX kernels take (H <= 286) among them:

* **resident** -- where one block's shared memory holds the layer's
  weights (a forward kernel and a sweep kernel take the shape):

  * ``bilstm_layer_fwd`` (eval) and ``bilstm_layer_fwd_train`` (train: also
    the cell streams) are the counterpart of
    ``intrepppid_tpu/ops/lstm_pallas_packed.py:392 _fwd_pallas_packed``
    (``with_states`` False / True; 2H == 128) and of
    ``intrepppid_tpu/ops/lstm_pallas_layer.py:376 _fwd_pallas`` at the
    other widths that fit. Three kernels do it, picked by shape and dtype
    (``fwd_kernel``): ``bilstm_layer_fwd_mma`` and
    ``bilstm_layer_fwd_train_mma`` launch ``csrc/bilstm_fwd_mma.cu`` (bf16,
    H <= 64: the products on the tensor cores), ``bilstm_layer_fwd_f32`` and
    ``bilstm_layer_fwd_train_f32`` launch ``csrc/bilstm_fwd_f32.cu`` (f32,
    H <= 64: three tf32 passes a product on the tensor cores), and the two
    wrappers themselves launch ``csrc/bilstm_fwd.cu`` for the rest (CUDA
    cores: f32 past H = 64, and the bf16 shapes the tensor-core forward does
    not take). Plain twin of all three: ``ops/lstm.py:bidir_layer``.
  * ``bilstm_bwd`` is the reverse-time sweep of ``lstm_pallas_packed.py:750
    _bwd_pallas_packed`` and of ``lstm_pallas_layer.py:603 _bwd_pallas``.
    Four kernels do it, picked by shape and dtype (``sweep_kernel``):
    ``bilstm_bwd_mma`` launches ``csrc/bilstm_bwd_mma.cu`` (bf16, H <= 64:
    the products on the tensor cores), ``bilstm_bwd_f32`` launches
    ``csrc/bilstm_bwd_f32.cu`` (f32, H <= 64: three tf32 passes a product on
    the tensor cores), ``bilstm_bwd_f32_onestage`` launches
    ``csrc/bilstm_bwd_f32_onestage.cu`` (the same kernel with one [x ; h]
    stage, f32 at E = H = 80), and ``bilstm_bwd`` itself launches
    ``csrc/bilstm_bwd.cu`` for the rest (CUDA cores: bf16 at H = 80). Plain
    twin of all four: ``ops/lstm.py:bidir_layer_sweep``.

* **wide** -- the rest (the scaled configuration's H = 256, and H = 128):

  * ``bilstm_gates`` is the input projection those TPU kernels form in
    their body (``_xg2``), by one of two kernels (``gates_kernel``):
    ``bilstm_gates_mma`` launches ``csrc/bilstm_gates_mma.cu`` (bf16: a GEMM
    on the tensor cores), ``bilstm_gates`` itself launches
    ``csrc/bilstm_gates.cu`` (f32, CUDA cores). Plain twin of both:
    ``ops/lstm.py:input_gates``.
  * ``bilstm_fwd_wide`` (eval) and ``bilstm_fwd_wide_train`` are the
    recurrence over those gates with ``W_hh`` split over a cluster of 8
    blocks, by one of two kernels (``wide_fwd_kernel``):
    ``bilstm_fwd_wide_mma`` and ``bilstm_fwd_wide_train_mma`` launch
    ``csrc/bilstm_fwd_wide_mma.cu`` (bf16, H = 128 and 256: the product on
    the tensor cores), the two wrappers themselves launch
    ``csrc/bilstm_fwd_wide.cu`` for the rest (f32, and the bf16 widths the
    tensor-core forward does not take; CUDA cores). With ``bilstm_gates``,
    the counterpart of ``_fwd_pallas`` at these widths. Plain twin of both:
    ``ops/lstm.py:bidir_recurrence``.
  * ``bilstm_bwd_lite`` is the sweep over the gate streams of
    ``lstm_pallas_layer.py:723 _bwd_pallas_lite`` (f32 gate cotangents
    out), by one of two kernels (``lite_kernel``):
    ``bilstm_bwd_lite_mma`` launches ``csrc/bilstm_bwd_lite_mma.cu`` (bf16,
    H = 128 and 256: the products on the tensor cores),
    ``bilstm_bwd_lite`` itself launches ``csrc/bilstm_bwd_lite.cu`` for the
    rest (f32, and the bf16 widths the tensor-core sweep does not take; CUDA
    cores). Plain twin of both: ``ops/lstm.py:bidir_layer_sweep_lite``.

* both routes: ``bilstm_wgrad``, the weight-gradient products, by one of
  three kernels (``wgrad_kernel``): ``bilstm_wgrad_mma`` launches
  ``csrc/bilstm_wgrad_mma.cu`` (bf16, H % 8 == 0: a split-K GEMM on the
  tensor cores, its last 128-row gate tile masked where H % 32 != 0),
  ``bilstm_wgrad_f32`` launches ``csrc/bilstm_wgrad_f32.cu`` (f32,
  H % 32 == 0: the same GEMM in three tf32 passes), ``bilstm_wgrad``
  itself launches ``csrc/bilstm_wgrad.cu`` for the rest (f32 at other
  widths, CUDA cores). Plain twin of all three:
  ``ops/lstm.py:bidir_layer_wgrad``.

Beside the layer kernels, the time-major recurrence op
(``ops/lstm_recurrence.py``, the counterpart of
``intrepppid_tpu/ops/lstm_pallas.py``; a width they do not take runs at
``recurrence_width``, padded, up to ``REC_MAX_H`` on the card) has kernels
of its own: three on the wide route's cluster design at every width they
take (past 288 the forward and the cluster sweep read their weight slices
from an L2-resident global copy, ``recurrence_global_weights``), and two
tensor-core ones:

* ``lstm_recurrence_fwd`` launches ``csrc/lstm_recurrence_fwd.cu``
  (``lstm_pallas.py:145 _fwd_pallas``). Plain twin: ``recurrence_fwd``.
* ``lstm_recurrence_bwd`` is the reverse-time sweep of ``lstm_pallas.py:274
  _bwd_pallas`` (``dxg``), by one of three kernels
  (``recurrence_sweep_kernel``): ``lstm_recurrence_bwd_mma`` launches
  ``csrc/lstm_recurrence_bwd_mma.cu`` (bf16, H = 32 or 64: one block per
  row tile, tensor cores), ``lstm_recurrence_bwd_f32`` launches
  ``csrc/lstm_recurrence_bwd_f32.cu`` (f32, H = 32 or 64: the same design
  in three tf32 passes), ``lstm_recurrence_bwd`` itself launches the
  cluster kernel ``csrc/lstm_recurrence_bwd.cu`` for the rest (H >= 96).
  Plain twin of all three: ``recurrence_sweep``.
* ``lstm_recurrence_wgrad`` is that kernel's ``dW`` sums, by one of two
  kernels (``recurrence_wgrad_kernel``): ``lstm_recurrence_wgrad_mma``
  launches ``csrc/lstm_recurrence_wgrad_mma.cu`` (bf16: a split-K GEMM on
  the tensor cores), ``lstm_recurrence_wgrad`` itself launches
  ``csrc/lstm_recurrence_wgrad.cu`` (f32, CUDA cores). Plain twin of both:
  ``recurrence_wgrad``.

These refuse operands that require grad under grad mode for CPU tensors
too: only ``FusedLSTMRecurrence`` calls them.

``layer_fwd`` and ``layer_bwd`` run one layer on its route. Each source's
header says what bounds it on the card and how it is laid out. For a CPU
tensor a wrapper runs its plain twin, so the CPU takes the same routes. For
a CUDA tensor it launches the kernel, or raises for a shape, dtype or
layout the kernel does not take; it never falls back. Where a weight
group's rows are not a whole number of row tiles, the resident wrappers pad
each group with length-0 rows and slice them off (the JAX package does the
same, ``ops/lstm.py:241-260``); the wide kernels cut each group into its
own tiles, as do the tensor-core kernels. Each wrapper's ``.launches``
counts the launches of its own kernel: a sweep that ``bilstm_bwd``
hands to ``bilstm_bwd_mma`` or ``bilstm_bwd_f32`` counts there, and so do
the forwards (the wide ones too), ``bilstm_wgrad``, ``bilstm_gates``,
``bilstm_bwd_lite``, ``lstm_recurrence_bwd`` and ``lstm_recurrence_wgrad``.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from fractions import Fraction
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from intrepppid_tpu_torch.ops import _build
from intrepppid_tpu_torch.ops.lstm import (
    bidir_layer,
    bidir_layer_sweep,
    bidir_layer_sweep_lite,
    bidir_layer_wgrad,
    bidir_recurrence,
    grouped_w_hh,
    input_gates,
    input_grads,
)
from intrepppid_tpu_torch.ops.lstm_recurrence import (
    recurrence_fwd,
    recurrence_sweep,
    recurrence_wgrad,
)

bilstm_layer_fwd_plain = bidir_layer

# shared memory one block may use on Hopper (bytes)
SMEM_LIMIT = 232448
# the kernels' compile-time constants, checked against each built library
# when it loads: bilstm_fwd.cu (kMaxRows, kMaxChunks, kMaxThreads),
# bilstm_bwd.cu (kRows, kMaxChunks, kMaxThreads, kMaxRX, kPad),
# bilstm_wgrad.cu (kTile), bilstm_gates.cu (kBN, kBK), bilstm_common.cuh
# (kWideCluster, kWideMaxThreads, kRecMaxH, kWideRowsMask), bilstm_bwd_lite.cu and
# lstm_recurrence_bwd.cu (kPad), lstm_recurrence_wgrad.cu (kTile),
# lstm_recurrence_wgrad_mma.cu (kTileM, kTileN, kTileK, kSmem),
# bilstm_mma.cuh (kMmaTile), bilstm_bwd_mma.cu (kStages, kMaxChunks,
# kMaxThreads, kMaxH, kPad), bilstm_bwd_f32.cu and bilstm_bwd_f32_onestage.cu
# (kMmaTile, kMaxChunks, kMaxThreads, kMaxH, kStrideAlign, kStridePad),
# lstm_recurrence_bwd_mma.cu (kStages, kMaxChunks,
# kMaxH, kWPad, kFPad), bilstm_fwd_mma.cu (kStages, kMaxChunks, kMaxThreads,
# kPad), bilstm_wgrad_mma.cu (kTileM, kTileN, kTileK, kStages),
# bilstm_fwd_f32.cu (kMmaTile, kMaxChunks, kMaxThreads, kMaxH, kStrideAlign,
# kStridePad), lstm_recurrence_bwd_f32.cu (kMmaTile, kStages, kMaxChunks,
# kMaxH, kWPad, kFPad), bilstm_gates_mma.cu (kBM, kBN, kBK, kStages, kSmem),
# bilstm_bwd_lite_mma.cu (kWideCluster, kThreads, kPad, kXgPad),
# bilstm_fwd_wide_mma.cu (kWideCluster, kThreads, kPad), bilstm_wgrad_f32.cu
# (kTileM, kTileN, kTileK, kStages, kSmem)
ROWS_PER_THREAD, MAX_CHUNKS, MAX_THREADS = 4, 4, 256
BWD_ROWS_PER_THREAD, BWD_MAX_CHUNKS, BWD_MAX_DX_ROWS, BWD_PAD = 2, 4, 8, 4
WGRAD_TILE = 64
GATES_TILE_N, GATES_TILE_K = 128, 16
# the wide kernels' blocks hold H threads, one per unit: at most 288 (a
# second instance past 256); the recurrence kernels' up to REC_MAX_H, past
# 288 with their weight slices in global memory
WIDE_CLUSTER, WIDE_MAX_THREADS, WIDE_PAD, REC_MAX_H = 8, 288, 4, 1024
# the tensor-core sweeps: rows per block (the n of mma m16n8k16), cp.async
# stages, 16-byte chunks a thread copies per step, widest H, row padding
MMA_TILE, MMA_STAGES, MMA_MAX_H, MMA_PAD = 8, 3, 64, 8
BWD_MMA_MAX_CHUNKS, BWD_MMA_MAX_THREADS = 3, 384
REC_MMA_MAX_CHUNKS, REC_MMA_F32_PAD = 4, 4
# the f32 tensor-core sweep: [x ; h] chunks a thread copies per step, and
# its weight / tile row stride K rounded up to 32 floats plus 8
BWD_F32_MAX_CHUNKS, BWD_F32_STRIDE_ALIGN, BWD_F32_STRIDE_PAD = 2, 32, 8
# the one-stage f32 tensor-core sweep (past bilstm_bwd_f32.cu's shared
# memory): threads a block and its widest H (its chunks and strides are the
# f32 sweep's)
BWD_F32_ONESTAGE_MAX_THREADS, BWD_F32_ONESTAGE_MAX_H = 320, 80
# the tensor-core forward: its (H, E) instances (the model's layers at the
# resident widths, E = H and E = 2H; at H = 48 no sweep takes E = 96), x
# chunks a thread copies per step
FWD_MMA_SHAPES = ((16, 16), (16, 32), (32, 32), (32, 64), (48, 48), (64, 64), (64, 128))
FWD_MMA_MAX_CHUNKS = 2
# the f32 tensor-core forward: x chunks a thread copies per step (its row
# stride is the f32 sweep's), and the row tiles it takes: one or two n8 tiles
FWD_F32_MAX_CHUNKS, FWD_F32_ROWS = 2, (8, 16)
# the tensor-core wgrad: block tile (gate rows x source columns), rows per
# K-tile, cp.async stages, and its dynamic shared memory
WGRAD_MMA_TILE_M, WGRAD_MMA_TILE_N, WGRAD_MMA_TILE_K, WGRAD_MMA_STAGES = 128, 128, 32, 4
WGRAD_MMA_SMEM = 2 * WGRAD_MMA_STAGES * WGRAD_MMA_TILE_K * (WGRAD_MMA_TILE_M + MMA_PAD) * 2
# the recurrence op's tensor-core wgrad: block tile (h columns x gate
# columns), rows per K-tile, its two shared stages (bytes), and the blocks
# its split aims for: one wave of the 132 SMs at two blocks each
REC_WGRAD_MMA_TILE_M, REC_WGRAD_MMA_TILE_N, REC_WGRAD_MMA_TILE_K = 64, 128, 64
REC_WGRAD_MMA_SMEM = 2 * REC_WGRAD_MMA_TILE_K * (
    REC_WGRAD_MMA_TILE_M + MMA_PAD + REC_WGRAD_MMA_TILE_N + MMA_PAD) * 2
REC_WGRAD_MMA_TARGET_BLOCKS = 2 * 132
# rows each wide-kernel thread may own; the row tile is WIDE_CLUSTER times that
WIDE_ROWS = (2, 4, 7, 10)
_WIDE_ROWS_MASK = sum(1 << r for r in WIDE_ROWS)
# the tensor-core input gates: block tile (rows x gate columns), input
# columns a stage, cp.async stages, and its dynamic shared memory
GATES_MMA_TILE_M, GATES_MMA_TILE_N, GATES_MMA_TILE_K, GATES_MMA_STAGES = 128, 128, 32, 4
GATES_MMA_SMEM = GATES_MMA_STAGES * (GATES_MMA_TILE_M + GATES_MMA_TILE_N) * (
    GATES_MMA_TILE_K + MMA_PAD) * 2
# the tensor-core lite sweep: the widths and row tiles it is instantiated
# for (a row tile is a multiple of the n8 tile), threads a block, and the
# padding of its f32 xg rows (its bf16 rows take MMA_PAD)
LITE_MMA_WIDTHS, LITE_MMA_ROWS = (128, 256), (16, 32, 40, 80)
LITE_MMA_THREADS, LITE_MMA_XG_PAD = 256, 4
# the tensor-core wide forward: the widths and row tiles it is instantiated
# for, and threads a block
FWD_WIDE_MMA_WIDTHS, FWD_WIDE_MMA_ROWS = (128, 256), (16, 32, 40, 64, 80)
FWD_WIDE_MMA_THREADS = 256
# the f32 tensor-core wgrad (three tf32 passes): the tiles of the bf16 one,
# cp.async stages, and its dynamic shared memory (f32 rows of 128 + 8)
WGRAD_F32_STAGES = 4
# waves of blocks the f32 wgrad's split may reach (``wgrad_f32_plan``)
WGRAD_F32_MAX_WAVES = 8
WGRAD_F32_SMEM = 2 * WGRAD_F32_STAGES * WGRAD_MMA_TILE_K * (WGRAD_MMA_TILE_M + 8) * 4
# blocks the wgrad split aims for: a few waves of the 132 SMs
WGRAD_TARGET_BLOCKS = 4 * 132
# a layer no route takes at its own widths runs at H or a multiple of
# PAD_STEP (``padded_width``: the tensor-core kernels' 16-unit groups), each
# input part at its width or a multiple of PART_STEP (``padded_parts``: the
# kernels' 16-byte bf16 chunks)
PAD_STEP, PART_STEP = 16, 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bilstm_fwd": ("bilstm_layer_fwd", [_I, _P, _P, _I, _I] + [_P] * 10 + [_I] * 7 + [_P]),
    "bilstm_bwd": ("bilstm_bwd", [_I, _P, _P, _I, _I] + [_P] * 12 + [_I] + [_P] * 8
                   + [_I] * 6 + [_P]),
    "bilstm_bwd_mma": ("bilstm_bwd_mma", [_P, _P, _I, _I] + [_P] * 12 + [_I] + [_P] * 8
                       + [_I] * 7 + [_P]),
    "bilstm_bwd_f32": ("bilstm_bwd_f32", [_P, _P, _I, _I] + [_P] * 12 + [_I] + [_P] * 8
                       + [_I] * 7 + [_P]),
    "bilstm_bwd_f32_onestage": ("bilstm_bwd_f32_onestage", [_P, _P, _I, _I] + [_P] * 12 + [_I]
                                + [_P] * 8 + [_I] * 7 + [_P]),
    "bilstm_wgrad": ("bilstm_wgrad", [_I] + [_P] * 3 + [_I, _I] + [_P] * 3 + [_I] * 5 + [_P]),
    "bilstm_fwd_mma": ("bilstm_fwd_mma", [_P, _P, _I, _I] + [_P] * 10 + [_I] * 6 + [_P]),
    "bilstm_wgrad_mma": ("bilstm_wgrad_mma", [_P] * 3 + [_I, _I] + [_P] * 3 + [_I] * 5 + [_P]),
    "bilstm_gates": ("bilstm_gates", [_I] + [_P] * 2 + [_I, _I] + [_P] * 3 + [_I] * 3 + [_P]),
    "bilstm_fwd_wide": ("bilstm_fwd_wide", [_I, _I] + [_P] * 9 + [_I] * 6 + [_P, _P]),
    "bilstm_bwd_lite": ("bilstm_bwd_lite", [_I, _I] + [_P] * 11 + [_I] + [_P] * 3
                        + [_I] * 6 + [_P, _P]),
    "bilstm_gates_mma": ("bilstm_gates_mma", [_P, _P, _I, _I] + [_P] * 3 + [_I] * 3 + [_P]),
    "bilstm_bwd_lite_mma": ("bilstm_bwd_lite_mma", [_I] + [_P] * 11 + [_I] + [_P] * 3
                            + [_I] * 6 + [_P, _P]),
    "lstm_recurrence_fwd": ("lstm_recurrence_fwd", [_I, _I] + [_P] * 8 + [_I] * 7 + [_P, _P]),
    "lstm_recurrence_bwd": ("lstm_recurrence_bwd", [_I, _I] + [_P] * 10 + [_I] * 7 + [_P, _P]),
    "lstm_recurrence_bwd_mma": ("lstm_recurrence_bwd_mma", [_P] * 9 + [_I] * 7 + [_P]),
    "lstm_recurrence_wgrad": ("lstm_recurrence_wgrad", [_I] + [_P] * 3 + [_I] * 6 + [_P]),
    "lstm_recurrence_wgrad_mma": ("lstm_recurrence_wgrad_mma", [_P] * 3 + [_I] * 6 + [_P]),
    "bilstm_fwd_f32": ("bilstm_fwd_f32", [_P, _P, _I, _I] + [_P] * 10 + [_I] * 8 + [_P]),
    "lstm_recurrence_bwd_f32": ("lstm_recurrence_bwd_f32", [_P] * 9 + [_I] * 7 + [_P]),
    "bilstm_fwd_wide_mma": ("bilstm_fwd_wide_mma", [_I] + [_P] * 9 + [_I] * 6 + [_P, _P]),
    "bilstm_wgrad_f32": ("bilstm_wgrad_f32", [_P] * 3 + [_I, _I] + [_P] * 3 + [_I] * 5 + [_P]),
}
_CONSTANTS = {
    "bilstm_fwd": (("bilstm_rows_per_thread", "bilstm_max_chunks", "bilstm_max_threads"),
                   (ROWS_PER_THREAD, MAX_CHUNKS, MAX_THREADS)),
    "bilstm_bwd": (("bilstm_bwd_rows_per_thread", "bilstm_bwd_max_chunks",
                    "bilstm_bwd_max_threads", "bilstm_bwd_max_dx_rows", "bilstm_bwd_pad"),
                   (BWD_ROWS_PER_THREAD, BWD_MAX_CHUNKS, MAX_THREADS, BWD_MAX_DX_ROWS, BWD_PAD)),
    "bilstm_bwd_mma": (("bilstm_bwd_mma_tile", "bilstm_bwd_mma_stages",
                        "bilstm_bwd_mma_max_chunks", "bilstm_bwd_mma_max_threads",
                        "bilstm_bwd_mma_max_h", "bilstm_bwd_mma_pad"),
                       (MMA_TILE, MMA_STAGES, BWD_MMA_MAX_CHUNKS, BWD_MMA_MAX_THREADS,
                        MMA_MAX_H, MMA_PAD)),
    "bilstm_bwd_f32": (("bilstm_bwd_f32_tile", "bilstm_bwd_f32_max_chunks",
                        "bilstm_bwd_f32_max_threads", "bilstm_bwd_f32_max_h",
                        "bilstm_bwd_f32_stride_align", "bilstm_bwd_f32_stride_pad"),
                       (MMA_TILE, BWD_F32_MAX_CHUNKS, BWD_MMA_MAX_THREADS, MMA_MAX_H,
                        BWD_F32_STRIDE_ALIGN, BWD_F32_STRIDE_PAD)),
    "bilstm_bwd_f32_onestage": (("bilstm_bwd_f32_onestage_tile",
                                 "bilstm_bwd_f32_onestage_max_chunks",
                                 "bilstm_bwd_f32_onestage_max_threads",
                                 "bilstm_bwd_f32_onestage_max_h",
                                 "bilstm_bwd_f32_onestage_stride_align",
                                 "bilstm_bwd_f32_onestage_stride_pad"),
                                (MMA_TILE, BWD_F32_MAX_CHUNKS, BWD_F32_ONESTAGE_MAX_THREADS,
                                 BWD_F32_ONESTAGE_MAX_H, BWD_F32_STRIDE_ALIGN,
                                 BWD_F32_STRIDE_PAD)),
    "bilstm_wgrad": (("bilstm_wgrad_tile",), (WGRAD_TILE,)),
    "bilstm_fwd_mma": (("bilstm_fwd_mma_tile", "bilstm_fwd_mma_stages",
                        "bilstm_fwd_mma_max_chunks", "bilstm_fwd_mma_max_threads",
                        "bilstm_fwd_mma_pad"),
                       (MMA_TILE, MMA_STAGES, FWD_MMA_MAX_CHUNKS, MAX_THREADS, MMA_PAD)),
    "bilstm_wgrad_mma": (("bilstm_wgrad_mma_tile_m", "bilstm_wgrad_mma_tile_n",
                          "bilstm_wgrad_mma_tile_k", "bilstm_wgrad_mma_stages",
                          "bilstm_wgrad_mma_smem"),
                         (WGRAD_MMA_TILE_M, WGRAD_MMA_TILE_N, WGRAD_MMA_TILE_K,
                          WGRAD_MMA_STAGES, WGRAD_MMA_SMEM)),
    "bilstm_gates": (("bilstm_gates_tile_n", "bilstm_gates_tile_k"),
                     (GATES_TILE_N, GATES_TILE_K)),
    "bilstm_fwd_wide": (("bilstm_fwd_wide_cluster", "bilstm_fwd_wide_max_threads",
                         "bilstm_fwd_wide_rows_mask"),
                        (WIDE_CLUSTER, WIDE_MAX_THREADS, _WIDE_ROWS_MASK)),
    "bilstm_bwd_lite": (("bilstm_bwd_lite_cluster", "bilstm_bwd_lite_max_threads",
                         "bilstm_bwd_lite_rows_mask", "bilstm_bwd_lite_pad"),
                        (WIDE_CLUSTER, WIDE_MAX_THREADS, _WIDE_ROWS_MASK, WIDE_PAD)),
    "bilstm_gates_mma": (("bilstm_gates_mma_tile_m", "bilstm_gates_mma_tile_n",
                          "bilstm_gates_mma_tile_k", "bilstm_gates_mma_stages",
                          "bilstm_gates_mma_smem"),
                         (GATES_MMA_TILE_M, GATES_MMA_TILE_N, GATES_MMA_TILE_K,
                          GATES_MMA_STAGES, GATES_MMA_SMEM)),
    "bilstm_bwd_lite_mma": (("bilstm_bwd_lite_mma_cluster", "bilstm_bwd_lite_mma_threads",
                             "bilstm_bwd_lite_mma_pad", "bilstm_bwd_lite_mma_xg_pad"),
                            (WIDE_CLUSTER, LITE_MMA_THREADS, MMA_PAD, LITE_MMA_XG_PAD)),
    "lstm_recurrence_fwd": (("lstm_recurrence_fwd_cluster", "lstm_recurrence_fwd_max_threads",
                             "lstm_recurrence_fwd_rows_mask", "lstm_recurrence_fwd_max_h"),
                            (WIDE_CLUSTER, WIDE_MAX_THREADS, _WIDE_ROWS_MASK, REC_MAX_H)),
    "lstm_recurrence_bwd": (("lstm_recurrence_bwd_cluster", "lstm_recurrence_bwd_max_threads",
                             "lstm_recurrence_bwd_rows_mask", "lstm_recurrence_bwd_pad",
                             "lstm_recurrence_bwd_max_h"),
                            (WIDE_CLUSTER, WIDE_MAX_THREADS, _WIDE_ROWS_MASK, WIDE_PAD,
                             REC_MAX_H)),
    "lstm_recurrence_bwd_mma": (("lstm_recurrence_bwd_mma_tile",
                                 "lstm_recurrence_bwd_mma_stages",
                                 "lstm_recurrence_bwd_mma_max_chunks",
                                 "lstm_recurrence_bwd_mma_max_h",
                                 "lstm_recurrence_bwd_mma_w_pad",
                                 "lstm_recurrence_bwd_mma_f_pad"),
                                (MMA_TILE, MMA_STAGES, REC_MMA_MAX_CHUNKS, MMA_MAX_H, MMA_PAD,
                                 REC_MMA_F32_PAD)),
    "lstm_recurrence_wgrad": (("lstm_recurrence_wgrad_tile",), (WGRAD_TILE,)),
    "lstm_recurrence_wgrad_mma": (("lstm_recurrence_wgrad_mma_tile_m",
                                   "lstm_recurrence_wgrad_mma_tile_n",
                                   "lstm_recurrence_wgrad_mma_tile_k",
                                   "lstm_recurrence_wgrad_mma_smem"),
                                  (REC_WGRAD_MMA_TILE_M, REC_WGRAD_MMA_TILE_N,
                                   REC_WGRAD_MMA_TILE_K, REC_WGRAD_MMA_SMEM)),
    "bilstm_fwd_f32": (("bilstm_fwd_f32_tile", "bilstm_fwd_f32_max_chunks",
                        "bilstm_fwd_f32_max_threads", "bilstm_fwd_f32_max_h",
                        "bilstm_fwd_f32_stride_align", "bilstm_fwd_f32_stride_pad"),
                       (MMA_TILE, FWD_F32_MAX_CHUNKS, MAX_THREADS, MMA_MAX_H,
                        BWD_F32_STRIDE_ALIGN, BWD_F32_STRIDE_PAD)),
    "lstm_recurrence_bwd_f32": (("lstm_recurrence_bwd_f32_tile",
                                 "lstm_recurrence_bwd_f32_stages",
                                 "lstm_recurrence_bwd_f32_max_chunks",
                                 "lstm_recurrence_bwd_f32_max_h",
                                 "lstm_recurrence_bwd_f32_w_pad",
                                 "lstm_recurrence_bwd_f32_f_pad"),
                                (MMA_TILE, MMA_STAGES, REC_MMA_MAX_CHUNKS, MMA_MAX_H, MMA_PAD,
                                 REC_MMA_F32_PAD)),
    "bilstm_fwd_wide_mma": (("bilstm_fwd_wide_mma_cluster", "bilstm_fwd_wide_mma_threads",
                             "bilstm_fwd_wide_mma_pad"),
                            (WIDE_CLUSTER, FWD_WIDE_MMA_THREADS, MMA_PAD)),
    "bilstm_wgrad_f32": (("bilstm_wgrad_f32_tile_m", "bilstm_wgrad_f32_tile_n",
                          "bilstm_wgrad_f32_tile_k", "bilstm_wgrad_f32_stages",
                          "bilstm_wgrad_f32_smem"),
                         (WGRAD_MMA_TILE_M, WGRAD_MMA_TILE_N, WGRAD_MMA_TILE_K,
                          WGRAD_F32_STAGES, WGRAD_F32_SMEM)),
}
_ERROR_STRING = {name: f"{'bilstm' if name == 'bilstm_fwd' else name}_error_string"
                 for name in _SIGNATURES}
_libs: Dict[str, ctypes.CDLL] = {}


def _kernels(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        fn, argtypes = _SIGNATURES[name]
        getattr(lib, fn).restype = _I
        getattr(lib, fn).argtypes = argtypes
        err = getattr(lib, _ERROR_STRING[name])
        err.restype, err.argtypes = ctypes.c_char_p, [_I]
        names, want = _CONSTANTS[name]
        built = tuple(getattr(lib, n)() for n in names)
        if built != want:
            raise RuntimeError(
                f"csrc/{name}.cu was built with {dict(zip(names, built))}; "
                f"ops/lstm_cuda.py plans launches for {dict(zip(names, want))}"
            )
        _libs[name] = lib
    return lib


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        msg = getattr(_kernels(name), _ERROR_STRING[name])(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def _vec(dtype: torch.dtype) -> Tuple[int, int]:
    size = torch.empty((), dtype=dtype).element_size()
    return size, 16 // size


def _check_parts(E_parts: Sequence[int], vec: int, dtype, what: str) -> None:
    if any(e <= 0 or e % vec for e in E_parts):
        raise ValueError(
            f"{what} needs each input part's width to be a positive multiple "
            f"of {vec} for {dtype}, got {list(E_parts)}"
        )


def launch_plan(E_parts: Sequence[int], H: int, dtype: torch.dtype,
                rows_per_thread: int = ROWS_PER_THREAD) -> Tuple[int, int, int]:
    """``(threads, rows_per_block, smem_bytes)`` of the forward kernel for a
    layer, or ValueError for a shape it does not take."""
    size, vec = _vec(dtype)
    if H % 4 or H > MAX_THREADS:
        raise ValueError(f"bilstm kernel needs H % 4 == 0 and H <= {MAX_THREADS}, got H={H}")
    _check_parts(E_parts, vec, dtype, "bilstm kernel")
    E = sum(E_parts)
    groups = MAX_THREADS // H
    threads, rows = H * groups, groups * rows_per_thread
    smem = _a16(E * 4 * H * size) + _a16(H * 4 * H * size) + 2 * rows * (E + H) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"bilstm kernel: E={E}, H={H} in {dtype} needs {smem} bytes of "
            f"shared memory, more than the {SMEM_LIMIT} a block may use"
        )
    if rows * E // vec > MAX_CHUNKS * threads:
        raise ValueError(f"bilstm kernel: input width E={E} too wide for H={H}")
    return threads, rows, smem


def fwd_rows_per_thread(B: int, H: int, sms: int) -> int:
    """Rows each forward thread owns: 2 when the halved row tiles still fit
    the card's SMs in one wave (one block per SM: the resident weights take
    most of its shared memory), which doubles the SMs a small batch fills;
    otherwise 4, which reuses each weight load over more rows."""
    tile = (MAX_THREADS // H) * 2
    return 2 if 2 * -(-B // tile) <= sms else ROWS_PER_THREAD


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def bwd_launch_plan(E_parts: Sequence[int], H: int,
                    dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(threads, rows_per_block, smem_bytes)`` of the backward sweep for a
    layer, or ValueError for a shape it does not take."""
    _, vec = _vec(dtype)
    if H % vec or H % 4 or H > MAX_THREADS:
        raise ValueError(
            f"bilstm_bwd kernel needs H % {max(vec, 4)} == 0 and H <= {MAX_THREADS}, got H={H}"
        )
    _check_parts(E_parts, vec, dtype, "bilstm_bwd kernel")
    E = sum(E_parts)
    groups = MAX_THREADS // H
    threads, rows = H * groups, groups * BWD_ROWS_PER_THREAD
    if threads % E or (rows * E) % threads or rows * E // threads > BWD_MAX_DX_ROWS:
        raise ValueError(
            f"bilstm_bwd kernel maps one input column per thread: E={E} must "
            f"divide {threads} and be a multiple of H/2 up to 4H (H={H})"
        )
    if rows * (E + H) // vec > BWD_MAX_CHUNKS * threads:
        raise ValueError(f"bilstm_bwd kernel: input width E={E} too wide for H={H}")
    ws = 4 * H + BWD_PAD
    # the sweep keeps its resident weights in f32 whatever the dtype
    smem = _a16(E * ws * 4) + _a16(H * ws * 4) + rows * (E + H + 4 * H) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"bilstm_bwd kernel: E={E}, H={H} in {dtype} needs {smem} bytes "
            f"of shared memory, more than the {SMEM_LIMIT} a block may use"
        )
    return threads, rows, smem


def bwd_mma_plan(E_parts: Sequence[int], H: int, dtype: torch.dtype,
                 ny: int = 2) -> Tuple[int, int]:
    """``(threads, smem_bytes)`` of the tensor-core sweep
    (``csrc/bilstm_bwd_mma.cu``) for a layer with ``ny`` dy streams per
    direction, or ValueError for a dtype or shape it does not take. It takes
    bfloat16 with H in {16, 32, 48, 64}, input parts that are multiples of 8
    wide, and ``(E + H) % 32 == 0`` (its products step K by 32)."""
    E = sum(E_parts)
    if (dtype != torch.bfloat16 or H % 16 or not 16 <= H <= MMA_MAX_H
            or any(e <= 0 or e % 8 for e in E_parts) or (E + H) % 32):
        raise ValueError(
            f"bilstm_bwd_mma kernel takes bfloat16 with H in {{16, 32, 48, {MMA_MAX_H}}}, input "
            f"parts that are positive multiples of 8 and (E + H) % 32 == 0, got {dtype}, "
            f"H={H}, E_parts={list(E_parts)}")
    # one warp per 8 hidden units; the dx columns past the first H go to
    # extra warps, 16 columns each
    threads = 32 * (H // 8 + -(-max(0, E // 8 - H // 8) // 2))
    chunks = MMA_TILE * (E + (2 + ny) * H) // 8
    ks, hs, gs = E + H + MMA_PAD, H + MMA_PAD, 4 * H + MMA_PAD
    smem = (_a16(4 * H * ks * 2) + _a16(2 * MMA_TILE * gs * 2)
            + MMA_STAGES * MMA_TILE * 2 * (ks + (1 + ny) * hs))
    if threads > BWD_MMA_MAX_THREADS or chunks > BWD_MMA_MAX_CHUNKS * threads \
            or smem > SMEM_LIMIT:
        raise ValueError(
            f"bilstm_bwd_mma kernel: E={E}, H={H} needs {threads} threads (at most "
            f"{BWD_MMA_MAX_THREADS}), {chunks} tile chunks (at most {BWD_MMA_MAX_CHUNKS} a "
            f"thread) and {smem} bytes of shared memory (at most {SMEM_LIMIT})")
    return threads, smem


def bwd_f32_plan(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(threads, smem_bytes)`` of the f32 tensor-core sweep
    (``csrc/bilstm_bwd_f32.cu``), or ValueError for a dtype or shape it does
    not take. It takes float32 with H in {16, 32, 48, 64} and 1 or 2 input
    parts that are multiples of 8 wide, where the f32 weights fit one block
    beside its tiles: one warp per 8 hidden units and one per 16 dx columns
    past the first H, as ``bwd_mma_plan``; shared memory for the weights
    (4H rows), one dgates tile and two [x ; h] stages (8 rows each)."""
    E = sum(E_parts)
    if (dtype != torch.float32 or H % 16 or not 16 <= H <= MMA_MAX_H
            or len(E_parts) not in (1, 2) or any(e <= 0 or e % 8 for e in E_parts)):
        raise ValueError(
            f"bilstm_bwd_f32 kernel takes float32 with H in {{16, 32, 48, {MMA_MAX_H}}} and 1 or "
            f"2 input parts that are positive multiples of 8, got {dtype}, H={H}, "
            f"E_parts={list(E_parts)}")
    threads = 32 * (H // 8 + -(-max(0, E // 8 - H // 8) // 2))
    ks = -(-(E + H) // BWD_F32_STRIDE_ALIGN) * BWD_F32_STRIDE_ALIGN + BWD_F32_STRIDE_PAD
    smem = (4 * H * ks + MMA_TILE * (4 * H + 4) + 2 * MMA_TILE * ks) * 4
    if (threads > BWD_MMA_MAX_THREADS or 2 * (E + H) > BWD_F32_MAX_CHUNKS * threads
            or smem > SMEM_LIMIT):
        raise ValueError(
            f"bilstm_bwd_f32 kernel: E={E}, H={H} needs {threads} threads (at most "
            f"{BWD_MMA_MAX_THREADS}) and {smem} bytes of shared memory (at most {SMEM_LIMIT})")
    return threads, smem


def _first_fitting(plans, E_parts: Sequence[int], H: int, dtype: torch.dtype) -> str:
    """The name of the first ``(name, plan)`` whose plan takes the shape;
    ValueError naming every refusal otherwise, the last plan's (the CUDA-core
    kernel's) first."""
    refusals = []
    for name, plan in plans:
        try:
            plan(E_parts, H, dtype)
            return name
        except ValueError as e:
            refusals.append(str(e))
    raise ValueError("; ".join(refusals[-1:] + refusals[:-1]))


def bwd_f32_onestage_plan(E_parts: Sequence[int], H: int,
                          dtype: torch.dtype) -> Tuple[int, int]:
    """``(threads, smem_bytes)`` of the one-stage f32 tensor-core sweep
    (``csrc/bilstm_bwd_f32_onestage.cu``), or ValueError for a dtype or
    shape it does not take. It takes float32 with H % 16 == 0 up to
    ``BWD_F32_ONESTAGE_MAX_H`` (80) and 1 or 2 input parts that are
    multiples of 8 wide: the threads of ``bwd_f32_plan``, and shared memory
    for the weights, one dgates tile and ONE [x ; h] stage (the next step's
    tile waits in registers), which is what lets E = H = 80 fit."""
    E = sum(E_parts)
    if (dtype != torch.float32 or H % 16 or not 16 <= H <= BWD_F32_ONESTAGE_MAX_H
            or len(E_parts) not in (1, 2) or any(e <= 0 or e % 8 for e in E_parts)):
        raise ValueError(
            f"bilstm_bwd_f32_onestage kernel takes float32 with H % 16 == 0 up to "
            f"{BWD_F32_ONESTAGE_MAX_H} and 1 or 2 input parts that are positive multiples of 8, "
            f"got {dtype}, H={H}, E_parts={list(E_parts)}")
    threads = 32 * (H // 8 + -(-max(0, E // 8 - H // 8) // 2))
    ks = -(-(E + H) // BWD_F32_STRIDE_ALIGN) * BWD_F32_STRIDE_ALIGN + BWD_F32_STRIDE_PAD
    smem = (4 * H * ks + MMA_TILE * (4 * H + 4) + MMA_TILE * ks) * 4
    if (threads > BWD_F32_ONESTAGE_MAX_THREADS or 2 * (E + H) > BWD_F32_MAX_CHUNKS * threads
            or smem > SMEM_LIMIT):
        raise ValueError(
            f"bilstm_bwd_f32_onestage kernel: E={E}, H={H} needs {threads} threads (at most "
            f"{BWD_F32_ONESTAGE_MAX_THREADS}) and {smem} bytes of shared memory (at most "
            f"{SMEM_LIMIT})")
    return threads, smem


def sweep_kernel(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> str:
    """The kernel the resident route's sweep takes for a layer, by shape and
    dtype alone, the first whose plan fits: ``"bilstm_bwd_mma"``
    (``bwd_mma_plan``: bf16, H <= 64), ``"bilstm_bwd_f32"``
    (``bwd_f32_plan``: f32, H <= 64), ``"bilstm_bwd_f32_onestage"``
    (``bwd_f32_onestage_plan``: f32 past bilstm_bwd_f32.cu's shared memory,
    E = H = 80), ``"bilstm_bwd"`` (``bwd_launch_plan``: the CUDA cores, the
    bf16 shapes the tensor-core sweep does not take); ValueError naming the
    four refusals otherwise. A tensor-core plan takes a shape whether or not
    the CUDA-core one does."""
    return _first_fitting(
        (("bilstm_bwd_mma", bwd_mma_plan), ("bilstm_bwd_f32", bwd_f32_plan),
         ("bilstm_bwd_f32_onestage", bwd_f32_onestage_plan), ("bilstm_bwd", bwd_launch_plan)),
        E_parts, H, dtype)


def mma_tiles(B: int, G: int, rows: int = MMA_TILE) -> int:
    """Row tiles of a tensor-core kernel: each weight group is cut into its
    own tiles of ``rows`` rows (the last one short)."""
    return G * -(-(B // G) // rows)


def fwd_mma_plan(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(threads, smem_bytes)`` of the tensor-core forward
    (``csrc/bilstm_fwd_mma.cu``), or ValueError for a dtype or shape it does
    not take. It takes bfloat16 at the (H, E) it is instantiated for
    (``FWD_MMA_SHAPES``: H in {16, 32, 48, 64}, E = H or 2H) in 1 or 2 input
    parts that are multiples of 8 wide. One warp per 8 hidden units; the
    shared memory is the three-stage ring of 8-row [x ; h] tiles."""
    E = sum(E_parts)
    if (dtype != torch.bfloat16 or (H, E) not in FWD_MMA_SHAPES or len(E_parts) not in (1, 2)
            or any(e <= 0 or e % 8 for e in E_parts)):
        raise ValueError(
            f"bilstm_fwd_mma kernel takes bfloat16 with (H, E) in {list(FWD_MMA_SHAPES)} and "
            f"1 or 2 input parts that are positive multiples of 8, got {dtype}, H={H}, "
            f"E_parts={list(E_parts)}")
    return 4 * H, MMA_STAGES * MMA_TILE * (E + H + MMA_PAD) * 2


def fwd_f32_plan(E_parts: Sequence[int], H: int, dtype: torch.dtype,
                 rows: int = MMA_TILE) -> Tuple[int, int]:
    """``(threads, smem_bytes)`` of the f32 tensor-core forward
    (``csrc/bilstm_fwd_f32.cu``) with row tiles of ``rows`` (8 or 16), or
    ValueError for a dtype or shape it does not take. It takes float32 with
    H in {16, 32, 48, 64} and 1 or 2 input parts that are multiples of 8
    wide, where the f32 weights fit one block beside two [x ; h] stages:
    one warp per 8 hidden units; shared memory for the weights (4H rows of
    E + H, stride rounded to 32 floats plus 8) and the two stages; a step's
    x chunks within the kernel's per-thread constant."""
    E = sum(E_parts)
    if (dtype != torch.float32 or H % 16 or not 16 <= H <= MMA_MAX_H
            or len(E_parts) not in (1, 2) or any(e <= 0 or e % 8 for e in E_parts)
            or rows not in FWD_F32_ROWS):
        raise ValueError(
            f"bilstm_fwd_f32 kernel takes float32 with H in {{16, 32, 48, {MMA_MAX_H}}}, 1 or 2 "
            f"input parts that are positive multiples of 8 and row tiles of {FWD_F32_ROWS}, got "
            f"{dtype}, H={H}, E_parts={list(E_parts)}, rows={rows}")
    threads = 4 * H
    ks = -(-(E + H) // BWD_F32_STRIDE_ALIGN) * BWD_F32_STRIDE_ALIGN + BWD_F32_STRIDE_PAD
    smem = (4 * H + 2 * rows) * ks * 4
    if rows * E // 4 > FWD_F32_MAX_CHUNKS * threads or smem > SMEM_LIMIT:
        raise ValueError(
            f"bilstm_fwd_f32 kernel: E={E}, H={H} at {rows}-row tiles needs "
            f"{rows * E // 4} x chunks (at most {FWD_F32_MAX_CHUNKS} a thread of {threads}) and "
            f"{smem} bytes of shared memory (at most {SMEM_LIMIT})")
    return threads, smem


def fwd_f32_rows(E_parts: Sequence[int], H: int, B: int, G: int, sms: int) -> int:
    """Row tile of an f32 tensor-core forward launch (one block per SM: the
    resident weights take most of its shared memory): 8 rows where the two
    directions' 8-row tiles fill the card's ``sms`` SMs in one wave (the
    train step's 400 rows in 5 groups: 100 blocks), else 16 where
    ``fwd_f32_plan`` takes it, so each split weight fragment feeds two n8
    products and a large batch takes half the blocks (serve's 800 rows:
    100 instead of 200)."""
    if 2 * mma_tiles(B, G) <= sms:
        return MMA_TILE
    try:
        fwd_f32_plan(E_parts, H, torch.float32, 2 * MMA_TILE)
    except ValueError:
        return MMA_TILE
    return 2 * MMA_TILE


def fwd_kernel(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> str:
    """The kernel the resident route's forward (both variants) takes for a
    layer, by shape and dtype alone, the first whose plan fits:
    ``"bilstm_fwd_mma"`` (``fwd_mma_plan``: bf16, H <= 64),
    ``"bilstm_fwd_f32"`` (``fwd_f32_plan``: f32, H <= 64), ``"bilstm_fwd"``
    (``launch_plan``: the CUDA cores, f32 past H = 64 and the bf16 shapes
    the tensor-core forward does not take); ValueError naming the three
    refusals otherwise. A tensor-core plan takes a shape whether or not the
    CUDA-core one does."""
    return _first_fitting(
        (("bilstm_fwd_mma", fwd_mma_plan), ("bilstm_fwd_f32", fwd_f32_plan),
         ("bilstm_fwd", launch_plan)), E_parts, H, dtype)


def wgrad_check(E_parts: Sequence[int], H: int) -> None:
    """ValueError for a shape the weight-gradient kernel does not take."""
    if (4 * H) % WGRAD_TILE or any(w <= 0 or w % 8 for w in (*E_parts, H)):
        raise ValueError(
            f"bilstm_wgrad kernel needs 4H % {WGRAD_TILE} == 0 and every width "
            f"% 8 == 0, got E_parts={list(E_parts)}, H={H}"
        )


def _tensor_core_wgrad_check(name, takes, unit, E_parts, H, dtype) -> None:
    if (dtype != takes or H <= 0 or H % unit or len(E_parts) not in (1, 2)
            or any(e <= 0 or e % 8 for e in E_parts)):
        raise ValueError(
            f"{name} kernel takes {str(takes).replace('torch.', '')} with H % {unit} == 0 and 1 "
            f"or 2 input parts that are positive multiples of 8, got {dtype}, H={H}, "
            f"E_parts={list(E_parts)}")


def wgrad_mma_check(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> None:
    """ValueError for a dtype or shape the tensor-core weight-gradient
    kernel (``csrc/bilstm_wgrad_mma.cu``) does not take: it takes bfloat16
    with H % 8 == 0 (its last 128-row gate tile masked where 4H is not a
    multiple of 128) and 1 or 2 input parts that are multiples of 8 wide."""
    _tensor_core_wgrad_check("bilstm_wgrad_mma", torch.bfloat16, 8, E_parts, H, dtype)


def wgrad_f32_check(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> None:
    """ValueError for a dtype or shape the f32 tensor-core weight-gradient
    kernel (``csrc/bilstm_wgrad_f32.cu``) does not take: it takes float32
    with H % 32 == 0 (whole 128-row gate tiles: at H = 80 its 128 x 128
    tiles would do about twice the result's work, where ``bilstm_wgrad.cu``
    is faster) and 1 or 2 input parts that are multiples of 8 wide."""
    _tensor_core_wgrad_check("bilstm_wgrad_f32", torch.float32, 32, E_parts, H, dtype)


def wgrad_kernel(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> str:
    """The kernel a layer's weight gradients take, by shape and dtype alone:
    ``"bilstm_wgrad_mma"`` where ``wgrad_mma_check`` passes (bf16,
    H % 8 == 0), ``"bilstm_wgrad_f32"`` where ``wgrad_f32_check`` passes
    (f32, H % 32 == 0), else ``"bilstm_wgrad"`` where ``wgrad_check``
    passes (the shapes the tensor-core kernels do not take: f32 at other
    widths); ValueError naming the three refusals otherwise."""
    try:
        wgrad_mma_check(E_parts, H, dtype)
        return "bilstm_wgrad_mma"
    except ValueError as mma:
        try:
            wgrad_f32_check(E_parts, H, dtype)
            return "bilstm_wgrad_f32"
        except ValueError as f32:
            try:
                wgrad_check(E_parts, H)
            except ValueError as cores:
                raise ValueError(f"{cores}; {mma}; {f32}") from None
    return "bilstm_wgrad"


def wgrad_mma_plan(T: int, B: int, G: int, E_parts: Sequence[int],
                   H: int) -> Tuple[int, int, int]:
    """``(m_tiles, n_tiles, splits)`` of the tensor-core wgrad launch (bf16
    and f32: the same tiles): 128-row tiles of the 4H gates (the last one
    partly past 4H where H % 32 != 0), 128-column tiles of the E + H source
    columns, and the split of each group's T * B / G rows that brings the
    grid to about ``WGRAD_TARGET_BLOCKS`` blocks, no more splits than
    K-tiles."""
    m_tiles = -(-4 * H // WGRAD_MMA_TILE_M)
    n_tiles = -(-(sum(E_parts) + H) // WGRAD_MMA_TILE_N)
    rows = T * (B // G)
    per_split = m_tiles * n_tiles * 2 * G
    splits = max(1, min(-(-rows // WGRAD_MMA_TILE_K), -(-WGRAD_TARGET_BLOCKS // per_split)))
    return m_tiles, n_tiles, splits


def wgrad_f32_plan(T: int, B: int, G: int, E_parts: Sequence[int], H: int,
                   sms: int) -> Tuple[int, int, int]:
    """``(m_tiles, n_tiles, splits)`` of the f32 tensor-core wgrad launch:
    the tiles of ``wgrad_mma_plan``, and the split whose blocks fill the
    card's ``sms`` SMs in whole waves best. The kernel holds one block an SM
    (255 registers a thread), so a launch costs about ceil(blocks / sms)
    waves of ``1 / splits`` of a group's rows each: the split with the least
    of that, among at most ``WGRAD_F32_MAX_WAVES`` waves of blocks and no
    more splits than K-tiles, the smaller split on a tie."""
    m_tiles, n_tiles, _ = wgrad_mma_plan(T, B, G, E_parts, H)
    per_split = m_tiles * n_tiles * 2 * G
    k_tiles = -(-T * (B // G) // WGRAD_MMA_TILE_K)
    most = max(1, min(k_tiles, WGRAD_F32_MAX_WAVES * sms // per_split))
    splits = min(range(1, most + 1),
                 key=lambda s: (Fraction(-(-per_split * s // sms), s), s))
    return m_tiles, n_tiles, splits


def wgrad_mma_rows(T: int, B: int, G: int, splits: int, split: int, g: int, d: int):
    """The rows the tensor-core wgrad's blocks of ``split`` read for weight
    group ``g`` and direction ``d``, as ``(t, b, t_prev)`` with ``t_prev``
    the position of the h_prev row (None past the ends: zeros); the same
    integer arithmetic as ``csrc/bilstm_wgrad_mma.cu`` and
    ``csrc/bilstm_wgrad_f32.cu``."""
    Bg = B // G
    rows = T * Bg
    out = []
    for n in range(rows * split // splits, rows * (split + 1) // splits):
        t, b = divmod(n, Bg)
        tp = t + (1 if d else -1)
        out.append((t, g * Bg + b, tp if 0 <= tp < T else None))
    return out


def wide_check(H: int, E_parts: Optional[Sequence[int]] = None) -> None:
    """ValueError for a width (and, when given, input parts) the wide
    kernels (gates, wide forward, lite sweep) do not take."""
    if H % 32 or not 32 <= H <= WIDE_MAX_THREADS:
        raise ValueError(
            f"bilstm wide kernels need H % 32 == 0 and 32 <= H <= {WIDE_MAX_THREADS}, got H={H}")
    if E_parts is None:
        return
    if len(E_parts) not in (1, 2) or any(e <= 0 or e % GATES_TILE_K for e in E_parts):
        raise ValueError(
            f"bilstm wide kernels take 1 or 2 input parts, each a positive multiple of "
            f"{GATES_TILE_K} wide, got {list(E_parts)}")


def _route_at(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> str:
    """The route that takes the layer at exactly these widths: ``"resident"``
    where a resident forward and sweep take it (``fwd_kernel``,
    ``sweep_kernel``: the layer's weights in one block's shared memory),
    else ``"wide"`` where ``wide_check`` passes; either only where a
    weight-gradient kernel takes it too (``wgrad_kernel``). ValueError
    naming the refusals otherwise."""
    try:
        fwd_kernel(E_parts, H, dtype)
        sweep_kernel(E_parts, H, dtype)
        route = "resident"
    except ValueError as resident:
        try:
            wide_check(H, E_parts)
        except ValueError as wide:
            raise ValueError(f"{resident}; {wide}") from None
        route = "wide"
    wgrad_kernel(E_parts, H, dtype)
    return route


def _padded_shapes(E_parts: Tuple[int, ...], H: int):
    """Every ``(Hp, Ep)`` a layer may run at, in order of its multiply-adds
    per row and step, ``Hp * (sum(Ep) + Hp)`` (on a tie the smaller Hp,
    then the more even parts): Hp is H or a multiple of ``PAD_STEP`` past
    it up to ``WIDE_MAX_THREADS``, each part of Ep its own width or a
    multiple of ``PART_STEP`` past it (at most ``2 * WIDE_MAX_THREADS``
    more). A best-first walk of that lattice: each step grows Hp or one
    part to its next width."""
    widths = [H] + list(range(H // PAD_STEP * PAD_STEP + PAD_STEP, WIDE_MAX_THREADS + 1,
                              PAD_STEP))

    def entry(at):
        Hp = widths[at[0]]
        Ep = tuple(e if i == 0 else (e // PART_STEP + i) * PART_STEP
                   for e, i in zip(E_parts, at[1:]))
        return (Hp * (sum(Ep) + Hp), Hp, max(Ep), Ep), at

    heap, seen = [entry((0,) * (1 + len(E_parts)))], set()
    while heap:
        (_, Hp, _, Ep), at = heapq.heappop(heap)
        yield Hp, Ep
        for k in range(len(at)):
            nxt = at[:k] + (at[k] + 1,) + at[k + 1:]
            if nxt in seen or (k == 0 and nxt[0] >= len(widths)):
                continue
            seen.add(nxt)
            key = entry(nxt)
            if k > 0 and key[0][3][k - 1] > E_parts[k - 1] + 2 * WIDE_MAX_THREADS:
                continue
            heapq.heappush(heap, key)


@functools.lru_cache(maxsize=None)
def _layer_plan(E_parts: Tuple[int, ...], H: int,
                dtype: torch.dtype) -> Tuple[str, int, Tuple[int, ...]]:
    """``(route, Hp, Ep)`` of a layer (``layer_route``, ``padded_width``,
    ``padded_parts``): of the shapes ``_padded_shapes`` walks, the first a
    route takes, so the one with the fewest extra multiply-adds. Kept per
    shape: the plans are pure functions of the shapes, and every layer call
    of a step asks again."""
    try:
        return _route_at(E_parts, H, dtype), H, E_parts
    except ValueError as e:
        native = e
    if not 1 <= H <= WIDE_MAX_THREADS or len(E_parts) not in (1, 2) or min(E_parts) <= 0:
        raise ValueError(f"no bilstm route takes this layer, at H={H}, E_parts={list(E_parts)} "
                         f"or padded (1 or 2 input parts and H <= {WIDE_MAX_THREADS}): "
                         f"{native}")
    for Hp, Ep in _padded_shapes(E_parts, H):
        try:
            return _route_at(Ep, Hp, dtype), Hp, Ep
        except ValueError:
            pass
    raise ValueError(f"no bilstm route takes this layer, at H={H} or padded up to "
                     f"{WIDE_MAX_THREADS}: {native}")


def padded_width(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> int:
    """The width a layer of H units runs at: H where a route takes the
    layer at its own widths (``_route_at``), else that of the padded shape
    with the fewest extra multiply-adds that a route takes (``_layer_plan``;
    ``layer_fwd`` and ``layer_bwd`` then grow each gate block with zero
    units and each input part with zero columns: ``pad_layer``). ValueError
    where no shape takes the layer (H past ``WIDE_MAX_THREADS``)."""
    return _layer_plan(tuple(E_parts), H, dtype)[1]


def padded_parts(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> Tuple[int, ...]:
    """The widths the layer's input parts run at, beside ``padded_width``:
    each part's own width, or a multiple of ``PART_STEP`` past it."""
    return _layer_plan(tuple(E_parts), H, dtype)[2]


def layer_route(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> str:
    """The route of a layer of H units: that of its padded shape
    (``padded_width``, ``padded_parts``), ``"resident"`` or ``"wide"``
    (``_route_at``); ValueError for a shape none takes. Shapes and dtype
    alone decide it, for CPU and CUDA tensors alike, before any launch."""
    return _layer_plan(tuple(E_parts), H, dtype)[0]


def gates_kernel(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> str:
    """The kernel the wide route's input gates take, by shape and dtype
    alone: ``"bilstm_gates_mma"`` for bfloat16 (the tensor cores; every
    shape ``wide_check`` admits), ``"bilstm_gates"`` for float32 (CUDA
    cores); ValueError for a dtype or shape neither takes."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"bilstm gates kernels take float32 or bfloat16, got {dtype}")
    wide_check(H, E_parts)
    return "bilstm_gates_mma" if dtype == torch.bfloat16 else "bilstm_gates"


def lite_mma_check(H: int, dtype: torch.dtype) -> None:
    """ValueError for a dtype or width the tensor-core lite sweep
    (``csrc/bilstm_bwd_lite_mma.cu``) does not take: it takes bfloat16 at
    H in ``LITE_MMA_WIDTHS`` (whole 8-unit groups in each of the cluster's
    8 blocks, and the dh product's m16 tiles evenly over 8 warps)."""
    if dtype != torch.bfloat16 or H not in LITE_MMA_WIDTHS:
        raise ValueError(
            f"bilstm_bwd_lite_mma kernel takes bfloat16 with H in {list(LITE_MMA_WIDTHS)}, "
            f"got {dtype}, H={H}")


def lite_kernel(H: int, dtype: torch.dtype) -> str:
    """The kernel the wide route's sweep takes, by width and dtype alone:
    ``"bilstm_bwd_lite_mma"`` where ``lite_mma_check`` passes (bf16, H = 128
    or 256), else ``"bilstm_bwd_lite"`` where ``wide_check`` passes (f32,
    and the bf16 widths the tensor-core sweep does not take); ValueError
    naming both refusals otherwise."""
    try:
        lite_mma_check(H, dtype)
        return "bilstm_bwd_lite_mma"
    except ValueError as mma:
        try:
            if dtype not in _DTYPE_CODES:
                raise ValueError(f"bilstm_bwd_lite kernel takes float32 or bfloat16, got {dtype}")
            wide_check(H)
        except ValueError as cores:
            raise ValueError(f"{cores}; {mma}") from None
    return "bilstm_bwd_lite"


def fwd_wide_mma_check(H: int, dtype: torch.dtype) -> None:
    """ValueError for a dtype or width the tensor-core wide forward
    (``csrc/bilstm_fwd_wide_mma.cu``) does not take: it takes bfloat16 at
    H in ``FWD_WIDE_MMA_WIDTHS`` (whole 8-unit groups in each of the
    cluster's 8 blocks, and its 8 warps evenly over them)."""
    if dtype != torch.bfloat16 or H not in FWD_WIDE_MMA_WIDTHS:
        raise ValueError(
            f"bilstm_fwd_wide_mma kernel takes bfloat16 with H in {list(FWD_WIDE_MMA_WIDTHS)}, "
            f"got {dtype}, H={H}")


def wide_fwd_kernel(H: int, dtype: torch.dtype) -> str:
    """The kernel the wide route's recurrence takes, by width and dtype
    alone: ``"bilstm_fwd_wide_mma"`` where ``fwd_wide_mma_check`` passes
    (bf16, H = 128 or 256), else ``"bilstm_fwd_wide"`` where ``wide_check``
    passes (f32, and the bf16 widths the tensor-core forward does not take);
    ValueError naming both refusals otherwise."""
    try:
        fwd_wide_mma_check(H, dtype)
        return "bilstm_fwd_wide_mma"
    except ValueError as mma:
        try:
            if dtype not in _DTYPE_CODES:
                raise ValueError(f"bilstm_fwd_wide kernel takes float32 or bfloat16, got {dtype}")
            wide_check(H)
        except ValueError as cores:
            raise ValueError(f"{cores}; {mma}") from None
    return "bilstm_fwd_wide"


def _lite_mma_part_stride(rows: int) -> int:
    # at least `rows` and 8 mod 32 (csrc/bilstm_bwd_lite_mma.cu:part_stride)
    return rows + (40 - rows % 32) % 32


def wide_smem(kind: str, H: int, rows: int) -> int:
    """Dynamic shared memory of a wide kernel's block. ``kind`` "fwd" or
    "bwd" (the CUDA-core kernels, ``rows`` per thread): the f32 ``W_hh``
    slice of its H/8 units (up to ``WIDE_MAX_THREADS``), the tile's h (and,
    in the sweep, its rounded gate cotangents). ``kind`` "lite_mma" (the
    tensor-core sweep, a row tile of ``rows``): the bf16 slice and, per
    row, two h_prev buffers, the f32 xg slice, c_prev and two dy streams,
    the bf16 dgates tile, and two buffers of the f32 partial dh of all H
    units. ``kind`` "fwd_mma" (the
    tensor-core forward, a row tile of ``rows``): the bf16 slice and, per
    row, two bf16 h tiles and the block's new h and c staged (both variants
    take the same, so they take the same tile)."""
    U = H // WIDE_CLUSTER
    if kind == "fwd_mma":
        BR, pad = rows, MMA_PAD
        return 4 * U * (H + pad) * 2 + 2 * BR * (H + pad) * 2 + 2 * BR * (U + pad) * 2
    if kind == "lite_mma":
        BR, pad = rows, MMA_PAD
        return (4 * U * (H + pad) * 2 + 2 * BR * (H + pad) * 2
                + BR * (4 * U + LITE_MMA_XG_PAD) * 4 + 3 * BR * U * 2
                + BR * (4 * U + pad) * 2 + 2 * H * _lite_mma_part_stride(BR) * 4)
    BR = WIDE_CLUSTER * rows
    w_slice = H * (4 * U + (WIDE_PAD if kind == "bwd" else 0)) * 4
    if H > WIDE_MAX_THREADS:
        # only the recurrence kernels run there, their weight slice read
        # from global memory (``recurrence_global_weights``)
        w_slice = 0
    if kind == "fwd":
        return w_slice + BR * H * 4
    return w_slice + BR * H * 4 + BR * 4 * U * 4


def wide_tiles(B: int, G: int, rows_per_thread: int) -> int:
    """Row tiles of a wide launch: each weight group is cut into its own
    tiles (the last one short), so no tile spans two groups."""
    return G * -(-(B // G) // (WIDE_CLUSTER * rows_per_thread))


def wide_plan(kind: str, B: int, G: int, H: int,
              max_clusters: Callable[[int, int], int], dirs: int = 2) -> Tuple[int, int, int]:
    """``(rows, tiles, smem_bytes)`` of a wide launch: the rows whose
    clusters (one per row tile and each of the ``dirs`` directions) fill the
    card in the fewest waves, and among those the smallest tile; ``rows``
    is the rows per thread (``WIDE_ROWS``) for the CUDA-core kernels and the
    row tile (multiples of 8: ``LITE_MMA_ROWS`` for ``kind`` "lite_mma",
    ``FWD_WIDE_MMA_ROWS`` for "fwd_mma") for the tensor-core ones.
    ``max_clusters(rows, smem)`` is how many clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    rows = {"lite_mma": LITE_MMA_ROWS, "fwd_mma": FWD_WIDE_MMA_ROWS}.get(kind, WIDE_ROWS)
    best = None
    for R in rows:
        smem = wide_smem(kind, H, R)
        if smem > SMEM_LIMIT:
            continue
        tiles = mma_tiles(B, G, R) if kind.endswith("_mma") else wide_tiles(B, G, R)
        waves = -(-dirs * tiles // max(1, max_clusters(R, smem)))
        if best is None or waves < best[0]:
            best = (waves, R, tiles, smem)
    if best is None:
        raise ValueError(f"bilstm wide kernels: H={H} leaves no row tile in shared memory")
    return best[1:]


_cluster_counts: Dict[tuple, int] = {}
# the operands between (dtype, rows_per_thread) and (T, B, H, G, tiles,
# smem) of each wide kernel's C entry, when it only reports occupancy
_NO_OPERANDS = {"bilstm_fwd_wide": [None] * 9, "bilstm_bwd_lite": [None] * 11 + [0] + [None] * 3,
                "bilstm_bwd_lite_mma": [None] * 11 + [0] + [None] * 3,
                "bilstm_fwd_wide_mma": [None] * 9,
                "lstm_recurrence_fwd": [None] * 8 + [1], "lstm_recurrence_bwd": [None] * 10 + [1]}


def _max_clusters(name: str, dtype: torch.dtype, H: int, dev: torch.device):
    # the tensor-core kernels' C entries take no dtype code (bf16 only)
    lead = [] if name.endswith("_mma") else [_DTYPE_CODES[dtype]]

    def count(R: int, smem: int) -> int:
        key = (name, dtype, H, R, smem, dev.index)
        if key not in _cluster_counts:
            out = ctypes.c_int(0)
            with torch.cuda.device(dev):
                err = getattr(_kernels(name), name)(
                    *lead, R, *_NO_OPERANDS[name], 0, 0, H, 1, 1, smem, None,
                    ctypes.byref(out))
            _raise_on_error(name, err)
            _cluster_counts[key] = out.value
        return _cluster_counts[key]
    return count


def _check(name, t, shape, dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"bilstm kernel: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device} (contiguous={t.is_contiguous()})"
        )


def _no_graph(*tensors) -> None:
    """The kernels' outputs are filled through ctypes and carry no autograd
    graph: refuse to drop a gradient silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "bilstm kernel outputs carry no autograd graph, and an operand "
            "requires grad: run the stack through ops/lstm.py:bilstm (which "
            "takes ops/lstm_stack.py's autograd Function when grad is on) or "
            "call the kernel under torch.no_grad()"
        )


def _group_pad(t: torch.Tensor, dim: int, G: int, pad: int) -> torch.Tensor:
    """Append ``pad`` zero rows to each of the G groups along ``dim``."""
    shape = list(t.shape)
    Bg = shape[dim] // G
    v = t.reshape(shape[:dim] + [G, Bg] + shape[dim + 1:])
    z = v.new_zeros(shape[:dim] + [G, pad] + shape[dim + 1:])
    return torch.cat([v, z], dim=dim + 1).reshape(
        shape[:dim] + [G * (Bg + pad)] + shape[dim + 1:]).contiguous()


def _group_unpad(t: torch.Tensor, dim: int, G: int, Bg: int) -> torch.Tensor:
    shape = list(t.shape)
    Bgp = shape[dim] // G
    return t.reshape(shape[:dim] + [G, Bgp] + shape[dim + 1:]).narrow(
        dim + 1, 0, Bg).reshape(shape[:dim] + [G * Bg] + shape[dim + 1:])


def _tile_pad(B: int, G: int, rows: int) -> int:
    """Rows to add to each weight group so no row tile spans two groups."""
    if G == 1:
        return 0
    return -(B // G) % rows


def _fwd_launch(x_parts, lengths, w_ih, w_hh, bias, compute_dtype, with_states):
    if compute_dtype not in _DTYPE_CODES:
        raise ValueError(f"bilstm kernel takes float32 or bfloat16, got {compute_dtype}")
    if len(x_parts) not in (1, 2):
        raise ValueError(f"bilstm kernel takes 1 or 2 input parts, got {len(x_parts)}")
    _no_graph(*x_parts, w_ih, w_hh, bias)
    dev = x_parts[0].device
    T, B = x_parts[0].shape[:2]
    H = w_hh.shape[-1]
    w_hh = grouped_w_hh(w_hh)
    G = w_hh.shape[1]
    for k, p in enumerate(x_parts):
        _check(f"x_parts[{k}]", p, (T, B, p.shape[-1]), compute_dtype, dev)
    E_parts = [p.shape[-1] for p in x_parts]
    _check("w_ih", w_ih, (2, 4 * H, sum(E_parts)), compute_dtype, dev)
    _check("w_hh", w_hh, (2, G, 4 * H, H), compute_dtype, dev)
    _check("bias", bias, (2, 4 * H), torch.float32, dev)
    _check("lengths", lengths, (B,), torch.int32, dev)
    if B % G:
        raise ValueError(f"bilstm kernel: batch {B} is not a multiple of {G} weight groups")

    rpt = fwd_rows_per_thread(B, H, _sm_count(dev))
    threads, rows, smem = launch_plan(E_parts, H, compute_dtype, rpt)
    pad = _tile_pad(B, G, rows)
    if pad:
        x_parts = tuple(_group_pad(p, 1, G, pad) for p in x_parts)
        lengths = _group_pad(lengths, 0, G, pad)
    Bp = x_parts[0].shape[1]
    lib = _kernels("bilstm_fwd")
    hs_f = torch.empty((T, Bp, H), dtype=compute_dtype, device=dev)
    hs_b = torch.empty_like(hs_f)
    cs_f = torch.empty_like(hs_f) if with_states else None
    cs_b = torch.empty_like(hs_f) if with_states else None
    hn = torch.empty((2, Bp, H), dtype=torch.float32, device=dev)
    cn = torch.empty_like(hn)
    outs = (hs_f, hs_b, hn, cn) + ((cs_f, cs_b) if with_states else ())
    if B == 0:
        return outs
    x1 = x_parts[1] if len(x_parts) == 2 else None
    with torch.cuda.device(dev):
        err = lib.bilstm_layer_fwd(
            _DTYPE_CODES[compute_dtype],
            x_parts[0].data_ptr(), x1.data_ptr() if x1 is not None else None,
            E_parts[0], E_parts[1] if x1 is not None else 0,
            lengths.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(),
            hs_f.data_ptr(), hs_b.data_ptr(),
            cs_f.data_ptr() if with_states else None, cs_b.data_ptr() if with_states else None,
            hn.data_ptr(), cn.data_ptr(),
            T, Bp, H, G, rpt, threads, smem, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error("bilstm_fwd", err)
    if pad:
        Bg = B // G
        outs = tuple(_group_unpad(o, 1, G, Bg) for o in outs)
    return outs


def _tile_fwd_launch(wrapper, name, x_parts, lengths, w_ih, w_hh, bias, compute_dtype,
                     with_states):
    """Launch the tensor-core forward ``csrc/<name>.cu`` (``bilstm_fwd_mma``
    or ``bilstm_fwd_f32``) for ``wrapper`` (the eval or the train variant),
    which counts the launch; an empty batch launches nothing."""
    if len(x_parts) not in (1, 2):
        raise ValueError(f"{name} kernel takes 1 or 2 input parts, got {len(x_parts)}")
    cd = compute_dtype
    dev = x_parts[0].device
    T, B = x_parts[0].shape[:2]
    H = w_hh.shape[-1]
    w_hh = grouped_w_hh(w_hh)
    G = w_hh.shape[1]
    E_parts = [p.shape[-1] for p in x_parts]
    if name == "bilstm_fwd_mma":
        threads, _ = fwd_mma_plan(E_parts, H, cd)
        plan = (mma_tiles(B, G), threads)
    else:
        # the f32 kernel also takes its row tile and dynamic shared memory; the
        # plan raises for a dtype or shape it does not take
        rows = fwd_f32_rows(E_parts, H, B, G, _sm_count(dev))
        plan = (rows, mma_tiles(B, G, rows), *fwd_f32_plan(E_parts, H, cd, rows))
    for k, p in enumerate(x_parts):
        _check(f"x_parts[{k}]", p, (T, B, E_parts[k]), cd, dev)
    _check("w_ih", w_ih, (2, 4 * H, sum(E_parts)), cd, dev)
    _check("w_hh", w_hh, (2, G, 4 * H, H), cd, dev)
    _check("bias", bias, (2, 4 * H), torch.float32, dev)
    _check("lengths", lengths, (B,), torch.int32, dev)
    if B % G:
        raise ValueError(f"{name} kernel: batch {B} is not a multiple of {G} weight groups")
    hs_f = torch.empty((T, B, H), dtype=cd, device=dev)
    hs_b = torch.empty_like(hs_f)
    cs_f = torch.empty_like(hs_f) if with_states else None
    cs_b = torch.empty_like(hs_f) if with_states else None
    hn = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    cn = torch.empty_like(hn)
    outs = (hs_f, hs_b, hn, cn) + ((cs_f, cs_b) if with_states else ())
    if B == 0:
        return outs
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            _ptr(x_parts, 0), _ptr(x_parts, 1), E_parts[0], E_parts[1] if len(E_parts) == 2 else 0,
            lengths.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(),
            hs_f.data_ptr(), hs_b.data_ptr(), _opt_ptr(cs_f), _opt_ptr(cs_b),
            hn.data_ptr(), cn.data_ptr(), T, B, H, G, *plan,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    return outs


def _fwd_kernel_of(x_parts, w_hh, compute_dtype, kernel: Optional[str]) -> str:
    if kernel not in (None, "bilstm_fwd", "bilstm_fwd_mma", "bilstm_fwd_f32"):
        raise ValueError(f"bilstm_layer_fwd: no forward kernel named {kernel!r}")
    return kernel or fwd_kernel([p.shape[-1] for p in x_parts], w_hh.shape[-1], compute_dtype)


def bilstm_layer_fwd(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bidirectional LSTM layer, time-major, eval variant.

    :param x_parts: 1 or 2 ``(T, B, E_i)`` tensors in ``compute_dtype``.
    :param lengths: ``(B,)`` int32.
    :param w_ih: ``(2, 4H, E)`` and ``w_hh`` ``(2, 4H, H)`` or ``(2, G, 4H,
        H)`` in ``compute_dtype``; ``bias`` ``(2, 4H)`` f32 (``b_ih +
        b_hh``).
    :returns: ``hs_f, hs_b (T, B, H)`` in ``compute_dtype``, ``hn, cn
        (2, B, H)`` f32.

    On the card the layer runs the kernel ``fwd_kernel`` names for its
    shapes and dtype: a tensor-core one through :func:`bilstm_layer_fwd_mma`
    (bf16) or :func:`bilstm_layer_fwd_f32` (f32), whose ``.launches`` then
    counts it, or ``csrc/bilstm_fwd.cu`` here. ``kernel="bilstm_fwd"`` asks
    for the latter by name (to time it beside the others); a shape it does
    not take raises.
    """
    x_parts = tuple(x_parts)
    if not x_parts[0].is_cuda:
        return bilstm_layer_fwd_plain(x_parts, lengths, w_ih, w_hh, bias, compute_dtype)
    name = _fwd_kernel_of(x_parts, w_hh, compute_dtype, kernel)
    if name in _TILE_FWD:
        return _TILE_FWD[name][0](x_parts, lengths, w_ih, w_hh, bias, compute_dtype)
    outs = _fwd_launch(x_parts, lengths, w_ih, w_hh, bias, compute_dtype, False)
    bilstm_layer_fwd.launches += 1
    return outs


bilstm_layer_fwd.launches = 0


def bilstm_layer_fwd_train(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """The train variant of :func:`bilstm_layer_fwd`: the same operands,
    and also the cell streams the backward reads; the same dispatch (the
    tensor-core kernels through :func:`bilstm_layer_fwd_train_mma` and
    :func:`bilstm_layer_fwd_train_f32`).

    :returns: ``hs_f, hs_b, hn, cn`` as the eval variant, then ``cs_f, cs_b
        (T, B, H)`` in ``compute_dtype``.
    """
    x_parts = tuple(x_parts)
    if not x_parts[0].is_cuda:
        return bilstm_layer_fwd_plain(x_parts, lengths, w_ih, w_hh, bias, compute_dtype,
                                      with_states=True)
    name = _fwd_kernel_of(x_parts, w_hh, compute_dtype, kernel)
    if name in _TILE_FWD:
        return _TILE_FWD[name][1](x_parts, lengths, w_ih, w_hh, bias, compute_dtype)
    outs = _fwd_launch(x_parts, lengths, w_ih, w_hh, bias, compute_dtype, True)
    bilstm_layer_fwd_train.launches += 1
    return outs


bilstm_layer_fwd_train.launches = 0


def bilstm_layer_fwd_mma(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The eval variant of one layer on the tensor cores
    (``csrc/bilstm_fwd_mma.cu``); the contract of :func:`bilstm_layer_fwd`.
    Takes the shapes ``fwd_mma_plan`` takes (bfloat16, H <= 64) and raises
    for the rest. Row tiles are cut inside each weight group, so nothing is
    padded. Its outputs carry no graph, so under grad mode it refuses an
    operand that requires grad, on the CPU too."""
    x_parts = tuple(x_parts)
    _no_graph(*x_parts, w_ih, w_hh, bias)
    if not x_parts[0].is_cuda:
        return bilstm_layer_fwd_plain(x_parts, lengths, w_ih, w_hh, bias, compute_dtype)
    return _tile_fwd_launch(bilstm_layer_fwd_mma, "bilstm_fwd_mma", x_parts, lengths, w_ih,
                            w_hh, bias, compute_dtype, False)


bilstm_layer_fwd_mma.launches = 0


def bilstm_layer_fwd_train_mma(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, ...]:
    """The train variant of :func:`bilstm_layer_fwd_mma`: also the cell
    streams ``cs_f, cs_b (T, B, H)``, after ``hn, cn``."""
    x_parts = tuple(x_parts)
    _no_graph(*x_parts, w_ih, w_hh, bias)
    if not x_parts[0].is_cuda:
        return bilstm_layer_fwd_plain(x_parts, lengths, w_ih, w_hh, bias, compute_dtype,
                                      with_states=True)
    return _tile_fwd_launch(bilstm_layer_fwd_train_mma, "bilstm_fwd_mma", x_parts, lengths,
                            w_ih, w_hh, bias, compute_dtype, True)


bilstm_layer_fwd_train_mma.launches = 0


def bilstm_layer_fwd_f32(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The eval variant of one layer in f32 on the tensor cores, three tf32
    passes a product (``csrc/bilstm_fwd_f32.cu``); the contract of
    :func:`bilstm_layer_fwd`. Takes the shapes ``fwd_f32_plan`` takes
    (float32, H <= 64) and raises for the rest; the row tile (8 or 16) is
    ``fwd_f32_rows``'s. Row tiles are cut inside each weight group, so
    nothing is padded. Its outputs carry no graph, so under grad mode it
    refuses an operand that requires grad, on the CPU too."""
    x_parts = tuple(x_parts)
    _no_graph(*x_parts, w_ih, w_hh, bias)
    if not x_parts[0].is_cuda:
        return bilstm_layer_fwd_plain(x_parts, lengths, w_ih, w_hh, bias, compute_dtype)
    return _tile_fwd_launch(bilstm_layer_fwd_f32, "bilstm_fwd_f32", x_parts, lengths, w_ih,
                            w_hh, bias, compute_dtype, False)


bilstm_layer_fwd_f32.launches = 0


def bilstm_layer_fwd_train_f32(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, ...]:
    """The train variant of :func:`bilstm_layer_fwd_f32`: also the cell
    streams ``cs_f, cs_b (T, B, H)``, after ``hn, cn``."""
    x_parts = tuple(x_parts)
    _no_graph(*x_parts, w_ih, w_hh, bias)
    if not x_parts[0].is_cuda:
        return bilstm_layer_fwd_plain(x_parts, lengths, w_ih, w_hh, bias, compute_dtype,
                                      with_states=True)
    return _tile_fwd_launch(bilstm_layer_fwd_train_f32, "bilstm_fwd_f32", x_parts, lengths,
                            w_ih, w_hh, bias, compute_dtype, True)


bilstm_layer_fwd_train_f32.launches = 0
# the tensor-core forwards' (eval, train) wrappers, by kernel name
_TILE_FWD = {"bilstm_fwd_mma": (bilstm_layer_fwd_mma, bilstm_layer_fwd_train_mma),
             "bilstm_fwd_f32": (bilstm_layer_fwd_f32, bilstm_layer_fwd_train_f32)}


def _sweep_operands(what, x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
                    dyf, dyb, dhn, dcn, cd):
    """Checked operands of a resident sweep kernel: ``(dev, T, B, H, G,
    E_parts, w_hh)`` with ``w_hh`` grouped."""
    if cd not in _DTYPE_CODES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, got {cd}")
    if len(x_parts) not in (1, 2) or len(dyf) != len(dyb) or len(dyf) > 2:
        raise ValueError(
            f"{what} kernel takes 1 or 2 input parts and 0-2 dy streams "
            f"per direction, got {len(x_parts)} parts and {len(dyf)}/{len(dyb)} streams"
        )
    dev = x_parts[0].device
    T, B = x_parts[0].shape[:2]
    H = hs_f.shape[-1]
    w_hh = grouped_w_hh(w_hh)
    G = w_hh.shape[1]
    E_parts = [p.shape[-1] for p in x_parts]
    for k, p in enumerate(x_parts):
        _check(f"x_parts[{k}]", p, (T, B, E_parts[k]), cd, dev)
    _check("w_ih", w_ih, (2, 4 * H, sum(E_parts)), cd, dev)
    _check("w_hh", w_hh, (2, G, 4 * H, H), cd, dev)
    _check("bias", bias, (2, 4 * H), torch.float32, dev)
    _check("lengths", lengths, (B,), torch.int32, dev)
    for name, t in (("hs_f", hs_f), ("hs_b", hs_b), ("cs_f", cs_f), ("cs_b", cs_b),
                    *((f"dy[{k}]", t) for k, t in enumerate(dyf + dyb))):
        _check(name, t, (T, B, H), cd, dev)
    for name, t in (("dhn", dhn), ("dcn", dcn)):
        if t is not None:
            _check(name, t, (2, B, H), torch.float32, dev)
    if B % G:
        raise ValueError(f"{what} kernel: batch {B} is not a multiple of {G} weight groups")
    return dev, T, B, H, G, E_parts, w_hh


def _ptr(seq, k):
    return seq[k].data_ptr() if k < len(seq) else None


def bilstm_bwd(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    cs_f: torch.Tensor,
    cs_b: torch.Tensor,
    dyf: Sequence[torch.Tensor],
    dyb: Sequence[torch.Tensor],
    dhn: Optional[torch.Tensor],
    dcn: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
    kernel: Optional[str] = None,
):
    """One layer's backward sweep; the contract of
    ``ops/lstm.py:bidir_layer_sweep``: returns ``(dxf, dxb, dgc, dbias)``.

    On the card the sweep runs the kernel ``sweep_kernel`` names for its
    shapes and dtype: a tensor-core one through :func:`bilstm_bwd_mma`
    (bf16), :func:`bilstm_bwd_f32` or :func:`bilstm_bwd_f32_onestage` (f32),
    whose ``.launches`` then counts it, or ``csrc/bilstm_bwd.cu`` here.
    ``kernel="bilstm_bwd"`` asks for the latter by name (to time it beside
    the others); a shape it does not take raises."""
    x_parts, dyf, dyb = tuple(x_parts), tuple(dyf), tuple(dyb)
    if not x_parts[0].is_cuda:
        return bidir_layer_sweep(x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
                                 dyf, dyb, dhn, dcn, compute_dtype)
    cd = compute_dtype
    dev, T, B, H, G, E_parts, w_hh = _sweep_operands(
        "bilstm_bwd", x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
        dyf, dyb, dhn, dcn, cd)
    if kernel not in (None, "bilstm_bwd", *_TILE_SWEEPS):
        raise ValueError(f"bilstm_bwd: no sweep kernel named {kernel!r}")
    kernel = kernel or sweep_kernel(E_parts, H, cd)
    if kernel != "bilstm_bwd":
        return _TILE_SWEEPS[kernel](x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
                                    dyf, dyb, dhn, dcn, cd)

    threads, rows, smem = bwd_launch_plan(E_parts, H, cd)
    pad = _tile_pad(B, G, rows)
    if pad:
        x_parts = tuple(_group_pad(p, 1, G, pad) for p in x_parts)
        lengths = _group_pad(lengths, 0, G, pad)
        hs_f, hs_b, cs_f, cs_b = (_group_pad(t, 1, G, pad) for t in (hs_f, hs_b, cs_f, cs_b))
        dyf = tuple(_group_pad(t, 1, G, pad) for t in dyf)
        dyb = tuple(_group_pad(t, 1, G, pad) for t in dyb)
        dhn = None if dhn is None else _group_pad(dhn, 1, G, pad)
        dcn = None if dcn is None else _group_pad(dcn, 1, G, pad)
    Bp = x_parts[0].shape[1]
    lib = _kernels("bilstm_bwd")
    dxf = tuple(torch.empty((T, Bp, e), dtype=cd, device=dev) for e in E_parts)
    dxb = tuple(torch.empty((T, Bp, e), dtype=cd, device=dev) for e in E_parts)
    dgc = torch.empty((2, T, Bp, 4 * H), dtype=cd, device=dev)
    nblk = -(-Bp // rows)
    dbias_part = torch.zeros((nblk, 2, 4 * H), dtype=torch.float32, device=dev)
    if B > 0:
        with torch.cuda.device(dev):
            err = lib.bilstm_bwd(
                _DTYPE_CODES[cd], _ptr(x_parts, 0), _ptr(x_parts, 1),
                E_parts[0], E_parts[1] if len(E_parts) == 2 else 0,
                lengths.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(),
                hs_f.data_ptr(), hs_b.data_ptr(), cs_f.data_ptr(), cs_b.data_ptr(),
                _ptr(dyf, 0), _ptr(dyf, 1), _ptr(dyb, 0), _ptr(dyb, 1), len(dyf),
                None if dhn is None else dhn.data_ptr(),
                None if dcn is None else dcn.data_ptr(),
                _ptr(dxf, 0), _ptr(dxf, 1), _ptr(dxb, 0), _ptr(dxb, 1),
                dgc.data_ptr(), dbias_part.data_ptr(),
                T, Bp, H, G, threads, smem, torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on_error("bilstm_bwd", err)
        bilstm_bwd.launches += 1
    dbias = dbias_part.sum(dim=0)
    if pad:
        Bg = B // G
        dxf = tuple(_group_unpad(t, 1, G, Bg) for t in dxf)
        dxb = tuple(_group_unpad(t, 1, G, Bg) for t in dxb)
        dgc = _group_unpad(dgc, 2, G, Bg)
    return dxf, dxb, dgc, dbias


bilstm_bwd.launches = 0


def _tile_sweep(wrapper, plan, x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
                dyf, dyb, dhn, dcn, compute_dtype):
    """The tensor-core sweeps' common body: ``wrapper`` names the kernel
    (``csrc/<name>.cu``, whose C entry takes the operands of
    ``bilstm_bwd_mma.cu``) and counts its launches; ``plan(E_parts, H,
    dtype, ny)`` gives ``(threads, smem_bytes)`` or raises. Row tiles are
    cut inside each weight group, so nothing is padded. The outputs carry
    no graph, so under grad mode it refuses an operand that requires grad,
    on the CPU too."""
    x_parts, dyf, dyb = tuple(x_parts), tuple(dyf), tuple(dyb)
    _no_graph(*x_parts, w_ih, w_hh, bias)
    if not x_parts[0].is_cuda:
        return bidir_layer_sweep(x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
                                 dyf, dyb, dhn, dcn, compute_dtype)
    cd, name = compute_dtype, wrapper.__name__
    dev, T, B, H, G, E_parts, w_hh = _sweep_operands(
        name, x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, cd)
    threads, smem = plan(E_parts, H, cd, len(dyf))
    dxf = tuple(torch.empty((T, B, e), dtype=cd, device=dev) for e in E_parts)
    dxb = tuple(torch.empty((T, B, e), dtype=cd, device=dev) for e in E_parts)
    dgc = torch.empty((2, T, B, 4 * H), dtype=cd, device=dev)
    tiles = mma_tiles(B, G)
    dbias_part = torch.zeros((tiles, 2, 4 * H), dtype=torch.float32, device=dev)
    if B * T > 0:
        with torch.cuda.device(dev):
            err = getattr(_kernels(name), name)(
                _ptr(x_parts, 0), _ptr(x_parts, 1),
                E_parts[0], E_parts[1] if len(E_parts) == 2 else 0,
                lengths.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(),
                hs_f.data_ptr(), hs_b.data_ptr(), cs_f.data_ptr(), cs_b.data_ptr(),
                _ptr(dyf, 0), _ptr(dyf, 1), _ptr(dyb, 0), _ptr(dyb, 1), len(dyf),
                None if dhn is None else dhn.data_ptr(),
                None if dcn is None else dcn.data_ptr(),
                _ptr(dxf, 0), _ptr(dxf, 1), _ptr(dxb, 0), _ptr(dxb, 1),
                dgc.data_ptr(), dbias_part.data_ptr(),
                T, B, H, G, tiles, threads, smem, torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on_error(name, err)
        wrapper.launches += 1
    return dxf, dxb, dgc, dbias_part.sum(dim=0)


def bilstm_bwd_mma(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    cs_f: torch.Tensor,
    cs_b: torch.Tensor,
    dyf: Sequence[torch.Tensor],
    dyb: Sequence[torch.Tensor],
    dhn: Optional[torch.Tensor],
    dcn: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
):
    """One layer's backward sweep on the tensor cores
    (``csrc/bilstm_bwd_mma.cu``); the contract of
    ``ops/lstm.py:bidir_layer_sweep``: returns ``(dxf, dxb, dgc, dbias)``.
    Takes the shapes ``bwd_mma_plan`` takes (bfloat16, H <= 64) and raises
    for the rest. Row tiles are cut inside each weight group, so nothing is
    padded. Its outputs carry no graph, so under grad mode it refuses an
    operand that requires grad, on the CPU too: ``BiLSTMStack`` is the way
    in."""
    return _tile_sweep(bilstm_bwd_mma, bwd_mma_plan, x_parts, lengths, w_ih, w_hh, bias,
                       hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, compute_dtype)


bilstm_bwd_mma.launches = 0


def bilstm_bwd_f32(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    cs_f: torch.Tensor,
    cs_b: torch.Tensor,
    dyf: Sequence[torch.Tensor],
    dyb: Sequence[torch.Tensor],
    dhn: Optional[torch.Tensor],
    dcn: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
):
    """One layer's backward sweep in f32 on the tensor cores, three tf32
    passes a product (``csrc/bilstm_bwd_f32.cu``); the contract of
    ``ops/lstm.py:bidir_layer_sweep``: returns ``(dxf, dxb, dgc, dbias)``.
    Takes the shapes ``bwd_f32_plan`` takes (float32, H <= 64) and raises
    for the rest, as ``bilstm_bwd_mma`` does for its own."""
    return _tile_sweep(bilstm_bwd_f32, lambda E_parts, H, cd, ny: bwd_f32_plan(E_parts, H, cd),
                       x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                       dhn, dcn, compute_dtype)


bilstm_bwd_f32.launches = 0


def bilstm_bwd_f32_onestage(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    cs_f: torch.Tensor,
    cs_b: torch.Tensor,
    dyf: Sequence[torch.Tensor],
    dyb: Sequence[torch.Tensor],
    dhn: Optional[torch.Tensor],
    dcn: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
):
    """One layer's backward sweep in f32 on the tensor cores, three tf32
    passes a product, with one [x ; h] stage (``csrc/bilstm_bwd_f32_onestage.cu``:
    the design of :func:`bilstm_bwd_f32` where its two stages do not fit,
    E = H = 80); the contract of ``ops/lstm.py:bidir_layer_sweep``: returns
    ``(dxf, dxb, dgc, dbias)``. Takes the shapes ``bwd_f32_onestage_plan``
    takes (float32, H <= 80) and raises for the rest, as ``bilstm_bwd_mma``
    does for its own."""
    return _tile_sweep(bilstm_bwd_f32_onestage,
                       lambda E_parts, H, cd, ny: bwd_f32_onestage_plan(E_parts, H, cd),
                       x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                       dhn, dcn, compute_dtype)


bilstm_bwd_f32_onestage.launches = 0
# the tensor-core sweeps' wrappers, by kernel name
_TILE_SWEEPS = {"bilstm_bwd_mma": bilstm_bwd_mma, "bilstm_bwd_f32": bilstm_bwd_f32,
                "bilstm_bwd_f32_onestage": bilstm_bwd_f32_onestage}


def bilstm_wgrad(
    dgc: torch.Tensor,
    x_parts: Sequence[torch.Tensor],
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    groups: int,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's weight gradients; the contract of
    ``ops/lstm.py:bidir_layer_wgrad``: returns ``dW_ih (2, 4H, E)`` and
    ``dW_hh (2, G, 4H, H)``, f32.

    On the card the products run on the kernel ``wgrad_kernel`` names for
    the shapes and dtype: a tensor-core one through :func:`bilstm_wgrad_mma`
    (bf16) or :func:`bilstm_wgrad_f32` (f32), whose ``.launches`` then
    counts it, or ``csrc/bilstm_wgrad.cu`` here. ``kernel="bilstm_wgrad"``
    asks for the latter by name (to time it beside the others); a shape it
    does not take raises."""
    x_parts = tuple(x_parts)
    if not dgc.is_cuda:
        return bidir_layer_wgrad(dgc, x_parts, hs_f, hs_b, groups)
    tensor_core = {"bilstm_wgrad_mma": bilstm_wgrad_mma, "bilstm_wgrad_f32": bilstm_wgrad_f32}
    if kernel not in (None, "bilstm_wgrad", *tensor_core):
        raise ValueError(f"bilstm_wgrad: no weight-gradient kernel named {kernel!r}")
    cd = dgc.dtype
    E_parts = [p.shape[-1] for p in x_parts]
    H = hs_f.shape[-1]
    name = kernel or wgrad_kernel(E_parts, H, cd)
    if name in tensor_core:
        return tensor_core[name](dgc, x_parts, hs_f, hs_b, groups)
    if cd not in _DTYPE_CODES:
        raise ValueError(f"bilstm_wgrad kernel takes float32 or bfloat16, got {cd}")
    if len(x_parts) not in (1, 2):
        raise ValueError(f"bilstm_wgrad kernel takes 1 or 2 input parts, got {len(x_parts)}")
    dev = dgc.device
    T, B = x_parts[0].shape[:2]
    G = groups
    wgrad_check(E_parts, H)
    if B % G:
        raise ValueError(f"bilstm_wgrad kernel: batch {B} is not a multiple of {G} groups")
    _check("dgc", dgc, (2, T, B, 4 * H), cd, dev)
    for k, p in enumerate(x_parts):
        _check(f"x_parts[{k}]", p, (T, B, E_parts[k]), cd, dev)
    _check("hs_f", hs_f, (T, B, H), cd, dev)
    _check("hs_b", hs_b, (T, B, H), cd, dev)

    E = sum(E_parts)
    tiles_y = (4 * H // WGRAD_TILE) * sum(-(-w // WGRAD_TILE) for w in (*E_parts, H))
    splits = max(1, min(T, math.ceil(WGRAD_TARGET_BLOCKS / (tiles_y * 2 * G))))
    partial = torch.empty((splits, 2, G, 4 * H, E + H), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        partial.zero_()
    else:
        lib = _kernels("bilstm_wgrad")
        x1 = x_parts[1] if len(x_parts) == 2 else None
        with torch.cuda.device(dev):
            err = lib.bilstm_wgrad(
                _DTYPE_CODES[cd], dgc.data_ptr(), x_parts[0].data_ptr(),
                x1.data_ptr() if x1 is not None else None,
                E_parts[0], E_parts[1] if x1 is not None else 0,
                hs_f.data_ptr(), hs_b.data_ptr(), partial.data_ptr(),
                T, B, H, G, splits, torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on_error("bilstm_wgrad", err)
        bilstm_wgrad.launches += 1
    total = partial.sum(dim=0)  # (2, G, 4H, E + H)
    return total[..., :E].sum(dim=1), total[..., E:].contiguous()


bilstm_wgrad.launches = 0


def _wgrad_tensor_core(wrapper, check, dgc, x_parts, hs_f, hs_b, groups):
    """A tensor-core weight-gradient launch (``wrapper.__name__`` names the
    kernel and its C entry) after ``check`` of its dtype and shapes, split
    by ``wgrad_mma_plan`` (bf16) or ``wgrad_f32_plan`` (f32)."""
    x_parts = tuple(x_parts)
    _no_graph(dgc, *x_parts, hs_f, hs_b)
    if not dgc.is_cuda:
        return bidir_layer_wgrad(dgc, x_parts, hs_f, hs_b, groups)
    name = wrapper.__name__
    cd = dgc.dtype
    dev = dgc.device
    T, B = x_parts[0].shape[:2]
    H = hs_f.shape[-1]
    G = groups
    E_parts = [p.shape[-1] for p in x_parts]
    check(E_parts, H, cd)
    if B % G:
        raise ValueError(f"{name} kernel: batch {B} is not a multiple of {G} groups")
    _check("dgc", dgc, (2, T, B, 4 * H), cd, dev)
    for k, p in enumerate(x_parts):
        _check(f"x_parts[{k}]", p, (T, B, E_parts[k]), cd, dev)
    _check("hs_f", hs_f, (T, B, H), cd, dev)
    _check("hs_b", hs_b, (T, B, H), cd, dev)
    E = sum(E_parts)
    if B * T == 0:
        return (torch.zeros((2, 4 * H, E), dtype=torch.float32, device=dev),
                torch.zeros((2, G, 4 * H, H), dtype=torch.float32, device=dev))
    if name == "bilstm_wgrad_f32":
        _, _, splits = wgrad_f32_plan(T, B, G, E_parts, H, _sm_count(dev))
    else:
        _, _, splits = wgrad_mma_plan(T, B, G, E_parts, H)
    partial = torch.empty((splits, 2, G, 4 * H, E + H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            dgc.data_ptr(), _ptr(x_parts, 0), _ptr(x_parts, 1),
            E_parts[0], E_parts[1] if len(E_parts) == 2 else 0,
            hs_f.data_ptr(), hs_b.data_ptr(), partial.data_ptr(),
            T, B, H, G, splits, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    total = partial.sum(dim=0)  # (2, G, 4H, E + H)
    return total[..., :E].sum(dim=1), total[..., E:].contiguous()


def bilstm_wgrad_mma(
    dgc: torch.Tensor,
    x_parts: Sequence[torch.Tensor],
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's weight gradients on the tensor cores
    (``csrc/bilstm_wgrad_mma.cu``); the contract of :func:`bilstm_wgrad`.
    Takes the shapes ``wgrad_mma_check`` takes (bfloat16, H % 8 == 0) and
    raises for the rest. Every block writes its partial tile, an empty row
    range included, so the ``torch.empty`` partials are whole; an empty
    batch returns zeros. Its outputs carry no graph, so under grad mode it
    refuses an operand that requires grad, on the CPU too."""
    return _wgrad_tensor_core(bilstm_wgrad_mma, wgrad_mma_check, dgc, x_parts, hs_f, hs_b,
                              groups)


bilstm_wgrad_mma.launches = 0


def bilstm_wgrad_f32(
    dgc: torch.Tensor,
    x_parts: Sequence[torch.Tensor],
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's weight gradients in f32 on the tensor cores, three tf32
    passes a product (``csrc/bilstm_wgrad_f32.cu``); the contract of
    :func:`bilstm_wgrad`. Takes the shapes ``wgrad_f32_check`` takes
    (float32, H % 32 == 0) and raises for the rest; split by
    ``wgrad_f32_plan``; the whole partials and the empty batch as in
    :func:`bilstm_wgrad_mma`. Its
    outputs carry no graph, so under grad mode it refuses an operand that
    requires grad, on the CPU too."""
    return _wgrad_tensor_core(bilstm_wgrad_f32, wgrad_f32_check, dgc, x_parts, hs_f, hs_b,
                              groups)


bilstm_wgrad_f32.launches = 0


def _gates_operands(x_parts, w_ih, bias, cd):
    """Checked operands of an input-gate kernel: ``(dev, T, B, H, E_parts)``."""
    _no_graph(*x_parts, w_ih, bias)
    dev = x_parts[0].device
    T, B = x_parts[0].shape[:2]
    H = w_ih.shape[1] // 4
    E_parts = [p.shape[-1] for p in x_parts]
    wide_check(H, E_parts)
    for k, p in enumerate(x_parts):
        _check(f"x_parts[{k}]", p, (T, B, E_parts[k]), cd, dev)
    _check("w_ih", w_ih, (2, 4 * H, sum(E_parts)), cd, dev)
    _check("bias", bias, (2, 4 * H), torch.float32, dev)
    return dev, T, B, H, E_parts


def bilstm_gates(
    x_parts: Sequence[torch.Tensor],
    w_ih: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """The input projection of one layer; the contract of
    ``ops/lstm.py:input_gates``: ``xg (2, T, B, 4H)`` f32 from 1 or 2
    ``(T, B, E_i)`` parts and ``w_ih (2, 4H, E)`` in ``compute_dtype`` and
    the f32 ``bias (2, 4H)``.

    On the card the product runs on the kernel ``gates_kernel`` names: the
    tensor-core one through :func:`bilstm_gates_mma` (bf16; its
    ``.launches`` then counts it), or ``csrc/bilstm_gates.cu`` here.
    ``kernel="bilstm_gates"`` asks for the latter by name (to time it beside
    the other)."""
    x_parts = tuple(x_parts)
    if not x_parts[0].is_cuda:
        return input_gates(x_parts, w_ih, bias, compute_dtype)
    if kernel not in (None, "bilstm_gates", "bilstm_gates_mma"):
        raise ValueError(f"bilstm_gates: no input-gate kernel named {kernel!r}")
    cd = compute_dtype
    name = kernel or gates_kernel([p.shape[-1] for p in x_parts], w_ih.shape[1] // 4, cd)
    if name == "bilstm_gates_mma":
        return bilstm_gates_mma(x_parts, w_ih, bias, cd)
    if cd not in _DTYPE_CODES:
        raise ValueError(f"bilstm_gates kernel takes float32 or bfloat16, got {cd}")
    dev, T, B, H, E_parts = _gates_operands(x_parts, w_ih, bias, cd)
    xg = torch.empty((2, T, B, 4 * H), dtype=torch.float32, device=dev)
    if T * B == 0:
        return xg
    x1 = x_parts[1] if len(x_parts) == 2 else None
    with torch.cuda.device(dev):
        err = _kernels("bilstm_gates").bilstm_gates(
            _DTYPE_CODES[cd], x_parts[0].data_ptr(), x1.data_ptr() if x1 is not None else None,
            E_parts[0], E_parts[1] if x1 is not None else 0, w_ih.data_ptr(), bias.data_ptr(),
            xg.data_ptr(), T, B, H, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error("bilstm_gates", err)
    bilstm_gates.launches += 1
    return xg


bilstm_gates.launches = 0


def bilstm_gates_mma(
    x_parts: Sequence[torch.Tensor],
    w_ih: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """The input projection of one layer on the tensor cores
    (``csrc/bilstm_gates_mma.cu``); the contract of :func:`bilstm_gates`.
    Takes bfloat16 at every shape ``wide_check`` admits and raises for the
    rest. Deterministic: the forward and the backward's recompute get the
    same bits. Its output carries no graph, so under grad mode it refuses an
    operand that requires grad, on the CPU too."""
    x_parts = tuple(x_parts)
    _no_graph(*x_parts, w_ih, bias)
    if not x_parts[0].is_cuda:
        return input_gates(x_parts, w_ih, bias, compute_dtype)
    cd = compute_dtype
    if cd != torch.bfloat16:
        raise ValueError(f"bilstm_gates_mma kernel takes bfloat16, got {cd}")
    dev, T, B, H, E_parts = _gates_operands(x_parts, w_ih, bias, cd)
    xg = torch.empty((2, T, B, 4 * H), dtype=torch.float32, device=dev)
    if T * B == 0:
        return xg
    with torch.cuda.device(dev):
        err = _kernels("bilstm_gates_mma").bilstm_gates_mma(
            _ptr(x_parts, 0), _ptr(x_parts, 1), E_parts[0],
            E_parts[1] if len(E_parts) == 2 else 0, w_ih.data_ptr(), bias.data_ptr(),
            xg.data_ptr(), T, B, H, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error("bilstm_gates_mma", err)
    bilstm_gates_mma.launches += 1
    return xg


bilstm_gates_mma.launches = 0


def _wide_operands(xg, lengths, w_hh, cd, what):
    """Checked operands of a wide kernel: ``(dev, T, B, H, G, w_hh)``."""
    if cd not in _DTYPE_CODES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, got {cd}")
    dev = xg.device
    _, T, B, H4 = xg.shape
    H = H4 // 4
    w_hh = grouped_w_hh(w_hh)
    G = w_hh.shape[1]
    wide_check(H)
    _check("xg", xg, (2, T, B, H4), torch.float32, dev)
    _check("w_hh", w_hh, (2, G, H4, H), cd, dev)
    _check("lengths", lengths, (B,), torch.int32, dev)
    if B % G:
        raise ValueError(f"{what} kernel: batch {B} is not a multiple of {G} weight groups")
    return dev, T, B, H, G, w_hh


def _fwd_wide_launch(wrapper, name, xg, lengths, w_hh, cd, with_states):
    """A wide forward launch of the kernel ``name`` ("bilstm_fwd_wide" or
    "bilstm_fwd_wide_mma") on the row tile its plan picks, counted on
    ``wrapper``; an empty batch launches nothing."""
    dev, T, B, H, G, w_hh = _wide_operands(xg, lengths, w_hh, cd, name)
    hs_f = torch.empty((T, B, H), dtype=cd, device=dev)
    hs_b = torch.empty_like(hs_f)
    cs_f = torch.empty_like(hs_f) if with_states else None
    cs_b = torch.empty_like(hs_f) if with_states else None
    hn = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    cn = torch.empty_like(hn)
    outs = (hs_f, hs_b, hn, cn) + ((cs_f, cs_b) if with_states else ())
    if B == 0:
        return outs
    mma = name == "bilstm_fwd_wide_mma"
    rows, tiles, smem = wide_plan("fwd_mma" if mma else "fwd", B, G, H,
                                  _max_clusters(name, cd, H, dev))
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            *([] if mma else [_DTYPE_CODES[cd]]), rows, xg.data_ptr(), lengths.data_ptr(),
            w_hh.data_ptr(), hs_f.data_ptr(), hs_b.data_ptr(), _opt_ptr(cs_f), _opt_ptr(cs_b),
            hn.data_ptr(), cn.data_ptr(), T, B, H, G, tiles, smem,
            torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    return outs


def _fwd_wide_dispatch(wrapper, mma_wrapper, xg, lengths, w_hh, cd, kernel, with_states):
    if kernel not in (None, "bilstm_fwd_wide", "bilstm_fwd_wide_mma"):
        raise ValueError(f"bilstm_fwd_wide: no wide forward kernel named {kernel!r}")
    if (kernel or wide_fwd_kernel(xg.shape[-1] // 4, cd)) == "bilstm_fwd_wide_mma":
        return mma_wrapper(xg, lengths, w_hh, cd)
    _no_graph(xg, w_hh)
    return _fwd_wide_launch(wrapper, "bilstm_fwd_wide", xg, lengths, w_hh, cd, with_states)


def bilstm_fwd_wide(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's recurrence over its input gates, eval variant; the
    contract of ``ops/lstm.py:bidir_recurrence``.

    :param xg: ``(2, T, B, 4H)`` f32 (``bilstm_gates``).
    :param lengths: ``(B,)`` int32; ``w_hh`` ``(2, 4H, H)`` or ``(2, G, 4H,
        H)`` in ``compute_dtype``.
    :returns: ``hs_f, hs_b (T, B, H)`` in ``compute_dtype``, ``hn, cn
        (2, B, H)`` f32.

    On the card the recurrence runs the kernel ``wide_fwd_kernel`` names for
    its width and dtype: the tensor-core one through
    :func:`bilstm_fwd_wide_mma` (bf16 at H = 128 and 256; its ``.launches``
    then counts it), or ``csrc/bilstm_fwd_wide.cu`` here.
    ``kernel="bilstm_fwd_wide"`` asks for the latter by name (to time it
    beside the other).
    """
    if not xg.is_cuda:
        return bidir_recurrence(xg, lengths, w_hh, compute_dtype)
    return _fwd_wide_dispatch(bilstm_fwd_wide, bilstm_fwd_wide_mma, xg, lengths, w_hh,
                              compute_dtype, kernel, False)


bilstm_fwd_wide.launches = 0


def bilstm_fwd_wide_train(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """The train variant of :func:`bilstm_fwd_wide`: also the cell streams
    ``cs_f, cs_b (T, B, H)`` in ``compute_dtype``, after ``hn, cn``; its
    tensor-core kernel through :func:`bilstm_fwd_wide_train_mma`."""
    if not xg.is_cuda:
        return bidir_recurrence(xg, lengths, w_hh, compute_dtype, with_states=True)
    return _fwd_wide_dispatch(bilstm_fwd_wide_train, bilstm_fwd_wide_train_mma, xg, lengths,
                              w_hh, compute_dtype, kernel, True)


bilstm_fwd_wide_train.launches = 0


def _fwd_wide_mma(wrapper, xg, lengths, w_hh, cd, with_states):
    _no_graph(xg, w_hh)
    if not xg.is_cuda:
        return bidir_recurrence(xg, lengths, w_hh, cd, with_states=with_states)
    fwd_wide_mma_check(xg.shape[-1] // 4, cd)
    return _fwd_wide_launch(wrapper, "bilstm_fwd_wide_mma", xg, lengths, w_hh, cd, with_states)


def bilstm_fwd_wide_mma(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's recurrence over its input gates on the tensor cores
    (``csrc/bilstm_fwd_wide_mma.cu``), eval variant; the contract of
    :func:`bilstm_fwd_wide`. Takes the widths ``fwd_wide_mma_check`` takes
    (bfloat16, H = 128 and 256) and raises for the rest; the row tile is
    ``wide_plan("fwd_mma", ...)``'s. Its outputs carry no graph, so under
    grad mode it refuses an operand that requires grad, on the CPU too."""
    return _fwd_wide_mma(bilstm_fwd_wide_mma, xg, lengths, w_hh, compute_dtype, False)


bilstm_fwd_wide_mma.launches = 0


def bilstm_fwd_wide_train_mma(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, ...]:
    """The train variant of :func:`bilstm_fwd_wide_mma`: also the cell
    streams ``cs_f, cs_b (T, B, H)`` in bfloat16, after ``hn, cn``. It gives
    the eval variant's ``hs`` bit for bit."""
    return _fwd_wide_mma(bilstm_fwd_wide_train_mma, xg, lengths, w_hh, compute_dtype, True)


bilstm_fwd_wide_train_mma.launches = 0


def _lite_operands(what, xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, cd):
    """Checked operands of a lite sweep kernel: ``(dev, T, B, H, G, w_hh)``."""
    if len(dyf) != len(dyb) or len(dyf) > 2:
        raise ValueError(
            f"{what} kernel takes 0-2 dy streams per direction, got {len(dyf)}/{len(dyb)}")
    dev, T, B, H, G, w_hh = _wide_operands(xg, lengths, w_hh, cd, what)
    for name, t in (("hs_f", hs_f), ("hs_b", hs_b), ("cs_f", cs_f), ("cs_b", cs_b),
                    *((f"dy[{k}]", t) for k, t in enumerate(dyf + dyb))):
        _check(name, t, (T, B, H), cd, dev)
    for name, t in (("dhn", dhn), ("dcn", dcn)):
        if t is not None:
            _check(name, t, (2, B, H), torch.float32, dev)
    return dev, T, B, H, G, w_hh


def bilstm_bwd_lite(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    cs_f: torch.Tensor,
    cs_b: torch.Tensor,
    dyf: Sequence[torch.Tensor],
    dyb: Sequence[torch.Tensor],
    dhn: Optional[torch.Tensor],
    dcn: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """One layer's backward sweep over its input gates; the contract of
    ``ops/lstm.py:bidir_layer_sweep_lite``: returns the masked ``dgates
    (2, T, B, 4H)`` f32.

    On the card the sweep runs the kernel ``lite_kernel`` names for its
    width and dtype: the tensor-core one through :func:`bilstm_bwd_lite_mma`
    (bf16 at H = 128 and 256; its ``.launches`` then counts it), or
    ``csrc/bilstm_bwd_lite.cu`` here. ``kernel="bilstm_bwd_lite"`` asks for
    the latter by name (to time it beside the other)."""
    dyf, dyb = tuple(dyf), tuple(dyb)
    cd = compute_dtype
    if not xg.is_cuda:
        return bidir_layer_sweep_lite(xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                                      dhn, dcn, cd)
    if kernel not in (None, "bilstm_bwd_lite", "bilstm_bwd_lite_mma"):
        raise ValueError(f"bilstm_bwd_lite: no lite sweep kernel named {kernel!r}")
    if (kernel or lite_kernel(xg.shape[-1] // 4, cd)) == "bilstm_bwd_lite_mma":
        return bilstm_bwd_lite_mma(xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                                   dhn, dcn, cd)
    dev, T, B, H, G, w_hh = _lite_operands("bilstm_bwd_lite", xg, lengths, w_hh, hs_f, hs_b,
                                           cs_f, cs_b, dyf, dyb, dhn, dcn, cd)
    dgates = torch.empty((2, T, B, 4 * H), dtype=torch.float32, device=dev)
    if B * T == 0:
        return dgates
    R, tiles, smem = wide_plan("bwd", B, G, H, _max_clusters("bilstm_bwd_lite", cd, H, dev))

    with torch.cuda.device(dev):
        err = _kernels("bilstm_bwd_lite").bilstm_bwd_lite(
            _DTYPE_CODES[cd], R, xg.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            hs_f.data_ptr(), hs_b.data_ptr(), cs_f.data_ptr(), cs_b.data_ptr(),
            _ptr(dyf, 0), _ptr(dyf, 1), _ptr(dyb, 0), _ptr(dyb, 1), len(dyf),
            None if dhn is None else dhn.data_ptr(), None if dcn is None else dcn.data_ptr(),
            dgates.data_ptr(), T, B, H, G, tiles, smem,
            torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error("bilstm_bwd_lite", err)
    bilstm_bwd_lite.launches += 1
    return dgates


bilstm_bwd_lite.launches = 0


def bilstm_bwd_lite_mma(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    cs_f: torch.Tensor,
    cs_b: torch.Tensor,
    dyf: Sequence[torch.Tensor],
    dyb: Sequence[torch.Tensor],
    dhn: Optional[torch.Tensor],
    dcn: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """One layer's backward sweep over its input gates on the tensor cores
    (``csrc/bilstm_bwd_lite_mma.cu``); the contract of
    :func:`bilstm_bwd_lite`. Takes the widths ``lite_mma_check`` takes
    (bfloat16, H = 128 and 256) and raises for the rest; the row tile is
    ``wide_plan("lite_mma", ...)``'s. Its output carries no graph, so under
    grad mode it refuses an operand that requires grad, on the CPU too."""
    dyf, dyb = tuple(dyf), tuple(dyb)
    cd = compute_dtype
    _no_graph(xg, w_hh, hs_f, hs_b, cs_f, cs_b, *dyf, *dyb)
    if not xg.is_cuda:
        return bidir_layer_sweep_lite(xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                                      dhn, dcn, cd)
    lite_mma_check(xg.shape[-1] // 4, cd)
    dev, T, B, H, G, w_hh = _lite_operands("bilstm_bwd_lite_mma", xg, lengths, w_hh, hs_f,
                                           hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, cd)
    dgates = torch.empty((2, T, B, 4 * H), dtype=torch.float32, device=dev)
    if B * T == 0:
        return dgates
    rows, tiles, smem = wide_plan("lite_mma", B, G, H,
                                  _max_clusters("bilstm_bwd_lite_mma", cd, H, dev))
    with torch.cuda.device(dev):
        err = _kernels("bilstm_bwd_lite_mma").bilstm_bwd_lite_mma(
            rows, xg.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            hs_f.data_ptr(), hs_b.data_ptr(), cs_f.data_ptr(), cs_b.data_ptr(),
            _ptr(dyf, 0), _ptr(dyf, 1), _ptr(dyb, 0), _ptr(dyb, 1), len(dyf),
            _opt_ptr(dhn), _opt_ptr(dcn), dgates.data_ptr(), T, B, H, G, tiles, smem,
            torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error("bilstm_bwd_lite_mma", err)
    bilstm_bwd_lite_mma.launches += 1
    return dgates


bilstm_bwd_lite_mma.launches = 0


# ------------------------------------------------------------ one layer, routed
def pad_units(t: torch.Tensor, H: int, Hp: int, dim: int = -1) -> torch.Tensor:
    """``t`` with its H units along ``dim`` grown to Hp by zeros at the end."""
    if Hp == H:
        return t
    shape = list(t.shape)
    shape[dim] = Hp
    out = t.new_zeros(shape)
    out.narrow(dim, 0, H).copy_(t)
    return out


def pad_gate_rows(t: torch.Tensor, H: int, Hp: int, dim: int) -> torch.Tensor:
    """``t`` with its 4H gate rows along ``dim`` (gate order i, f, g, o)
    grown to 4Hp: each gate's block of H grown to Hp by zeros at its end,
    within the block."""
    if Hp == H:
        return t
    dim %= t.dim()
    shape = list(t.shape)
    blocks = t.reshape(shape[:dim] + [4, H] + shape[dim + 1:])
    return pad_units(blocks, H, Hp, dim + 1).reshape(shape[:dim] + [4 * Hp] + shape[dim + 1:])


def unpad_gate_rows(t: torch.Tensor, H: int, Hp: int, dim: int) -> torch.Tensor:
    """The inverse of ``pad_gate_rows``: the first H rows of each gate block
    of Hp, contiguous."""
    if Hp == H:
        return t
    dim %= t.dim()
    shape = list(t.shape)
    blocks = t.reshape(shape[:dim] + [4, Hp] + shape[dim + 1:]).narrow(dim + 1, 0, H)
    return blocks.reshape(shape[:dim] + [4 * H] + shape[dim + 1:]).contiguous()


def pad_parts(t: torch.Tensor, E_parts: Sequence[int], Ep: Sequence[int],
              dim: int = -1) -> torch.Tensor:
    """``t`` with its input columns along ``dim`` (the parts of
    ``E_parts`` side by side) grown part by part to ``Ep``, each by zeros
    at its own end."""
    if tuple(E_parts) == tuple(Ep):
        return t
    pieces = torch.split(t, list(E_parts), dim)
    return torch.cat([pad_units(q, e, ep, dim) for q, e, ep in zip(pieces, E_parts, Ep)], dim)


def unpad_parts(t: torch.Tensor, E_parts: Sequence[int], Ep: Sequence[int],
                dim: int = -1) -> torch.Tensor:
    """The inverse of ``pad_parts``: the first E columns of each part of
    ``Ep``, contiguous."""
    if tuple(E_parts) == tuple(Ep):
        return t
    pieces = torch.split(t, list(Ep), dim)
    return torch.cat([q.narrow(dim, 0, e) for q, e in zip(pieces, E_parts)], dim)


def pad_layer(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor, H: int, Hp: int,
              E_parts: Sequence[int] = (), Ep: Sequence[int] = ()):
    """A layer's operands at Hp units and input parts of ``Ep`` columns:
    every gate block of ``w_ih (2, 4H, E)``, ``w_hh (2, [G,] 4H, H)`` and
    ``bias (2, 4H)`` grown to Hp rows, ``w_hh`` to Hp columns and each
    part's block of ``w_ih`` columns to its width in ``Ep``, all by zeros.
    A padded unit's pre-activation is then exactly 0, so its c stays 0
    (``sigmoid(0) * 0 + sigmoid(0) * tanh(0)``) and its h is 0; the real
    units read it through zero columns; in the backward its dh and dc are
    0, so its gate cotangents are 0 and add nothing to the real units' dh,
    dx or weight gradients. A padded input column (zero in x, ``layer_fwd``
    pads it so) meets a zero weight column, so it adds exactly 0 to every
    gate; its dx and its ``dW_ih`` column belong to no real input and are
    cut off (``layer_bwd``), and the real columns' products are the same
    sums as without it."""
    return (pad_parts(pad_gate_rows(w_ih, H, Hp, -2), E_parts, Ep),
            pad_units(pad_gate_rows(w_hh, H, Hp, -2), H, Hp, -1),
            pad_gate_rows(bias, H, Hp, -1))


def _padded_layer(x_parts, w_ih, w_hh, bias, H, compute_dtype):
    """``(route, Hp, Ep, x_parts, w_ih, w_hh, bias)`` of a layer at its
    padded shape (``_layer_plan``), the x parts grown by zero columns."""
    E_parts = tuple(p.shape[-1] for p in x_parts)
    route, Hp, Ep = _layer_plan(E_parts, H, compute_dtype)
    w_ih, w_hh, bias = pad_layer(w_ih, w_hh, bias, H, Hp, E_parts, Ep)
    x_parts = tuple(pad_units(p, e, ep) for p, e, ep in zip(x_parts, E_parts, Ep))
    return route, Hp, Ep, x_parts, w_ih, w_hh, bias


def layer_fwd(x_parts, lengths, w_ih, w_hh, bias, compute_dtype, with_states=False):
    """One layer's forward on its route (``layer_route``) at its padded
    shape (``padded_width``, ``padded_parts``): the eval variant's
    ``(hs_f, hs_b, hn, cn)``, or with ``with_states`` the train variant's,
    which adds ``(cs_f, cs_b)``. A padded layer's outputs are cut back to
    its H units."""
    H = w_hh.shape[-1]
    route, Hp, _, x_parts, w_ih, w_hh, bias = _padded_layer(
        tuple(x_parts), w_ih, w_hh, bias, H, compute_dtype)
    if route == "resident":
        fwd = bilstm_layer_fwd_train if with_states else bilstm_layer_fwd
        outs = fwd(x_parts, lengths, w_ih, w_hh, bias, compute_dtype)
    else:
        fwd = bilstm_fwd_wide_train if with_states else bilstm_fwd_wide
        outs = fwd(bilstm_gates(x_parts, w_ih, bias, compute_dtype), lengths, w_hh,
                   compute_dtype)
    if Hp == H:
        return outs
    return tuple(o[..., :H].contiguous() for o in outs)


def layer_bwd(x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b,
              dyf, dyb, dhn, dcn, compute_dtype):
    """One layer's backward on its route at its padded shape, with the
    contract of ``ops/lstm.py:bidir_layer_bwd``: ``(dxf, dxb, dW_ih (2, 4H,
    E), dW_hh (2, G, 4H, H), dbias (2, 4H))``, the weight gradients f32.
    The sweep is ``bilstm_bwd`` (resident) or, on the wide route, the input
    gates recomputed with the forward's kernel (the same dispatch, so the
    same f32 bits), the lite sweep, and dx, ``dgc`` and ``dbias`` from
    ``ops/lstm.py:input_grads``; then ``bilstm_wgrad``. A padded layer's
    states and cotangents are grown back to Hp units by zeros (the padded
    units' values: ``pad_layer``), and its dx parts, ``dW_ih`` columns and
    gradients are cut back to the true widths."""
    E_parts = tuple(p.shape[-1] for p in x_parts)
    H = hs_f.shape[-1]
    route, Hp, Ep, x_parts, w_ih, w_hh, bias = _padded_layer(
        tuple(x_parts), w_ih, w_hh, bias, H, compute_dtype)
    hs_f, hs_b, cs_f, cs_b = (pad_units(t, H, Hp) for t in (hs_f, hs_b, cs_f, cs_b))
    dyf, dyb = (tuple(pad_units(t, H, Hp) for t in ts) for ts in (dyf, dyb))
    dhn, dcn = (None if t is None else pad_units(t, H, Hp) for t in (dhn, dcn))
    if route == "resident":
        dxf, dxb, dgc, dbias = bilstm_bwd(x_parts, lengths, w_ih, w_hh, bias, hs_f, hs_b,
                                          cs_f, cs_b, dyf, dyb, dhn, dcn, compute_dtype)
    else:
        dgates = bilstm_bwd_lite(bilstm_gates(x_parts, w_ih, bias, compute_dtype), lengths,
                                 w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn,
                                 compute_dtype)
        dxf, dxb, dgc, dbias = input_grads(dgates, w_ih, Ep)
        del dgates
    dw_ih, dw_hh = bilstm_wgrad(dgc, x_parts, hs_f, hs_b, grouped_w_hh(w_hh).shape[1])
    if Ep != E_parts:
        dxf, dxb = (tuple(t[..., :e].contiguous() for t, e in zip(ts, E_parts))
                    for ts in (dxf, dxb))
        dw_ih = unpad_parts(dw_ih, E_parts, Ep)
    if Hp != H:
        dw_ih = unpad_gate_rows(dw_ih, H, Hp, -2)
        dw_hh = unpad_gate_rows(dw_hh, H, Hp, -2)[..., :H].contiguous()
        dbias = unpad_gate_rows(dbias, H, Hp, -1)
    return dxf, dxb, dw_ih, dw_hh, dbias


# ------------------------------------------- the time-major recurrence op
REC_MMA_WIDTHS = (32, 64)


def recurrence_width(H: int, compute_dtype: torch.dtype, on_card: bool = True) -> int:
    """The width the recurrence op of H units runs at: H where
    ``recurrence_check`` takes it, else the next multiple of 32 (at least
    32), each gate block of ``xg`` and ``w`` grown by zero units (the
    exactness argument of ``pad_layer``; ``FusedLSTMRecurrence`` pads and
    cuts back). Past ``REC_MAX_H`` the card's kernels take no width
    (ValueError with ``on_card``: one thread per unit, and a block holds at
    most 1024), while the plain twins, which take any H as JAX's interpret
    mode does, run the op unpadded. ValueError for H < 1 or a compute dtype
    the kernels do not take."""
    if H < 1:
        raise ValueError(f"the recurrence op takes H >= 1, got H={H}")
    if H > REC_MAX_H:
        if on_card:
            raise ValueError(f"the recurrence op takes H <= {REC_MAX_H} on the card (its "
                             f"kernels run one thread per unit in each of 8 blocks of at most "
                             f"1024), got H={H}")
        return H
    Hp = max(32, -(-H // 32) * 32)
    recurrence_check(Hp, compute_dtype)
    return Hp


def recurrence_check(H: int, compute_dtype: torch.dtype) -> None:
    """ValueError for a width or compute dtype the recurrence kernels do
    not take."""
    if compute_dtype not in _DTYPE_CODES or H % 32 or not 32 <= H <= REC_MAX_H:
        raise ValueError(
            f"lstm_recurrence kernels take H in {{32, 64, 96, ..., {REC_MAX_H}}} "
            f"(H % 32 == 0) with compute dtype float32 or bfloat16 (the forward, the weight "
            f"gradient and the cluster sweep lstm_recurrence_bwd; the tensor-core sweeps "
            f"lstm_recurrence_bwd_mma takes bfloat16 with H in {set(REC_MMA_WIDTHS)}, and "
            f"lstm_recurrence_bwd_f32 float32 there), got H={H}, {compute_dtype}")


def recurrence_sweep_kernel(H: int, compute_dtype: torch.dtype) -> str:
    """The kernel the recurrence op's sweep takes, by width and compute
    dtype alone: at H = 32 or 64 the tensor-core ones,
    ``"lstm_recurrence_bwd_mma"`` for bfloat16 and
    ``"lstm_recurrence_bwd_f32"`` (three tf32 passes) for float32; the
    cluster kernel ``"lstm_recurrence_bwd"`` for H = 96 to ``REC_MAX_H``
    in either dtype; ValueError for what none takes."""
    recurrence_check(H, compute_dtype)
    if H in REC_MMA_WIDTHS:
        return "lstm_recurrence_bwd_mma" if compute_dtype == torch.bfloat16 \
            else "lstm_recurrence_bwd_f32"
    return "lstm_recurrence_bwd"


def recurrence_mma_smem(H: int) -> int:
    """Dynamic shared memory of the tensor-core recurrence sweep's block:
    the bf16 ``w`` (4H x H, rows padded), two bf16 dgates tiles, and three
    stages of the f32 xg, h_prev, c_prev and dhs tiles."""
    ws, gs = H + MMA_PAD, 4 * H + MMA_PAD
    xs, cs = 4 * H + REC_MMA_F32_PAD, H + REC_MMA_F32_PAD
    return (_a16(4 * H * ws * 2) + _a16(2 * MMA_TILE * gs * 2)
            + MMA_STAGES * MMA_TILE * 4 * (xs + ws + 2 * cs))


def recurrence_f32_smem(H: int) -> int:
    """Dynamic shared memory of the f32 tensor-core recurrence sweep's
    block: ``w`` pre-split into a big and a small f32 copy (4H x H each,
    rows padded), two buffers of the big and small f32 dgates tiles, and
    three stages of the f32 xg, h_prev, c_prev and dhs tiles."""
    ws, gs = H + MMA_PAD, 4 * H + REC_MMA_F32_PAD
    xs, cs = 4 * H + REC_MMA_F32_PAD, H + REC_MMA_F32_PAD
    return 4 * (2 * 4 * H * ws + 2 * 2 * MMA_TILE * gs
                + MMA_STAGES * MMA_TILE * (xs + ws + 2 * cs))


def recurrence_global_weights(w: torch.Tensor) -> Optional[torch.Tensor]:
    """The copy of ``w (D, G, H, 4H)`` the cluster kernels read past
    ``WIDE_MAX_THREADS`` units, where a block's f32 slice no longer fits
    shared memory: f32, laid out as the shared slices are, ``(D, G,
    WIDE_CLUSTER, H, H / 8, 4)`` ([d][g][block][k][unit][gate]), so each
    block reads one contiguous slice; None at the widths whose slices stay
    in shared memory."""
    D, G, H, _ = w.shape
    if H <= WIDE_MAX_THREADS:
        return None
    U = H // WIDE_CLUSTER
    return w.float().reshape(D, G, H, 4, WIDE_CLUSTER, U).permute(0, 1, 4, 2, 5, 3).contiguous()


def _recurrence_operands(xg, valid, w, G, cd, what):
    """Checked operands of a recurrence kernel: ``(dev, T, D, B, H, valid8)``
    with the mask as contiguous uint8."""
    dev = xg.device
    if xg.dim() != 4:
        raise ValueError(f"{what} kernel: xg must be (T, D, B, 4H), got {tuple(xg.shape)}")
    T, D, B, H4 = xg.shape
    H = H4 // 4
    recurrence_check(H, cd)
    _check("xg", xg, (T, D, B, 4 * H), torch.float32, dev)
    _check("w", w, (D, G, H, 4 * H), cd, dev)
    if valid.device != dev or tuple(valid.shape) != (T, D, B):
        raise ValueError(
            f"{what} kernel: valid must be (T, D, B) = {(T, D, B)} on {dev}, got "
            f"{tuple(valid.shape)} on {valid.device}")
    if B % G:
        raise ValueError(f"{what} kernel: batch {B} is not a multiple of {G} weight groups")
    return dev, T, D, B, H, (valid != 0).to(torch.uint8).contiguous()


def lstm_recurrence_fwd(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, G: int, compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The masked recurrence over time-major input gates; the contract of
    ``ops/lstm_recurrence.py:recurrence_fwd``.

    :param xg: ``(T, D, B, 4H)`` f32; ``valid`` ``(T, D, B)`` bool or int;
        ``w`` ``(D, G, H, 4H)`` in ``compute_dtype``.
    :returns: ``hs, cs (T, D, B, H)`` and ``hn, cn (D, B, H)``, f32.
    """
    _no_graph(xg, w)
    if not xg.is_cuda:
        return recurrence_fwd(xg, valid, w, G, compute_dtype)
    cd = compute_dtype
    dev, T, D, B, H, valid8 = _recurrence_operands(xg, valid, w, G, cd, "lstm_recurrence_fwd")
    hs = torch.empty((T, D, B, H), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    hn = torch.zeros((D, B, H), dtype=torch.float32, device=dev)
    cn = torch.zeros_like(hn)
    if B * D == 0 or T == 0:
        return hs, cs, hn, cn
    name = "lstm_recurrence_fwd"
    R, tiles, smem = wide_plan("fwd", B, G, H, _max_clusters(name, cd, H, dev), dirs=D)
    wl = recurrence_global_weights(w)
    with torch.cuda.device(dev):
        err = _kernels(name).lstm_recurrence_fwd(
            _DTYPE_CODES[cd], R, xg.data_ptr(), valid8.data_ptr(), w.data_ptr(), _opt_ptr(wl),
            hs.data_ptr(), cs.data_ptr(), hn.data_ptr(), cn.data_ptr(), D, T, B, H, G, tiles,
            smem, torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    lstm_recurrence_fwd.launches += 1
    return hs, cs, hn, cn


lstm_recurrence_fwd.launches = 0


def _recurrence_sweep_operands(what, xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd):
    """Checked operands of a recurrence sweep kernel, as
    ``_recurrence_operands``."""
    dev, T, D, B, H, valid8 = _recurrence_operands(xg, valid, w, G, cd, what)
    for name, t, shape in (("hs", hs, (T, D, B, H)), ("cs", cs, (T, D, B, H)),
                           ("dhs", dhs, (T, D, B, H)), ("dhn", dhn, (D, B, H)),
                           ("dcn", dcn, (D, B, H))):
        if t is not None:
            _check(name, t, shape, torch.float32, dev)
    return dev, T, D, B, H, valid8


def _opt_ptr(t):
    return None if t is None else t.data_ptr()


def lstm_recurrence_bwd(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: Optional[torch.Tensor], dhn: Optional[torch.Tensor], dcn: Optional[torch.Tensor],
    G: int, compute_dtype: torch.dtype, kernel: Optional[str] = None,
) -> torch.Tensor:
    """The recurrence's backward sweep; the contract of
    ``ops/lstm_recurrence.py:recurrence_sweep``: the masked f32 gate
    cotangents ``dxg (T, D, B, 4H)``. ``dhs (T, D, B, H)`` and ``dhn``,
    ``dcn (D, B, H)`` are f32, or None for zero.

    On the card the sweep runs the kernel ``recurrence_sweep_kernel`` names
    for its width and dtype: the tensor-core one through
    :func:`lstm_recurrence_bwd_mma` (whose ``.launches`` then counts it), or
    the cluster kernel here. ``kernel="lstm_recurrence_bwd"`` asks for the
    latter by name (to time it beside the others)."""
    _no_graph(xg, w, hs, cs)
    if not xg.is_cuda:
        return recurrence_sweep(xg, valid, w, hs, cs, dhs, dhn, dcn, G, compute_dtype)
    cd = compute_dtype
    name = "lstm_recurrence_bwd"
    if kernel not in (None, name, *_TILE_SWEEP):
        raise ValueError(f"lstm_recurrence_bwd: no sweep kernel named {kernel!r}")
    dev, T, D, B, H, valid8 = _recurrence_sweep_operands(
        name, xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    kernel = kernel or recurrence_sweep_kernel(H, cd)
    if kernel in _TILE_SWEEP:
        return _TILE_SWEEP[kernel](xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    dxg = torch.empty((T, D, B, 4 * H), dtype=torch.float32, device=dev)
    if B * D * T == 0:
        return dxg
    R, tiles, smem = wide_plan("bwd", B, G, H, _max_clusters(name, cd, H, dev), dirs=D)
    wl = recurrence_global_weights(w)
    with torch.cuda.device(dev):
        err = _kernels(name).lstm_recurrence_bwd(
            _DTYPE_CODES[cd], R, xg.data_ptr(), valid8.data_ptr(), w.data_ptr(), _opt_ptr(wl),
            hs.data_ptr(), cs.data_ptr(), _opt_ptr(dhs), _opt_ptr(dhn), _opt_ptr(dcn),
            dxg.data_ptr(), D, T, B, H, G, tiles, smem,
            torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    lstm_recurrence_bwd.launches += 1
    return dxg


lstm_recurrence_bwd.launches = 0


def lstm_recurrence_bwd_mma(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: Optional[torch.Tensor], dhn: Optional[torch.Tensor], dcn: Optional[torch.Tensor],
    G: int, compute_dtype: torch.dtype,
) -> torch.Tensor:
    """The recurrence's backward sweep on the tensor cores
    (``csrc/lstm_recurrence_bwd_mma.cu``: one block per 8-row tile and
    direction, no cluster); the contract of
    ``ops/lstm_recurrence.py:recurrence_sweep``. Takes bfloat16 at H = 32 or
    64 and raises for the rest."""
    return _tile_recurrence_sweep(lstm_recurrence_bwd_mma, "bfloat16", recurrence_mma_smem,
                                  xg, valid, w, hs, cs, dhs, dhn, dcn, G, compute_dtype)


lstm_recurrence_bwd_mma.launches = 0


def lstm_recurrence_bwd_f32(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: Optional[torch.Tensor], dhn: Optional[torch.Tensor], dcn: Optional[torch.Tensor],
    G: int, compute_dtype: torch.dtype,
) -> torch.Tensor:
    """The recurrence's backward sweep in f32 on the tensor cores, three
    tf32 passes a product (``csrc/lstm_recurrence_bwd_f32.cu``: the design
    of ``lstm_recurrence_bwd_mma`` with ``w`` resident pre-split); the
    contract of ``ops/lstm_recurrence.py:recurrence_sweep``. Takes float32
    at H = 32 or 64 and raises for the rest."""
    return _tile_recurrence_sweep(lstm_recurrence_bwd_f32, "float32", recurrence_f32_smem,
                                  xg, valid, w, hs, cs, dhs, dhn, dcn, G, compute_dtype)


lstm_recurrence_bwd_f32.launches = 0
# the tensor-core recurrence sweeps' wrappers, by kernel name
_TILE_SWEEP = {"lstm_recurrence_bwd_mma": lstm_recurrence_bwd_mma,
               "lstm_recurrence_bwd_f32": lstm_recurrence_bwd_f32}


def _tile_recurrence_sweep(wrapper, dtype_name, smem, xg, valid, w, hs, cs, dhs, dhn, dcn, G,
                           compute_dtype):
    """The tensor-core recurrence sweeps' common body: ``wrapper`` names the
    kernel (``csrc/<name>.cu``, one block per 8-row tile and direction),
    takes compute dtype ``dtype_name`` at H = 32 or 64 and counts its
    launches; ``smem(H)`` is its dynamic shared memory. On the CPU the plain
    twin; under grad mode an operand that requires grad is refused."""
    _no_graph(xg, w, hs, cs)
    if not xg.is_cuda:
        return recurrence_sweep(xg, valid, w, hs, cs, dhs, dhn, dcn, G, compute_dtype)
    cd, name = compute_dtype, wrapper.__name__
    dev, T, D, B, H, valid8 = _recurrence_sweep_operands(
        name, xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    if recurrence_sweep_kernel(H, cd) != name:
        raise ValueError(
            f"{name} kernel takes compute dtype {dtype_name} with H in {set(REC_MMA_WIDTHS)}, "
            f"got H={H}, {cd}")
    dxg = torch.empty((T, D, B, 4 * H), dtype=torch.float32, device=dev)
    if B * D * T == 0:
        return dxg
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            xg.data_ptr(), valid8.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            _opt_ptr(dhs), _opt_ptr(dhn), _opt_ptr(dcn), dxg.data_ptr(),
            D, T, B, H, G, mma_tiles(B, G), smem(H),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    return dxg


def recurrence_wgrad_kernel(H: int, compute_dtype: torch.dtype) -> str:
    """The kernel the recurrence op's weight gradient takes, by width and
    compute dtype alone: ``"lstm_recurrence_wgrad_mma"`` for bfloat16 (the
    tensor cores), ``"lstm_recurrence_wgrad"`` for float32 (CUDA cores);
    ValueError for what neither takes (``recurrence_check``)."""
    recurrence_check(H, compute_dtype)
    if compute_dtype == torch.bfloat16:
        return "lstm_recurrence_wgrad_mma"
    return "lstm_recurrence_wgrad"


def recurrence_wgrad_mma_plan(T: int, B: int, D: int, G: int, H: int) -> Tuple[int, int, int]:
    """``(m_tiles, n_tiles, splits)`` of the tensor-core recurrence wgrad:
    64-column tiles of the H h columns (the last one partly zero where
    H % 64 == 32), 128-column tiles of the 4H gates, and the split of each
    group's ``(T - 1) * B / G`` rows that brings the grid to at most
    ``REC_WGRAD_MMA_TARGET_BLOCKS`` blocks (one wave), at least one split
    and no more splits than K-tiles."""
    m_tiles = -(-H // REC_WGRAD_MMA_TILE_M)
    n_tiles = 4 * H // REC_WGRAD_MMA_TILE_N
    rows = max(0, T - 1) * (B // G)
    per_split = m_tiles * n_tiles * D * G
    splits = max(1, min(-(-rows // REC_WGRAD_MMA_TILE_K),
                        REC_WGRAD_MMA_TARGET_BLOCKS // per_split))
    return m_tiles, n_tiles, splits


def recurrence_wgrad_mma_rows(T: int, B: int, G: int, splits: int, split: int, g: int):
    """The rows the tensor-core recurrence wgrad's blocks of ``split`` read
    for weight group ``g``, as ``(s, b, s_prev)``: the dxg row at step s and
    the hs row at ``s_prev = s - 1`` (step 0 has no h_prev and is no row);
    the same integer arithmetic as ``csrc/lstm_recurrence_wgrad_mma.cu``."""
    Bg = B // G
    rows = max(0, T - 1) * Bg
    out = []
    for n in range(rows * split // splits, rows * (split + 1) // splits):
        s = 1 + n // Bg
        out.append((s, g * Bg + n - (s - 1) * Bg, s - 1))
    return out


def _recurrence_wgrad_operands(hs, dxg, G, cd, what):
    """Checked operands of a recurrence wgrad kernel: ``(dev, T, D, B, H)``."""
    dev = hs.device
    if hs.dim() != 4:
        raise ValueError(f"{what} kernel: hs must be (T, D, B, H), got {tuple(hs.shape)}")
    T, D, B, H = hs.shape
    recurrence_check(H, cd)
    _check("hs", hs, (T, D, B, H), torch.float32, dev)
    _check("dxg", dxg, (T, D, B, 4 * H), torch.float32, dev)
    if B % G:
        raise ValueError(f"{what} kernel: batch {B} is not a multiple of {G} weight groups")
    return dev, T, D, B, H


def lstm_recurrence_wgrad(hs: torch.Tensor, dxg: torch.Tensor, G: int,
                          compute_dtype: torch.dtype, kernel: Optional[str] = None) -> torch.Tensor:
    """The recurrence's weight gradient; the contract of
    ``ops/lstm_recurrence.py:recurrence_wgrad``: ``dw (D, G, H, 4H)`` f32
    from ``hs (T, D, B, H)`` and ``dxg (T, D, B, 4H)``, both f32, rounded
    to ``compute_dtype`` as they are read.

    On the card it runs the kernel ``recurrence_wgrad_kernel`` names for the
    width and dtype: the tensor-core one through
    :func:`lstm_recurrence_wgrad_mma` (whose ``.launches`` then counts it),
    or ``csrc/lstm_recurrence_wgrad.cu`` here. ``kernel="lstm_recurrence_wgrad"``
    asks for the latter by name (to time it beside the other)."""
    _no_graph(hs, dxg)
    if not hs.is_cuda:
        return recurrence_wgrad(hs, dxg, G, compute_dtype)
    cd = compute_dtype
    name = "lstm_recurrence_wgrad"
    if kernel not in (None, name, "lstm_recurrence_wgrad_mma"):
        raise ValueError(f"lstm_recurrence_wgrad: no weight-gradient kernel named {kernel!r}")
    dev, T, D, B, H = _recurrence_wgrad_operands(hs, dxg, G, cd, name)
    if (kernel or recurrence_wgrad_kernel(H, cd)) == "lstm_recurrence_wgrad_mma":
        return lstm_recurrence_wgrad_mma(hs, dxg, G, cd)
    tiles_y = (4 * H // WGRAD_TILE) * -(-H // WGRAD_TILE)
    splits = max(1, min(T, math.ceil(WGRAD_TARGET_BLOCKS / (tiles_y * D * G))))
    partial = torch.empty((splits, D, G, H, 4 * H), dtype=torch.float32, device=dev)
    if B * D == 0 or T <= 1:
        partial.zero_()
    else:
        with torch.cuda.device(dev):
            err = _kernels(name).lstm_recurrence_wgrad(
                _DTYPE_CODES[cd], hs.data_ptr(), dxg.data_ptr(), partial.data_ptr(),
                D, T, B, H, G, splits, torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on_error(name, err)
        lstm_recurrence_wgrad.launches += 1
    return partial.sum(dim=0)


lstm_recurrence_wgrad.launches = 0


def lstm_recurrence_wgrad_mma(hs: torch.Tensor, dxg: torch.Tensor, G: int,
                              compute_dtype: torch.dtype) -> torch.Tensor:
    """The recurrence's weight gradient on the tensor cores
    (``csrc/lstm_recurrence_wgrad_mma.cu``: a split-K GEMM that rounds the
    f32 streams to bf16 as it stages them); the contract of
    :func:`lstm_recurrence_wgrad`. Takes compute dtype bfloat16 at every
    width the op takes and raises for the rest. Every block writes its
    partial tile, empty row ranges included; with no row (``T <= 1`` or an
    empty batch) it returns zeros without a launch. Its output carries no
    graph, so under grad mode it refuses an operand that requires grad, on
    the CPU too."""
    _no_graph(hs, dxg)
    if not hs.is_cuda:
        return recurrence_wgrad(hs, dxg, G, compute_dtype)
    cd = compute_dtype
    name = "lstm_recurrence_wgrad_mma"
    dev, T, D, B, H = _recurrence_wgrad_operands(hs, dxg, G, cd, name)
    if recurrence_wgrad_kernel(H, cd) != name:
        raise ValueError(f"{name} kernel takes compute dtype bfloat16, got {cd}")
    if B * D == 0 or T <= 1:
        return torch.zeros((D, G, H, 4 * H), dtype=torch.float32, device=dev)
    _, _, splits = recurrence_wgrad_mma_plan(T, B, D, G, H)
    partial = torch.empty((splits, D, G, H, 4 * H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _kernels(name).lstm_recurrence_wgrad_mma(
            hs.data_ptr(), dxg.data_ptr(), partial.data_ptr(), D, T, B, H, G, splits,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(name, err)
    lstm_recurrence_wgrad_mma.launches += 1
    return partial.sum(dim=0)


lstm_recurrence_wgrad_mma.launches = 0
