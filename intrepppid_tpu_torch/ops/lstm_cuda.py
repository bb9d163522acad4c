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
    every resident shape a layer runs at, ``FWD_MMA_SHAPES``: the products
    on the tensor cores), ``bilstm_layer_fwd_f32`` and
    ``bilstm_layer_fwd_train_f32`` launch ``csrc/bilstm_fwd_f32.cu`` (f32,
    H <= 80: three tf32 passes a product on the tensor cores); the two
    wrappers themselves only dispatch, and raise for a shape neither
    kernel takes (e.g. bf16 at H = 80, E = 72 and f32 at H = 72, shapes no
    layer runs at). Plain twin of both: ``ops/lstm.py:bidir_layer``.
  * ``bilstm_bwd`` is the reverse-time sweep of ``lstm_pallas_packed.py:750
    _bwd_pallas_packed`` and of ``lstm_pallas_layer.py:603 _bwd_pallas``.
    Four kernels do it, picked by shape and dtype (``sweep_kernel``):
    ``bilstm_bwd_mma`` launches ``csrc/bilstm_bwd_mma.cu`` (bf16, H <= 64
    at any E, H % 16 == 8 and E = H = 80: the products on the tensor
    cores), ``bilstm_bwd_f32``
    launches ``csrc/bilstm_bwd_f32.cu`` (f32, H <= 64: three tf32 passes a product on
    the tensor cores), ``bilstm_bwd_f32_onestage`` launches
    ``csrc/bilstm_bwd_f32_onestage.cu`` (the same kernel with one [x ; h]
    stage, f32 at E = H = 80), and ``bilstm_bwd`` itself launches
    ``csrc/bilstm_bwd.cu`` for the rest (CUDA cores: bf16 shapes no layer
    runs at, e.g. H = 80 at E = 40). Plain twin of all four:
    ``ops/lstm.py:bidir_layer_sweep``.

* **wide** -- the rest (the scaled configuration's H = 256, and H = 128):

  * ``bilstm_gates`` is the input projection those TPU kernels form in
    their body (``_xg2``), by one of two kernels (``gates_kernel``):
    ``bilstm_gates_mma`` launches ``csrc/bilstm_gates_mma.cu`` (bf16: a GEMM
    on the tensor cores), ``bilstm_gates_f32`` launches
    ``csrc/bilstm_gates_f32.cu`` (f32: the same GEMM in three tf32 passes).
    Plain twin of both: ``ops/lstm.py:input_gates``.
  * ``bilstm_fwd_wide`` (eval) and ``bilstm_fwd_wide_train`` are the
    recurrence over those gates with ``W_hh`` split over a cluster of 8
    blocks or, at 96, in one block, by one of four kernels
    (``wide_fwd_kernel``), the wrappers themselves only dispatching:
    ``bilstm_fwd_wide_mma`` and
    ``bilstm_fwd_wide_train_mma`` launch ``csrc/bilstm_fwd_wide_mma.cu``
    (bf16, H = 128-288 in steps of 32: the product on the tensor cores; at
    160, 192, 224 and 288 an instance whose cluster splits the unit groups
    unevenly, 2 / 3, 3, 3 / 4 and 4 / 5 a block),
    ``bilstm_fwd_wide_f32`` and ``bilstm_fwd_wide_train_f32`` launch
    ``csrc/bilstm_fwd_wide_f32.cu`` (f32 at those widths: three tf32 passes
    on the lite sweep's f32 fragment copy of ``W_hh^T``),
    ``bilstm_fwd_wide_mma_resident`` and
    ``bilstm_fwd_wide_train_mma_resident`` launch
    ``csrc/bilstm_fwd_wide_mma_resident.cu`` (bf16 at 96: one block a row
    tile, ``W_hh`` as ``mma.sync`` fragments in registers),
    ``bilstm_fwd_wide_f32_resident`` and
    ``bilstm_fwd_wide_train_f32_resident`` launch
    ``csrc/bilstm_fwd_wide_f32_resident.cu`` (f32 at 96: the same in three
    tf32 passes). With ``bilstm_gates``, the counterpart of ``_fwd_pallas``
    at these widths. Plain twin of all four: ``ops/lstm.py:bidir_recurrence``.
  * ``bilstm_bwd_lite`` is the sweep over the gate streams of
    ``lstm_pallas_layer.py:723 _bwd_pallas_lite`` (f32 gate cotangents
    out), by one of four kernels (``lite_kernel``), the wrapper itself only
    dispatching: ``bilstm_bwd_lite_mma`` launches
    ``csrc/bilstm_bwd_lite_mma.cu`` (bf16, H = 128-288 in steps of 32: the
    products on the tensor cores; at 160, 192, 224 and 288 a kernel whose
    cluster splits the unit groups unevenly),
    ``bilstm_bwd_lite_f32`` launches ``csrc/bilstm_bwd_lite_f32.cu`` (f32 at
    those widths and at 160, 192 and 224: three tf32 passes on the f32
    fragment copy of ``W_hh^T`` read from L2, ``recurrence_f32_weights``),
    ``bilstm_bwd_lite_f32_resident`` launches
    ``csrc/bilstm_bwd_lite_f32_resident.cu`` (f32 at 96: three tf32 passes,
    one block a row tile with ``W_hh`` resident in shared memory),
    ``bilstm_bwd_lite_mma_resident`` launches
    ``csrc/bilstm_bwd_lite_mma_resident.cu`` (bf16 at 96: the same schedule
    in one bf16 pass on the tensor cores). Plain twin of all four:
    ``ops/lstm.py:bidir_layer_sweep_lite``.

* both routes: ``bilstm_wgrad``, the weight-gradient products, by one of
  two kernels (``wgrad_kernel``), the wrapper itself only dispatching:
  ``bilstm_wgrad_mma`` launches
  ``csrc/bilstm_wgrad_mma.cu`` (bf16, H % 8 == 0: a split-K GEMM on the
  tensor cores, its last 128-row gate tile masked where H % 32 != 0),
  ``bilstm_wgrad_f32`` launches ``csrc/bilstm_wgrad_f32.cu`` (f32,
  H % 16 == 0: the same GEMM in three tf32 passes, 64-row gate tiles at
  H % 32 == 16). Plain twin of both: ``ops/lstm.py:bidir_layer_wgrad``. On the wide route in
  bf16 past 96 units (``wgrad_split``), ``layer_bwd`` splits the products
  as the JAX lite mode does
  (``lstm_pallas_layer.py:1091-1108``: ``dW_ih`` an XLA GEMM, ``dW_hh`` in
  the Pallas kernel): ``bilstm_wgrad_split`` takes ``dW_ih`` from
  ``bilstm_wgrad_ih`` (cuBLAS bf16 products with f32 output, one per
  direction and input part) and ``dW_hh`` from ``bilstm_wgrad_mma`` with
  no input part.

Beside the layer kernels, the time-major recurrence op
(``ops/lstm_recurrence.py``, the counterpart of
``intrepppid_tpu/ops/lstm_pallas.py``; a width they do not take runs at
``recurrence_width``, padded, up to ``REC_MAX_H`` on the card) has kernels
of its own, all on the tensor cores (the CUDA-core wgrad by name only):

* ``lstm_recurrence_fwd`` is the forward of ``lstm_pallas.py:145
  _fwd_pallas``, by one of six tensor-core kernels (``recurrence_fwd_kernel``):
  ``lstm_recurrence_fwd_mma`` launches ``csrc/lstm_recurrence_fwd_mma.cu``
  (bf16 at H = 32 and 64: one block per 8-row tile),
  ``lstm_recurrence_fwd_f32`` launches ``csrc/lstm_recurrence_fwd_f32.cu``
  (f32 there: the same schedule in three tf32 passes, ``w`` resident
  pre-split), ``lstm_recurrence_fwd_mid_mma`` launches
  ``csrc/lstm_recurrence_fwd_mid_mma.cu`` (bf16 at 96-288: clusters of 4 or
  8 blocks, each holding its share of the bf16 weight fragments,
  ``recurrence_mma_weights``, in shared memory),
  ``lstm_recurrence_fwd_mid_f32`` launches
  ``csrc/lstm_recurrence_fwd_mid_f32.cu`` (f32 there: the same schedule in
  three tf32 passes on the f32 fragment copy, ``recurrence_f32_weights``),
  ``lstm_recurrence_fwd_wide_mma`` launches
  ``csrc/lstm_recurrence_fwd_wide_mma.cu`` (bf16 past 288: 8-block
  clusters, the product on ``mma.sync`` from bf16 weight fragments read
  from L2, ``recurrence_mma_weights``), ``lstm_recurrence_fwd_wide_f32``
  launches ``csrc/lstm_recurrence_fwd_wide_f32.cu`` (f32 past 288: the same
  design in three tf32 passes on the sweep's f32 fragment copy). Plain
  twin of all six: ``recurrence_fwd``.
* ``lstm_recurrence_bwd`` is the reverse-time sweep of ``lstm_pallas.py:274
  _bwd_pallas`` (``dxg``), by one of six tensor-core kernels
  (``recurrence_sweep_kernel``): ``lstm_recurrence_bwd_mma`` launches
  ``csrc/lstm_recurrence_bwd_mma.cu`` (bf16, H = 32 or 64: one block per
  row tile, tensor cores), ``lstm_recurrence_bwd_f32`` launches
  ``csrc/lstm_recurrence_bwd_f32.cu`` (f32, H = 32 or 64: the same design
  in three tf32 passes), ``lstm_recurrence_bwd_wide_mma`` launches
  ``csrc/lstm_recurrence_bwd_wide_mma.cu`` (bf16 past 288: the forward's
  clusters and weight fragments, both products on ``mma.sync``),
  ``lstm_recurrence_bwd_wide_f32`` launches
  ``csrc/lstm_recurrence_bwd_wide_f32.cu`` (f32 past 288: the same design
  in three tf32 passes on an f32 copy of the weight fragments,
  ``recurrence_f32_weights``), ``lstm_recurrence_bwd_mid_f32`` launches
  ``csrc/lstm_recurrence_bwd_mid_f32.cu`` (f32 at 96-288: three tf32 passes,
  clusters of 4 or 8 blocks holding their share of the f32 fragments),
  ``lstm_recurrence_bwd_mid_mma`` launches
  ``csrc/lstm_recurrence_bwd_mid_mma.cu`` (bf16 at 96-288: the same design
  in one bf16 pass on the forward's bf16 fragments). Plain twin of all
  six: ``recurrence_sweep``.
* ``lstm_recurrence_wgrad`` is that kernel's ``dW`` sums, by one of two
  kernels (``recurrence_wgrad_kernel``): ``lstm_recurrence_wgrad_mma``
  launches ``csrc/lstm_recurrence_wgrad_mma.cu`` (bf16: a split-K GEMM on
  the tensor cores), ``lstm_recurrence_wgrad_f32`` launches
  ``csrc/lstm_recurrence_wgrad_f32.cu`` (f32: the same GEMM in three tf32
  passes); ``lstm_recurrence_wgrad`` itself launches
  ``csrc/lstm_recurrence_wgrad.cu`` (CUDA cores) by name only. Plain twin
  of all three: ``recurrence_wgrad``.

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
hands to ``bilstm_bwd_mma`` or ``bilstm_bwd_f32`` counts there, and so does
``lstm_recurrence_wgrad``; ``bilstm_layer_fwd``, ``bilstm_layer_fwd_train``,
``bilstm_wgrad``, ``bilstm_gates``, ``bilstm_bwd_lite``,
``lstm_recurrence_fwd`` and ``lstm_recurrence_bwd`` only dispatch, and the
kernel's own wrapper counts (all but ``bilstm_gates`` and
``bilstm_bwd_lite`` keep a count that stays 0: their kernels are gone);
``bilstm_wgrad_ih`` counts
its calls, each a layer's ``dW_ih`` products.
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
# when it loads: bilstm_bwd.cu (kRows, kMaxChunks, kMaxThreads, kMaxRX, kPad),
# bilstm_common.cuh (kWideCluster, kRecMaxH),
# lstm_recurrence_bwd.cu (kPad), lstm_recurrence_wgrad.cu (kTile),
# lstm_recurrence_wgrad_mma.cu (kTileM, kTileN, kTileK, kSmem),
# lstm_recurrence_wgrad_f32.cu (kTileM, kTileK, each tile's blocks an SM and
# shared memory),
# bilstm_mma.cuh (kMmaTile), bilstm_bwd_mma.cu (kStages, kMaxChunks,
# kMaxThreads, kMaxH = BWD_MMA_MAX_H, kPad), bilstm_bwd_f32.cu and
# bilstm_bwd_f32_onestage.cu (kMmaTile, kMaxChunks, kMaxThreads, kMaxH,
# kStrideAlign, kStridePad),
# lstm_recurrence_bwd_mma.cu (kStages, kMaxChunks,
# kMaxH, kWPad, kFPad), lstm_recurrence_fwd_mma.cu (kMmaTile, kStages, kMaxH,
# kWPad, kFPad), bilstm_fwd_mma.cu (kStages, kMaxChunks, kMaxThreads,
# kPad, kTailPad), bilstm_wgrad_mma.cu (kTileM, kTileN, kTileK, kStages),
# bilstm_bwd_lite_mma_resident.cu (kMmaTile, kMaxH, kMaxThreads, kPad, kStages),
# bilstm_fwd_f32.cu (kMmaTile, kMaxChunks, kMaxThreads, kMaxH, kStrideAlign,
# kStridePad), bilstm_bwd_lite_f32_resident.cu (kMmaTile, kMaxH, kMaxThreads,
# kStrideAlign, kStridePad), lstm_recurrence_bwd_f32.cu (kMmaTile, kStages, kMaxChunks,
# kMaxH, kWPad, kFPad), bilstm_gates_mma.cu (kBM, kBN, kBK, kStages, kSmem),
# bilstm_bwd_lite_mma.cu (kWideCluster, kThreads, kPad, kXgPad),
# bilstm_fwd_wide_mma.cu (kWideCluster, kThreads, kPad, the uneven instance's
# row tiles and widths), bilstm_wgrad_f32.cu (the 128 x 128 tile, kTileK, its
# stages and shared memory; the narrow tile's rows, widest columns, blocks an
# SM and shared memory), lstm_recurrence_{fwd,bwd}_wide_mma.cu
# and lstm_recurrence_{fwd,bwd}_wide_f32.cu (kWideCluster, kThreads, their padding,
# kMinH, kRecMaxH, the row tiles of each instance), bilstm_bwd_lite_f32.cu
# (kWideCluster, kThreads, kFPad, its row tiles and widths), bilstm_gates_f32.cu
# (kBM, kBN, kBK, kStages, kSmem), bilstm_fwd_wide_f32.cu (kWideCluster,
# kThreads, kFPad, its widths and its row tiles), bilstm_fwd_wide_mma_resident.cu
# (kMmaTile, kMaxH, kMaxThreads, kWPad, kFPad, kStages),
# bilstm_fwd_wide_f32_resident.cu (kMmaTile, kMaxH, kMaxThreads, kHPad, kFPad,
# kStages), lstm_recurrence_bwd_mid_f32.cu (kThreads, kFPad, its widths, row
# tiles and instances), lstm_recurrence_{bwd,fwd}_mid_mma.cu (kThreads, kPad,
# their widths, row tiles and instances; the forward's kXPad, kStages,
# kStagesAt8, kMaskBytes)
MAX_THREADS = 256
BWD_ROWS_PER_THREAD, BWD_MAX_CHUNKS, BWD_MAX_DX_ROWS, BWD_PAD = 2, 4, 8, 4
WGRAD_TILE = 64
# the wide kernels' clusters; the widest H a layer route takes (past it the
# recurrence op's tensor-core kernels for widths past 288); the recurrence
# op's widest H on the card; the wide route's input parts are multiples of
# WIDE_PART_STEP wide
WIDE_CLUSTER, WIDE_MAX_THREADS, REC_MAX_H = 8, 288, 1024
WIDE_PART_STEP = 16
# the tensor-core sweeps: rows per block (the n of mma m16n8k16), cp.async
# stages, 16-byte chunks a thread copies per step, widest H, row padding
MMA_TILE, MMA_STAGES, MMA_MAX_H, MMA_PAD = 8, 3, 64, 8
BWD_MMA_MAX_CHUNKS, BWD_MMA_MAX_THREADS = 3, 384
# the bf16 tensor-core sweep's widest H (csrc/bilstm_bwd_mma.cu kMaxH): past
# MMA_MAX_H it takes E = H = 80 only, its <80, 80> instance (the shape
# bilstm_bwd.cu took there: no layer changes its route or padded shape)
BWD_MMA_MAX_H = 80
# the widths at H % 16 == 8 the bf16 tensor-core sweep takes, at the shapes
# bilstm_bwd.cu takes there (so again no layer changes its route or padded
# shape): its gate product runs E + H to the next multiple of 32 over zero
# columns of the resident weights and of the [x ; h] tile
BWD_MMA_ODD_WIDTHS = (8, 24, 40, 56, 72)
# the widths at H % 16 == 0 the bf16 tensor-core sweep takes whatever
# (E + H) % 32 (the same zero columns): the stacked layer of the bf16 model
# at embedding 16 (E = 32, K = 48) and layer 0 of 1-16 units at E = 8 left
# bilstm_bwd.cu for it; E = H = 80 keeps (E + H) % 32 == 0
BWD_MMA_ANY_K_WIDTHS = (16, 32, 48, 64)
REC_MMA_MAX_CHUNKS, REC_MMA_F32_PAD = 4, 4
# the op's bf16 tensor-core forward at REC_MMA_WIDTHS
# (lstm_recurrence_fwd_mma.cu): its cp.async stages of the xg and mask tiles
REC_FWD_MMA_STAGES = 5
# the f32 tensor-core sweep: [x ; h] chunks a thread copies per step, and
# its weight / tile row stride K rounded up to 32 floats plus 8
BWD_F32_MAX_CHUNKS, BWD_F32_STRIDE_ALIGN, BWD_F32_STRIDE_PAD = 2, 32, 8
# the one-stage f32 tensor-core sweep (past bilstm_bwd_f32.cu's shared
# memory): threads a block and its widest H (its chunks and strides are the
# f32 sweep's)
BWD_F32_ONESTAGE_MAX_THREADS, BWD_F32_ONESTAGE_MAX_H = 320, 80
# the tensor-core forward: its (H, E) instances (the model's layers at the
# resident widths, E = H and E = 2H; at H = 48 no sweep takes E = 96; past
# MMA_MAX_H layer 0 of the two-layer models at embedding 72 and 80, E = H;
# the shapes at H % 16 == 8 and H = 48 at E = 80 / 112 that the layers of
# 1-56 units run at, whose K = E + H % 16 == 8 ends in a k8 step; all of
# them shapes the deleted bilstm_fwd.cu took), x chunks a thread copies per
# step, its widest block (the <80, 80> instance: one warp per 8 units), and
# the padding of its [x ; h] rows where K % 16 == 8 (MMA_PAD where K % 16
# == 0: either keeps the row stride an odd number of 16 bytes)
FWD_MMA_SHAPES = ((16, 16), (16, 32), (32, 32), (32, 64), (48, 48), (64, 64), (64, 128),
                  (72, 72), (80, 80), (8, 8), (8, 16), (16, 8), (24, 24), (24, 48), (40, 40),
                  (40, 80), (48, 80), (48, 112), (56, 56), (56, 112))
FWD_MMA_MAX_CHUNKS, FWD_MMA_MAX_THREADS = 2, 320
FWD_MMA_TAIL_PAD = 16
# the f32 tensor-core forward: x chunks a thread copies per step (its row
# stride is the f32 sweep's), the row tiles it takes (one or two n8 tiles),
# its widest H and its threads there (the instances at H = 80 take 320, in
# 8-row tiles, the ones up to 64 at most MAX_THREADS)
FWD_F32_MAX_CHUNKS, FWD_F32_ROWS = 2, (8, 16)
FWD_F32_MAX_H, FWD_F32_MAX_THREADS = 80, 320
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
# the recurrence op's f32 tensor-core wgrad (three tf32 passes): block tile
# rows (h columns), rows per K-tile, the block tiles' gate columns it is
# built for with the blocks an SM each holds (64 x 128: one, its warps
# carry 128 accumulators; 64 x 64: two), cp.async stages at most, and the
# tile the dispatch takes at every width (64 x 64: at the train shape, one
# layer of 400 rows in 5 groups, T = 1500, it took 0.87 / 3.34 / 18.65 ms
# at H = 64 / 128 / 288 against 0.99 / 3.85 / 21.69 for 64 x 128, each in
# turns with lstm_recurrence_wgrad.cu on an H100, PERF.md)
REC_WGRAD_F32_TILE_M, REC_WGRAD_F32_TILE_K = 64, 32
REC_WGRAD_F32_BLOCKS = {128: 1, 64: 2}
REC_WGRAD_F32_STAGES = 4
REC_WGRAD_F32_TILE_N = 64
# the tensor-core input gates: block tile (rows x gate columns), input
# columns a stage, cp.async stages, and its dynamic shared memory
GATES_MMA_TILE_M, GATES_MMA_TILE_N, GATES_MMA_TILE_K, GATES_MMA_STAGES = 128, 128, 32, 4
GATES_MMA_SMEM = GATES_MMA_STAGES * (GATES_MMA_TILE_M + GATES_MMA_TILE_N) * (
    GATES_MMA_TILE_K + MMA_PAD) * 2
# the tensor-core lite sweep: the widths and row tiles it is instantiated
# for (a row tile is a multiple of the n8 tile; at 160, 192, 224 and 288,
# whose unit groups or dh tiles split unevenly, its second kernel, 16 and
# 32), threads a block, and the padding of its f32 xg rows (its bf16 rows
# take MMA_PAD)
LITE_MMA_WIDTHS, LITE_MMA_ROWS = (128, 160, 192, 224, 256, 288), (16, 32, 40, 80)
LITE_MMA_UNEVEN_ROWS = (16, 32)
LITE_MMA_THREADS, LITE_MMA_XG_PAD = 256, 4
# the tensor-core wide forward: the widths and row tiles it is instantiated
# for (at 160, 192, 224 and 288, H % 128 != 0, whose unit groups do not
# split evenly over the cluster's blocks and their 8 warps, a second kernel
# with tiles of at most 4 (group, n8 tile) items a warp), and threads a block
FWD_WIDE_MMA_WIDTHS, FWD_WIDE_MMA_ROWS = (128, 160, 192, 224, 256, 288), (16, 32, 40, 64, 80)
FWD_WIDE_MMA_UNEVEN_ROWS = (16, 32, 40)
FWD_WIDE_MMA_THREADS = 256
# the f32 tensor-core wgrad (three tf32 passes): the tiles of the bf16 one,
# cp.async stages, and its dynamic shared memory (f32 rows of 128 + 8)
WGRAD_F32_STAGES = 4
# the recurrence op's bf16 tensor-core kernels past WIDE_MAX_THREADS
# (lstm_recurrence_{fwd,bwd}_wide_mma.cu): threads a block, the first width
# they take, and the row tiles each is instantiated for, by the unit groups
# of 8 a warp owns (one up to H = 512, two past it)
REC_WIDE_MMA_THREADS, REC_WIDE_MMA_MIN_H = 256, 320
REC_WIDE_MMA_ROWS = {"fwd": {1: (16, 32, 48, 80), 2: (16, 32)},
                     "bwd": {1: (16, 32), 2: (16,)}}
# the op's f32 tensor-core sweep past WIDE_MAX_THREADS
# (lstm_recurrence_bwd_wide_f32.cu): its row tiles by unit groups a warp,
# and the f32 padding of its h and dgates tile rows
REC_WIDE_F32_ROWS, REC_WIDE_F32_PAD = {1: (16, 32), 2: (16,)}, 16
# the op's f32 tensor-core forward past WIDE_MAX_THREADS
# (lstm_recurrence_fwd_wide_f32.cu): its row tiles by unit groups a warp
# (its padding is the sweep's; no 16-row tile up to 512, whose two blocks
# an SM lost to one 32-row block)
REC_WIDE_F32_FWD_ROWS = {1: (32, 48), 2: (16,)}
# the f32 tensor-core lite sweep (bilstm_bwd_lite_f32.cu, three tf32 passes
# on the sweep's f32 fragment copy): the widths and row tiles it is
# instantiated for (its threads are the bf16 one's, its padding the op
# sweep's; its clusters split the unit groups 2 / 3 a block at 160, 3 at 192,
# 3 / 4 at 224)
LITE_F32_WIDTHS, LITE_F32_ROWS = (128, 160, 192, 224, 256, 288), (16, 32)
# the f32 tensor-core lite sweep with W_hh resident in one block
# (bilstm_bwd_lite_f32_resident.cu, three tf32 passes, 8-row tiles, one warp
# per 8 units): the width it is built for (the f32 weights of 96 units fit a
# block; 112 do not)
LITE_F32_RESIDENT_WIDTHS = (96,)
# the bf16 tensor-core lite sweep with W_hh resident in one block
# (bilstm_bwd_lite_mma_resident.cu, 8-row tiles, one warp per 8 units): the
# width it is built for (the stacked layer of the bf16 models at embedding
# 72 and 80, run at 96)
LITE_MMA_RESIDENT_WIDTHS = (96,)
# the bf16 tensor-core wide forward with W_hh in one block
# (bilstm_fwd_wide_mma_resident.cu, 8-row tiles, one warp per 8 units, the
# weights as mma fragments in registers): the width it is built for (the
# stacked layer of the bf16 models at embedding 72 and 80, run at 96) and
# the stages of its cp.async ring of xg tiles
FWD_WIDE_MMA_RESIDENT_WIDTHS, FWD_WIDE_MMA_RESIDENT_STAGES = (96,), 5
# the f32 tensor-core wide forward with W_hh in one block
# (bilstm_fwd_wide_f32_resident.cu, three tf32 passes, 8-row tiles, one warp
# per 8 units, the weights as f32 mma fragments in registers): the width it
# is built for (the stacked layer of the f32 model at embedding 80, run at
# 96), the padding of its f32 h tile rows (16 mod 32 floats) and the stages
# of its cp.async ring of xg tiles
FWD_WIDE_F32_RESIDENT_WIDTHS, FWD_WIDE_F32_RESIDENT_H_PAD = (96,), 16
FWD_WIDE_F32_RESIDENT_STAGES = 5
# the op's f32 tensor-core sweep at 96-288 (lstm_recurrence_bwd_mid_f32.cu,
# three tf32 passes on the f32 fragment copy of w): its widths and row
# tiles; the widths each (blocks a cluster, fragments resident in shared
# memory) is instantiated for (8-block clusters read from L2 at every width,
# and resident up to 256; 4-block clusters resident where a block's share
# of the fragments and its tiles fit, 96-192); the plan's cluster size by
# width (8 where not named: the faster in turns, PERF.md) and the widths it
# reads from L2 (288, where no share fits)
REC_MID_F32_WIDTHS, REC_MID_F32_ROWS = (96, 128, 160, 192, 224, 256, 288), (16, 32)
REC_MID_F32_INSTANCES = {(8, True): (96, 128, 160, 192, 224, 256),
                         (8, False): (96, 128, 160, 192, 224, 256, 288),
                         (4, True): (96, 128, 160, 192)}
REC_MID_F32_CLUSTER = {96: 4, 128: 4, 160: 4, 192: 4}
REC_MID_F32_FROM_L2 = (288,)
# the op's f32 tensor-core forward at H = 32 / 64 (lstm_recurrence_fwd_f32.cu,
# three tf32 passes, one block an 8-row tile, w resident pre-split): the
# stages of its cp.async ring of xg and mask tiles
REC_FWD_F32_STAGES = 5
# the op's f32 tensor-core forward at 96-288 (lstm_recurrence_fwd_mid_f32.cu,
# three tf32 passes on the sweep's f32 fragment copy): its row tiles; the
# widths each (blocks a cluster, fragments resident) is instantiated for
# (the sweep's: 8-block clusters resident to 256 and from L2 at every width,
# 4-block ones resident at 96-192); the plan's cluster size by width (8
# where not named) and the widths it reads from L2 (288, where the share and
# the f32 h tiles leave no room for a ring stage; 224 and 256, where the
# share leaves room for 16-row tiles only, four waves of 15 8-block clusters
# at the train shape against two of 32-row L2-fed ones: 30.25 / 31.79 ms
# against 24.02 / 26.14 in turns on an H100, PERF.md); the most and fewest stages of
# its cp.async ring (each instance takes the most that fit at its widest
# width, ``recurrence_mid_f32_fwd_stages``); the padding of its xg ring rows
# and staged h rows (f32), and a stage's mask bytes
REC_FWD_MID_F32_ROWS = (16, 32)
REC_FWD_MID_F32_INSTANCES = {(8, True): (96, 128, 160, 192, 224, 256),
                             (8, False): (96, 128, 160, 192, 224, 256, 288),
                             (4, True): (96, 128, 160, 192)}
REC_FWD_MID_F32_CLUSTER = {96: 4, 128: 4, 160: 4, 192: 4}
REC_FWD_MID_F32_FROM_L2 = (224, 256, 288)
REC_FWD_MID_F32_STAGES = (5, 3)
REC_FWD_MID_F32_X_PAD, REC_FWD_MID_F32_S_PAD, REC_FWD_MID_F32_MASK_BYTES = 4, 4, 48
# the op's bf16 tensor-core sweep and forward at 96-288
# (lstm_recurrence_{bwd,fwd}_mid_mma.cu, one bf16 pass on the fragment copy
# of w, recurrence_mma_weights, each block's share resident in shared
# memory): their widths and row tiles; the widths each cluster size is
# instantiated for (8 blocks at every width, 4 where a block's unit groups
# do not outnumber its 8 warps, 96-256); the plan's cluster size by kind
# and width (8 where not named: the faster in turns on an H100, PERF.md;
# at 256 the sweep's 8-block clusters in 32-row tiles beat the 4-block ones
# in 16-row tiles); the forward's cp.async stages (fewer where
# a block owns 8 groups, H = 256 in 4-block clusters), the padding of its
# f32 xg ring rows and a stage's mask bytes
REC_MID_MMA_WIDTHS, REC_MID_MMA_ROWS = (96, 128, 160, 192, 224, 256, 288), (16, 32)
REC_MID_MMA_INSTANCES = {8: (96, 128, 160, 192, 224, 256, 288), 4: (96, 128, 160, 192, 224, 256)}
REC_MID_MMA_CLUSTER = {"bwd": {96: 4, 128: 4, 160: 4, 192: 4, 224: 4},
                       "fwd": {96: 4, 128: 4, 160: 4, 192: 4, 224: 4, 256: 4}}
REC_FWD_MID_MMA_STAGES, REC_FWD_MID_MMA_X_PAD, REC_FWD_MID_MMA_MASK_BYTES = (5, 4), 4, 48
# the f32 tensor-core input gates (three tf32 passes): the bf16 one's
# block tile, input columns a stage (64 bytes of a row), cp.async stages,
# and its dynamic shared memory (f32 rows padded by 4)
GATES_F32_TILE_K, GATES_F32_STAGES = 16, 4
GATES_F32_SMEM = GATES_F32_STAGES * (GATES_MMA_TILE_M + GATES_MMA_TILE_N) * (
    GATES_F32_TILE_K + 4) * 4
# the f32 tensor-core wide forward (three tf32 passes on the lite sweep's f32
# fragment copy, read from L2): its widths and its row tiles where every
# unit group of a block gets two warps or more (at most 4 groups a block:
# H = 128-256)
FWD_WIDE_F32_WIDTHS = (128, 160, 192, 224, 256, 288)
FWD_WIDE_F32_ROWS = (16, 32)
# its row tiles at 288 (4 or 5 unit groups a block): a 32-row tile gives
# the 5-group blocks' lone warps 4 items, and its one wave took 1.23 x two
# waves of 16-row tiles (PERF.md)
FWD_WIDE_F32_ROWS_288 = (16,)
# waves of blocks the f32 wgrad's split may reach (``wgrad_f32_plan``)
WGRAD_F32_MAX_WAVES = 8
WGRAD_F32_SMEM = 2 * WGRAD_F32_STAGES * WGRAD_MMA_TILE_K * (WGRAD_MMA_TILE_M + 8) * 4
# the f32 wgrad's tile at H % 32 == 16 (``wgrad_f32_tile``): 64 gate rows,
# which divide 4H, by the whole E + H row rounded up to 32 columns, up to
# 160; two blocks an SM (``wgrad_f32_stages``: the stages, at most
# WGRAD_F32_STAGES, that let two share an SM's shared memory)
WGRAD_F32_NARROW_M, WGRAD_F32_NARROW_MAX_N, WGRAD_F32_NARROW_BLOCKS = 64, 160, 2
# the widths the f32 wgrad takes are multiples of this: 4H is then a
# multiple of the 64-row tile, and every f32 layer's padded width is one
WGRAD_F32_H_STEP = 16
# the tiles the kernel is built for: those two, and 128 x 160 (the last gate
# tile masked at 4H = 320), timed against them at E = H = 80 (PERF.md)
WGRAD_F32_TILES = ((128, 128), (128, 160)) + tuple(
    (WGRAD_F32_NARROW_M, n) for n in range(32, WGRAD_F32_NARROW_MAX_N + 1, 32))
# an SM's shared memory, and what the card keeps of it for each block (bytes)
SM_SMEM, BLOCK_SMEM_RESERVE = 233472, 1024
# the bf16 wide route splits a layer's weight gradients as the JAX lite
# mode does (``bilstm_wgrad_split``: dW_ih on cuBLAS, dW_hh on
# bilstm_wgrad_mma) only past this width: at 96 the split took 1.31 ms
# against 0.98 for the whole kernel in turns on an H100, and won at 160 and
# 288 (PERF.md)
WGRAD_SPLIT_PAST_H = 96
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
    "bilstm_bwd": ("bilstm_bwd", [_I, _P, _P, _I, _I] + [_P] * 12 + [_I] + [_P] * 8
                   + [_I] * 6 + [_P]),
    "bilstm_bwd_mma": ("bilstm_bwd_mma", [_P, _P, _I, _I] + [_P] * 12 + [_I] + [_P] * 8
                       + [_I] * 8 + [_P]),
    "bilstm_bwd_f32": ("bilstm_bwd_f32", [_P, _P, _I, _I] + [_P] * 12 + [_I] + [_P] * 8
                       + [_I] * 7 + [_P]),
    "bilstm_bwd_f32_onestage": ("bilstm_bwd_f32_onestage", [_P, _P, _I, _I] + [_P] * 12 + [_I]
                                + [_P] * 8 + [_I] * 7 + [_P]),
    "bilstm_fwd_mma": ("bilstm_fwd_mma", [_P, _P, _I, _I] + [_P] * 10 + [_I] * 6 + [_P]),
    "bilstm_wgrad_mma": ("bilstm_wgrad_mma", [_P] * 3 + [_I, _I] + [_P] * 3 + [_I] * 5 + [_P]),
    "bilstm_gates_mma": ("bilstm_gates_mma", [_P, _P, _I, _I] + [_P] * 3 + [_I] * 3 + [_P]),
    "bilstm_bwd_lite_mma": ("bilstm_bwd_lite_mma", [_I] + [_P] * 11 + [_I] + [_P] * 3
                            + [_I] * 6 + [_P, _P]),
    "lstm_recurrence_bwd_mma": ("lstm_recurrence_bwd_mma", [_P] * 9 + [_I] * 7 + [_P]),
    "lstm_recurrence_fwd_mma": ("lstm_recurrence_fwd_mma", [_P] * 7 + [_I] * 6 + [_P]),
    "lstm_recurrence_wgrad": ("lstm_recurrence_wgrad", [_I] + [_P] * 3 + [_I] * 6 + [_P]),
    "lstm_recurrence_wgrad_mma": ("lstm_recurrence_wgrad_mma", [_P] * 3 + [_I] * 6 + [_P]),
    "lstm_recurrence_wgrad_f32": ("lstm_recurrence_wgrad_f32", [_P] * 3 + [_I] * 7 + [_P]),
    "bilstm_fwd_f32": ("bilstm_fwd_f32", [_P, _P, _I, _I] + [_P] * 10 + [_I] * 8 + [_P]),
    "lstm_recurrence_bwd_f32": ("lstm_recurrence_bwd_f32", [_P] * 9 + [_I] * 7 + [_P]),
    "bilstm_fwd_wide_mma": ("bilstm_fwd_wide_mma", [_I] + [_P] * 9 + [_I] * 6 + [_P, _P]),
    "bilstm_wgrad_f32": ("bilstm_wgrad_f32", [_P] * 3 + [_I, _I] + [_P] * 3 + [_I] * 7 + [_P]),
    "lstm_recurrence_fwd_wide_mma": ("lstm_recurrence_fwd_wide_mma",
                                     [_I] + [_P] * 7 + [_I] * 7 + [_P, _P]),
    "lstm_recurrence_bwd_wide_mma": ("lstm_recurrence_bwd_wide_mma",
                                     [_I] + [_P] * 9 + [_I] * 7 + [_P, _P]),
    "lstm_recurrence_bwd_wide_f32": ("lstm_recurrence_bwd_wide_f32",
                                     [_I] + [_P] * 9 + [_I] * 7 + [_P, _P]),
    "lstm_recurrence_fwd_wide_f32": ("lstm_recurrence_fwd_wide_f32",
                                     [_I] + [_P] * 7 + [_I] * 7 + [_P, _P]),
    "bilstm_bwd_lite_f32": ("bilstm_bwd_lite_f32", [_I] + [_P] * 11 + [_I] + [_P] * 3
                            + [_I] * 6 + [_P, _P]),
    "bilstm_gates_f32": ("bilstm_gates_f32", [_P, _P, _I, _I] + [_P] * 3 + [_I] * 3 + [_P]),
    "bilstm_fwd_wide_f32": ("bilstm_fwd_wide_f32", [_I] + [_P] * 9 + [_I] * 6 + [_P, _P]),
    "bilstm_bwd_lite_f32_resident": ("bilstm_bwd_lite_f32_resident",
                                     [_P] * 11 + [_I] + [_P] * 3 + [_I] * 7 + [_P]),
    "bilstm_bwd_lite_mma_resident": ("bilstm_bwd_lite_mma_resident",
                                     [_P] * 11 + [_I] + [_P] * 3 + [_I] * 7 + [_P]),
    "bilstm_fwd_wide_mma_resident": ("bilstm_fwd_wide_mma_resident",
                                     [_P] * 9 + [_I] * 7 + [_P]),
    "bilstm_fwd_wide_f32_resident": ("bilstm_fwd_wide_f32_resident",
                                     [_P] * 9 + [_I] * 7 + [_P]),
    "lstm_recurrence_bwd_mid_f32": ("lstm_recurrence_bwd_mid_f32",
                                    [_I] * 3 + [_P] * 9 + [_I] * 7 + [_P, _P]),
    "lstm_recurrence_bwd_mid_mma": ("lstm_recurrence_bwd_mid_mma",
                                    [_I] * 2 + [_P] * 9 + [_I] * 7 + [_P, _P]),
    "lstm_recurrence_fwd_mid_mma": ("lstm_recurrence_fwd_mid_mma",
                                    [_I] * 2 + [_P] * 7 + [_I] * 7 + [_P, _P]),
    "lstm_recurrence_fwd_f32": ("lstm_recurrence_fwd_f32", [_P] * 7 + [_I] * 7 + [_P]),
    "lstm_recurrence_fwd_mid_f32": ("lstm_recurrence_fwd_mid_f32",
                                    [_I] * 3 + [_P] * 7 + [_I] * 7 + [_P, _P]),
}
_CONSTANTS = {
    "bilstm_bwd": (("bilstm_bwd_rows_per_thread", "bilstm_bwd_max_chunks",
                    "bilstm_bwd_max_threads", "bilstm_bwd_max_dx_rows", "bilstm_bwd_pad"),
                   (BWD_ROWS_PER_THREAD, BWD_MAX_CHUNKS, MAX_THREADS, BWD_MAX_DX_ROWS, BWD_PAD)),
    "bilstm_bwd_mma": (("bilstm_bwd_mma_tile", "bilstm_bwd_mma_stages",
                        "bilstm_bwd_mma_max_chunks", "bilstm_bwd_mma_max_threads",
                        "bilstm_bwd_mma_max_h", "bilstm_bwd_mma_pad"),
                       (MMA_TILE, MMA_STAGES, BWD_MMA_MAX_CHUNKS, BWD_MMA_MAX_THREADS,
                        BWD_MMA_MAX_H, MMA_PAD)),
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
    "bilstm_fwd_mma": (("bilstm_fwd_mma_tile", "bilstm_fwd_mma_stages",
                        "bilstm_fwd_mma_max_chunks", "bilstm_fwd_mma_max_threads",
                        "bilstm_fwd_mma_pad", "bilstm_fwd_mma_tail_pad"),
                       (MMA_TILE, MMA_STAGES, FWD_MMA_MAX_CHUNKS, FWD_MMA_MAX_THREADS,
                        MMA_PAD, FWD_MMA_TAIL_PAD)),
    "bilstm_wgrad_mma": (("bilstm_wgrad_mma_tile_m", "bilstm_wgrad_mma_tile_n",
                          "bilstm_wgrad_mma_tile_k", "bilstm_wgrad_mma_stages",
                          "bilstm_wgrad_mma_smem"),
                         (WGRAD_MMA_TILE_M, WGRAD_MMA_TILE_N, WGRAD_MMA_TILE_K,
                          WGRAD_MMA_STAGES, WGRAD_MMA_SMEM)),
    "bilstm_gates_mma": (("bilstm_gates_mma_tile_m", "bilstm_gates_mma_tile_n",
                          "bilstm_gates_mma_tile_k", "bilstm_gates_mma_stages",
                          "bilstm_gates_mma_smem"),
                         (GATES_MMA_TILE_M, GATES_MMA_TILE_N, GATES_MMA_TILE_K,
                          GATES_MMA_STAGES, GATES_MMA_SMEM)),
    "bilstm_bwd_lite_mma": (("bilstm_bwd_lite_mma_cluster", "bilstm_bwd_lite_mma_threads",
                             "bilstm_bwd_lite_mma_pad", "bilstm_bwd_lite_mma_xg_pad"),
                            (WIDE_CLUSTER, LITE_MMA_THREADS, MMA_PAD, LITE_MMA_XG_PAD)),
    "lstm_recurrence_bwd_mma": (("lstm_recurrence_bwd_mma_tile",
                                 "lstm_recurrence_bwd_mma_stages",
                                 "lstm_recurrence_bwd_mma_max_chunks",
                                 "lstm_recurrence_bwd_mma_max_h",
                                 "lstm_recurrence_bwd_mma_w_pad",
                                 "lstm_recurrence_bwd_mma_f_pad"),
                                (MMA_TILE, MMA_STAGES, REC_MMA_MAX_CHUNKS, MMA_MAX_H, MMA_PAD,
                                 REC_MMA_F32_PAD)),
    "lstm_recurrence_fwd_mma": (tuple(f"lstm_recurrence_fwd_mma_{c}" for c in (
        "tile", "stages", "max_h", "w_pad", "f_pad")),
        (MMA_TILE, REC_FWD_MMA_STAGES, MMA_MAX_H, MMA_PAD, REC_MMA_F32_PAD)),
    "lstm_recurrence_wgrad": (("lstm_recurrence_wgrad_tile",), (WGRAD_TILE,)),
    "lstm_recurrence_wgrad_mma": (("lstm_recurrence_wgrad_mma_tile_m",
                                   "lstm_recurrence_wgrad_mma_tile_n",
                                   "lstm_recurrence_wgrad_mma_tile_k",
                                   "lstm_recurrence_wgrad_mma_smem"),
                                  (REC_WGRAD_MMA_TILE_M, REC_WGRAD_MMA_TILE_N,
                                   REC_WGRAD_MMA_TILE_K, REC_WGRAD_MMA_SMEM)),
    "lstm_recurrence_wgrad_f32": (tuple(f"lstm_recurrence_wgrad_f32_{c}" for c in (
        "tile_m", "tile_k", "blocks_128", "blocks_64", "smem_128", "smem_64")),
        (REC_WGRAD_F32_TILE_M, REC_WGRAD_F32_TILE_K, REC_WGRAD_F32_BLOCKS[128],
         REC_WGRAD_F32_BLOCKS[64], *(REC_WGRAD_F32_STAGES * REC_WGRAD_F32_TILE_K
                                     * (REC_WGRAD_F32_TILE_M + n + 16) * 4 for n in (128, 64)))),
    "bilstm_fwd_f32": (("bilstm_fwd_f32_tile", "bilstm_fwd_f32_max_chunks",
                        "bilstm_fwd_f32_max_threads", "bilstm_fwd_f32_max_h",
                        "bilstm_fwd_f32_stride_align", "bilstm_fwd_f32_stride_pad"),
                       (MMA_TILE, FWD_F32_MAX_CHUNKS, FWD_F32_MAX_THREADS, FWD_F32_MAX_H,
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
                             "bilstm_fwd_wide_mma_pad", "bilstm_fwd_wide_mma_uneven_rows",
                             "bilstm_fwd_wide_mma_uneven_widths"),
                            (WIDE_CLUSTER, FWD_WIDE_MMA_THREADS, MMA_PAD,
                             sum(1 << (r // 8) for r in FWD_WIDE_MMA_UNEVEN_ROWS),
                             sum(1 << (h // 32) for h in FWD_WIDE_MMA_WIDTHS if h % 128))),
    "bilstm_wgrad_f32": (("bilstm_wgrad_f32_tile_m", "bilstm_wgrad_f32_tile_n",
                          "bilstm_wgrad_f32_tile_k", "bilstm_wgrad_f32_stages",
                          "bilstm_wgrad_f32_smem", "bilstm_wgrad_f32_narrow_m",
                          "bilstm_wgrad_f32_narrow_max_n", "bilstm_wgrad_f32_narrow_blocks",
                          "bilstm_wgrad_f32_narrow_smem"),
                         (WGRAD_MMA_TILE_M, WGRAD_MMA_TILE_N, WGRAD_MMA_TILE_K,
                          WGRAD_F32_STAGES, WGRAD_F32_SMEM, WGRAD_F32_NARROW_M,
                          WGRAD_F32_NARROW_MAX_N, WGRAD_F32_NARROW_BLOCKS,
                          # its 64 x 160 tile's: three stages of 32 rows of 72 + 168 floats
                          WGRAD_MMA_TILE_K * (WGRAD_F32_NARROW_M + WGRAD_F32_NARROW_MAX_N + 16)
                          * 4 * 3)),
    **{f"lstm_recurrence_{kind}_wide_mma": (
        tuple(f"lstm_recurrence_{kind}_wide_mma_{c}"
              for c in ("cluster", "threads", "pad", "min_h", "max_h", "rows1", "rows2")),
        (WIDE_CLUSTER, REC_WIDE_MMA_THREADS, MMA_PAD, REC_WIDE_MMA_MIN_H, REC_MAX_H,
         *(sum(1 << (r // 8) for r in REC_WIDE_MMA_ROWS[kind][n]) for n in (1, 2))))
       for kind in ("fwd", "bwd")},
    **{f"lstm_recurrence_{kind}_wide_f32": (
        tuple(f"lstm_recurrence_{kind}_wide_f32_{c}"
              for c in ("cluster", "threads", "pad", "min_h", "max_h", "rows1", "rows2")),
        (WIDE_CLUSTER, REC_WIDE_MMA_THREADS, REC_WIDE_F32_PAD, REC_WIDE_MMA_MIN_H, REC_MAX_H,
         *(sum(1 << (r // 8) for r in rows[n]) for n in (1, 2))))
       for kind, rows in (("fwd", REC_WIDE_F32_FWD_ROWS), ("bwd", REC_WIDE_F32_ROWS))},
    "bilstm_bwd_lite_f32": (tuple(f"bilstm_bwd_lite_f32_{c}" for c in (
        "cluster", "threads", "pad", "rows", "widths")),
        (WIDE_CLUSTER, LITE_MMA_THREADS, REC_WIDE_F32_PAD,
         sum(1 << (r // 8) for r in LITE_F32_ROWS),
         sum(1 << (h // 32) for h in LITE_F32_WIDTHS))),
    "bilstm_gates_f32": (tuple(f"bilstm_gates_f32_{c}" for c in (
        "tile_m", "tile_n", "tile_k", "stages", "smem")),
        (GATES_MMA_TILE_M, GATES_MMA_TILE_N, GATES_F32_TILE_K, GATES_F32_STAGES, GATES_F32_SMEM)),
    "bilstm_fwd_wide_f32": (tuple(f"bilstm_fwd_wide_f32_{c}" for c in (
        "cluster", "threads", "pad", "widths", "rows")),
        (WIDE_CLUSTER, LITE_MMA_THREADS, REC_WIDE_F32_PAD,
         sum(1 << (h // 32) for h in FWD_WIDE_F32_WIDTHS),
         sum(sum(1 << (r // 8) for r in rows) << (8 * i)
             for i, rows in enumerate((FWD_WIDE_F32_ROWS, FWD_WIDE_F32_ROWS_288))))),
    "bilstm_bwd_lite_f32_resident": (tuple(f"bilstm_bwd_lite_f32_resident_{c}" for c in (
        "tile", "max_h", "max_threads", "stride_align", "stride_pad")),
        (MMA_TILE, max(LITE_F32_RESIDENT_WIDTHS), 4 * max(LITE_F32_RESIDENT_WIDTHS),
         BWD_F32_STRIDE_ALIGN, BWD_F32_STRIDE_PAD)),
    "bilstm_bwd_lite_mma_resident": (tuple(f"bilstm_bwd_lite_mma_resident_{c}" for c in (
        "tile", "max_h", "max_threads", "pad", "stages")),
        (MMA_TILE, max(LITE_MMA_RESIDENT_WIDTHS), 4 * max(LITE_MMA_RESIDENT_WIDTHS), MMA_PAD,
         MMA_STAGES)),
    "bilstm_fwd_wide_mma_resident": (tuple(f"bilstm_fwd_wide_mma_resident_{c}" for c in (
        "tile", "max_h", "max_threads", "w_pad", "f_pad", "stages")),
        (MMA_TILE, max(FWD_WIDE_MMA_RESIDENT_WIDTHS), 4 * max(FWD_WIDE_MMA_RESIDENT_WIDTHS),
         MMA_PAD, REC_MMA_F32_PAD, FWD_WIDE_MMA_RESIDENT_STAGES)),
    "bilstm_fwd_wide_f32_resident": (tuple(f"bilstm_fwd_wide_f32_resident_{c}" for c in (
        "tile", "max_h", "max_threads", "h_pad", "f_pad", "stages")),
        (MMA_TILE, max(FWD_WIDE_F32_RESIDENT_WIDTHS), 4 * max(FWD_WIDE_F32_RESIDENT_WIDTHS),
         FWD_WIDE_F32_RESIDENT_H_PAD, REC_MMA_F32_PAD, FWD_WIDE_F32_RESIDENT_STAGES)),
    "lstm_recurrence_bwd_mid_f32": (tuple(f"lstm_recurrence_bwd_mid_f32_{c}" for c in (
        "threads", "pad", "min_h", "max_h", "rows", "resident8", "l2_8", "resident4")),
        (REC_WIDE_MMA_THREADS, REC_WIDE_F32_PAD, min(REC_MID_F32_WIDTHS),
         max(REC_MID_F32_WIDTHS), sum(1 << (r // 8) for r in REC_MID_F32_ROWS),
         *(sum(1 << (h // 32) for h in REC_MID_F32_INSTANCES[k])
           for k in ((8, True), (8, False), (4, True))))),
    **{f"lstm_recurrence_{kind}_mid_mma": (
        tuple(f"lstm_recurrence_{kind}_mid_mma_{c}" for c in (
            "threads", "pad", "min_h", "max_h", "rows", "widths8", "widths4") + extra[0]),
        (REC_WIDE_MMA_THREADS, MMA_PAD, min(REC_MID_MMA_WIDTHS), max(REC_MID_MMA_WIDTHS),
         sum(1 << (r // 8) for r in REC_MID_MMA_ROWS),
         *(sum(1 << (h // 32) for h in REC_MID_MMA_INSTANCES[c]) for c in (8, 4)), *extra[1]))
       for kind, extra in (("bwd", ((), ())),
                           ("fwd", (("x_pad", "stages", "stages_at8", "mask_bytes"),
                                    (REC_FWD_MID_MMA_X_PAD, *REC_FWD_MID_MMA_STAGES,
                                     REC_FWD_MID_MMA_MASK_BYTES))))},
    "lstm_recurrence_fwd_f32": (tuple(f"lstm_recurrence_fwd_f32_{c}" for c in (
        "tile", "stages", "max_h", "w_pad", "f_pad")),
        (MMA_TILE, REC_FWD_F32_STAGES, MMA_MAX_H, MMA_PAD, REC_MMA_F32_PAD)),
    "lstm_recurrence_fwd_mid_f32": (tuple(f"lstm_recurrence_fwd_mid_f32_{c}" for c in (
        "threads", "pad", "x_pad", "s_pad", "max_stages", "min_stages", "mask_bytes", "min_h",
        "max_h", "rows", "resident8", "l2_8", "resident4")),
        (REC_WIDE_MMA_THREADS, REC_WIDE_F32_PAD, REC_FWD_MID_F32_X_PAD, REC_FWD_MID_F32_S_PAD,
         *REC_FWD_MID_F32_STAGES, REC_FWD_MID_F32_MASK_BYTES, min(REC_MID_F32_WIDTHS),
         max(REC_MID_F32_WIDTHS), sum(1 << (r // 8) for r in REC_FWD_MID_F32_ROWS),
         *(sum(1 << (h // 32) for h in REC_FWD_MID_F32_INSTANCES[k])
           for k in ((8, True), (8, False), (4, True))))),
}
_ERROR_STRING = {name: f"{name}_error_string" for name in _SIGNATURES}
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
    bfloat16 with input parts that are multiples of 8 wide: H in
    ``BWD_MMA_ANY_K_WIDTHS`` (16, 32, 48, 64) at any such E, E = H =
    ``BWD_MMA_MAX_H`` (80), and H in ``BWD_MMA_ODD_WIDTHS`` (8, 24, 40, 56,
    72: H % 16 == 8) at the shapes ``bwd_launch_plan`` takes there. Its
    products step K by 32: where K = E + H is not a multiple of 32 the gate
    product runs it to the next one over zero columns inside the kernel
    (the dh product's K = 4H always is)."""
    E = sum(E_parts)
    odd = H in BWD_MMA_ODD_WIDTHS
    if (dtype != torch.bfloat16 or any(e <= 0 or e % 8 for e in E_parts)
            or not (odd or H in BWD_MMA_ANY_K_WIDTHS
                    or (H % 16 == 0 and (E + H) % 32 == 0
                        and (16 <= H <= MMA_MAX_H or H == E == BWD_MMA_MAX_H)))):
        raise ValueError(
            f"bilstm_bwd_mma kernel takes bfloat16 with H in {set(BWD_MMA_ANY_K_WIDTHS)}, "
            f"E = H = {BWD_MMA_MAX_H} or H in {set(BWD_MMA_ODD_WIDTHS)}, and input parts that "
            f"are positive multiples of 8, got {dtype}, H={H}, E_parts={list(E_parts)}")
    if odd:
        try:
            bwd_launch_plan(E_parts, H, dtype)
        except ValueError as e:
            raise ValueError(f"bilstm_bwd_mma kernel takes bfloat16 at H={H} (H % 16 == 8) only "
                             f"at the shapes bilstm_bwd.cu takes there: {e}") from None
    # one warp per 8 hidden units; the dx columns past the first H go to
    # extra warps, 16 columns each
    threads = 32 * (H // 8 + -(-max(0, E // 8 - H // 8) // 2))
    chunks = MMA_TILE * (E + (2 + ny) * H) // 8
    # the [W_ih | W_hh] rows and the [x ; h] tile run to K rounded up to 32
    ks, hs, gs = -(-(E + H) // 32) * 32 + MMA_PAD, H + MMA_PAD, 4 * H + MMA_PAD
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
    ValueError naming every refusal otherwise, the last plan's (in the
    sweep's list the CUDA-core kernel's) first."""
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
    (``bwd_mma_plan``: bf16, H <= 64 at any E, E = H = 80 and, at
    H % 16 == 8, the shapes ``bilstm_bwd.cu`` took there),
    ``"bilstm_bwd_f32"`` (``bwd_f32_plan``: f32, H <= 64),
    ``"bilstm_bwd_f32_onestage"`` (``bwd_f32_onestage_plan``: f32 past
    bilstm_bwd_f32.cu's shared memory, E = H = 80), ``"bilstm_bwd"``
    (``bwd_launch_plan``: the CUDA cores, the bf16 shapes the tensor-core
    sweep does not take, none a layer of the width grid runs at); ValueError naming the
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
    (``FWD_MMA_SHAPES``: H in {16, 32, 48, 64}, E = H or 2H, E = H = 72 or
    80, and the shapes at H % 16 == 8 and H = 48 at E = 80 / 112 whose
    K = E + H ends in a k8 step: every bf16 resident shape a layer runs at)
    in 1 or 2 input parts that are multiples of 8 wide. One warp per 8 hidden units
    (at 80, ``FWD_MMA_MAX_THREADS``); the shared memory is the three-stage
    ring of 8-row [x ; h] tiles, each row padded by ``fwd_mma_pad``."""
    E = sum(E_parts)
    if (dtype != torch.bfloat16 or (H, E) not in FWD_MMA_SHAPES or len(E_parts) not in (1, 2)
            or any(e <= 0 or e % 8 for e in E_parts)):
        raise ValueError(
            f"bilstm_fwd_mma kernel takes bfloat16 with (H, E) in {list(FWD_MMA_SHAPES)} and "
            f"1 or 2 input parts that are positive multiples of 8, got {dtype}, H={H}, "
            f"E_parts={list(E_parts)}")
    return 4 * H, MMA_STAGES * MMA_TILE * (E + H + fwd_mma_pad(E + H)) * 2


def fwd_mma_pad(K: int) -> int:
    """bf16 elements of padding on the tensor-core forward's [x ; h] rows of
    K = E + H: ``MMA_PAD`` where K % 16 == 0, ``FWD_MMA_TAIL_PAD`` where
    K % 16 == 8, so the row stride is an odd number of 16 bytes (ldmatrix
    then reads 8 rows in distinct bank groups)."""
    return MMA_PAD if K % 16 == 0 else FWD_MMA_TAIL_PAD


def fwd_f32_plan(E_parts: Sequence[int], H: int, dtype: torch.dtype,
                 rows: int = MMA_TILE) -> Tuple[int, int]:
    """``(threads, smem_bytes)`` of the f32 tensor-core forward
    (``csrc/bilstm_fwd_f32.cu``) with row tiles of ``rows`` (8 or 16), or
    ValueError for a dtype or shape it does not take. It takes float32 with
    H in {16, 32, 48, 64, 80} (``FWD_F32_MAX_H``) and 1 or 2 input parts
    that are multiples of 8 wide, where the f32 weights fit one block beside
    two [x ; h] stages: one warp per 8 hidden units; shared memory for the
    weights (4H rows of E + H, stride rounded to 32 floats plus 8) and the
    two stages; a step's x chunks within the kernel's per-thread constant.
    At H = 80 only 8-row tiles fit (E = H = 80: 225,792 bytes; 16 rows
    236,544)."""
    E = sum(E_parts)
    if (dtype != torch.float32 or H % 16 or not 16 <= H <= FWD_F32_MAX_H
            or len(E_parts) not in (1, 2) or any(e <= 0 or e % 8 for e in E_parts)
            or rows not in FWD_F32_ROWS):
        raise ValueError(
            f"bilstm_fwd_f32 kernel takes float32 with H % 16 == 0 up to {FWD_F32_MAX_H}, 1 or 2 "
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
    ``"bilstm_fwd_mma"`` (``fwd_mma_plan``: bf16 at ``FWD_MMA_SHAPES``,
    every resident shape a bf16 layer runs at), ``"bilstm_fwd_f32"``
    (``fwd_f32_plan``: f32, H % 16 == 0 up to 80); ValueError naming both
    refusals otherwise (such as bf16 at H = 80, E = 72 and f32 at H = 72,
    shapes no layer runs at)."""
    return _first_fitting(
        (("bilstm_fwd_mma", fwd_mma_plan), ("bilstm_fwd_f32", fwd_f32_plan)), E_parts, H, dtype)


def _tensor_core_wgrad_check(name, takes, unit, E_parts, H, dtype, parts=(1, 2)) -> None:
    if (dtype != takes or H <= 0 or H % unit or len(E_parts) not in parts
            or any(e <= 0 or e % 8 for e in E_parts)):
        counts = ", ".join(map(str, parts[:-1])) + f" or {parts[-1]}"
        raise ValueError(
            f"{name} kernel takes {str(takes).replace('torch.', '')} with H % {unit} == 0 and "
            f"{counts} input parts that are positive multiples of 8, got {dtype}, H={H}, "
            f"E_parts={list(E_parts)}")


def wgrad_mma_check(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> None:
    """ValueError for a dtype or shape the tensor-core weight-gradient
    kernel (``csrc/bilstm_wgrad_mma.cu``) does not take: it takes bfloat16
    with H % 8 == 0 (its last 128-row gate tile masked where 4H is not a
    multiple of 128) and 1 or 2 input parts that are multiples of 8 wide,
    or none: ``dW_hh`` alone (``bilstm_wgrad_split``)."""
    _tensor_core_wgrad_check("bilstm_wgrad_mma", torch.bfloat16, 8, E_parts, H, dtype,
                             (0, 1, 2))


def wgrad_f32_check(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> None:
    """ValueError for a dtype or shape the f32 tensor-core weight-gradient
    kernel (``csrc/bilstm_wgrad_f32.cu``) does not take: it takes float32
    with H % 16 == 0 (whole 128-row gate tiles where H % 32 == 0, whole
    64-row ones at the rest: ``wgrad_f32_tile``) and 1 or 2 input parts that
    are multiples of 8 wide."""
    _tensor_core_wgrad_check("bilstm_wgrad_f32", torch.float32, WGRAD_F32_H_STEP, E_parts, H,
                             dtype)


def wgrad_f32_tile(E_parts: Sequence[int], H: int) -> Tuple[int, int]:
    """``(gate rows, source columns)`` of the f32 tensor-core wgrad's block
    tile: 128 x 128 where H % 32 == 0 (the shapes it took before the
    narrow tile), else ``WGRAD_F32_NARROW_M`` (64, a divisor of 4H at
    H % 16 == 0) x the E + H row rounded up to 32 columns, at most
    ``WGRAD_F32_NARROW_MAX_N`` (160; a wider row takes several)."""
    if H % 32 == 0:
        return WGRAD_MMA_TILE_M, WGRAD_MMA_TILE_N
    return WGRAD_F32_NARROW_M, min(WGRAD_F32_NARROW_MAX_N, -(-(sum(E_parts) + H) // 32) * 32)


def wgrad_f32_blocks(tile: Tuple[int, int]) -> int:
    """Blocks of the f32 wgrad's ``tile`` kernel an SM holds (its launch
    bounds): two of the 64-row tiles, one of the 128-row ones (255
    registers a thread)."""
    return WGRAD_F32_NARROW_BLOCKS if tile[0] == WGRAD_F32_NARROW_M else 1


def wgrad_f32_stages(tile: Tuple[int, int]) -> int:
    """cp.async stages of the f32 wgrad's ``tile`` kernel: the most, up to
    ``WGRAD_F32_STAGES``, whose f32 rows (each operand's tile width plus 8)
    let ``wgrad_f32_blocks`` blocks share an SM's shared memory."""
    stage = WGRAD_MMA_TILE_K * (tile[0] + tile[1] + 16) * 4
    fit = (SM_SMEM // wgrad_f32_blocks(tile) - BLOCK_SMEM_RESERVE) // stage
    return min(WGRAD_F32_STAGES, fit)


def wgrad_f32_smem(tile: Tuple[int, int]) -> int:
    """Dynamic shared memory of the f32 wgrad's ``tile`` kernel (bytes)."""
    return wgrad_f32_stages(tile) * WGRAD_MMA_TILE_K * (tile[0] + tile[1] + 16) * 4


def wgrad_kernel(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> str:
    """The kernel a layer's weight gradients take, by shape and dtype alone:
    ``"bilstm_wgrad_mma"`` where ``wgrad_mma_check`` passes (bf16,
    H % 8 == 0), ``"bilstm_wgrad_f32"`` where ``wgrad_f32_check`` passes
    (f32, H % 16 == 0); ValueError naming both refusals otherwise."""
    try:
        wgrad_mma_check(E_parts, H, dtype)
        return "bilstm_wgrad_mma"
    except ValueError as mma:
        try:
            wgrad_f32_check(E_parts, H, dtype)
        except ValueError as f32:
            raise ValueError(f"{mma}; {f32}") from None
    return "bilstm_wgrad_f32"


def wgrad_split(route: str, H: int, dtype: torch.dtype) -> bool:
    """Whether ``layer_bwd`` splits a layer's weight gradients as the JAX
    lite mode does (``bilstm_wgrad_split``) rather than taking them whole
    from ``wgrad_kernel``'s kernel: on the wide route in bfloat16 past
    ``WGRAD_SPLIT_PAST_H`` units (at 96 the whole kernel is the faster)."""
    return route == "wide" and dtype == torch.bfloat16 and H > WGRAD_SPLIT_PAST_H


def wgrad_mma_plan(T: int, B: int, G: int, E_parts: Sequence[int],
                   H: int) -> Tuple[int, int, int]:
    """``(m_tiles, n_tiles, splits)`` of the tensor-core wgrad launch (bf16
    and f32: the same tiles): 128-row tiles of the 4H gates (the last one
    partly past 4H where H % 32 != 0), 128-column tiles of the E + H source
    columns (H alone with no input part: ``dW_hh`` alone), and the split of
    each group's T * B / G rows that brings the
    grid to about ``WGRAD_TARGET_BLOCKS`` blocks, no more splits than
    K-tiles."""
    m_tiles = -(-4 * H // WGRAD_MMA_TILE_M)
    n_tiles = -(-(sum(E_parts) + H) // WGRAD_MMA_TILE_N)
    rows = T * (B // G)
    per_split = m_tiles * n_tiles * 2 * G
    splits = max(1, min(-(-rows // WGRAD_MMA_TILE_K), -(-WGRAD_TARGET_BLOCKS // per_split)))
    return m_tiles, n_tiles, splits


def wgrad_f32_plan(T: int, B: int, G: int, E_parts: Sequence[int], H: int, sms: int,
                   tile: Optional[Tuple[int, int]] = None) -> Tuple[int, int, int]:
    """``(m_tiles, n_tiles, splits)`` of the f32 tensor-core wgrad launch
    with block tile ``tile`` (``wgrad_f32_tile`` when None; the last gate or
    column tile masked where it runs past 4H or E + H), and the split whose
    blocks fill the card's ``sms`` SMs in whole waves best. An SM holds
    ``wgrad_f32_blocks(tile)`` blocks (one of the 128-row tiles, 255
    registers a thread; two of the 64-row ones), so a launch costs about
    ceil(blocks / (sms x that)) waves of ``1 / splits`` of a group's rows
    each: the split with the least of that, among at most
    ``WGRAD_F32_MAX_WAVES`` waves of blocks and no more splits than K-tiles,
    the smaller split on a tie."""
    tile = tile or wgrad_f32_tile(E_parts, H)
    m_tiles = -(-4 * H // tile[0])
    n_tiles = -(-(sum(E_parts) + H) // tile[1])
    per_split = m_tiles * n_tiles * 2 * G
    k_tiles = -(-T * (B // G) // WGRAD_MMA_TILE_K)
    return m_tiles, n_tiles, _whole_wave_splits(per_split, k_tiles,
                                                sms * wgrad_f32_blocks(tile))


@functools.lru_cache(maxsize=None)
def _whole_wave_splits(per_split: int, k_tiles: int, slots: int) -> int:
    """``wgrad_f32_plan``'s split: kept per shape, since every layer call
    of a step asks again and the search takes a host millisecond or more
    where a split has few blocks (two at H = 16 in one group: some 1,000
    candidates)."""
    most = max(1, min(k_tiles, WGRAD_F32_MAX_WAVES * slots // per_split))
    return min(range(1, most + 1), key=lambda s: (Fraction(-(-per_split * s // slots), s), s))


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
    if len(E_parts) not in (1, 2) or any(e <= 0 or e % WIDE_PART_STEP for e in E_parts):
        raise ValueError(
            f"bilstm wide kernels take 1 or 2 input parts, each a positive multiple of "
            f"{WIDE_PART_STEP} wide, got {list(E_parts)}")


def _route_at(E_parts: Sequence[int], H: int, dtype: torch.dtype) -> str:
    """The route that takes the layer at exactly these widths: ``"resident"``
    where a resident forward and sweep take it (``fwd_kernel``,
    ``sweep_kernel``: the layer's weights in one block's shared memory),
    else ``"wide"`` where ``wide_check`` passes and a lite sweep takes H
    (``lite_kernel``: not 32 or 64, whose layers, E far past H, take a
    padded shape); either only where a weight-gradient kernel takes it too
    (``wgrad_kernel``). ValueError naming the refusals otherwise."""
    try:
        fwd_kernel(E_parts, H, dtype)
        sweep_kernel(E_parts, H, dtype)
        route = "resident"
    except ValueError as resident:
        try:
            wide_check(H, E_parts)
            lite_kernel(H, dtype)
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
    alone, at every shape ``wide_check`` admits: ``"bilstm_gates_mma"`` for
    bfloat16, ``"bilstm_gates_f32"`` for float32 (both on the tensor cores,
    the latter in three tf32 passes); ValueError for a dtype or shape
    neither takes."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"bilstm gates kernels take float32 or bfloat16, got {dtype}")
    wide_check(H, E_parts)
    return "bilstm_gates_mma" if dtype == torch.bfloat16 else "bilstm_gates_f32"


def lite_mma_check(H: int, dtype: torch.dtype) -> None:
    """ValueError for a dtype or width the tensor-core lite sweep
    (``csrc/bilstm_bwd_lite_mma.cu``) does not take: it takes bfloat16 at
    H in ``LITE_MMA_WIDTHS``: 128 and 256 (whole 8-unit groups in each of
    the cluster's 8 blocks, and the dh product's m16 tiles evenly over 8
    warps), and 160, 192, 224 and 288 (a second kernel, its instances for
    2 / 3, 3, 3 / 4 and 4 / 5 groups a block)."""
    if dtype != torch.bfloat16 or H not in LITE_MMA_WIDTHS:
        raise ValueError(
            f"bilstm_bwd_lite_mma kernel takes bfloat16 with H in {list(LITE_MMA_WIDTHS)}, "
            f"got {dtype}, H={H}")


def lite_f32_check(H: int, dtype: torch.dtype) -> None:
    """ValueError for a dtype or width the f32 tensor-core lite sweep
    (``csrc/bilstm_bwd_lite_f32.cu``, three tf32 passes) does not take: it
    takes float32 at H in ``LITE_F32_WIDTHS``: 128, 256 and 288, the widths
    of the bf16 one, and 160, 192 and 224 (2 / 3, 3 and 3 / 4 unit groups a
    block)."""
    if dtype != torch.float32 or H not in LITE_F32_WIDTHS:
        raise ValueError(
            f"bilstm_bwd_lite_f32 kernel takes float32 with H in {list(LITE_F32_WIDTHS)}, "
            f"got {dtype}, H={H}")


def lite_f32_resident_plan(H: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(threads, smem_bytes)`` of the f32 tensor-core lite sweep with
    ``W_hh`` resident in one block (``csrc/bilstm_bwd_lite_f32_resident.cu``,
    three tf32 passes), or ValueError for a dtype or width it does not take:
    it takes float32 at H in ``LITE_F32_RESIDENT_WIDTHS`` (96). One warp per
    8 hidden units; shared memory for the weights (4H rows of H, stride
    rounded to 32 floats plus 8), the dgates tile, two h_prev stages (8 rows
    each) and the exchange of the dh product's warp pairs."""
    if dtype != torch.float32 or H not in LITE_F32_RESIDENT_WIDTHS:
        raise ValueError(
            f"bilstm_bwd_lite_f32_resident kernel takes float32 with H in "
            f"{list(LITE_F32_RESIDENT_WIDTHS)}, got {dtype}, H={H}")
    ks = -(-H // BWD_F32_STRIDE_ALIGN) * BWD_F32_STRIDE_ALIGN + BWD_F32_STRIDE_PAD
    smem = (4 * H * ks + MMA_TILE * (4 * H + 4) + 2 * MMA_TILE * ks + H // 8 * 64) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"bilstm_bwd_lite_f32_resident kernel: H={H} needs {smem} bytes of "
                         f"shared memory (at most {SMEM_LIMIT})")
    return 4 * H, smem


def lite_mma_resident_plan(H: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(threads, smem_bytes)`` of the bf16 tensor-core lite sweep with
    ``W_hh`` resident in one block (``csrc/bilstm_bwd_lite_mma_resident.cu``),
    or ValueError for a dtype or width it does not take: it takes bfloat16
    at H in ``LITE_MMA_RESIDENT_WIDTHS`` (96). One warp per 8 hidden units;
    shared memory for the bf16 weights (4H rows of H + 8), the dgates tile
    in f32 (8 rows of 4H + 4) and in bf16 (8 rows of 4H + 8), the
    ``MMA_STAGES`` stages of the step tiles' cp.async ring (8 rows each of
    h_prev, c_prev and two dy streams in bf16, H + 8 wide, and of xg in f32,
    4H + 4 wide) and the exchange of the dh product's warp pairs."""
    if dtype != torch.bfloat16 or H not in LITE_MMA_RESIDENT_WIDTHS:
        raise ValueError(
            f"bilstm_bwd_lite_mma_resident kernel takes bfloat16 with H in "
            f"{list(LITE_MMA_RESIDENT_WIDTHS)}, got {dtype}, H={H}")
    ks, gs, fs = H + MMA_PAD, 4 * H + MMA_PAD, 4 * H + 4
    stage = MMA_TILE * ks * 2 * 4 + MMA_TILE * fs * 4
    smem = (4 * H * ks * 2 + MMA_TILE * fs * 4 + MMA_TILE * gs * 2 + MMA_STAGES * stage
            + H // 8 * 64 * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"bilstm_bwd_lite_mma_resident kernel: H={H} needs {smem} bytes of "
                         f"shared memory (at most {SMEM_LIMIT})")
    return 4 * H, smem


def lite_kernel(H: int, dtype: torch.dtype) -> str:
    """The kernel the wide route's sweep takes, by width and dtype alone:
    ``"bilstm_bwd_lite_mma"`` where ``lite_mma_check`` passes (bf16, H = 128,
    160, 192, 224, 256 or 288), ``"bilstm_bwd_lite_f32"`` where
    ``lite_f32_check`` passes (f32 at those widths),
    ``"bilstm_bwd_lite_f32_resident"`` where ``lite_f32_resident_plan``
    takes it (f32 at 96), ``"bilstm_bwd_lite_mma_resident"`` where
    ``lite_mma_resident_plan`` takes it (bf16 at 96); ValueError naming the
    four refusals otherwise (32 and 64 among them: ``_route_at`` runs no
    layer wide there)."""
    refusals = []
    for name, check in (("bilstm_bwd_lite_mma", lite_mma_check),
                        ("bilstm_bwd_lite_f32", lite_f32_check),
                        ("bilstm_bwd_lite_f32_resident", lite_f32_resident_plan),
                        ("bilstm_bwd_lite_mma_resident", lite_mma_resident_plan)):
        try:
            check(H, dtype)
            return name
        except ValueError as e:
            refusals.append(str(e))
    raise ValueError(f"bilstm_bwd_lite: no lite sweep kernel takes H={H} in {dtype}; "
                     + "; ".join(refusals))


def fwd_wide_mma_check(H: int, dtype: torch.dtype) -> None:
    """ValueError for a dtype or width the tensor-core wide forward
    (``csrc/bilstm_fwd_wide_mma.cu``) does not take: it takes bfloat16 at
    H in ``FWD_WIDE_MMA_WIDTHS``: 128 and 256 (whole 8-unit groups in each
    of the cluster's 8 blocks, and its 8 warps evenly over them) and 160,
    192, 224 and 288 (a second kernel, its instances for 2 / 3, 3, 3 / 4 and
    4 / 5 groups a block, its (group, n8 tile) items dealt over the 8
    warps)."""
    if dtype != torch.bfloat16 or H not in FWD_WIDE_MMA_WIDTHS:
        raise ValueError(
            f"bilstm_fwd_wide_mma kernel takes bfloat16 with H in {list(FWD_WIDE_MMA_WIDTHS)}, "
            f"got {dtype}, H={H}")


def fwd_wide_f32_check(H: int, dtype: torch.dtype) -> None:
    """ValueError for a dtype or width the f32 tensor-core wide forward
    (``csrc/bilstm_fwd_wide_f32.cu``, three tf32 passes) does not take: it
    takes float32 at H in ``FWD_WIDE_F32_WIDTHS``, 128-288, the widths of
    the f32 lite sweep (its instances for 2 / 3, 3 and 3 / 4 unit groups a
    block at 160, 192 and 224)."""
    if dtype != torch.float32 or H not in FWD_WIDE_F32_WIDTHS:
        raise ValueError(
            f"bilstm_fwd_wide_f32 kernel takes float32 with H in {list(FWD_WIDE_F32_WIDTHS)}, "
            f"got {dtype}, H={H}")


def fwd_wide_mma_resident_plan(H: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(threads, smem_bytes)`` of the bf16 tensor-core wide forward with
    ``W_hh`` in one block (``csrc/bilstm_fwd_wide_mma_resident.cu``), or
    ValueError for a dtype or width it does not take: it takes bfloat16 at
    H in ``FWD_WIDE_MMA_RESIDENT_WIDTHS`` (96). One warp per 8 hidden units;
    the weights as ``mma.sync`` fragments in registers; shared memory for
    two bf16 h tiles (8 rows of H + 8) and the ``FWD_WIDE_MMA_RESIDENT_STAGES``
    stages of its cp.async ring of f32 xg tiles (8 rows of 4H + 4)."""
    if dtype != torch.bfloat16 or H not in FWD_WIDE_MMA_RESIDENT_WIDTHS:
        raise ValueError(
            f"bilstm_fwd_wide_mma_resident kernel takes bfloat16 with H in "
            f"{list(FWD_WIDE_MMA_RESIDENT_WIDTHS)}, got {dtype}, H={H}")
    smem = (2 * MMA_TILE * (H + MMA_PAD) * 2
            + FWD_WIDE_MMA_RESIDENT_STAGES * MMA_TILE * (4 * H + REC_MMA_F32_PAD) * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"bilstm_fwd_wide_mma_resident kernel: H={H} needs {smem} bytes of "
                         f"shared memory (at most {SMEM_LIMIT})")
    return 4 * H, smem


def fwd_wide_f32_resident_plan(H: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(threads, smem_bytes)`` of the f32 tensor-core wide forward with
    ``W_hh`` in one block (``csrc/bilstm_fwd_wide_f32_resident.cu``, three
    tf32 passes), or ValueError for a dtype or width it does not take: it
    takes float32 at H in ``FWD_WIDE_F32_RESIDENT_WIDTHS`` (96). One warp per
    8 hidden units; the weights as f32 ``mma.sync`` fragments in registers;
    shared memory for two f32 h tiles (8 rows of H +
    ``FWD_WIDE_F32_RESIDENT_H_PAD``) and the ``FWD_WIDE_F32_RESIDENT_STAGES``
    stages of its cp.async ring of f32 xg tiles (8 rows of 4H + 4)."""
    if dtype != torch.float32 or H not in FWD_WIDE_F32_RESIDENT_WIDTHS:
        raise ValueError(
            f"bilstm_fwd_wide_f32_resident kernel takes float32 with H in "
            f"{list(FWD_WIDE_F32_RESIDENT_WIDTHS)}, got {dtype}, H={H}")
    smem = (2 * MMA_TILE * (H + FWD_WIDE_F32_RESIDENT_H_PAD) * 4
            + FWD_WIDE_F32_RESIDENT_STAGES * MMA_TILE * (4 * H + REC_MMA_F32_PAD) * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"bilstm_fwd_wide_f32_resident kernel: H={H} needs {smem} bytes of "
                         f"shared memory (at most {SMEM_LIMIT})")
    return 4 * H, smem


def wide_fwd_kernel(H: int, dtype: torch.dtype) -> str:
    """The kernel the wide route's recurrence takes, by width and dtype
    alone: ``"bilstm_fwd_wide_mma"`` where ``fwd_wide_mma_check`` passes
    (bf16, H = 128-288 in steps of 32), ``"bilstm_fwd_wide_f32"`` where
    ``fwd_wide_f32_check`` passes (f32 at 128-288),
    ``"bilstm_fwd_wide_mma_resident"`` where ``fwd_wide_mma_resident_plan``
    takes it (bf16 at 96), ``"bilstm_fwd_wide_f32_resident"`` where
    ``fwd_wide_f32_resident_plan`` takes it (f32 at 96); ValueError naming
    the refusals otherwise (32 and 64 among them, which no layer runs
    wide)."""
    refusals = []
    for name, check in (("bilstm_fwd_wide_mma", fwd_wide_mma_check),
                        ("bilstm_fwd_wide_f32", fwd_wide_f32_check),
                        ("bilstm_fwd_wide_mma_resident", fwd_wide_mma_resident_plan),
                        ("bilstm_fwd_wide_f32_resident", fwd_wide_f32_resident_plan)):
        try:
            check(H, dtype)
            return name
        except ValueError as e:
            refusals.append(str(e))
    raise ValueError(f"bilstm_fwd_wide: no wide forward kernel takes H={H} in {dtype}; "
                     + "; ".join(refusals))


def fwd_wide_f32_rows(H: int) -> Tuple[int, ...]:
    """The row tiles the f32 tensor-core wide forward is built for at H:
    ``FWD_WIDE_F32_ROWS`` where every unit group of a block gets two of its
    8 warps or more (at most 4 groups a block, H <= 256),
    ``FWD_WIDE_F32_ROWS_288`` at 288."""
    return FWD_WIDE_F32_ROWS if -(-H // 64) <= 4 else FWD_WIDE_F32_ROWS_288


def _lite_mma_part_stride(rows: int) -> int:
    # at least `rows` and 8 mod 32 (csrc/bilstm_bwd_lite_mma.cu:part_stride)
    return rows + (40 - rows % 32) % 32


def wide_smem(kind: str, H: int, rows: int) -> int:
    """Dynamic shared memory of a wide kernel's block. ``kind`` "lite_mma" (the
    tensor-core sweep, a row tile of ``rows``): the bf16 slice and, per
    row, two h_prev buffers, the f32 xg slice, c_prev and two dy streams,
    the bf16 dgates tile, and two buffers of the f32 partial dh of all H
    units. ``kind`` "fwd_mma" (the
    tensor-core forward, a row tile of ``rows``): the bf16 slice and, per
    row, two bf16 h tiles and the block's new h and c staged (both variants
    take the same, so they take the same tile; at H % 128 != 0 (160, 192,
    224, 288), the kernel for uneven groups, every per-block width sized for
    the block of ceil(H / 64) groups). ``kind`` "rec_fwd_mma" and
    "rec_bwd_mma": the recurrence op's bf16 tensor-core kernels past 288
    (``recurrence_wide_mma_smem``); "rec_bwd_f32": its f32 tensor-core
    sweep and forward past 288 (``recurrence_wide_f32_smem``). At H = 160,
    192, 224 and 288 "lite_mma" is the kernel for uneven groups: every
    per-block width sized for the block of ceil(H / 64) groups, and ONE
    partial buffer; "lite_mma_uneven" is that kernel at any width (at 256,
    by name only).
    ``kind`` "lite_f32" (the f32 tensor-core sweep, ``csrc/bilstm_bwd_lite_f32.cu``):
    the op sweep's f32 h_prev tile, dgates tile and one partial buffer, its
    weights read from L2 (the formula of ``recurrence_wide_f32_smem``).
    ``kind`` "fwd_f32" (the f32 tensor-core forward,
    ``csrc/bilstm_fwd_wide_f32.cu:smem_bytes``): its two f32 h tiles and
    its staged new h, sized for the block of ceil(H / 64) unit groups; its
    weights are read from L2."""
    if kind == "fwd_f32":
        fwd_wide_f32_check(H, torch.float32)
        if rows not in fwd_wide_f32_rows(H):
            raise ValueError(f"bilstm_fwd_wide_f32: no instance for a row tile of {rows} "
                             f"at H={H}")
        return (2 * rows * (H + REC_WIDE_F32_PAD) * 4
                + rows * (8 * -(-H // 64) + REC_WIDE_F32_PAD) * 4)
    if kind in ("rec_fwd_mma", "rec_bwd_mma"):
        return recurrence_wide_mma_smem(kind[4:7], H, rows)
    if kind in ("rec_fwd_f32", "rec_bwd_f32"):
        return recurrence_wide_f32_smem(H, rows, kind[4:7])
    if kind == "lite_f32":
        lite_f32_check(H, torch.float32)
        if rows not in LITE_F32_ROWS:
            raise ValueError(f"bilstm_bwd_lite_f32: no instance for a row tile of {rows}")
        return _wide_f32_sweep_smem(H, rows)
    U = H // WIDE_CLUSTER
    if kind == "fwd_mma":
        BR, pad = rows, MMA_PAD
        if H % 128:
            U = 8 * -(-H // 64)
        return 4 * U * (H + pad) * 2 + 2 * BR * (H + pad) * 2 + 2 * BR * (U + pad) * 2
    if kind in ("lite_mma", "lite_mma_uneven"):
        BR, pad, buffers = rows, MMA_PAD, 2
        if H % 128 or kind == "lite_mma_uneven":
            U, buffers = 8 * -(-H // 64), 1
        return (4 * U * (H + pad) * 2 + 2 * BR * (H + pad) * 2
                + BR * (4 * U + LITE_MMA_XG_PAD) * 4 + 3 * BR * U * 2
                + BR * (4 * U + pad) * 2 + buffers * H * _lite_mma_part_stride(BR) * 4)
    raise ValueError(f"bilstm wide kernels: no kernel of kind {kind!r}")


def wide_plan(kind: str, B: int, G: int, H: int,
              max_clusters: Callable[[int, int], int], dirs: int = 2) -> Tuple[int, int, int]:
    """``(rows, tiles, smem_bytes)`` of a wide launch: the rows whose
    clusters (one per row tile and each of the ``dirs`` directions) fill the
    card in the fewest waves, and among those the smallest tile; ``rows``
    is the row tile (multiples of 8: ``LITE_MMA_ROWS`` for ``kind`` "lite_mma",
    ``LITE_MMA_UNEVEN_ROWS`` there at H % 128 != 0 and for "lite_mma_uneven",
    ``FWD_WIDE_MMA_ROWS`` for "fwd_mma" (``FWD_WIDE_MMA_UNEVEN_ROWS`` at
    H % 128 != 0), ``REC_WIDE_MMA_ROWS`` at H for "rec_fwd_mma" and
    "rec_bwd_mma", ``REC_WIDE_F32_ROWS`` at H for "rec_bwd_f32",
    ``REC_WIDE_F32_FWD_ROWS`` at H for "rec_fwd_f32", ``LITE_F32_ROWS`` for
    "lite_f32", ``fwd_wide_f32_rows(H)`` for "fwd_f32"); ValueError for
    another kind. ``max_clusters(rows, smem)`` is how many clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    rows = {"lite_mma": LITE_MMA_ROWS if H % 128 == 0 else LITE_MMA_UNEVEN_ROWS,
            "lite_mma_uneven": LITE_MMA_UNEVEN_ROWS,
            "fwd_mma": FWD_WIDE_MMA_ROWS if H % 128 == 0 else FWD_WIDE_MMA_UNEVEN_ROWS,
            }.get(kind, ())
    if kind in ("rec_fwd_mma", "rec_bwd_mma"):
        rows = REC_WIDE_MMA_ROWS[kind[4:7]][1 if H <= 512 else 2]
    if kind in ("rec_fwd_f32", "rec_bwd_f32"):
        rows = (REC_WIDE_F32_FWD_ROWS if kind == "rec_fwd_f32"
                else REC_WIDE_F32_ROWS)[1 if H <= 512 else 2]
    if kind == "lite_f32":
        rows = LITE_F32_ROWS
    if kind == "fwd_f32":
        rows = fwd_wide_f32_rows(H)
    if not rows:
        raise ValueError(f"bilstm wide kernels: no kernel of kind {kind!r}")
    best = None
    for R in rows:
        smem = wide_smem(kind, H, R)
        if smem > SMEM_LIMIT:
            continue
        tiles = mma_tiles(B, G, R)
        waves = -(-dirs * tiles // max(1, max_clusters(R, smem)))
        if best is None or waves < best[0]:
            best = (waves, R, tiles, smem)
    if best is None:
        raise ValueError(f"bilstm wide kernels: H={H} leaves no row tile in shared memory")
    return best[1:]


_cluster_counts: Dict[tuple, int] = {}
# the operands between (dtype, rows_per_thread) and (T, B, H, G, tiles,
# smem) of each wide kernel's C entry, when it only reports occupancy
_NO_OPERANDS = {"bilstm_bwd_lite_mma": [None] * 11 + [0] + [None] * 3,
                "bilstm_fwd_wide_mma": [None] * 9,
                "lstm_recurrence_fwd_wide_mma": [None] * 7 + [1],
                "lstm_recurrence_bwd_wide_mma": [None] * 9 + [1],
                "lstm_recurrence_bwd_wide_f32": [None] * 9 + [1],
                "lstm_recurrence_bwd_mid_f32": [None] * 9 + [1],
                "lstm_recurrence_bwd_mid_mma": [None] * 9 + [1],
                "lstm_recurrence_fwd_mid_mma": [None] * 7 + [1],
                "lstm_recurrence_fwd_mid_f32": [None] * 7 + [1],
                "lstm_recurrence_fwd_wide_f32": [None] * 7 + [1],
                "bilstm_bwd_lite_f32": [None] * 11 + [0] + [None] * 3,
                "bilstm_fwd_wide_f32": [None] * 9}


def _max_clusters(name: str, dtype: torch.dtype, H: int, dev: torch.device):
    # the tensor-core kernels' C entries take no dtype code (one dtype each)
    lead = [] if name.endswith(("_mma", "_f32")) else [_DTYPE_CODES[dtype]]

    def count(R: int, smem: int, *config: int) -> int:
        # config: what the C entry takes before the row tile besides ``lead``
        # (lstm_recurrence_bwd_mid_f32: blocks a cluster, resident)
        key = (name, dtype, H, *config, R, smem, dev.index)
        if key not in _cluster_counts:
            out = ctypes.c_int(0)
            with torch.cuda.device(dev):
                err = getattr(_kernels(name), name)(
                    *lead, *config, R, *_NO_OPERANDS[name], 0, 0, H, 1, 1, smem, None,
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


def bilstm_layer_fwd(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bidirectional LSTM layer, time-major, eval variant.

    :param x_parts: 1 or 2 ``(T, B, E_i)`` tensors in ``compute_dtype``.
    :param lengths: ``(B,)`` int32.
    :param w_ih: ``(2, 4H, E)`` and ``w_hh`` ``(2, 4H, H)`` or ``(2, G, 4H,
        H)`` in ``compute_dtype``; ``bias`` ``(2, 4H)`` f32 (``b_ih +
        b_hh``).
    :returns: ``hs_f, hs_b (T, B, H)`` in ``compute_dtype``, ``hn, cn
        (2, B, H)`` f32.

    On the card the layer runs the tensor-core kernel ``fwd_kernel`` names
    for its shapes and dtype, through :func:`bilstm_layer_fwd_mma` (bf16) or
    :func:`bilstm_layer_fwd_f32` (f32), whose ``.launches`` counts it; a
    shape neither takes raises.
    """
    x_parts = tuple(x_parts)
    if not x_parts[0].is_cuda:
        return bilstm_layer_fwd_plain(x_parts, lengths, w_ih, w_hh, bias, compute_dtype)
    name = fwd_kernel([p.shape[-1] for p in x_parts], w_hh.shape[-1], compute_dtype)
    return _TILE_FWD[name][0](x_parts, lengths, w_ih, w_hh, bias, compute_dtype)


bilstm_layer_fwd.launches = 0


def bilstm_layer_fwd_train(
    x_parts: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
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
    name = fwd_kernel([p.shape[-1] for p in x_parts], w_hh.shape[-1], compute_dtype)
    return _TILE_FWD[name][1](x_parts, lengths, w_ih, w_hh, bias, compute_dtype)


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
    Takes the shapes ``fwd_mma_plan`` takes (bfloat16, H <= 64 and E = H =
    72, 80) and raises for the rest. Row tiles are cut inside each weight
    group, so nothing is padded. Its outputs carry no graph, so under grad
    mode it refuses an operand that requires grad, on the CPU too."""
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
    the others; not in bf16 past H = 64 where the tensor-core sweep takes
    the shape, its <80, 80> and <72, 72> instances; at H % 16 == 8 up to 56
    in bf16 still); a shape it does not take raises."""
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
    if kernel == "bilstm_bwd" and cd == torch.bfloat16 and H > MMA_MAX_H \
            and sweep_kernel(E_parts, H, cd) == "bilstm_bwd_mma":
        raise ValueError("bilstm_bwd: csrc/bilstm_bwd.cu is not asked for by name where the "
                         f"bf16 tensor-core sweep takes H={H} past {MMA_MAX_H}")
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
                dyf, dyb, dhn, dcn, compute_dtype, extra=()):
    """The tensor-core sweeps' common body: ``wrapper`` names the kernel
    (``csrc/<name>.cu``, whose C entry takes the operands of
    ``bilstm_bwd_mma.cu``, then ``extra`` ints) and counts its launches;
    ``plan(E_parts, H, dtype, ny)`` gives ``(threads, smem_bytes)`` or
    raises. Row tiles are
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
                T, B, H, G, tiles, threads, smem, *extra,
                torch.cuda.current_stream(dev).cuda_stream,
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
    generic: bool = False,
):
    """One layer's backward sweep on the tensor cores
    (``csrc/bilstm_bwd_mma.cu``); the contract of
    ``ops/lstm.py:bidir_layer_sweep``: returns ``(dxf, dxb, dgc, dbias)``.
    Takes the shapes ``bwd_mma_plan`` takes (bfloat16, H <= 64 at any E,
    E = H = 80 and at H % 16 == 8 the shapes of ``bilstm_bwd.cu``) and
    raises for the rest. Row tiles are cut inside each weight group, so
    nothing is padded. ``generic=True`` runs the kernel's run-time
    ``<0, 0>`` build where the shape has an instance of its own, to time the
    two. Its outputs carry no graph, so under grad mode it refuses an
    operand that requires grad, on the CPU too: ``BiLSTMStack`` is the way
    in."""
    return _tile_sweep(bilstm_bwd_mma, bwd_mma_plan, x_parts, lengths, w_ih, w_hh, bias,
                       hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, compute_dtype,
                       (int(generic),))


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's weight gradients; the contract of
    ``ops/lstm.py:bidir_layer_wgrad``: returns ``dW_ih (2, 4H, E)`` and
    ``dW_hh (2, G, 4H, H)``, f32.

    On the card the products run on the tensor-core kernel ``wgrad_kernel``
    names for the shapes and dtype, through :func:`bilstm_wgrad_mma` (bf16)
    or :func:`bilstm_wgrad_f32` (f32), whose ``.launches`` counts it; a
    shape neither takes raises."""
    x_parts = tuple(x_parts)
    if not dgc.is_cuda:
        return bidir_layer_wgrad(dgc, x_parts, hs_f, hs_b, groups)
    name = wgrad_kernel([p.shape[-1] for p in x_parts], hs_f.shape[-1], dgc.dtype)
    wrapper = bilstm_wgrad_mma if name == "bilstm_wgrad_mma" else bilstm_wgrad_f32
    return wrapper(dgc, x_parts, hs_f, hs_b, groups)


bilstm_wgrad.launches = 0


def _wgrad_tensor_core(wrapper, check, dgc, x_parts, hs_f, hs_b, groups, tile=None):
    """A tensor-core weight-gradient launch (``wrapper.__name__`` names the
    kernel and its C entry) after ``check`` of its dtype and shapes, split
    by ``wgrad_mma_plan`` (bf16) or ``wgrad_f32_plan`` (f32, at block tile
    ``tile``, ``wgrad_f32_tile`` when None)."""
    x_parts = tuple(x_parts)
    _no_graph(dgc, *x_parts, hs_f, hs_b)
    if not dgc.is_cuda:
        return bidir_layer_wgrad(dgc, x_parts, hs_f, hs_b, groups)
    name = wrapper.__name__
    cd = dgc.dtype
    dev = dgc.device
    T, B = hs_f.shape[:2]
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
        tile = tile or wgrad_f32_tile(E_parts, H)
        _, _, splits = wgrad_f32_plan(T, B, G, E_parts, H, _sm_count(dev), tile)
        extra = tile
    else:
        _, _, splits = wgrad_mma_plan(T, B, G, E_parts, H)
        extra = ()
    partial = torch.empty((splits, 2, G, 4 * H, E + H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            dgc.data_ptr(), _ptr(x_parts, 0), _ptr(x_parts, 1),
            *(list(E_parts) + [0, 0])[:2],
            hs_f.data_ptr(), hs_b.data_ptr(), partial.data_ptr(),
            T, B, H, G, splits, *extra, torch.cuda.current_stream(dev).cuda_stream,
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
    raises for the rest; with no input part (``x_parts`` empty) it computes
    ``dW_hh`` alone, and ``dW_ih`` is ``(2, 4H, 0)``. Every block writes its
    partial tile, an empty row
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
    tile: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's weight gradients in f32 on the tensor cores, three tf32
    passes a product (``csrc/bilstm_wgrad_f32.cu``); the contract of
    :func:`bilstm_wgrad`. Takes the shapes ``wgrad_f32_check`` takes
    (float32, H % 16 == 0) and raises for the rest; block tile
    ``wgrad_f32_tile`` (``tile`` pins another of ``WGRAD_F32_TILES``, to time
    it), split by ``wgrad_f32_plan``; the whole partials and the empty
    batch as in :func:`bilstm_wgrad_mma`. Its outputs carry no graph, so
    under grad mode it refuses an operand that requires grad, on the CPU
    too."""
    if tile is not None and tuple(tile) not in WGRAD_F32_TILES:
        raise ValueError(f"bilstm_wgrad_f32 is built for the tiles {list(WGRAD_F32_TILES)}, "
                         f"got {tile}")
    return _wgrad_tensor_core(bilstm_wgrad_f32, wgrad_f32_check, dgc, x_parts, hs_f, hs_b,
                              groups, tile and tuple(tile))


bilstm_wgrad_f32.launches = 0


def bilstm_wgrad_ih(dgc: torch.Tensor, x_parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``dW_ih (2, 4H, E)`` f32, ``dW_ih[d] = sum_{t, b} dgc[d, t, b] (x)
    x[t, b]`` over the input parts' columns: the JAX lite mode's ``dW_ih``
    GEMMs (``lstm_pallas_layer.py:1091-1108``, bf16 operands with
    ``preferred_element_type=f32``), left to XLA there and to cuBLAS here.
    On the card one bf16 product with f32 output (``torch.mm(...,
    out_dtype=torch.float32)``) per direction and input part: ``dgc[d]``
    transposed and each part are views of the streams as they lie, so no
    operand is copied; each product fills its part's columns. Takes
    bfloat16 and raises for the rest; ``.launches`` counts its calls (one a
    layer). On the CPU the plain f32 sums. Its output carries no graph, so
    under grad mode it refuses an operand that requires grad, on the CPU
    too."""
    x_parts = tuple(x_parts)
    _no_graph(dgc, *x_parts)
    E_parts = [p.shape[-1] for p in x_parts]
    if not dgc.is_cuda:
        x = torch.cat([p.float() for p in x_parts], dim=-1)
        return torch.einsum("dtbg,tbe->dge", dgc.float(), x)
    if dgc.dtype != torch.bfloat16 or not x_parts:
        raise ValueError(f"bilstm_wgrad_ih takes bfloat16 and 1 or more input parts, got "
                         f"{dgc.dtype}, E_parts={E_parts}")
    dev = dgc.device
    _, T, B, H4 = dgc.shape
    _check("dgc", dgc, (2, T, B, H4), torch.bfloat16, dev)
    for k, p in enumerate(x_parts):
        _check(f"x_parts[{k}]", p, (T, B, E_parts[k]), torch.bfloat16, dev)
    dw_ih = torch.empty((2, H4, sum(E_parts)), dtype=torch.float32, device=dev)
    if T * B == 0:
        return dw_ih.zero_()
    d = dgc.view(2, T * B, H4)
    col = 0
    for p, e in zip(x_parts, E_parts):
        x = p.view(T * B, e)
        for k in range(2):
            dw_ih[k, :, col:col + e] = torch.mm(d[k].t(), x, out_dtype=torch.float32)
        col += e
    bilstm_wgrad_ih.launches += 1
    return dw_ih


bilstm_wgrad_ih.launches = 0


def bilstm_wgrad_split(
    dgc: torch.Tensor,
    x_parts: Sequence[torch.Tensor],
    hs_f: torch.Tensor,
    hs_b: torch.Tensor,
    groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 wide route's weight gradients, split as the JAX lite mode
    splits them; the contract of :func:`bilstm_wgrad`. On the card ``dW_ih``
    from :func:`bilstm_wgrad_ih` (cuBLAS) and ``dW_hh`` from
    :func:`bilstm_wgrad_mma` with no input part (its ``.launches`` counts
    it); the shapes ``wgrad_mma_check`` takes, raising for the rest. On the
    CPU the plain ``bidir_layer_wgrad``."""
    x_parts = tuple(x_parts)
    if not dgc.is_cuda:
        return bidir_layer_wgrad(dgc, x_parts, hs_f, hs_b, groups)
    wgrad_mma_check([p.shape[-1] for p in x_parts], hs_f.shape[-1], dgc.dtype)
    dw_ih = bilstm_wgrad_ih(dgc, x_parts)
    _, dw_hh = bilstm_wgrad_mma(dgc, (), hs_f, hs_b, groups)
    return dw_ih, dw_hh


def bilstm_gates(
    x_parts: Sequence[torch.Tensor],
    w_ih: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """The input projection of one layer; the contract of
    ``ops/lstm.py:input_gates``: ``xg (2, T, B, 4H)`` f32 from 1 or 2
    ``(T, B, E_i)`` parts and ``w_ih (2, 4H, E)`` in ``compute_dtype`` and
    the f32 ``bias (2, 4H)``.

    On the card the product runs on the kernel ``gates_kernel`` names: a
    tensor-core one through :func:`bilstm_gates_mma` (bf16) or
    :func:`bilstm_gates_f32` (f32), whose ``.launches`` then counts it."""
    x_parts = tuple(x_parts)
    if not x_parts[0].is_cuda:
        return input_gates(x_parts, w_ih, bias, compute_dtype)
    name = gates_kernel([p.shape[-1] for p in x_parts], w_ih.shape[1] // 4, compute_dtype)
    wrapper = bilstm_gates_mma if name == "bilstm_gates_mma" else bilstm_gates_f32
    return wrapper(x_parts, w_ih, bias, compute_dtype)


def _gates_tensor_core(wrapper, dtype, x_parts, w_ih, bias, cd):
    """The tensor-core input gates' body: ``wrapper`` names the kernel
    (``csrc/<name>.cu``, which takes ``dtype`` alone) and counts its
    launches. On the CPU the plain twin; under grad mode an operand that
    requires grad is refused, and so is another dtype, on the CPU too."""
    x_parts = tuple(x_parts)
    _no_graph(*x_parts, w_ih, bias)
    name = wrapper.__name__
    if cd != dtype:
        raise ValueError(f"{name} kernel takes {dtype}, got {cd}")
    if not x_parts[0].is_cuda:
        return input_gates(x_parts, w_ih, bias, cd)
    dev = x_parts[0].device
    T, B = x_parts[0].shape[:2]
    H = w_ih.shape[1] // 4
    E_parts = [p.shape[-1] for p in x_parts]
    wide_check(H, E_parts)
    for k, p in enumerate(x_parts):
        _check(f"x_parts[{k}]", p, (T, B, E_parts[k]), cd, dev)
    _check("w_ih", w_ih, (2, 4 * H, sum(E_parts)), cd, dev)
    _check("bias", bias, (2, 4 * H), torch.float32, dev)
    xg = torch.empty((2, T, B, 4 * H), dtype=torch.float32, device=dev)
    if T * B == 0:
        return xg
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            _ptr(x_parts, 0), _ptr(x_parts, 1), E_parts[0],
            E_parts[1] if len(E_parts) == 2 else 0, w_ih.data_ptr(), bias.data_ptr(),
            xg.data_ptr(), T, B, H, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    return xg


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
    return _gates_tensor_core(bilstm_gates_mma, torch.bfloat16, x_parts, w_ih, bias,
                              compute_dtype)


bilstm_gates_mma.launches = 0


def bilstm_gates_f32(
    x_parts: Sequence[torch.Tensor],
    w_ih: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """The input projection of one layer in f32 on the tensor cores, three
    tf32 passes a product (``csrc/bilstm_gates_f32.cu``); the contract of
    :func:`bilstm_gates`. Takes float32 at every shape ``wide_check`` admits
    and raises for the rest. Deterministic (no split-K, no atomics): the
    forward and the backward's recompute get the same bits. Its output
    carries no graph, so under grad mode it refuses an operand that requires
    grad, on the CPU too."""
    return _gates_tensor_core(bilstm_gates_f32, torch.float32, x_parts, w_ih, bias,
                              compute_dtype)


bilstm_gates_f32.launches = 0


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


def _wide_fwd_outputs(T, B, H, cd, dev, with_states):
    """A wide forward's outputs, empty: ``hs_f, hs_b, hn, cn`` and, with
    ``with_states``, ``cs_f, cs_b``."""
    hs = torch.empty((T, B, H), dtype=cd, device=dev)
    hn = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    states = (torch.empty_like(hs), torch.empty_like(hs)) if with_states else ()
    return (hs, torch.empty_like(hs), hn, torch.empty_like(hn)) + states


def _fwd_wide_launch(wrapper, name, xg, lengths, w_hh, cd, with_states):
    """A wide forward launch of the kernel ``name`` ("bilstm_fwd_wide_mma"
    or "bilstm_fwd_wide_f32") on the row tile its plan picks, counted on
    ``wrapper``; an empty batch launches nothing."""
    dev, T, B, H, G, w_hh = _wide_operands(xg, lengths, w_hh, cd, name)
    outs = _wide_fwd_outputs(T, B, H, cd, dev, with_states)
    hs_f, hs_b, hn, cn = outs[:4]
    cs_f, cs_b = outs[4:] if with_states else (None, None)
    if B == 0:
        return outs
    if name == "bilstm_fwd_wide_f32":
        # the lite sweep's f32 fragment copy of W_hh^T (2, G, H, 4H)
        kind, w = "fwd_f32", recurrence_f32_weights(w_hh.transpose(-1, -2))
    else:
        kind, w = "fwd_mma", w_hh
    rows, tiles, smem = wide_plan(kind, B, G, H, _max_clusters(name, cd, H, dev))
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            rows, xg.data_ptr(), lengths.data_ptr(),
            w.data_ptr(), hs_f.data_ptr(), hs_b.data_ptr(), _opt_ptr(cs_f), _opt_ptr(cs_b),
            hn.data_ptr(), cn.data_ptr(), T, B, H, G, tiles, smem,
            torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    return outs


def _fwd_wide_dispatch(wrappers, xg, lengths, w_hh, cd, kernel, with_states):
    """``wrappers``: the tensor-core wide forwards of one variant, in the
    order of their kernel names below; another name is refused, on the CPU
    too, where the plain twin runs."""
    tensor_core = dict(zip(
        ("bilstm_fwd_wide_mma", "bilstm_fwd_wide_f32", "bilstm_fwd_wide_mma_resident",
         "bilstm_fwd_wide_f32_resident"), wrappers))
    if kernel not in (None, *tensor_core):
        raise ValueError(f"bilstm_fwd_wide: no wide forward kernel named {kernel!r}")
    if not xg.is_cuda:
        return bidir_recurrence(xg, lengths, w_hh, cd, with_states=with_states)
    return tensor_core[kernel or wide_fwd_kernel(xg.shape[-1] // 4, cd)](xg, lengths, w_hh, cd)


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
    its width and dtype (``kernel`` names one of them instead; another name
    is refused, on the CPU too), a tensor-core one through
    :func:`bilstm_fwd_wide_mma` (bf16 at H = 128-288),
    :func:`bilstm_fwd_wide_f32` (f32 at 128-288),
    :func:`bilstm_fwd_wide_mma_resident` (bf16 at 96) or
    :func:`bilstm_fwd_wide_f32_resident` (f32 at 96), whose ``.launches``
    counts it; it raises at the widths none takes (32 and 64, which no layer
    runs wide).
    """
    return _fwd_wide_dispatch((bilstm_fwd_wide_mma, bilstm_fwd_wide_f32,
                               bilstm_fwd_wide_mma_resident, bilstm_fwd_wide_f32_resident), xg,
                              lengths, w_hh, compute_dtype, kernel, False)


def bilstm_fwd_wide_train(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """The train variant of :func:`bilstm_fwd_wide`: also the cell streams
    ``cs_f, cs_b (T, B, H)`` in ``compute_dtype``, after ``hn, cn``; its
    tensor-core kernels through :func:`bilstm_fwd_wide_train_mma`,
    :func:`bilstm_fwd_wide_train_f32`,
    :func:`bilstm_fwd_wide_train_mma_resident` and
    :func:`bilstm_fwd_wide_train_f32_resident`."""
    return _fwd_wide_dispatch(
        (bilstm_fwd_wide_train_mma, bilstm_fwd_wide_train_f32,
         bilstm_fwd_wide_train_mma_resident, bilstm_fwd_wide_train_f32_resident), xg, lengths,
        w_hh, compute_dtype, kernel, True)


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
    (bfloat16, H = 128-288 in steps of 32) and raises for the rest; the row tile is
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


def _fwd_wide_f32(wrapper, xg, lengths, w_hh, cd, with_states):
    _no_graph(xg, w_hh)
    fwd_wide_f32_check(xg.shape[-1] // 4, cd)
    if not xg.is_cuda:
        return bidir_recurrence(xg, lengths, w_hh, cd, with_states=with_states)
    return _fwd_wide_launch(wrapper, "bilstm_fwd_wide_f32", xg, lengths, w_hh, cd, with_states)


def bilstm_fwd_wide_f32(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's recurrence over its input gates in f32 on the tensor
    cores, three tf32 passes a product (``csrc/bilstm_fwd_wide_f32.cu``:
    8-block clusters on the f32 fragment copy of ``W_hh^T`` that
    :func:`bilstm_bwd_lite_f32` reads, ``recurrence_f32_weights``), eval
    variant; the contract of :func:`bilstm_fwd_wide`. Takes the widths
    ``fwd_wide_f32_check`` takes (float32, H = 128, 256 and 288) and raises
    for the rest, on the CPU too; the row tile is
    ``wide_plan("fwd_f32", ...)``'s. Its outputs carry no graph, so under grad mode it
    refuses an operand that requires grad, on the CPU too."""
    return _fwd_wide_f32(bilstm_fwd_wide_f32, xg, lengths, w_hh, compute_dtype, False)


bilstm_fwd_wide_f32.launches = 0


def bilstm_fwd_wide_train_f32(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, ...]:
    """The train variant of :func:`bilstm_fwd_wide_f32`: also the cell
    streams ``cs_f, cs_b (T, B, H)`` in f32, after ``hn, cn``. It gives the
    eval variant's ``hs`` bit for bit."""
    return _fwd_wide_f32(bilstm_fwd_wide_train_f32, xg, lengths, w_hh, compute_dtype, True)


bilstm_fwd_wide_train_f32.launches = 0


def _fwd_wide_resident(wrapper, name, plan, xg, lengths, w_hh, cd, with_states):
    """The one-block wide forwards' body: ``name`` the kernel
    (``csrc/<name>.cu``), ``plan(H, dtype)`` its ``(threads, smem)`` or
    ValueError for what it does not take; ``wrapper`` counts its launches.
    On the CPU the plain twin; under grad mode an operand that requires
    grad is refused; an empty batch launches nothing."""
    _no_graph(xg, w_hh)
    if not xg.is_cuda:
        return bidir_recurrence(xg, lengths, w_hh, cd, with_states=with_states)
    threads, smem = plan(xg.shape[-1] // 4, cd)
    dev, T, B, H, G, w_hh = _wide_operands(xg, lengths, w_hh, cd, name)
    outs = _wide_fwd_outputs(T, B, H, cd, dev, with_states)
    hs_f, hs_b, hn, cn = outs[:4]
    cs_f, cs_b = outs[4:] if with_states else (None, None)
    if B == 0:
        return outs
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            xg.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(), hs_f.data_ptr(),
            hs_b.data_ptr(), _opt_ptr(cs_f), _opt_ptr(cs_b), hn.data_ptr(), cn.data_ptr(),
            T, B, H, G, mma_tiles(B, G), threads, smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    return outs


def bilstm_fwd_wide_mma_resident(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's recurrence over its input gates in bf16 on the tensor
    cores, one block a row tile with ``W_hh`` resident as ``mma.sync``
    fragments in registers (``csrc/bilstm_fwd_wide_mma_resident.cu``), eval
    variant; the contract of :func:`bilstm_fwd_wide`. Takes the widths
    ``fwd_wide_mma_resident_plan`` takes (bfloat16, H = 96) and raises for
    the rest. Row tiles of 8 are cut inside each weight group, so nothing is
    padded. Its outputs carry no graph, so under grad mode it refuses an
    operand that requires grad, on the CPU too."""
    return _fwd_wide_resident(bilstm_fwd_wide_mma_resident, "bilstm_fwd_wide_mma_resident",
                              fwd_wide_mma_resident_plan, xg, lengths, w_hh, compute_dtype,
                              False)


bilstm_fwd_wide_mma_resident.launches = 0


def bilstm_fwd_wide_train_mma_resident(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, ...]:
    """The train variant of :func:`bilstm_fwd_wide_mma_resident`: also the
    cell streams ``cs_f, cs_b (T, B, H)`` in bfloat16, after ``hn, cn``. It
    gives the eval variant's ``hs`` bit for bit."""
    return _fwd_wide_resident(bilstm_fwd_wide_train_mma_resident,
                              "bilstm_fwd_wide_mma_resident", fwd_wide_mma_resident_plan, xg,
                              lengths, w_hh, compute_dtype, True)


bilstm_fwd_wide_train_mma_resident.launches = 0


def bilstm_fwd_wide_f32_resident(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's recurrence over its input gates in f32 on the tensor
    cores, three tf32 passes, one block a row tile with ``W_hh`` resident as
    f32 ``mma.sync`` fragments in registers
    (``csrc/bilstm_fwd_wide_f32_resident.cu``), eval variant; the contract of
    :func:`bilstm_fwd_wide`. Takes the widths ``fwd_wide_f32_resident_plan``
    takes (float32, H = 96) and raises for the rest. Row tiles of 8 are cut
    inside each weight group, so nothing is padded. Its outputs carry no
    graph, so under grad mode it refuses an operand that requires grad, on
    the CPU too."""
    return _fwd_wide_resident(bilstm_fwd_wide_f32_resident, "bilstm_fwd_wide_f32_resident",
                              fwd_wide_f32_resident_plan, xg, lengths, w_hh, compute_dtype,
                              False)


bilstm_fwd_wide_f32_resident.launches = 0


def bilstm_fwd_wide_train_f32_resident(
    xg: torch.Tensor,
    lengths: torch.Tensor,
    w_hh: torch.Tensor,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, ...]:
    """The train variant of :func:`bilstm_fwd_wide_f32_resident`: also the
    cell streams ``cs_f, cs_b (T, B, H)`` in f32, after ``hn, cn``. It gives
    the eval variant's ``hs`` bit for bit."""
    return _fwd_wide_resident(bilstm_fwd_wide_train_f32_resident,
                              "bilstm_fwd_wide_f32_resident", fwd_wide_f32_resident_plan, xg,
                              lengths, w_hh, compute_dtype, True)


bilstm_fwd_wide_train_f32_resident.launches = 0


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
    width and dtype (``kernel`` names one of them instead; another name is
    refused, on the CPU too): a tensor-core one through :func:`bilstm_bwd_lite_mma` (bf16 at H = 128-288),
    :func:`bilstm_bwd_lite_f32` (f32 there), :func:`bilstm_bwd_lite_f32_resident`
    (f32 at 96) or :func:`bilstm_bwd_lite_mma_resident` (bf16 at 96), whose
    ``.launches`` counts it; a width none takes raises."""
    dyf, dyb = tuple(dyf), tuple(dyb)
    cd = compute_dtype
    kernels = {"bilstm_bwd_lite_mma": bilstm_bwd_lite_mma,
               "bilstm_bwd_lite_f32": bilstm_bwd_lite_f32,
               "bilstm_bwd_lite_f32_resident": bilstm_bwd_lite_f32_resident,
               "bilstm_bwd_lite_mma_resident": bilstm_bwd_lite_mma_resident}
    if kernel not in (None, *kernels):
        raise ValueError(f"bilstm_bwd_lite: no lite sweep kernel named {kernel!r}")
    if not xg.is_cuda:
        return bidir_layer_sweep_lite(xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                                      dhn, dcn, cd)
    kernel = kernel or lite_kernel(xg.shape[-1] // 4, cd)
    return kernels[kernel](xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, cd)


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
    uneven: bool = False,
) -> torch.Tensor:
    """One layer's backward sweep over its input gates on the tensor cores
    (``csrc/bilstm_bwd_lite_mma.cu``); the contract of
    :func:`bilstm_bwd_lite`. Takes the widths ``lite_mma_check`` takes
    (bfloat16, H in ``LITE_MMA_WIDTHS``) and raises for the rest; the row tile is
    ``wide_plan("lite_mma", ...)``'s. ``uneven=True`` asks at H = 256 for
    the second kernel (160-288's, which deals its (unit group, n8 tile)
    items over its 8 warps; row tile ``wide_plan("lite_mma_uneven", ...)``'s),
    to time the two in turns; no dispatch asks for it. Its output carries no
    graph, so under grad mode it refuses an operand that requires grad, on
    the CPU too."""
    if uneven and xg.is_cuda and xg.shape[-1] // 4 not in (256, 288):
        raise ValueError(f"bilstm_bwd_lite_mma: the uneven instance takes H = 256 and 288, "
                         f"got H={xg.shape[-1] // 4}")
    return _lite_tensor_core(bilstm_bwd_lite_mma, lite_mma_check,
                             "lite_mma_uneven" if uneven else "lite_mma", lambda w: w, xg,
                             lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn,
                             compute_dtype)


bilstm_bwd_lite_mma.launches = 0


def bilstm_bwd_lite_f32(
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
    """One layer's backward sweep over its input gates in f32 on the tensor
    cores, three tf32 passes a product (``csrc/bilstm_bwd_lite_f32.cu``:
    8-block clusters, both products from one f32 fragment copy of
    ``W_hh^T`` read from L2, ``recurrence_f32_weights``, split in
    registers); the contract of :func:`bilstm_bwd_lite`. Takes the widths
    ``lite_f32_check`` takes (float32, H = 128, 256 and 288) and raises for
    the rest; the row tile is ``wide_plan("lite_f32", ...)``'s. Its output
    carries no graph, so under grad mode it refuses an operand that requires
    grad, on the CPU too."""
    # the fragment copy of W_hh^T (2, G, H, 4H): the op's layout, so its copy serves
    return _lite_tensor_core(bilstm_bwd_lite_f32, lite_f32_check, "lite_f32",
                             lambda w: recurrence_f32_weights(w.transpose(-1, -2)), xg, lengths,
                             w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, compute_dtype)


bilstm_bwd_lite_f32.launches = 0


def bilstm_bwd_lite_f32_resident(
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
    """One layer's backward sweep over its input gates in f32 on the tensor
    cores, three tf32 passes a product, one block a row tile with ``W_hh``
    resident in its shared memory (``csrc/bilstm_bwd_lite_f32_resident.cu``);
    the contract of :func:`bilstm_bwd_lite`. Takes the widths
    ``lite_f32_resident_plan`` takes (float32, H = 96) and raises for the
    rest. Row tiles of 8 are cut inside each weight group, so nothing is
    padded. Its output carries no graph, so under grad mode it refuses an
    operand that requires grad, on the CPU too."""
    return _lite_resident(bilstm_bwd_lite_f32_resident, lite_f32_resident_plan, xg, lengths,
                          w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, compute_dtype)


bilstm_bwd_lite_f32_resident.launches = 0


def bilstm_bwd_lite_mma_resident(
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
    """One layer's backward sweep over its input gates in bf16 on the tensor
    cores, one block a row tile with ``W_hh`` resident (the gate product's
    weights in registers, the dh product's in shared memory;
    ``csrc/bilstm_bwd_lite_mma_resident.cu``); the contract of
    :func:`bilstm_bwd_lite`. Takes the widths ``lite_mma_resident_plan``
    takes (bfloat16, H = 96) and raises for the rest. Row tiles of 8 are cut
    inside each weight group, so nothing is padded. Its output carries no
    graph, so under grad mode it refuses an operand that requires grad, on
    the CPU too."""
    return _lite_resident(bilstm_bwd_lite_mma_resident, lite_mma_resident_plan, xg, lengths,
                          w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, compute_dtype)


bilstm_bwd_lite_mma_resident.launches = 0


def _lite_resident(wrapper, plan, xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn,
                   cd):
    """The one-block lite sweeps' body: ``wrapper`` names the kernel
    (``csrc/<name>.cu``, 8-row tiles, its C entry the operands of
    ``bilstm_bwd_lite_f32_resident.cu``) and counts its launches,
    ``plan(H, dtype)`` gives its threads and shared memory or refuses. On
    the CPU the plain twin; under grad mode an operand that requires grad is
    refused."""
    dyf, dyb = tuple(dyf), tuple(dyb)
    _no_graph(xg, w_hh, hs_f, hs_b, cs_f, cs_b, *dyf, *dyb)
    if not xg.is_cuda:
        return bidir_layer_sweep_lite(xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                                      dhn, dcn, cd)
    name = wrapper.__name__
    threads, smem = plan(xg.shape[-1] // 4, cd)
    dev, T, B, H, G, w_hh = _lite_operands(name, xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b,
                                           dyf, dyb, dhn, dcn, cd)
    dgates = torch.empty((2, T, B, 4 * H), dtype=torch.float32, device=dev)
    if B * T == 0:
        return dgates
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            xg.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            hs_f.data_ptr(), hs_b.data_ptr(), cs_f.data_ptr(), cs_b.data_ptr(),
            _ptr(dyf, 0), _ptr(dyf, 1), _ptr(dyb, 0), _ptr(dyb, 1), len(dyf),
            _opt_ptr(dhn), _opt_ptr(dcn), dgates.data_ptr(), T, B, H, G, mma_tiles(B, G),
            threads, smem, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    return dgates


def _lite_tensor_core(wrapper, check, plan, weights, xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b,
                      dyf, dyb, dhn, dcn, cd):
    """The tensor-core lite sweeps' body: ``wrapper`` names the kernel
    (``csrc/<name>.cu``) and counts its launches, ``check(H, dtype)`` refuses
    what it does not take, ``wide_plan(plan, ...)`` picks its row tile and
    ``weights(w_hh)`` is the weight operand it reads. On the CPU the plain
    twin; under grad mode an operand that requires grad is refused."""
    dyf, dyb = tuple(dyf), tuple(dyb)
    _no_graph(xg, w_hh, hs_f, hs_b, cs_f, cs_b, *dyf, *dyb)
    if not xg.is_cuda:
        return bidir_layer_sweep_lite(xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                                      dhn, dcn, cd)
    name = wrapper.__name__
    check(xg.shape[-1] // 4, cd)
    dev, T, B, H, G, w_hh = _lite_operands(name, xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b,
                                           dyf, dyb, dhn, dcn, cd)
    dgates = torch.empty((2, T, B, 4 * H), dtype=torch.float32, device=dev)
    if B * T == 0:
        return dgates
    rows, tiles, smem = wide_plan(plan, B, G, H, _max_clusters(name, cd, H, dev))
    w = weights(w_hh)
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            rows, xg.data_ptr(), lengths.data_ptr(), w.data_ptr(),
            hs_f.data_ptr(), hs_b.data_ptr(), cs_f.data_ptr(), cs_b.data_ptr(),
            _ptr(dyf, 0), _ptr(dyf, 1), _ptr(dyb, 0), _ptr(dyb, 1), len(dyf),
            _opt_ptr(dhn), _opt_ptr(dcn), dgates.data_ptr(), T, B, H, G, tiles, smem,
            torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    return dgates


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
    ``ops/lstm.py:input_grads``; then ``bilstm_wgrad`` (where ``wgrad_split``
    says so, in bf16 on the wide route past 96, ``bilstm_wgrad_split``:
    ``dW_ih`` on cuBLAS, as the JAX lite mode leaves it to XLA, and ``dW_hh``
    on ``bilstm_wgrad_mma``). A padded layer's
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
    wgrad = bilstm_wgrad_split if wgrad_split(route, Hp, compute_dtype) else bilstm_wgrad
    dw_ih, dw_hh = wgrad(dgc, x_parts, hs_f, hs_b, grouped_w_hh(w_hh).shape[1])
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
            f"(H % 32 == 0) with compute dtype float32 or bfloat16 (the forward, the sweep and "
            f"the weight gradient, each by width and dtype; the tensor-core sweep "
            f"lstm_recurrence_bwd_mma takes bfloat16 with H in {set(REC_MMA_WIDTHS)}, as does the "
            f"forward lstm_recurrence_fwd_mma, and lstm_recurrence_bwd_f32 and "
            f"lstm_recurrence_fwd_f32 float32 there), got H={H}, {compute_dtype}")


def recurrence_wide_mma_check(H: int, compute_dtype: torch.dtype) -> None:
    """ValueError for a width or compute dtype the recurrence op's bf16
    tensor-core kernels past 288 (``lstm_recurrence_{fwd,bwd}_wide_mma``)
    do not take: they take bfloat16 with H % 32 == 0 from
    ``REC_WIDE_MMA_MIN_H`` to ``REC_MAX_H``."""
    if compute_dtype != torch.bfloat16 or H % 32 or not REC_WIDE_MMA_MIN_H <= H <= REC_MAX_H:
        raise ValueError(
            f"lstm_recurrence_fwd_wide_mma and lstm_recurrence_bwd_wide_mma take compute dtype "
            f"bfloat16 with H % 32 == 0 from {REC_WIDE_MMA_MIN_H} to {REC_MAX_H}, got H={H}, "
            f"{compute_dtype}")


def recurrence_wide_f32_check(H: int, compute_dtype: torch.dtype) -> None:
    """ValueError for a width or compute dtype the recurrence op's f32
    tensor-core kernels past 288 (``lstm_recurrence_{fwd,bwd}_wide_f32``) do
    not take: they take float32 with H % 32 == 0 from ``REC_WIDE_MMA_MIN_H``
    to ``REC_MAX_H``."""
    if compute_dtype != torch.float32 or H % 32 or not REC_WIDE_MMA_MIN_H <= H <= REC_MAX_H:
        raise ValueError(
            f"lstm_recurrence_bwd_wide_f32 (and lstm_recurrence_fwd_wide_f32) takes compute "
            f"dtype float32 with H % 32 == 0 from {REC_WIDE_MMA_MIN_H} to {REC_MAX_H}, got H={H}, "
            f"{compute_dtype}")


def recurrence_fwd_kernel(H: int, compute_dtype: torch.dtype) -> str:
    """The kernel the recurrence op's forward takes, by width and compute
    dtype alone, each on the tensor cores: at H = 32 or 64
    ``"lstm_recurrence_fwd_mma"`` for bfloat16 and
    ``"lstm_recurrence_fwd_f32"`` (three tf32 passes) for float32, one block
    per 8-row tile; from 96 to 288 ``"lstm_recurrence_fwd_mid_mma"`` for
    bfloat16 and ``"lstm_recurrence_fwd_mid_f32"`` (three tf32 passes) for
    float32, clusters whose blocks hold their share of the weight
    fragments; past ``WIDE_MAX_THREADS`` units ``"lstm_recurrence_fwd_wide_mma"``
    for bfloat16 and ``"lstm_recurrence_fwd_wide_f32"`` for float32;
    ValueError for what none takes (``recurrence_check``)."""
    recurrence_check(H, compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    if H in REC_MMA_WIDTHS:
        return "lstm_recurrence_fwd_mma" if bf16 else "lstm_recurrence_fwd_f32"
    if H > WIDE_MAX_THREADS:
        return "lstm_recurrence_fwd_wide_mma" if bf16 else "lstm_recurrence_fwd_wide_f32"
    return "lstm_recurrence_fwd_mid_mma" if bf16 else "lstm_recurrence_fwd_mid_f32"


def recurrence_sweep_kernel(H: int, compute_dtype: torch.dtype) -> str:
    """The kernel the recurrence op's sweep takes, by width and compute
    dtype alone: at H = 32 or 64 the tensor-core ones,
    ``"lstm_recurrence_bwd_mma"`` for bfloat16 and
    ``"lstm_recurrence_bwd_f32"`` (three tf32 passes) for float32; bfloat16
    past ``WIDE_MAX_THREADS`` the tensor-core
    ``"lstm_recurrence_bwd_wide_mma"``, float32 there
    ``"lstm_recurrence_bwd_wide_f32"`` (three tf32 passes); from 96 to 288
    the tensor-core ``"lstm_recurrence_bwd_mid_f32"`` (three tf32 passes)
    for float32 and ``"lstm_recurrence_bwd_mid_mma"`` for bfloat16;
    ValueError for what none takes."""
    recurrence_check(H, compute_dtype)
    if H in REC_MMA_WIDTHS:
        return "lstm_recurrence_bwd_mma" if compute_dtype == torch.bfloat16 \
            else "lstm_recurrence_bwd_f32"
    if H > WIDE_MAX_THREADS:
        return "lstm_recurrence_bwd_wide_mma" if compute_dtype == torch.bfloat16 \
            else "lstm_recurrence_bwd_wide_f32"
    if compute_dtype == torch.float32:
        return "lstm_recurrence_bwd_mid_f32"
    return "lstm_recurrence_bwd_mid_mma"


def recurrence_mid_f32_check(H: int, compute_dtype: torch.dtype) -> None:
    """ValueError for a width or compute dtype the recurrence op's f32
    tensor-core sweep and forward at 96-288 (``lstm_recurrence_bwd_mid_f32``,
    ``lstm_recurrence_fwd_mid_f32``) do not take: they take float32 at H in
    ``REC_MID_F32_WIDTHS``."""
    if compute_dtype != torch.float32 or H not in REC_MID_F32_WIDTHS:
        raise ValueError(
            f"lstm_recurrence_bwd_mid_f32 takes compute dtype float32 with H in "
            f"{list(REC_MID_F32_WIDTHS)}, as does lstm_recurrence_fwd_mid_f32, got H={H}, "
            f"{compute_dtype}")


def recurrence_mid_f32_smem(H: int, rows: int, cluster: int, resident: bool,
                            kind: str = "bwd") -> int:
    """Dynamic shared memory of a block of ``lstm_recurrence_{kind}_mid_f32``
    (``kind`` "bwd" or "fwd") at H units, a row tile of ``rows`` and
    ``cluster`` blocks a cluster (``csrc/lstm_recurrence_{bwd,fwd}_mid_f32.cu:
    smem_bytes``): with ``resident`` first the block's share of the f32
    weight fragments (128 bytes a unit group and input, for the most groups
    a block owns, ceil(H / 8 / cluster)). "bwd": then the f32 h_prev tile
    and the block's f32 dgates tile (32 gate columns a group), rows padded
    by ``REC_WIDE_F32_PAD``, and the f32 partial dh of all H units (rows
    padded to 8 mod 16). "fwd": two f32 h tiles (rows padded the same), the
    block's new h staged (8 units a group + ``REC_FWD_MID_F32_S_PAD``), and
    the cp.async ring of f32 xg rows (4 gates x 8 units a group +
    ``REC_FWD_MID_F32_X_PAD``) and of mask bytes, its stages
    ``recurrence_mid_f32_fwd_stages``. ValueError for a width
    ``recurrence_mid_f32_check`` refuses or a combination with no instance
    (``REC_MID_F32_INSTANCES`` and ``REC_MID_F32_ROWS``, or
    ``REC_FWD_MID_F32_INSTANCES``, ``REC_FWD_MID_F32_ROWS`` and a ring of
    at least ``REC_FWD_MID_F32_STAGES[1]`` stages)."""
    recurrence_mid_f32_check(H, torch.float32)
    groups, pad = -(-H // (8 * cluster)), REC_WIDE_F32_PAD
    fwd = kind == "fwd"
    rows_of, instances = ((REC_FWD_MID_F32_ROWS, REC_FWD_MID_F32_INSTANCES) if fwd
                          else (REC_MID_F32_ROWS, REC_MID_F32_INSTANCES))
    stages = recurrence_mid_f32_fwd_stages(rows, cluster, groups, resident) if fwd else None
    if kind not in ("bwd", "fwd") or rows not in rows_of or stages == 0 \
            or H not in instances.get((cluster, bool(resident)), ()):
        raise ValueError(f"lstm_recurrence_{kind}_mid_f32: no instance for a row tile of "
                         f"{rows}, {cluster}-block clusters, resident={bool(resident)} at H={H}")
    if fwd:
        return _mid_f32_fwd_bytes(H, rows, cluster, resident, stages)
    return ((groups * H * 128 if resident else 0) + rows * (H + pad) * 4
            + rows * (32 * groups + pad) * 4 + H * (rows + (8 - rows) % 16) * 4)


def _mid_f32_fwd_bytes(H: int, rows: int, cluster: int, resident: bool, stages: int) -> int:
    # csrc/lstm_recurrence_fwd_mid_f32.cu:smem_with
    groups, pad = -(-H // (8 * cluster)), REC_WIDE_F32_PAD
    return ((groups * H * 128 if resident else 0) + 2 * rows * (H + pad) * 4
            + rows * (8 * groups + REC_FWD_MID_F32_S_PAD) * 4
            + stages * (rows * (32 * groups + REC_FWD_MID_F32_X_PAD) * 4
                        + REC_FWD_MID_F32_MASK_BYTES))


def recurrence_mid_f32_fwd_stages(rows: int, cluster: int, groups: int, resident: bool) -> int:
    """The cp.async ring stages of the ``lstm_recurrence_fwd_mid_f32``
    instance for ``groups`` unit groups a block
    (``csrc/lstm_recurrence_fwd_mid_f32.cu:stages``): the most, from
    ``REC_FWD_MID_F32_STAGES[0]`` down to ``[1]``, whose block fits shared
    memory at the instance's widest width, min(8 * cluster * groups, 288);
    0 where fewer fit (no instance)."""
    widest = min(8 * cluster * groups, max(REC_MID_F32_WIDTHS))
    most, fewest = REC_FWD_MID_F32_STAGES
    for stages in range(most, fewest - 1, -1):
        if _mid_f32_fwd_bytes(widest, rows, cluster, resident, stages) <= SMEM_LIMIT:
            return stages
    return 0


def recurrence_mid_f32_plan(B: int, G: int, H: int, max_clusters, dirs: int = 2,
                            kind: str = "bwd"):
    """``(cluster, resident, rows, tiles, smem_bytes)`` of a launch of
    ``lstm_recurrence_{kind}_mid_f32`` (``kind`` "bwd" or "fwd"): the blocks
    a cluster at H of ``REC_MID_F32_CLUSTER`` ("bwd") or
    ``REC_FWD_MID_F32_CLUSTER`` ("fwd"), 8 where it names none, the
    fragments resident unless H is in ``REC_MID_F32_FROM_L2`` (or
    ``REC_FWD_MID_F32_FROM_L2``), and among ``REC_MID_F32_ROWS`` (or the
    forward's ``REC_FWD_MID_F32_ROWS`` that have an instance there) the row
    tile whose clusters fill the card in the fewest waves, then the
    smallest. ``max_clusters(cluster, resident, rows, smem)`` is how many
    clusters the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    fwd = kind == "fwd"
    clusters, from_l2, rows_of = ((REC_FWD_MID_F32_CLUSTER, REC_FWD_MID_F32_FROM_L2,
                                   REC_FWD_MID_F32_ROWS) if fwd else
                                  (REC_MID_F32_CLUSTER, REC_MID_F32_FROM_L2, REC_MID_F32_ROWS))
    cluster = clusters.get(H, WIDE_CLUSTER)
    resident = H not in from_l2
    best = None
    for rows in rows_of:
        if fwd and not recurrence_mid_f32_fwd_stages(rows, cluster, -(-H // (8 * cluster)),
                                                     resident):
            continue
        smem = recurrence_mid_f32_smem(H, rows, cluster, resident, kind)
        if smem > SMEM_LIMIT:
            continue
        tiles = mma_tiles(B, G, rows)
        waves = -(-dirs * tiles // max(1, max_clusters(cluster, resident, rows, smem)))
        if best is None or waves < best[0]:
            best = (waves, rows, tiles, smem)
    if best is None:
        raise ValueError(f"lstm_recurrence_{kind}_mid_f32: H={H} leaves no row tile in shared "
                         f"memory")
    return (cluster, resident) + best[1:]


def recurrence_mid_mma_check(H: int, compute_dtype: torch.dtype) -> None:
    """ValueError for a width or compute dtype the recurrence op's bf16
    tensor-core kernels at 96-288 (``lstm_recurrence_{bwd,fwd}_mid_mma``)
    do not take: they take bfloat16 at H in ``REC_MID_MMA_WIDTHS``."""
    if compute_dtype != torch.bfloat16 or H not in REC_MID_MMA_WIDTHS:
        raise ValueError(
            f"lstm_recurrence_bwd_mid_mma and lstm_recurrence_fwd_mid_mma take compute dtype "
            f"bfloat16 with H in {list(REC_MID_MMA_WIDTHS)}, got H={H}, {compute_dtype}")


def recurrence_mid_mma_smem(kind: str, H: int, rows: int, cluster: int) -> int:
    """Dynamic shared memory of a block of ``lstm_recurrence_{kind}_mid_mma``
    (``kind`` "bwd" or "fwd") at H units, a row tile of ``rows`` and
    ``cluster`` blocks a cluster (``csrc/lstm_recurrence_{bwd,fwd}_mid_mma.cu:
    smem_bytes``): first the block's share of the bf16 weight fragments, 64
    bytes a unit group and input for the most groups a block owns,
    ceil(H / 8 / cluster). "bwd": then the f32 h_prev tile, its bf16
    rounding and the block's bf16 dgates tile (32 gate columns a group),
    rows padded by ``MMA_PAD``, and the f32 partial dh of all H units (rows
    padded to 8 mod 16). "fwd": two bf16 h tiles, the block's new h staged
    (8 units a group), rows padded by ``MMA_PAD``, the cp.async ring of f32
    xg rows (4 gates x 8 units a group + ``REC_FWD_MID_MMA_X_PAD``) and of
    mask bytes, ``REC_FWD_MID_MMA_STAGES[0]`` stages, or ``[1]`` where a
    block owns 8 groups. ValueError for a width
    ``recurrence_mid_mma_check`` refuses or a combination with no instance
    (``REC_MID_MMA_INSTANCES``, ``REC_MID_MMA_ROWS``)."""
    recurrence_mid_mma_check(H, torch.bfloat16)
    if kind not in ("bwd", "fwd") or rows not in REC_MID_MMA_ROWS \
            or H not in REC_MID_MMA_INSTANCES.get(cluster, ()):
        raise ValueError(f"lstm_recurrence_{kind}_mid_mma: no instance for a row tile of "
                         f"{rows}, {cluster}-block clusters at H={H}")
    groups, pad = -(-H // (8 * cluster)), MMA_PAD
    w = groups * H * 64
    if kind == "bwd":
        return (w + rows * H * 4 + rows * (H + pad) * 2 + rows * (32 * groups + pad) * 2
                + H * (rows + (8 - rows) % 16) * 4)
    stages = REC_FWD_MID_MMA_STAGES[groups >= 8]
    return (w + 2 * rows * (H + pad) * 2 + rows * (8 * groups + pad) * 2
            + stages * (rows * (32 * groups + REC_FWD_MID_MMA_X_PAD) * 4
                        + REC_FWD_MID_MMA_MASK_BYTES))


def recurrence_mid_mma_plan(kind: str, B: int, G: int, H: int, max_clusters, dirs: int = 2):
    """``(cluster, rows, tiles, smem_bytes)`` of a launch of
    ``lstm_recurrence_{kind}_mid_mma``: ``REC_MID_MMA_CLUSTER[kind]``'s
    blocks a cluster at H (8 where it names none), and among
    ``REC_MID_MMA_ROWS`` the row tile whose clusters fill the card in the
    fewest waves, then the smallest. ``max_clusters(cluster, rows, smem)``
    is how many clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    cluster = REC_MID_MMA_CLUSTER[kind].get(H, WIDE_CLUSTER)
    best = None
    for rows in REC_MID_MMA_ROWS:
        smem = recurrence_mid_mma_smem(kind, H, rows, cluster)
        if smem > SMEM_LIMIT:
            continue
        tiles = mma_tiles(B, G, rows)
        waves = -(-dirs * tiles // max(1, max_clusters(cluster, rows, smem)))
        if best is None or waves < best[0]:
            best = (waves, rows, tiles, smem)
    if best is None:
        raise ValueError(f"lstm_recurrence_{kind}_mid_mma: H={H} leaves no row tile in shared "
                         f"memory")
    return (cluster,) + best[1:]


def recurrence_wide_mma_smem(kind: str, H: int, rows: int) -> int:
    """Dynamic shared memory of a block of ``lstm_recurrence_{kind}_wide_mma``
    (``kind`` "fwd" or "bwd") at H units and a row tile of ``rows``
    (``csrc/lstm_recurrence_{fwd,bwd}_wide_mma.cu:smem_bytes``). "fwd": two
    bf16 h tiles and the block's new h staged (8 units for each of its at
    most ceil(H / 64) unit groups). "bwd": the f32 h_prev tile, its bf16
    rounding, the block's bf16 dgates tile (32 gate columns a group) and the
    f32 partial dh of all H units (rows padded to 8 mod 16). ValueError for
    a width ``recurrence_wide_mma_check`` refuses or a row tile neither
    kernel is instantiated for."""
    recurrence_wide_mma_check(H, torch.bfloat16)
    if rows not in REC_WIDE_MMA_ROWS[kind][1 if H <= 512 else 2]:
        raise ValueError(f"lstm_recurrence_{kind}_wide_mma: no instance for a row tile of "
                         f"{rows} at H={H}")
    groups = -(-H // 64)
    if kind == "fwd":
        return 2 * rows * (H + MMA_PAD) * 2 + rows * (8 * groups + MMA_PAD) * 2
    part_stride = rows + (8 - rows) % 16
    return (rows * H * 4 + rows * (H + MMA_PAD) * 2 + rows * (32 * groups + MMA_PAD) * 2
            + H * part_stride * 4)


def recurrence_wide_f32_smem(H: int, rows: int, kind: str = "bwd") -> int:
    """Dynamic shared memory of a block of ``lstm_recurrence_{kind}_wide_f32``
    (``kind`` "bwd" or "fwd") at H units and a row tile of ``rows``
    (``csrc/lstm_recurrence_{bwd,fwd}_wide_f32.cu:smem_bytes``). "bwd": the
    f32 h_prev tile, the block's f32 dgates tile (32 gate columns for each
    of its at most ceil(H / 64) unit groups), rows padded by
    ``REC_WIDE_F32_PAD``, and the f32 partial dh of all H units (rows padded
    to 8 mod 16). "fwd": two f32 h tiles and the block's new h staged (8
    units for each of its groups), rows padded the same. ValueError for a
    width ``recurrence_wide_f32_check`` refuses or a row tile with no
    instance."""
    recurrence_wide_f32_check(H, torch.float32)
    table = REC_WIDE_F32_FWD_ROWS if kind == "fwd" else REC_WIDE_F32_ROWS
    if rows not in table[1 if H <= 512 else 2]:
        raise ValueError(f"lstm_recurrence_{kind}_wide_f32: no instance for a row tile of "
                         f"{rows} at H={H}")
    if kind == "fwd":
        pad = REC_WIDE_F32_PAD
        return 2 * rows * (H + pad) * 4 + rows * (8 * -(-H // 64) + pad) * 4
    return _wide_f32_sweep_smem(H, rows)


def _wide_f32_sweep_smem(H: int, rows: int) -> int:
    # the f32 sweeps reading their weights from L2 (the op's past 288 and the
    # layer's lite one): f32 h_prev tile, dgates tile, one partial dh buffer
    pad, part_stride = REC_WIDE_F32_PAD, rows + (8 - rows) % 16
    return (rows * (H + pad) * 4 + rows * (32 * -(-H // 64) + pad) * 4
            + H * part_stride * 4)


def recurrence_f32_weights(w: torch.Tensor) -> torch.Tensor:
    """The copy of ``w (D, G, H, 4H)`` (f32) that the f32 tensor-core kernels
    read from L2 (the op's forward and sweep past 288; the layer's lite
    sweep, from ``w_hh`` transposed): for each (d, g), unit group of 8, k8 step kk of the H
    inputs and m16 half mt of the group's 32 permuted gate rows (row
    32 * group + 8 * gate + unit % 8, ``bilstm_mma.cuh``), every lane's
    ``mma.sync`` tf32 A fragment, ``(D, G, H / 8, H / 8, 2, 32, 4)``. Lane
    4 g + t holds rows g, g + 8, g, g + 8 at inputs 16 c + 2 kh + 4t, then
    the one after it (kk = 2c + kh): the K order within each k16 chunk is
    permuted so that a lane's B values are four adjacent inputs
    (``csrc/lstm_recurrence_bwd_wide_f32.cu``)."""
    D, G, H, _ = w.shape
    # k = 16 c + 4 t + 2 kh + e; column j = (2 mt + hi) H + 8 group + g
    a = w.float().reshape(D, G, H // 16, 4, 2, 2, 2, 2, H // 8, 8)
    # -> [group][c][kh][mt][g][t][e][hi]: register e * 2 + hi
    return a.permute(0, 1, 8, 2, 4, 6, 9, 3, 5, 7).reshape(D, G, H // 8, H // 8, 2, 32, 4) \
        .contiguous()


def recurrence_mma_weights(w: torch.Tensor) -> torch.Tensor:
    """The copy of ``w (D, G, H, 4H)`` (bf16) that the bf16 tensor-core
    kernels past 288 read: for each (d, g), unit group of 8, k16 step of the
    H inputs and m16 half of the group's 32 permuted gate rows (row
    32 * group + 8 * gate + unit % 8, ``bilstm_mma.cuh``), every lane's mma
    A fragment, ``(D, G, H / 8, H / 16, 2, 32, 8)``; lane 4 g + t holds rows
    g, g + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9 in the register order
    of ``mma.sync`` (``csrc/lstm_recurrence_wide_mma.cuh``)."""
    D, G, H, _ = w.shape
    a = w.reshape(D, G, H, 4, H // 8, 8).permute(0, 1, 4, 3, 5, 2)  # [group][gate][u % 8][k]
    # gate = 2 mt + hi, row g = u % 8; k = 16 kk + 8 kh + 2 t + e
    a = a.reshape(D, G, H // 8, 2, 2, 8, H // 16, 2, 4, 2)
    return a.permute(0, 1, 2, 6, 3, 5, 8, 7, 4, 9).reshape(D, G, H // 8, H // 16, 2, 32, 8) \
        .contiguous()


def recurrence_fragments(w: torch.Tensor, compute_dtype: torch.dtype) -> Optional[torch.Tensor]:
    """The fragment copy of ``w (D, G, H, 4H)`` that both the op's forward
    and its sweep read on the card at H in ``compute_dtype``, from 96 to
    ``REC_MAX_H`` units, where the forward is a cluster kernel on the tensor
    cores: ``recurrence_mma_weights(w)`` in bf16,
    ``recurrence_f32_weights(w)`` in f32; None at 32 and 64 (the kernels
    there read ``w`` itself)."""
    kernel = recurrence_fwd_kernel(w.shape[-2], compute_dtype)
    if kernel in ("lstm_recurrence_fwd_mid_mma", "lstm_recurrence_fwd_wide_mma"):
        return recurrence_mma_weights(w)
    if kernel in ("lstm_recurrence_fwd_mid_f32", "lstm_recurrence_fwd_wide_f32"):
        return recurrence_f32_weights(w)
    return None


def recurrence_mma_smem(H: int) -> int:
    """Dynamic shared memory of the tensor-core recurrence sweep's block:
    the bf16 ``w`` (4H x H, rows padded), two bf16 dgates tiles, and three
    stages of the f32 xg, h_prev, c_prev and dhs tiles."""
    ws, gs = H + MMA_PAD, 4 * H + MMA_PAD
    xs, cs = 4 * H + REC_MMA_F32_PAD, H + REC_MMA_F32_PAD
    return (_a16(4 * H * ws * 2) + _a16(2 * MMA_TILE * gs * 2)
            + MMA_STAGES * MMA_TILE * 4 * (xs + ws + 2 * cs))


def recurrence_fwd_f32_smem(H: int) -> int:
    """Dynamic shared memory of the f32 tensor-core recurrence forward's
    block at H = 32 / 64 (``csrc/lstm_recurrence_fwd_f32.cu:smem_bytes``;
    its weights sit in registers): two f32 h tiles (rows padded by
    ``MMA_PAD``) and ``REC_FWD_F32_STAGES`` stages of the f32 xg tile (rows
    padded by ``REC_MMA_F32_PAD``) and of 32 mask bytes."""
    return (4 * (2 * MMA_TILE * (H + MMA_PAD)
                 + REC_FWD_F32_STAGES * MMA_TILE * (4 * H + REC_MMA_F32_PAD))
            + REC_FWD_F32_STAGES * 32)


def recurrence_f32_smem(H: int) -> int:
    """Dynamic shared memory of the f32 tensor-core recurrence sweep's
    block: ``w`` pre-split into a big and a small f32 copy (4H x H each,
    rows padded), two buffers of the big and small f32 dgates tiles, and
    three stages of the f32 xg, h_prev, c_prev and dhs tiles."""
    ws, gs = H + MMA_PAD, 4 * H + REC_MMA_F32_PAD
    xs, cs = 4 * H + REC_MMA_F32_PAD, H + REC_MMA_F32_PAD
    return 4 * (2 * 4 * H * ws + 2 * 2 * MMA_TILE * gs
                + MMA_STAGES * MMA_TILE * (xs + ws + 2 * cs))


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
    kernel: Optional[str] = None, wf: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The masked recurrence over time-major input gates; the contract of
    ``ops/lstm_recurrence.py:recurrence_fwd``.

    :param xg: ``(T, D, B, 4H)`` f32; ``valid`` ``(T, D, B)`` bool or int;
        ``w`` ``(D, G, H, 4H)`` in ``compute_dtype``.
    :returns: ``hs, cs (T, D, B, H)`` and ``hn, cn (D, B, H)``, f32.

    On the card the forward runs the kernel ``recurrence_fwd_kernel`` names
    for its width and dtype (``kernel`` asks for another of them by name), a
    tensor-core one: through :func:`lstm_recurrence_fwd_mma`,
    :func:`lstm_recurrence_fwd_f32`, :func:`lstm_recurrence_fwd_mid_mma`,
    :func:`lstm_recurrence_fwd_mid_f32`, :func:`lstm_recurrence_fwd_wide_mma`
    or :func:`lstm_recurrence_fwd_wide_f32`, whose ``.launches`` counts it
    (this wrapper only dispatches: its count stays 0); ``wf``, the fragment
    copy of ``w`` where the caller has it, goes to the last four:
    ``recurrence_mma_weights(w)`` in bf16, ``recurrence_f32_weights(w)`` in
    f32.
    """
    _no_graph(xg, w)
    if not xg.is_cuda:
        return recurrence_fwd(xg, valid, w, G, compute_dtype)
    cd = compute_dtype
    if kernel not in (None, *_REC_TILE_FWD, *_REC_WIDE_FWD):
        raise ValueError(f"lstm_recurrence_fwd: no forward kernel named {kernel!r}")
    H = xg.shape[-1] // 4
    kernel = kernel or recurrence_fwd_kernel(H, cd)
    if kernel in _REC_TILE_FWD:
        return _REC_TILE_FWD[kernel](xg, valid, w, G, cd)
    return _REC_WIDE_FWD[kernel](xg, valid, w, G, cd, wf)


lstm_recurrence_fwd.launches = 0


def lstm_recurrence_fwd_mma(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, G: int, compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence's forward on the tensor cores at H = 32 and 64
    (``csrc/lstm_recurrence_fwd_mma.cu``: one block per 8-row tile and
    direction, no cluster, ``w`` resident as the warps' mma fragments); the
    contract of :func:`lstm_recurrence_fwd`. Takes bfloat16 at H in
    ``REC_MMA_WIDTHS`` and raises for the rest. On the CPU the plain twin;
    under grad mode an operand that requires grad is refused."""
    _no_graph(xg, w)
    if not xg.is_cuda:
        return recurrence_fwd(xg, valid, w, G, compute_dtype)
    cd, name = compute_dtype, "lstm_recurrence_fwd_mma"
    dev, T, D, B, H, valid8 = _recurrence_operands(xg, valid, w, G, cd, name)
    if recurrence_fwd_kernel(H, cd) != name:
        raise ValueError(f"{name} kernel takes compute dtype bfloat16 with H in "
                         f"{set(REC_MMA_WIDTHS)}, got H={H}, {cd}")
    hs = torch.empty((T, D, B, H), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    hn = torch.zeros((D, B, H), dtype=torch.float32, device=dev)
    cn = torch.zeros_like(hn)
    if B * D == 0 or T == 0:
        return hs, cs, hn, cn
    with torch.cuda.device(dev):
        err = _kernels(name).lstm_recurrence_fwd_mma(
            xg.data_ptr(), valid8.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            hn.data_ptr(), cn.data_ptr(), D, T, B, H, G, mma_tiles(B, G),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(name, err)
    lstm_recurrence_fwd_mma.launches += 1
    return hs, cs, hn, cn


lstm_recurrence_fwd_mma.launches = 0


def lstm_recurrence_fwd_mid_mma(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, G: int, compute_dtype: torch.dtype,
    wf: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence's forward on the tensor cores at 96-288 units
    (``csrc/lstm_recurrence_fwd_mid_mma.cu``: clusters of 4 or 8 blocks,
    each holding its share of the bf16 fragment copy of the weights,
    ``recurrence_mma_weights``, in shared memory; the (unit group, n8 tile)
    items dealt over the warps; the new h exchanged through distributed
    shared memory; xg and the mask through a cp.async ring); the contract of
    :func:`lstm_recurrence_fwd`. ``wf`` is that copy of ``w`` where the
    caller has it, else it is built here. Takes bfloat16 at H in
    ``REC_MID_MMA_WIDTHS`` and raises for the rest; the launch is
    ``recurrence_mid_mma_plan("fwd", ...)``'s. On the CPU the plain twin;
    under grad mode an operand that requires grad is refused."""
    _no_graph(xg, w)
    if not xg.is_cuda:
        return recurrence_fwd(xg, valid, w, G, compute_dtype)
    cd, name = compute_dtype, "lstm_recurrence_fwd_mid_mma"
    dev, T, D, B, H, valid8 = _recurrence_operands(xg, valid, w, G, cd, name)
    recurrence_mid_mma_check(H, cd)
    hs = torch.empty((T, D, B, H), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    hn = torch.zeros((D, B, H), dtype=torch.float32, device=dev)
    cn = torch.zeros_like(hn)
    if B * D == 0 or T == 0:
        return hs, cs, hn, cn
    count = _max_clusters(name, cd, H, dev)
    cluster, rows, tiles, smem = recurrence_mid_mma_plan(
        "fwd", B, G, H, lambda c, R, m: count(R, m, c), dirs=D)
    wf = _mma_copy(w, wf)
    with torch.cuda.device(dev):
        err = _kernels(name).lstm_recurrence_fwd_mid_mma(
            cluster, rows, xg.data_ptr(), valid8.data_ptr(), wf.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), hn.data_ptr(), cn.data_ptr(), D, T, B, H, G, tiles, smem,
            torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    lstm_recurrence_fwd_mid_mma.launches += 1
    return hs, cs, hn, cn


lstm_recurrence_fwd_mid_mma.launches = 0


def lstm_recurrence_fwd_f32(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, G: int, compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence's forward in f32 on the tensor cores at H = 32 and 64,
    three tf32 passes a product (``csrc/lstm_recurrence_fwd_f32.cu``: the
    one-block schedule of :func:`lstm_recurrence_fwd_mma` with ``w``
    resident in shared memory pre-split into big and small tf32 parts, as
    the f32 sweep holds it); the contract of :func:`lstm_recurrence_fwd`.
    Takes float32 at H in ``REC_MMA_WIDTHS`` and raises for the rest. On the
    CPU the plain twin; under grad mode an operand that requires grad is
    refused."""
    _no_graph(xg, w)
    if not xg.is_cuda:
        return recurrence_fwd(xg, valid, w, G, compute_dtype)
    cd, name = compute_dtype, "lstm_recurrence_fwd_f32"
    dev, T, D, B, H, valid8 = _recurrence_operands(xg, valid, w, G, cd, name)
    if recurrence_fwd_kernel(H, cd) != name:
        raise ValueError(f"{name} kernel takes compute dtype float32 with H in "
                         f"{set(REC_MMA_WIDTHS)}, got H={H}, {cd}")
    hs = torch.empty((T, D, B, H), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    hn = torch.zeros((D, B, H), dtype=torch.float32, device=dev)
    cn = torch.zeros_like(hn)
    if B * D == 0 or T == 0:
        return hs, cs, hn, cn
    with torch.cuda.device(dev):
        err = _kernels(name).lstm_recurrence_fwd_f32(
            xg.data_ptr(), valid8.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            hn.data_ptr(), cn.data_ptr(), D, T, B, H, G, mma_tiles(B, G),
            recurrence_fwd_f32_smem(H), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(name, err)
    lstm_recurrence_fwd_f32.launches += 1
    return hs, cs, hn, cn


lstm_recurrence_fwd_f32.launches = 0


def lstm_recurrence_fwd_mid_f32(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, G: int, compute_dtype: torch.dtype,
    wf: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence's forward in f32 on the tensor cores at 96-288 units,
    three tf32 passes a product (``csrc/lstm_recurrence_fwd_mid_f32.cu``:
    the schedule of :func:`lstm_recurrence_fwd_mid_mma` on the f32 fragment
    copy the f32 sweep reads, ``recurrence_f32_weights``, each block's share
    in shared memory (read from L2 at 288), split in registers); the
    contract of :func:`lstm_recurrence_fwd`. ``wf`` is that copy of ``w``
    where the caller has it (``FusedLSTMRecurrence`` builds it once for the
    forward and the sweep), else it is built here. Takes float32 at H in
    ``REC_MID_F32_WIDTHS`` and raises for the rest; the launch is
    ``recurrence_mid_f32_plan(..., kind="fwd")``'s. On the CPU the plain
    twin; under grad mode an operand that requires grad is refused."""
    _no_graph(xg, w)
    if not xg.is_cuda:
        return recurrence_fwd(xg, valid, w, G, compute_dtype)
    cd, name = compute_dtype, "lstm_recurrence_fwd_mid_f32"
    dev, T, D, B, H, valid8 = _recurrence_operands(xg, valid, w, G, cd, name)
    recurrence_mid_f32_check(H, cd)
    hs = torch.empty((T, D, B, H), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    hn = torch.zeros((D, B, H), dtype=torch.float32, device=dev)
    cn = torch.zeros_like(hn)
    if B * D == 0 or T == 0:
        return hs, cs, hn, cn
    count = _max_clusters(name, cd, H, dev)
    cluster, resident, rows, tiles, smem = recurrence_mid_f32_plan(
        B, G, H, lambda c, r, R, m: count(R, m, c, int(r)), dirs=D, kind="fwd")
    wf = _f32_copy(w, wf)
    with torch.cuda.device(dev):
        err = _kernels(name).lstm_recurrence_fwd_mid_f32(
            cluster, int(resident), rows, xg.data_ptr(), valid8.data_ptr(), wf.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), hn.data_ptr(), cn.data_ptr(), D, T, B, H, G, tiles,
            smem, torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    lstm_recurrence_fwd_mid_f32.launches += 1
    return hs, cs, hn, cn


lstm_recurrence_fwd_mid_f32.launches = 0


def lstm_recurrence_fwd_wide_mma(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, G: int, compute_dtype: torch.dtype,
    wf: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence's forward on the tensor cores past 288 units
    (``csrc/lstm_recurrence_fwd_wide_mma.cu``: 8-block clusters, the bf16
    weight fragments read from L2 once a step for the whole row tile); the
    contract of :func:`lstm_recurrence_fwd`. ``wf`` is the fragment copy
    ``recurrence_mma_weights(w)`` where the caller has built it
    (``FusedLSTMRecurrence`` builds it once for the forward and the sweep),
    else it is built here. Takes bfloat16 with H % 32 == 0 from 320 to
    ``REC_MAX_H`` and raises for the rest."""
    return _wide_recurrence_fwd(lstm_recurrence_fwd_wide_mma, recurrence_wide_mma_check,
                                "rec_fwd_mma", lambda w: _mma_copy(w, wf), xg, valid, w, G,
                                compute_dtype)


lstm_recurrence_fwd_wide_mma.launches = 0


def lstm_recurrence_fwd_wide_f32(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, G: int, compute_dtype: torch.dtype,
    wf: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence's forward in f32 on the tensor cores past 288 units,
    three tf32 passes a product (``csrc/lstm_recurrence_fwd_wide_f32.cu``:
    the schedule of :func:`lstm_recurrence_fwd_wide_mma` on the f32 fragment
    copy the f32 sweep reads, ``recurrence_f32_weights``, split in
    registers); the contract of :func:`lstm_recurrence_fwd`. ``wf`` is that
    copy of ``w`` where the caller has built it (``FusedLSTMRecurrence``
    builds it once for the forward and the sweep), else it is built here.
    Takes float32 with H % 32 == 0 from 320 to ``REC_MAX_H`` and raises for
    the rest."""
    return _wide_recurrence_fwd(lstm_recurrence_fwd_wide_f32, recurrence_wide_f32_check,
                                "rec_fwd_f32", lambda w: _f32_copy(w, wf), xg, valid, w, G,
                                compute_dtype)


lstm_recurrence_fwd_wide_f32.launches = 0
# the tensor-core recurrence forwards' wrappers by kernel name: those that
# read w itself, and those that take its fragment copy
_REC_TILE_FWD = {"lstm_recurrence_fwd_mma": lstm_recurrence_fwd_mma,
                 "lstm_recurrence_fwd_f32": lstm_recurrence_fwd_f32}
_REC_WIDE_FWD = {"lstm_recurrence_fwd_mid_mma": lstm_recurrence_fwd_mid_mma,
                 "lstm_recurrence_fwd_mid_f32": lstm_recurrence_fwd_mid_f32,
                 "lstm_recurrence_fwd_wide_mma": lstm_recurrence_fwd_wide_mma,
                 "lstm_recurrence_fwd_wide_f32": lstm_recurrence_fwd_wide_f32}


def _wide_recurrence_fwd(wrapper, check, plan, copy, xg, valid, w, G, compute_dtype):
    """The tensor-core recurrence forwards' body past 288: ``wrapper`` names
    the kernel (``csrc/<name>.cu``: 8-block clusters reading the weight
    fragments from L2) and counts its launches, ``check(H, dtype)`` refuses
    what it does not take, ``wide_plan(plan, ...)`` picks its row tile,
    ``copy(w)`` lays out its weight fragments. On the CPU the plain twin;
    under grad mode an operand that requires grad is refused."""
    _no_graph(xg, w)
    if not xg.is_cuda:
        return recurrence_fwd(xg, valid, w, G, compute_dtype)
    cd, name = compute_dtype, wrapper.__name__
    dev, T, D, B, H, valid8 = _recurrence_operands(xg, valid, w, G, cd, name)
    check(H, cd)
    wf = copy(w)
    hs = torch.empty((T, D, B, H), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    hn = torch.zeros((D, B, H), dtype=torch.float32, device=dev)
    cn = torch.zeros_like(hn)
    if B * D == 0 or T == 0:
        return hs, cs, hn, cn
    R, tiles, smem = wide_plan(plan, B, G, H, _max_clusters(name, cd, H, dev), dirs=D)
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            R, xg.data_ptr(), valid8.data_ptr(), wf.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            hn.data_ptr(), cn.data_ptr(), D, T, B, H, G, tiles, smem,
            torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    return hs, cs, hn, cn


def _mma_copy(w: torch.Tensor, wf: Optional[torch.Tensor]) -> torch.Tensor:
    """``wf`` checked as the bf16 fragment copy of ``w``'s shape, or that
    copy built (``recurrence_mma_weights``)."""
    if wf is None:
        return recurrence_mma_weights(w)
    D, G, H, _ = w.shape
    _check("wf", wf, (D, G, H // 8, H // 16, 2, 32, 8), torch.bfloat16, w.device)
    return wf


def _f32_copy(w: torch.Tensor, wf: Optional[torch.Tensor]) -> torch.Tensor:
    """``wf`` checked as the f32 fragment copy of ``w``'s shape, or that
    copy built (``recurrence_f32_weights``)."""
    if wf is None:
        return recurrence_f32_weights(w)
    D, G, H, _ = w.shape
    _check("wf", wf, (D, G, H // 8, H // 8, 2, 32, 4), torch.float32, w.device)
    return wf


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
    wf: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The recurrence's backward sweep; the contract of
    ``ops/lstm_recurrence.py:recurrence_sweep``: the masked f32 gate
    cotangents ``dxg (T, D, B, 4H)``. ``dhs (T, D, B, H)`` and ``dhn``,
    ``dcn (D, B, H)`` are f32, or None for zero.

    On the card the sweep runs the kernel ``recurrence_sweep_kernel`` names
    for its width and dtype (or ``kernel``, one of those names), a
    tensor-core one: through :func:`lstm_recurrence_bwd_mma`,
    :func:`lstm_recurrence_bwd_f32`, :func:`lstm_recurrence_bwd_wide_mma`,
    :func:`lstm_recurrence_bwd_wide_f32`,
    :func:`lstm_recurrence_bwd_mid_f32` or
    :func:`lstm_recurrence_bwd_mid_mma`, whose ``.launches`` counts it;
    ``wf``, the fragment copy of ``w`` where the caller has it, goes to the
    last four: ``recurrence_mma_weights(w)`` in bf16,
    ``recurrence_f32_weights(w)`` in f32. This function launches nothing
    itself."""
    _no_graph(xg, w, hs, cs)
    if not xg.is_cuda:
        return recurrence_sweep(xg, valid, w, hs, cs, dhs, dhn, dcn, G, compute_dtype)
    cd = compute_dtype
    if kernel not in (None, "lstm_recurrence_bwd_mid_f32", "lstm_recurrence_bwd_mid_mma",
                      *_TILE_SWEEP, *_WIDE_SWEEP):
        raise ValueError(f"lstm_recurrence_bwd: no sweep kernel named {kernel!r}")
    _, _, _, _, H, _ = _recurrence_sweep_operands(
        "lstm_recurrence_bwd", xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    kernel = kernel or recurrence_sweep_kernel(H, cd)
    if kernel in _TILE_SWEEP:
        return _TILE_SWEEP[kernel](xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    if kernel == "lstm_recurrence_bwd_mid_f32":
        return lstm_recurrence_bwd_mid_f32(xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd, wf)
    if kernel == "lstm_recurrence_bwd_mid_mma":
        return lstm_recurrence_bwd_mid_mma(xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd, wf)
    return _WIDE_SWEEP[kernel](xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd, wf)


# it launches nothing itself: the count stays 0 (the steps' launch checks
# hold it there, as they did while it had a kernel of its own)
lstm_recurrence_bwd.launches = 0




def lstm_recurrence_bwd_wide_mma(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: Optional[torch.Tensor], dhn: Optional[torch.Tensor], dcn: Optional[torch.Tensor],
    G: int, compute_dtype: torch.dtype, wf: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The recurrence's backward sweep on the tensor cores past 288 units
    (``csrc/lstm_recurrence_bwd_wide_mma.cu``: 8-block clusters, both
    products on ``mma.sync`` from the bf16 weight fragments in L2, the
    partial dh summed in rank order); the contract of
    :func:`lstm_recurrence_bwd`. ``wf`` is the fragment copy
    ``recurrence_mma_weights(w)`` where the caller has it (the forward's),
    else it is built here. Takes bfloat16 with H % 32 == 0 from 320 to
    ``REC_MAX_H`` and raises for the rest."""
    return _wide_recurrence_sweep(lstm_recurrence_bwd_wide_mma, recurrence_wide_mma_check,
                                  "rec_bwd_mma", lambda w: _mma_copy(w, wf), xg, valid, w, hs,
                                  cs, dhs, dhn, dcn, G, compute_dtype)


lstm_recurrence_bwd_wide_mma.launches = 0


def lstm_recurrence_bwd_wide_f32(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: Optional[torch.Tensor], dhn: Optional[torch.Tensor], dcn: Optional[torch.Tensor],
    G: int, compute_dtype: torch.dtype, wf: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The recurrence's backward sweep in f32 on the tensor cores past 288
    units, three tf32 passes a product (``csrc/lstm_recurrence_bwd_wide_f32.cu``:
    the design of :func:`lstm_recurrence_bwd_wide_mma` on an f32 copy of the
    weight fragments, ``recurrence_f32_weights``, split in registers); the
    contract of :func:`lstm_recurrence_bwd`. ``wf`` is that copy of ``w``
    where the caller has it (the forward's), else it is built here. Takes
    float32 with H % 32 == 0 from 320 to ``REC_MAX_H`` and raises for the
    rest."""
    return _wide_recurrence_sweep(lstm_recurrence_bwd_wide_f32, recurrence_wide_f32_check,
                                  "rec_bwd_f32", lambda w: _f32_copy(w, wf), xg, valid, w, hs,
                                  cs, dhs, dhn, dcn, G, compute_dtype)


lstm_recurrence_bwd_wide_f32.launches = 0


def lstm_recurrence_bwd_mid_f32(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: Optional[torch.Tensor], dhn: Optional[torch.Tensor], dcn: Optional[torch.Tensor],
    G: int, compute_dtype: torch.dtype, wf: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The recurrence's backward sweep in f32 on the tensor cores at 96-288
    units, three tf32 passes a product (``csrc/lstm_recurrence_bwd_mid_f32.cu``:
    clusters of 4 or 8 blocks, each holding its share of the f32 fragment
    copy of the weights, ``recurrence_f32_weights``, in shared memory (read
    from L2 at 288); the (unit group, n8 tile) items dealt over the warps;
    the partial dh summed in rank order); the contract of
    :func:`lstm_recurrence_bwd`. ``wf`` is that copy of ``w`` where the
    caller has it, else it is built here. Takes float32 at H in
    ``REC_MID_F32_WIDTHS`` and raises for the rest; the launch is
    ``recurrence_mid_f32_plan``'s. On the CPU the plain twin; under grad
    mode an operand that requires grad is refused."""
    _no_graph(xg, w, hs, cs)
    if not xg.is_cuda:
        return recurrence_sweep(xg, valid, w, hs, cs, dhs, dhn, dcn, G, compute_dtype)
    cd, name = compute_dtype, "lstm_recurrence_bwd_mid_f32"
    dev, T, D, B, H, valid8 = _recurrence_sweep_operands(
        name, xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    recurrence_mid_f32_check(H, cd)
    dxg = torch.empty((T, D, B, 4 * H), dtype=torch.float32, device=dev)
    if B * D * T == 0:
        return dxg
    count = _max_clusters(name, cd, H, dev)
    cluster, resident, rows, tiles, smem = recurrence_mid_f32_plan(
        B, G, H, lambda c, r, R, smem: count(R, smem, c, int(r)), dirs=D)
    wf = _f32_copy(w, wf)
    with torch.cuda.device(dev):
        err = _kernels(name).lstm_recurrence_bwd_mid_f32(
            cluster, int(resident), rows, xg.data_ptr(), valid8.data_ptr(), wf.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), _opt_ptr(dhs), _opt_ptr(dhn), _opt_ptr(dcn),
            dxg.data_ptr(), D, T, B, H, G, tiles, smem,
            torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    lstm_recurrence_bwd_mid_f32.launches += 1
    return dxg


lstm_recurrence_bwd_mid_f32.launches = 0


def lstm_recurrence_bwd_mid_mma(
    xg: torch.Tensor, valid: torch.Tensor, w: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
    dhs: Optional[torch.Tensor], dhn: Optional[torch.Tensor], dcn: Optional[torch.Tensor],
    G: int, compute_dtype: torch.dtype, wf: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The recurrence's backward sweep in bf16 on the tensor cores at 96-288
    units (``csrc/lstm_recurrence_bwd_mid_mma.cu``: clusters of 4 or 8
    blocks, each holding its share of the bf16 fragment copy of the
    weights, ``recurrence_mma_weights``, in shared memory; the (unit group,
    n8 tile) items dealt over the warps; the partial dh summed in rank
    order); the contract of :func:`lstm_recurrence_bwd`. ``wf`` is that copy
    of ``w`` where the caller has it (the forward's), else it is built here.
    Takes bfloat16 at H in ``REC_MID_MMA_WIDTHS`` and raises for the rest;
    the launch is ``recurrence_mid_mma_plan("bwd", ...)``'s. On the CPU the
    plain twin; under grad mode an operand that requires grad is refused."""
    _no_graph(xg, w, hs, cs)
    if not xg.is_cuda:
        return recurrence_sweep(xg, valid, w, hs, cs, dhs, dhn, dcn, G, compute_dtype)
    cd, name = compute_dtype, "lstm_recurrence_bwd_mid_mma"
    dev, T, D, B, H, valid8 = _recurrence_sweep_operands(
        name, xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    recurrence_mid_mma_check(H, cd)
    dxg = torch.empty((T, D, B, 4 * H), dtype=torch.float32, device=dev)
    if B * D * T == 0:
        return dxg
    count = _max_clusters(name, cd, H, dev)
    cluster, rows, tiles, smem = recurrence_mid_mma_plan(
        "bwd", B, G, H, lambda c, R, m: count(R, m, c), dirs=D)
    wf = _mma_copy(w, wf)
    with torch.cuda.device(dev):
        err = _kernels(name).lstm_recurrence_bwd_mid_mma(
            cluster, rows, xg.data_ptr(), valid8.data_ptr(), wf.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), _opt_ptr(dhs), _opt_ptr(dhn), _opt_ptr(dcn), dxg.data_ptr(), D, T,
            B, H, G, tiles, smem, torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    lstm_recurrence_bwd_mid_mma.launches += 1
    return dxg


lstm_recurrence_bwd_mid_mma.launches = 0
# the recurrence sweeps past 288 on the tensor cores, by kernel name
_WIDE_SWEEP = {"lstm_recurrence_bwd_wide_mma": lstm_recurrence_bwd_wide_mma,
               "lstm_recurrence_bwd_wide_f32": lstm_recurrence_bwd_wide_f32}


def _wide_recurrence_sweep(wrapper, check, plan, copy, xg, valid, w, hs, cs, dhs, dhn, dcn, G,
                           compute_dtype):
    """The tensor-core recurrence sweeps' body past 288: ``wrapper`` names
    the kernel (``csrc/<name>.cu``: 8-block clusters reading the weight
    fragments from L2), ``check(H, dtype)`` refuses what it does not take,
    ``wide_plan(plan, ...)`` picks its row tile, ``copy(w)`` lays out its
    weight fragments; it counts its launches. On the CPU the plain twin;
    under grad mode an operand that requires grad is refused."""
    _no_graph(xg, w, hs, cs)
    if not xg.is_cuda:
        return recurrence_sweep(xg, valid, w, hs, cs, dhs, dhn, dcn, G, compute_dtype)
    cd, name = compute_dtype, wrapper.__name__
    dev, T, D, B, H, valid8 = _recurrence_sweep_operands(
        name, xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    check(H, cd)
    dxg = torch.empty((T, D, B, 4 * H), dtype=torch.float32, device=dev)
    if B * D * T == 0:
        return dxg
    R, tiles, smem = wide_plan(plan, B, G, H, _max_clusters(name, cd, H, dev), dirs=D)
    wf = copy(w)
    with torch.cuda.device(dev):
        err = getattr(_kernels(name), name)(
            R, xg.data_ptr(), valid8.data_ptr(), wf.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            _opt_ptr(dhs), _opt_ptr(dhn), _opt_ptr(dcn), dxg.data_ptr(), D, T, B, H, G, tiles,
            smem, torch.cuda.current_stream(dev).cuda_stream, None,
        )
    _raise_on_error(name, err)
    wrapper.launches += 1
    return dxg


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
    compute dtype alone: ``"lstm_recurrence_wgrad_mma"`` for bfloat16,
    ``"lstm_recurrence_wgrad_f32"`` for float32 (three tf32 passes), both on
    the tensor cores at every width the op takes; ValueError for what
    neither takes (``recurrence_check``)."""
    recurrence_check(H, compute_dtype)
    if compute_dtype == torch.bfloat16:
        return "lstm_recurrence_wgrad_mma"
    return "lstm_recurrence_wgrad_f32"


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


def recurrence_wgrad_f32_smem(tile_n: int) -> int:
    """Dynamic shared memory (bytes) of the f32 recurrence wgrad's 64 x
    ``tile_n`` tile: ``REC_WGRAD_F32_STAGES`` stages of 32 rows of both
    operands' f32 tile widths plus 8 (both fit the blocks an SM it holds)."""
    return (REC_WGRAD_F32_STAGES * REC_WGRAD_F32_TILE_K
            * (REC_WGRAD_F32_TILE_M + tile_n + 16) * 4)


def recurrence_wgrad_f32_plan(T: int, B: int, D: int, G: int, H: int, sms: int,
                              tile_n: Optional[int] = None) -> Tuple[int, int, int]:
    """``(m_tiles, n_tiles, splits)`` of the f32 tensor-core recurrence
    wgrad with block tile 64 x ``tile_n`` (``REC_WGRAD_F32_TILE_N`` when
    None): 64-column tiles of the H h columns (the last one partly
    zero where H % 64 == 32), ``tile_n``-column tiles of the 4H gates, and
    the split of each group's ``(T - 1) * B / G`` rows whose blocks fill the
    card's ``sms`` SMs in whole waves best, at the tile's blocks an SM
    (``REC_WGRAD_F32_BLOCKS``), as ``wgrad_f32_plan`` splits; at least one
    split and no more splits than K-tiles."""
    tile_n = tile_n or REC_WGRAD_F32_TILE_N
    m_tiles = -(-H // REC_WGRAD_F32_TILE_M)
    n_tiles = 4 * H // tile_n
    k_tiles = max(1, -(-max(0, T - 1) * (B // G) // REC_WGRAD_F32_TILE_K))
    per_split = m_tiles * n_tiles * D * G
    return m_tiles, n_tiles, _whole_wave_splits(per_split, k_tiles,
                                                sms * REC_WGRAD_F32_BLOCKS[tile_n])


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

    On the card it runs the tensor-core kernel ``recurrence_wgrad_kernel``
    names for the width and dtype, through :func:`lstm_recurrence_wgrad_mma`
    (bf16) or :func:`lstm_recurrence_wgrad_f32` (f32), whose ``.launches``
    then counts it. ``kernel="lstm_recurrence_wgrad"`` asks for
    ``csrc/lstm_recurrence_wgrad.cu`` (CUDA cores, either dtype) by name,
    to time it beside them; it runs on no path."""
    _no_graph(hs, dxg)
    if not hs.is_cuda:
        return recurrence_wgrad(hs, dxg, G, compute_dtype)
    cd = compute_dtype
    name = "lstm_recurrence_wgrad"
    tensor_core = {"lstm_recurrence_wgrad_mma": lstm_recurrence_wgrad_mma,
                   "lstm_recurrence_wgrad_f32": lstm_recurrence_wgrad_f32}
    if kernel not in (None, name, *tensor_core):
        raise ValueError(f"lstm_recurrence_wgrad: no weight-gradient kernel named {kernel!r}")
    dev, T, D, B, H = _recurrence_wgrad_operands(hs, dxg, G, cd, name)
    kernel = kernel or recurrence_wgrad_kernel(H, cd)
    if kernel in tensor_core:
        return tensor_core[kernel](hs, dxg, G, cd)
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


def lstm_recurrence_wgrad_f32(hs: torch.Tensor, dxg: torch.Tensor, G: int,
                              compute_dtype: torch.dtype,
                              tile_n: Optional[int] = None) -> torch.Tensor:
    """The recurrence's weight gradient in f32 on the tensor cores, three
    tf32 passes a product (``csrc/lstm_recurrence_wgrad_f32.cu``: a split-K
    GEMM over a cp.async ring of the f32 streams); the contract of
    :func:`lstm_recurrence_wgrad`. Takes compute dtype float32 at every
    width the op takes and raises for the rest; block tile 64 x
    ``REC_WGRAD_F32_TILE_N`` (``tile_n`` pins the other of
    ``REC_WGRAD_F32_BLOCKS``, to time it), split by
    ``recurrence_wgrad_f32_plan``. Every block writes its partial tile,
    empty row ranges included; with no row (``T <= 1`` or an empty batch)
    it returns zeros without a launch. Its output carries no graph, so
    under grad mode it refuses an operand that requires grad, on the CPU
    too."""
    _no_graph(hs, dxg)
    if not hs.is_cuda:
        return recurrence_wgrad(hs, dxg, G, compute_dtype)
    cd = compute_dtype
    name = "lstm_recurrence_wgrad_f32"
    dev, T, D, B, H = _recurrence_wgrad_operands(hs, dxg, G, cd, name)
    if recurrence_wgrad_kernel(H, cd) != name:
        raise ValueError(f"{name} kernel takes compute dtype float32, got {cd}")
    if tile_n is not None and tile_n not in REC_WGRAD_F32_BLOCKS:
        raise ValueError(f"{name} is built for 64 x {sorted(REC_WGRAD_F32_BLOCKS)} tiles, "
                         f"got 64 x {tile_n}")
    if B * D == 0 or T <= 1:
        return torch.zeros((D, G, H, 4 * H), dtype=torch.float32, device=dev)
    tile_n = tile_n or REC_WGRAD_F32_TILE_N
    _, _, splits = recurrence_wgrad_f32_plan(T, B, D, G, H, _sm_count(dev), tile_n)
    partial = torch.empty((splits, D, G, H, 4 * H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _kernels(name).lstm_recurrence_wgrad_f32(
            hs.data_ptr(), dxg.data_ptr(), partial.data_ptr(), D, T, B, H, G, splits, tile_n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(name, err)
    lstm_recurrence_wgrad_f32.launches += 1
    return partial.sum(dim=0)


lstm_recurrence_wgrad_f32.launches = 0
