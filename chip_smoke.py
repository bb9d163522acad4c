#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``intrepppid_tpu_torch``) on one
NVIDIA card, from a checkout of the repository:

    python3 chip_smoke.py

Phases, each printing one JSON line (a failed check raises, and the script
exits non-zero with no result):

1. build — compile every kernel from ``intrepppid_tpu_torch/csrc`` with
   ``nvcc`` (and the native tokenizer with ``g++``) in parallel, and print
   the ``-Xptxas -v`` summary (registers, shared memory, spills);
2. kernel — the bidirectional-LSTM layer forward (eval variant) against its
   plain PyTorch version on the card, at the serve path's shapes (800 rows,
   T = 1500, H = 64, layer 0 at E = 64 and layer 1 at E = 2 x 64) in f32
   (``bilstm_fwd_f32``, three tf32 passes on the tensor cores) and bf16
   (``bilstm_fwd_mma``), and the CUDA-core ``bilstm_fwd.cu`` asked for by
   name, with lengths mixing 0, 1, T and random values, plus H = 32 at a
   smaller size; then the kernel and the CUDA-core one in turns (new, old,
   old, new), the plain version and cuDNN's ``nn.LSTM(bidirectional=True)``
   (a yardstick the port never calls) timed with CUDA events at full
   lengths;
3. serve — ``Serve.start`` at the manuscript width (vocab 250, E = 64,
   2 layers, f32) with seeded random weights written as a reference-layout
   ``.ckpt``, answering real HTTP requests on 127.0.0.1; probabilities are
   checked against the port's CPU plain forward, and the f32 tensor-core
   forward's launch counter must rise during the requests and
   ``bilstm_fwd.cu``'s stay at 0;
4. train_kernel — the train step's kernels (the forward in both variants,
   the two backward sweeps and the weight-gradient kernel) against their
   plain versions at the train shapes (400 rows in 5 weight groups of 80,
   T = 1500, H = 64, layer 0 at E = 64 with grouped W_hh and layer 1 at
   E = 2 x 64) in f32 and bf16, lengths mixing 0, 1, T, random values and
   per-group maxima: in bf16 the forward, the sweep and wgrad are the
   tensor-core kernels (``bilstm_layer_fwd(_train)_mma``,
   ``bilstm_bwd_mma``, ``bilstm_wgrad_mma``), in f32 the forward, the sweep
   and wgrad are the 3xTF32 tensor-core kernels
   (``bilstm_layer_fwd(_train)_f32``, ``bilstm_bwd_f32``,
   ``bilstm_wgrad_f32``), and the CUDA-core ones, asked for by name, are
   held too, and the twins with their products in one tf32 pass are
   recorded beside them (a control for the f32 tolerance); ragged cases (27
   rows in 3 groups, T = 1, rows of length 0; the one-stage f32 sweep at
   E = H = 80, T = 1 and 5); at their own main path's shapes (layer 0 of
   the two-layer model at embedding 80: E = H = 80, 5 groups, two dy
   streams a direction) ``bilstm_fwd.cu`` (both variants) in f32 and
   bf16, ``bilstm_wgrad.cu`` in f32 and ``bilstm_wgrad_mma`` (its last
   gate tile masked) in bf16 (in turns with ``bilstm_wgrad.cu`` by name),
   the one-stage 3xTF32 sweep ``bilstm_bwd_f32_onestage`` in f32 (in turns
   with ``bilstm_bwd.cu`` by name) and ``bilstm_bwd.cu`` in bf16; then
   each kernel, the
   new and the old in turns (new, old, old, new, in the same run), and a
   PyTorch yardstick
   (cuDNN training and inference forward and backward-data in f32 and in
   bf16, cuBLAS products in the same dtype) timed with CUDA events at full
   lengths, TF32 off; the plain versions are timed once, in the check;
5. train — ``intrepppid_network(compute_dtype=bfloat16,
   optimizer_type="ranger21_xx")`` on the card and the port's ``Trainer``
   on synthetic quintuplet batches (80 pairs, T = 1500, dropout on): 2
   warm-up steps, 12 timed steps and an eval step, a profiled step, and
   each kernel's launch count: the tensor-core forward (both variants),
   ``bilstm_bwd_mma`` and ``bilstm_wgrad_mma`` must be > 0 and the
   CUDA-core forward, sweep and wgrad and the f32 tensor-core kernels 0;
   then 2 steps of the same model in f32 (and a profiled one), which must
   run ``bilstm_layer_fwd_train_f32``, ``bilstm_bwd_f32`` and
   ``bilstm_wgrad_f32`` and never the CUDA-core forward or wgrad, and 2
   steps and an eval step of the two-layer model at embedding 80 in f32 and
   in bf16: layer 0's forward (both variants) ``bilstm_fwd.cu``, its wgrad
   ``bilstm_wgrad.cu`` in f32 and ``bilstm_wgrad_mma`` in bf16 (and
   ``bilstm_wgrad.cu`` never), its sweep ``bilstm_bwd_f32_onestage`` in
   f32 and ``bilstm_bwd.cu`` in bf16; the stacked layer padded to H = 96 on the
   wide route; then one step's gradients (and at embedding 80 an eval step)
   on the card held against the port's CPU plain path at a small size, in
   f32 and bf16 (also at embedding 80, two layers);
5b. widths — the layers the width repairs open (``ops/lstm_cuda.py:
   padded_width``, ``padded_parts``: the stacked layer at embedding 80, run
   at H = 96; both layers at embedding 112 and 100, run at 128 with parts
   of 112; layer 0 at embedding 50, run at H = 64 with E = 56 in f32 and
   64 in bf16; both layers at 272, run at 288), 400 rows, T = 1500, f32 and
   bf16: ``layer_fwd`` and ``layer_bwd`` against the plain layer at the
   true widths, the kernels they ran, their times beside their bounds at
   the true and the padded widths and cuDNN at the true ones; the
   two-layer model at embedding 100 at the train shape (80 pairs,
   T = 1500, dropout on: 2 steps and an eval step) in f32 and bf16 and at
   272 in bf16, each with the kernels it must launch and must not; the
   288-thread CUDA-core wide forward (both variants) and lite sweep at
   their main path's shapes (layer 0 at embedding 272) against their
   twins, timed beside their bounds and cuDNN; then a gradient step and
   an eval step on the card against the CPU at small size (8 pairs,
   T = 64), in f32 and bf16, of two-layer models at embedding 48, 50, 100,
   112 and (bf16) 272 and of the recurrence backend at embedding 80 (run
   at 96), each with the kernels it must launch;
6. wide_kernel — the wide route's kernels (input gates, the cluster
   forward in both variants, the lite sweep) and the weight-gradient
   kernel against their plain versions at the scaled configuration's
   shapes (400 rows in 5 groups of 80, T = 1500, H = 256, layer 0 at
   E = 256 with grouped W_hh and a stacked layer at E = 2 x 256) in f32 and
   bf16, at H = 128 (T = 300), and the resident forward, sweep and wgrad at
   H = 32 (T = 300); in bf16 the input gates are ``bilstm_gates_mma``, the
   wide forward ``bilstm_fwd_wide(_train)_mma``, the lite sweep
   ``bilstm_bwd_lite_mma`` and wgrad ``bilstm_wgrad_mma``, in f32 wgrad is
   ``bilstm_wgrad_f32``, and the CUDA-core kernels, asked for by name, are
   held too; the input gates computed twice must agree bit for bit (the
   backward recomputes them), and so must the tensor-core forward's hs in
   its two variants; ragged cases of the tensor-core kernels (27 rows in 3
   groups and in 1, T = 1 and 5, every row tile of the forward and the
   sweep; wgrad in both dtypes); then each timed with CUDA events at full
   lengths beside its plain version and a PyTorch yardstick in the same
   dtype (cuBLAS ``addmm``, in bf16 with ``out_dtype=float32``; cuDNN), TF32
   off; in bf16 the gates, the forward (both variants), the sweep and wgrad
   new, old, old, new, and the forward and the sweep at each of their row
   tiles; in f32 wgrad new, old, old, new;
7. train_scaled — the scaled configuration (embedding 256, 3 layers,
   bf16, ``ranger21_xx``, 80 pairs, T = 1500, dropout on): 2 warm-up
   steps, 6 timed steps and one eval step, whose launches must go through
   ``bilstm_gates_mma``, ``bilstm_fwd_wide(_train)_mma``,
   ``bilstm_bwd_lite_mma`` and ``bilstm_wgrad_mma`` and never through the
   resident kernels or the CUDA-core gates, forward, sweep and wgrad, a
   profiled step and peak memory; then one step's gradients at embedding
   256 and 3 layers held against the CPU plain path in f32, with an eval
   step after it (which must run ``bilstm_gates.cu``,
   ``bilstm_fwd_wide.cu`` in both variants and ``bilstm_bwd_lite.cu``:
   their main path, and ``bilstm_wgrad_f32``) and in bf16 (which must run
   the tensor-core ones);
8. recurrence_kernel — the time-major recurrence op's kernels (forward,
   sweep, weight gradient) against their plain versions at T = 1500,
   D = 2, 400 rows: H = 64 with 5 weight groups and with 1, H = 256 with 5
   groups, and H = 32 at T = 300; f32 and bf16; masks built from lengths
   (mixing 0, 1, T and random values; a suffix for the reverse direction)
   and a random mask with holes, an all-zero and an all-one row. At H = 64
   and 32 the sweep is a tensor-core kernel (``lstm_recurrence_bwd_mma`` in
   bf16, ``lstm_recurrence_bwd_f32`` in f32, three tf32 passes), and in bf16
   the weight gradient is ``lstm_recurrence_wgrad_mma``; the cluster sweep
   and the CUDA-core wgrad, asked for by name, are held and timed beside
   them (new, old, old, new); ragged cases (27 rows in 3 groups, T = 1, 2
   and 5); the cluster sweep at its own main path's shapes (H = 128, 5
   groups, f32). Each is timed
   with CUDA events beside its plain version and a PyTorch yardstick (one
   bidirectional ``nn.LSTM`` layer at full lengths, in f32 and at H = 64
   and 32 in bf16, which also does the input projection; for the weight
   gradient one batched cuBLAS product on the rounded operands and, in
   bf16, the rounding, layout and product together); then the op past 256
   units (H = 288 on the cluster kernels' 288-thread instance, 512 and
   1024 on the global-weight one) against its twins, and one call at
   H = 512 (400 rows, T = 300) timed beside its bound and cuDNN;
9. recurrence_path — with ``ops.lstm.DEFAULT_BACKEND = "recurrence"``, the
   manuscript-width bf16 train step of phase 5 (2 warm-up and 4 timed
   steps, one eval step): the forward, ``lstm_recurrence_bwd_mma`` and
   ``lstm_recurrence_wgrad_mma`` must be > 0, the cluster sweep, the
   CUDA-core wgrad and the layer kernels 0; then 2 f32 steps (and a
   profiled one), whose sweep and wgrad must be ``lstm_recurrence_bwd_f32``
   and the CUDA-core wgrad alone, and 2 f32 steps of a one-layer model at
   embedding 128, whose sweep only the cluster kernel takes; a profiled
   step, peak memory, and the card's gradients against the CPU's on the
   same backend, in f32 and in bf16, and of a one-layer model at embedding
   320 (the forward and the cluster sweep on their global-weight
   instance);
10. infer — ``python -m intrepppid_tpu_torch infer from_csv`` on a
    synthetic proteome (1200 sequences of 200-3000 residues, 4000 pairs,
    ``tests/fixtures/golden_spm.model``, manuscript width, ``trunc_len``
    1500, batch 64, seeded weights): 4000 rows in input order, the first
    batch's 64 probabilities against the same command on the CPU, the
    f32 tensor-core eval forward's launch count (``bilstm_fwd.cu``'s must
    stay 0); file-to-file seconds and pairs/s, and where the time goes;
11. the ``kernels`` line (twenty-seven kernels, each with launches > 0 on
    a main path; the 288-thread instances, the bf16 wgrad at H = 80 and
    the recurrence op past 288 as ``h288_*``, ``h80_*`` and ``h512_*``
    fields of their kernels' entries), the card's name and power limit,
    and the result.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the repository beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
# serve path: bulk rung of 400 pairs = 800 encoder rows, top bucket 1500
B_SERVE, T_SERVE, H_SERVE, E_SERVE = 800, 1500, 64, 64
# train path: 80 pairs x 5 encoder calls = 400 rows in 5 weight groups
PAIRS_TRAIN, G_TRAIN = 80, 5
B_TRAIN = PAIRS_TRAIN * G_TRAIN
T_TRAIN = 1500
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the scaled configuration: BASELINE.json configs[4],
# tools/experiment_scaled_config.py:27-33 (embedding = hidden 256, 3 layers)
E_SCALED, LAYERS_SCALED = 256, 3
# H100 SXM published peaks (dense): f32 on CUDA cores, bf16 and tf32 on
# tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
AAS = "ACDEFGHIKLMNPQRSTVWY"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ build
def phase_build() -> dict:
    from intrepppid_tpu_torch.native import load_spm_library
    from intrepppid_tpu_torch.ops import _build
    from intrepppid_tpu_torch.ops.lstm_cuda import (
        FWD_WIDE_MMA_ROWS,
        FWD_WIDE_MMA_WIDTHS,
        GATES_MMA_SMEM,
        LITE_MMA_ROWS,
        REC_WGRAD_MMA_SMEM,
        SMEM_LIMIT,
        WGRAD_F32_SMEM,
        WGRAD_MMA_SMEM,
        bwd_f32_onestage_plan,
        bwd_f32_plan,
        bwd_launch_plan,
        bwd_mma_plan,
        fwd_f32_plan,
        fwd_mma_plan,
        WIDE_ROWS,
        launch_plan,
        recurrence_f32_smem,
        recurrence_mma_smem,
        wide_smem,
    )

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        native = pool.submit(load_spm_library)
        libs = _build.build()
        native_ok = native.result() is not None
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for name, log in _build.build_logs.items()
    }
    # the kernel's shared memory is dynamic, so ptxas does not report it
    smem = {
        f"{kernel} {str(dtype).replace('torch.', '')} E={E}": plan([E], H_SERVE, dtype)[2]
        for kernel, plan in (("fwd", launch_plan), ("bwd", bwd_launch_plan))
        for dtype in (torch.float32, torch.bfloat16)
        for E in (E_SERVE, 2 * H_SERVE)
    }
    for E_parts in ([E_SERVE], [H_SERVE, H_SERVE]):
        smem[f"bwd_mma bfloat16 E={sum(E_parts)}"] = bwd_mma_plan(
            E_parts, H_SERVE, torch.bfloat16)[1]
        smem[f"fwd_mma (static) bfloat16 E={sum(E_parts)}"] = fwd_mma_plan(
            E_parts, H_SERVE, torch.bfloat16)[1]
        smem[f"bwd_f32 float32 E={sum(E_parts)}"] = bwd_f32_plan(
            E_parts, H_SERVE, torch.float32)[1]
        for rows in (8, 16):
            smem[f"fwd_f32 float32 E={sum(E_parts)} rows={rows}"] = fwd_f32_plan(
                E_parts, H_SERVE, torch.float32, rows)[1]
    smem["bwd_f32_onestage float32 E=H=80"] = bwd_f32_onestage_plan([80], 80, torch.float32)[1]
    smem[f"recurrence_bwd_mma H={H_SERVE}"] = recurrence_mma_smem(H_SERVE)
    smem[f"recurrence_bwd_f32 H={H_SERVE}"] = recurrence_f32_smem(H_SERVE)
    smem["wgrad_mma"] = WGRAD_MMA_SMEM
    smem["wgrad_f32"] = WGRAD_F32_SMEM
    smem["recurrence_wgrad_mma"] = REC_WGRAD_MMA_SMEM
    smem["gates_mma"] = GATES_MMA_SMEM
    for H in (128, E_SCALED):
        for rows in LITE_MMA_ROWS:
            if wide_smem("lite_mma", H, rows) <= SMEM_LIMIT:
                smem[f"bwd_lite_mma H={H} rows={rows}"] = wide_smem("lite_mma", H, rows)
    for H in FWD_WIDE_MMA_WIDTHS:
        for rows in FWD_WIDE_MMA_ROWS:
            smem[f"fwd_wide_mma H={H} rows={rows}"] = wide_smem("fwd_mma", H, rows)
    # the 288-thread instances of the CUDA-core cluster kernels, and the
    # recurrence kernels' global-weight instance (no weight slice in shared memory)
    for kind in ("fwd", "bwd"):
        for R in WIDE_ROWS:
            if wide_smem(kind, 288, R) <= SMEM_LIMIT:
                smem[f"{kind}_wide H=288 R={R}"] = wide_smem(kind, 288, R)
        for H in (320, 512, 1024):
            smem[f"recurrence_{kind} H={H} R=2 (global weights)"] = wide_smem(kind, H, 2)
    out = {"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
           "kernels": sorted(libs), "ptxas": ptxas,
           "dynamic_smem_bytes": smem, "native_tokenizer": native_ok}
    emit(out)
    return out


# ----------------------------------------------------------------- kernel
def layer_inputs(B, T, E_parts, H, dtype, dev, seed, full_lengths=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    parts = tuple(
        (torch.rand(T, B, e, generator=g, device=dev) * 2 - 1).to(dtype)
        for e in E_parts
    )
    k = 1.0 / H ** 0.5

    def u(*shape):
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * k

    w_ih = u(2, 4 * H, sum(E_parts)).to(dtype).contiguous()
    w_hh = u(2, 4 * H, H).to(dtype).contiguous()
    bias = (u(2, 4 * H) + u(2, 4 * H)).contiguous()
    if full_lengths:
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    else:
        lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev,
                                dtype=torch.int32)
        lengths[0], lengths[1], lengths[2] = 0, 1, T
        lengths[3::4] = T
    return parts, lengths, w_ih, w_hh, bias


def rel_err(got, want, tol):
    """(max abs error, whether it is within tol x max(1, max|want|))."""
    a, b = got.float(), want.float()
    e, scale = float((a - b).abs().max()), max(1.0, float(b.abs().max()))
    return e, e <= tol * scale


def scaled_err(got, want) -> float:
    """max |got - want| / max(1, max|want|): what the tolerances bound."""
    a, b = got.float(), want.float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def time_ms(fn, reps: int) -> float:
    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_work(B, T, E, H, size) -> tuple:
    """(flops, bytes) one bidirectional layer needs at full lengths:
    4H * (E + H) multiply-adds per row, step and direction; each input read
    once and each output written once."""
    flops = 2 * 2 * B * T * 4 * H * (E + H)
    nbytes = (T * B * E * size + 2 * T * B * H * size + B * 4
              + 2 * 4 * H * (E + H) * size + 2 * 4 * H * 4 + 2 * 2 * B * H * 4)
    return flops, nbytes


def phase_kernel(dev) -> dict:
    from intrepppid_tpu_torch.ops.lstm_cuda import (
        bilstm_layer_fwd,
        bilstm_layer_fwd_plain,
        fwd_kernel,
    )

    checks = []
    cases = [
        (B_SERVE, T_SERVE, H_SERVE, parts, dtype)
        for dtype in (torch.float32, torch.bfloat16)
        for parts in ([E_SERVE], [H_SERVE, H_SERVE])
    ] + [
        (96, 300, 32, parts, dtype)
        for dtype in (torch.float32, torch.bfloat16)
        for parts in ([32], [32, 32])
    ]
    for i, (B, T, H, E_parts, dtype) in enumerate(cases):
        args = layer_inputs(B, T, E_parts, H, dtype, dev, SEED + i)
        got = bilstm_layer_fwd(*args, dtype)
        want = bilstm_layer_fwd_plain(*args, dtype)
        # and the CUDA-core kernel by name, on the same operands
        old = bilstm_layer_fwd(*args, dtype, kernel="bilstm_fwd")
        torch.cuda.synchronize()
        names = ("hs_f", "hs_b", "hn", "cn")
        errs = {name: float((a.float() - b.float()).abs().max())
                for name, a, b in zip(names, got, want)}
        errs.update({f"cuda_core_{name}": float((a.float() - b.float()).abs().max())
                     for name, a, b in zip(names, old, want)})
        check = {"B": B, "T": T, "H": H, "E_parts": E_parts,
                 "dtype": str(dtype).replace("torch.", ""),
                 "kernel": fwd_kernel(E_parts, H, dtype),
                 "max_abs_err": errs, "tol": TOL[dtype]}
        checks.append(check)
        del got, want, old, args
        if not max(errs.values()) <= TOL[dtype]:
            emit({"phase": "kernel", "failed": check})
            raise AssertionError(f"bilstm kernel disagrees with its plain version: {check}")

    # the dispatched kernel (in f32 the 3xTF32 forward, in bf16 the
    # tensor-core one) and the CUDA-core kernel by name on the same
    # operands, in turns: new, old, old, new
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        t = {"kernel": fwd_kernel([E_SERVE], H_SERVE, dtype), "kernel_ms": 0.0,
             "kernel_ms_again": 0.0, "cuda_core_ms": 0.0, "plain_ms": 0.0, "flops": 0.0,
             "bytes": 0.0}
        for E_parts in ([E_SERVE], [H_SERVE, H_SERVE]):
            args = layer_inputs(B_SERVE, T_SERVE, E_parts, H_SERVE, dtype, dev,
                                SEED, full_lengths=True)
            a, b, c = in_turns(lambda: bilstm_layer_fwd(*args, dtype),
                               lambda: bilstm_layer_fwd(*args, dtype, kernel="bilstm_fwd"), 5)
            t["kernel_ms"] += a
            t["kernel_ms_again"] += b
            t["cuda_core_ms"] += c
            t["plain_ms"] += time_ms(lambda: bilstm_layer_fwd_plain(*args, dtype), 2)
            f, nb = layer_work(B_SERVE, T_SERVE, sum(E_parts), H_SERVE, size)
            t["flops"], t["bytes"] = t["flops"] + f, t["bytes"] + nb
            del args
        t["bound_ms"], t["bound_by"] = bound(
            [(t["flops"], t["bytes"], kernel_peak(dtype, t["kernel"]))])
        timings[name] = t

    # the kernel at the H = 32 width it also serves (the shapes of TPU
    # kernel row 3, lstm_pallas_layer.py:376 _fwd_pallas, at 2H != 128),
    # beside the CUDA-core one by name, in turns
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.empty((), dtype=dtype).element_size()
        t = {"kernel": fwd_kernel([32], 32, dtype), "kernel_ms": 0.0, "kernel_ms_again": 0.0,
             "cuda_core_ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0, "B": 96,
             "T": 300}
        for E_parts in ([32], [32, 32]):
            args = layer_inputs(96, 300, E_parts, 32, dtype, dev, SEED, full_lengths=True)
            a, b, c = in_turns(lambda: bilstm_layer_fwd(*args, dtype),
                               lambda: bilstm_layer_fwd(*args, dtype, kernel="bilstm_fwd"), 5)
            t["kernel_ms"] += a
            t["kernel_ms_again"] += b
            t["cuda_core_ms"] += c
            t["plain_ms"] += time_ms(lambda: bilstm_layer_fwd_plain(*args, dtype), 2)
            f, nb = layer_work(96, 300, sum(E_parts), 32, size)
            t["flops"], t["bytes"] = t["flops"] + f, t["bytes"] + nb
        t["bound_ms"], t["bound_by"] = bound(
            [(t["flops"], t["bytes"], kernel_peak(dtype, t["kernel"]))])
        lstm = torch.nn.LSTM(32, 32, num_layers=2, bidirectional=True).to(dev).to(dtype)
        x = (torch.rand(300, 96, 32, device=dev) * 2 - 1).to(dtype)
        with torch.inference_mode():
            t["library_ms"] = time_ms(lambda: lstm(x), 5)
        del lstm, x
        timings[f"h32_{str(dtype).replace('torch.', '')}"] = t

    # cuDNN yardstick: the same two-layer bidirectional stack, full lengths
    lstm = torch.nn.LSTM(E_SERVE, H_SERVE, num_layers=2, bidirectional=True).to(dev)
    x = torch.rand(T_SERVE, B_SERVE, E_SERVE, device=dev) * 2 - 1
    with torch.inference_mode():
        lib_ms = time_ms(lambda: lstm(x), 5)
    del lstm, x
    timings["float32"]["library_ms"] = lib_ms
    out = {"phase": "kernel", "checks": checks, "timings": timings,
           "shape": {"B": B_SERVE, "T": T_SERVE, "H": H_SERVE,
                     "layers": "E=64 + E=2x64 (one bulk dispatch)"}}
    emit(out)
    return out


# ------------------------------------------------------------------ serve
def random_jax_params(seed: int, V=250, E=64, L=2) -> dict:
    """Seeded random weights in the JAX package's params-tree layout
    (numpy leaves), with torch's default initialisation."""
    rng = np.random.default_rng(seed)

    def u(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def lin(i, o):
        return {"w": u(i ** -0.5, o, i), "b": u(i ** -0.5, o)}

    emb = rng.standard_normal((V, E)).astype(np.float32)
    emb[0] = 0.0
    k = E ** -0.5
    lstm = [
        {d: {"w_ih": u(k, 4 * E, E if l == 0 else 2 * E), "w_hh": u(k, 4 * E, E),
             "b_ih": u(k, 4 * E), "b_hh": u(k, 4 * E)} for d in ("fwd", "bwd")}
        for l in range(L)
    ]
    d = (2 * E - E) // 3
    proj = [lin(E, E + d), lin(E + d, E + 2 * d), lin(E + 2 * d, 2 * E)]
    return {
        "encoder": {"embedding": emb, "lstm": lstm, "fc": lin(E, E),
                    "projection": proj},
        "head": {"fc1": lin(E, E // 2), "fc2": lin(E // 2, 1)},
        "triplet_projection": lin(E, E),
    }


def profile_device(fn, top: int = 6, groups=None) -> dict:
    """Wall and device time of ``fn()`` under ``torch.profiler``: the sum
    of the kernels' and copies' durations (one stream, so they do not overlap),
    the idle share of the wall time, the device time by kernel name, and
    the host operators' own time (what keeps the host from feeding the
    device). ``groups`` maps a label to a substring of kernel names (or a
    tuple of them); the device time of each group, and of the rest, is
    summed too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name: dict = {}
    for evt in prof.events():
        # kernels and copies only: a user annotation (the optimizer's
        # "Optimizer.step#..." span) is mirrored onto the device timeline
        # and would count the kernels under it twice
        if evt.device_type == torch.autograd.DeviceType.CUDA and not (
                getattr(evt, "is_user_annotation", False) or evt.name.startswith("Optimizer.")):
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    device_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(((e.key, e.self_cpu_time_total) for e in prof.key_averages()),
                  key=lambda kv: -kv[1])[:top]
    out = {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
           "idle_share": 1.0 - device_us / wall_us,
           "top_device_ms": {name[:80]: us / 1e3 for name, us in ranked},
           "top_host_self_ms": {name[:80]: us / 1e3 for name, us in host}}
    if groups:
        split = {label: 0.0 for label in groups}
        split["rest"] = 0.0
        for name, us in by_name.items():
            label = next((k for k, subs in groups.items()
                          if any(sub in name for sub in
                                 ((subs,) if isinstance(subs, str) else subs))), "rest")
            split[label] += us / 1e3
        out["device_ms_by_group"] = split
    return out


def http(base: str, path: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def phase_serve(dev, trunc_len=1500, bulk=400, n_concurrent=8) -> dict:
    from intrepppid_tpu_torch.cli.serve import Serve
    from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.ops.lstm_cuda import bilstm_layer_fwd, bilstm_layer_fwd_f32
    from intrepppid_tpu_torch.serve import ScoringEngine
    from intrepppid_tpu_torch.utils.convert import (
        load_reference_checkpoint,
        save_reference_checkpoint,
    )

    spm = ROOT / "tests" / "fixtures" / "tiny_spm.model"
    rng = np.random.default_rng(SEED)

    def seq(n):
        return "".join(rng.choice(list(AAS), int(n)))

    small = [(seq(rng.integers(20, 300)), seq(rng.integers(20, 300)))
             for _ in range(4)]
    lens = rng.integers(50, trunc_len + 1, size=(bulk, 2))
    lens[0] = trunc_len
    big = [(seq(a), seq(b)) for a, b in lens]
    concurrent = [[(seq(rng.integers(20, 400)), seq(rng.integers(20, 400)))
                   for _ in range(4)] for _ in range(n_concurrent)]

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "model.ckpt"
        save_reference_checkpoint(random_jax_params(SEED), ckpt)
        t0 = time.perf_counter()
        server = Serve.start(
            weights_path=ckpt, spm_path=spm, host="127.0.0.1", port=0,
            trunc_len=trunc_len, batch_size=16, bulk_batch_size=bulk,
            device=str(dev), _block=False,
        )
        startup_s = time.perf_counter() - t0
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            # the main path: every request below goes through the f32
            # tensor-core forward, and none through bilstm_fwd.cu
            bilstm_layer_fwd.launches = bilstm_layer_fwd_f32.launches = 0
            health = http(base, "/healthz")
            p_small = http(base, "/score", {"pairs": small})["probabilities"]
            big_s, p_big = [], None
            for _ in range(3):
                t = time.perf_counter()
                p_big = http(base, "/score", {"pairs": big})["probabilities"]
                big_s.append(time.perf_counter() - t)
            with ThreadPoolExecutor(n_concurrent) as pool:
                p_conc = list(pool.map(
                    lambda req: http(base, "/score", {"pairs": req})["probabilities"],
                    concurrent,
                ))
            stats = http(base, "/statsz")
            launches, cuda_core_launches = bilstm_layer_fwd_f32.launches, bilstm_layer_fwd.launches
            # where a bulk request's time goes, without HTTP and JSON: the
            # engine call alone (token cache warm), then under the profiler
            engine_s = []
            for _ in range(3):
                t = time.perf_counter()
                server.engine.score_pairs(big)
                engine_s.append(time.perf_counter() - t)
            breakdown = profile_device(lambda: server.engine.score_pairs(big))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)

        probs = np.asarray(p_small + p_big + sum(p_conc, []), np.float64)
        if probs.shape != (4 + bulk + 4 * n_concurrent,) \
                or not np.all(np.isfinite(probs)) \
                or not np.all((probs > 0) & (probs < 1)):
            raise AssertionError("served probabilities are not finite values in (0, 1)")
        if launches <= 0 or cuda_core_launches != 0:
            raise AssertionError(
                f"the requests launched the f32 tensor-core forward {launches} times and "
                f"bilstm_fwd.cu {cuda_core_launches} times (want > 0 and 0)")
        if health.get("status") != "ok" or health["model"]["device"] != str(dev):
            raise AssertionError(f"unexpected /healthz: {health}")

        # the port's CPU plain forward on the same ids: a CPU engine gives
        # the 400-pair request the same chunk, bucket and truncation
        t = time.perf_counter()
        cpu_net = intrepppid_network(0, use_projection=True, device="cpu")
        cpu_engine = ScoringEngine(
            cpu_net, load_reference_checkpoint(ckpt), SentencePieceTokenizer(spm),
            trunc_len=trunc_len, batch_size=16, bulk_batch_size=bulk,
        )
        ref = np.concatenate([cpu_engine.score_pairs(small),
                              cpu_engine.score_pairs(big)[:8]])
        cpu_s = time.perf_counter() - t
    got = np.concatenate([p_small, p_big[:8]])
    err = float(np.abs(got - ref).max())
    if not err <= 1e-4:
        raise AssertionError(f"served probabilities differ from the CPU forward by {err}")
    out = {
        "phase": "serve", "startup_s": startup_s,
        "requests": stats["requests"], "pairs_scored": stats["pairs_scored"],
        "errors": stats["errors"], "bulk_request_s": big_s,
        "pairs_per_s": bulk / float(np.median(big_s)),
        "p50_latency_ms": stats["latency_ms"]["p50"],
        "launches": launches, "cuda_core_launches": cuda_core_launches,
        "max_abs_err_vs_cpu": err, "cpu_reference_s": cpu_s,
        "engine_bulk_s": engine_s, "engine_bulk_profile": breakdown,
    }
    emit(out)
    return out


# ----------------------------------------------------------- train kernels
def train_layer_inputs(E_parts, H, G, dtype, dev, seed, full_lengths=False, T=T_TRAIN,
                       ny=None):
    """One train layer's operands at B_TRAIN rows: forward inputs, and the
    backward's dy streams (``ny`` per direction; by default two for the
    lower layer of the two-layer stack, one for the top) and final-state
    cotangents."""
    parts, lengths, w_ih, _, bias = layer_inputs(
        B_TRAIN, T, E_parts, H, dtype, dev, seed, full_lengths)
    g = torch.Generator(device=dev).manual_seed(seed + 100)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 2 - 1

    w_hh = (u(2, G, 4 * H, H) * H ** -0.5).to(dtype).contiguous()
    if not full_lengths:
        # the main path's per-call truncation gives every row of a group the
        # group's longest length: groups 0-2 at 0, 1 and T; 3-4 keep random
        # per-row values
        Bg = B_TRAIN // G_TRAIN
        lengths[: 3 * Bg] = torch.tensor([0, 1, T], dtype=torch.int32,
                                         device=dev).repeat_interleave(Bg)
    if ny is None:
        ny = 2 if len(E_parts) == 1 else 1
    dyf = tuple(u(T, B_TRAIN, H).to(dtype) for _ in range(ny))
    dyb = tuple(u(T, B_TRAIN, H).to(dtype) for _ in range(ny))
    return parts, lengths, w_ih, w_hh, bias, dyf, dyb, u(2, B_TRAIN, H), u(2, B_TRAIN, H)


def train_layer_work(E, H, size, ny, T=T_TRAIN, G=G_TRAIN):
    """(flops, bytes) of each train kernel for one layer at full lengths:
    multiply-adds x 2 over both directions, each input read once and each
    output written once."""
    rows = 2 * B_TRAIN * T  # (direction, row, step) triples
    stream = B_TRAIN * T * size
    weights = 2 * 4 * H * (E + G * H) * size + 2 * 4 * H * 4
    fwd = (2 * rows * 4 * H * (E + H),
           stream * E + weights + B_TRAIN * 4 + 4 * stream * H + 2 * 2 * B_TRAIN * H * 4)
    # the eval variant writes no cell streams
    fwd_eval = (fwd[0], fwd[1] - 2 * stream * H)
    # sweep: gate recompute 4H(E+H), dx 4H E, dh 4H H per (direction, row, step)
    bwd = (2 * rows * 4 * H * (2 * E + 2 * H),
           stream * E + 4 * stream * H + 2 * ny * stream * H + weights + B_TRAIN * 4
           + 2 * 2 * B_TRAIN * H * 4 + 2 * stream * E + 2 * stream * 4 * H)
    wgrad = (2 * rows * 4 * H * (E + H),
             2 * stream * 4 * H + stream * E + 2 * stream * H
             + 2 * 4 * H * (E + G * H) * 4)
    return {"fwd": fwd, "fwd_eval": fwd_eval, "bwd": bwd, "wgrad": wgrad}


def wgrad_library(dgc, parts, hs_f, hs_b, G):
    """cuBLAS products of the wgrad kernel's operands (its yardstick):
    dW_ih over all rows, dW_hh per weight group."""
    from intrepppid_tpu_torch.ops.lstm import prev_states

    T, B, H4 = dgc.shape[1:]
    N, Bg = T * B, B // G
    x = torch.cat(parts, dim=-1).reshape(N, -1)
    d = dgc.reshape(2, N, H4).transpose(1, 2)
    dg = dgc.view(2, T, G, Bg, H4).permute(0, 2, 4, 1, 3).reshape(2, G, H4, T * Bg)
    hp = prev_states(hs_f, hs_b).view(2, T, G, Bg, H4 // 4).permute(0, 2, 1, 3, 4).reshape(
        2, G, T * Bg, H4 // 4)
    return lambda: (torch.matmul(d, x), torch.matmul(dg, hp))


# the f32 kernels on the tensor cores: three tf32 products for each f32 one
TF32_X3 = ("bilstm_bwd_f32", "bilstm_fwd_f32", "lstm_recurrence_bwd_f32", "bilstm_wgrad_f32",
           "bilstm_bwd_f32_onestage")


def kernel_peak(dtype, name: str = "") -> float:
    """Peak rate of a kernel's products: the f32 tensor-core kernels
    (``TF32_X3``) do three tf32 products for each f32 one (3xTF32); every
    other kernel runs at its dtype's rate (f32 on the CUDA cores)."""
    if name in TF32_X3:
        return PEAK_TF32_FLOPS / 3
    return PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def bound(parts) -> tuple:
    """(ms, bound_by): the least time the card could take for work done as
    ``parts``, each (flops, bytes, peak FLOP/s): the operations over their
    peaks or all bytes over the HBM rate, whichever is larger."""
    ops_ms = sum(f / p for f, _, p in parts) * 1e3
    bytes_ms = sum(b for _, b, _ in parts) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def add_bounds(t: dict, work: dict, dtype, peaks=None) -> None:
    """For each kernel k with work[k] = (flops, bytes): its bound (``bound``)
    at the dtype's peak, or at ``peaks[k]`` where given."""
    for k, (f, b) in work.items():
        peak = (peaks or {}).get(k, kernel_peak(dtype))
        t[f"{k}_flops"], t[f"{k}_bytes"] = f, b
        t[f"{k}_bound_ms"], t[f"{k}_bound_by"] = bound([(f, b, peak)])


def cudnn_stack_times(dev, dtype, E=E_SERVE, H=H_SERVE, layers=2) -> dict:
    """cuDNN yardstick: a bidirectional ``nn.LSTM`` (by default the
    manuscript two layers) at the train shape in ``dtype``, TF32 off: the
    training-mode forward, then the backward for the input alone and for
    input and weights (each the forward and backward together, less the
    forward), and the inference forward."""
    lstm = torch.nn.LSTM(E, H, num_layers=layers, bidirectional=True).to(dev).to(dtype)
    lstm.flatten_parameters()
    x = (torch.rand(T_TRAIN, B_TRAIN, E, device=dev) * 2 - 1).to(dtype).requires_grad_()
    dy = (torch.rand(T_TRAIN, B_TRAIN, 2 * H, device=dev) * 2 - 1).to(dtype)
    fwd_ms = time_ms(lambda: lstm(x), 5)
    full_ms = time_ms(lambda: torch.autograd.grad(lstm(x)[0], [x, *lstm.parameters()], dy), 5)
    for p in lstm.parameters():
        p.requires_grad_(False)
    data_ms = time_ms(lambda: torch.autograd.grad(lstm(x)[0], [x], dy), 5)
    with torch.inference_mode():
        inference_ms = time_ms(lambda: lstm(x), 5)
    return {"cudnn_fwd_ms": fwd_ms, "cudnn_fwd_bwd_ms": full_ms,
            "cudnn_bwd_data_ms": data_ms - fwd_ms, "cudnn_bwd_ms": full_ms - fwd_ms,
            "cudnn_inference_ms": inference_ms}


def sweep_names(dxf, dxb):
    """Names of a sweep's outputs, in the order (*dxf, *dxb, dgc, dbias)."""
    return ([f"dxf{k}" for k in range(len(dxf))] + [f"dxb{k}" for k in range(len(dxb))]
            + ["dgc", "dbias"])


def ragged_sweep_check(dev) -> list:
    """The tensor-core sweeps against their twin where no size is round: 27
    rows in 3 weight groups of 9 (a short tile in each group), T = 1, rows
    of length 0, both layer shapes, in bf16 (``bilstm_bwd_mma``) and in f32
    (``bilstm_bwd_f32``); and the one-stage f32 sweep
    (``bilstm_bwd_f32_onestage``) at E = H = 80, T = 1 and 5."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer, bidir_layer_sweep

    B, G = 27, 3
    cases = [(cd, i, E_parts, H_SERVE, 1) for cd in (torch.bfloat16, torch.float32)
             for i, E_parts in enumerate(([E_SERVE], [H_SERVE, H_SERVE]))]
    cases += [(torch.float32, 0, [80], 80, T) for T in (1, 5)]
    out = []
    for cd, i, E_parts, H, T in cases:
        kernel = (L.bilstm_bwd_mma if cd == torch.bfloat16 else
                  L.bilstm_bwd_f32 if H <= 64 else L.bilstm_bwd_f32_onestage)
        g = torch.Generator(device=dev).manual_seed(SEED + 70 + i if H == H_SERVE else
                                                    SEED + 90 + T)

        def u(*shape, scale=1.0):
            return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * scale

        parts = tuple(u(T, B, e).to(cd) for e in E_parts)
        w_ih = u(2, 4 * H, sum(E_parts), scale=H ** -0.5).to(cd)
        w_hh = u(2, G, 4 * H, H, scale=H ** -0.5).to(cd)
        bias = u(2, 4 * H)
        lengths = torch.ones(B, dtype=torch.int32, device=dev)
        lengths[1::4] = T
        lengths[2::7] = min(3, T)
        lengths[::5] = 0
        ny = 2 - i
        dyf = tuple(u(T, B, H).to(cd) for _ in range(ny))
        dyb = tuple(u(T, B, H).to(cd) for _ in range(ny))
        hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                                   with_states=True)
        args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                u(2, B, H), u(2, B, H), cd)
        got, want = kernel(*args), bidir_layer_sweep(*args)
        torch.cuda.synchronize()
        flat = lambda r: list(r[0]) + list(r[1]) + list(r[2:])  # noqa: E731
        res = {n: rel_err(a, b, TOL[cd])
               for n, a, b in zip(sweep_names(*got[:2]), flat(got), flat(want))}
        check = {"kernel": kernel.__name__, "B": B, "G": G, "T": T, "H": H, "E_parts": E_parts,
                 "dtype": str(cd).replace("torch.", ""),
                 "max_abs_err": {n: e for n, (e, _) in res.items()},
                 "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out.append(check)
        if not all(ok for _, ok in res.values()):
            emit({"phase": "train_kernel", "failed": check})
            raise AssertionError(f"the ragged sweep disagrees with its plain version: {check}")
    return out


def ragged_fwd_wgrad_check(dev) -> list:
    """The tensor-core forwards (both variants) and wgrad against their
    twins where no size is round: 27 rows in 3 weight groups of 9 (a short
    tile in each group), T = 1, rows of length 0, both layer shapes; the
    forward and wgrad in bf16, the 3xTF32 forward and wgrad in f32."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer, bidir_layer_wgrad

    H, B, G, T = H_SERVE, 27, 3, 1
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    out = []
    for cd, i, E_parts in ((cd, i, E_parts) for cd in (torch.bfloat16, torch.float32)
                           for i, E_parts in enumerate(([E_SERVE], [H, H]))):
        bf16 = cd == torch.bfloat16
        fwd_eval, fwd_train = ((L.bilstm_layer_fwd_mma, L.bilstm_layer_fwd_train_mma) if bf16
                               else (L.bilstm_layer_fwd_f32, L.bilstm_layer_fwd_train_f32))
        wgrad = L.bilstm_wgrad_mma if bf16 else L.bilstm_wgrad_f32
        g = torch.Generator(device=dev).manual_seed(SEED + 75 + i)

        def u(*shape, scale=1.0):
            return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * scale

        parts = tuple(u(T, B, e).to(cd) for e in E_parts)
        w_ih = u(2, 4 * H, sum(E_parts), scale=H ** -0.5).to(cd)
        w_hh = u(2, G, 4 * H, H, scale=H ** -0.5).to(cd)
        bias = u(2, 4 * H)
        lengths = torch.ones(B, dtype=torch.int32, device=dev)
        lengths[::4] = 0
        args = (parts, lengths, w_ih, w_hh, bias, cd)
        want = bidir_layer(*args, with_states=True)
        res = {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(names, fwd_train(*args), want)}
        res.update({f"eval_{n}": rel_err(a, b, TOL[cd])
                    for n, a, b in zip(names, fwd_eval(*args), want[:4])})
        hs_f, hs_b = want[:2]
        dgc = u(2, T, B, 4 * H).to(cd)
        ref = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
        got = wgrad(dgc, parts, hs_f, hs_b, G)
        res["dW_ih"], res["dW_hh"] = (rel_err(got[0], ref[0], TOL[cd]),
                                      rel_err(got[1], ref[1], TOL[cd]))
        torch.cuda.synchronize()
        check = {"kernel": ("bilstm_fwd_mma, bilstm_wgrad_mma" if bf16
                            else "bilstm_fwd_f32, bilstm_wgrad_f32"),
                 "B": B, "G": G, "T": T, "H": H,
                 "E_parts": E_parts, "dtype": str(cd).replace("torch.", ""),
                 "max_abs_err": {n: e for n, (e, _) in res.items()},
                 "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out.append(check)
        if not all(ok for _, ok in res.values()):
            emit({"phase": "train_kernel", "failed": check})
            raise AssertionError(f"a ragged forward or wgrad disagrees with its twin: {check}")
    return out


def embedding_80_kernels(dev) -> dict:
    """Layer 0 of the two-layer model at embedding 80 (E = H = 80, 5 weight
    groups, two dy streams a direction from the stacked layer above, 400
    rows, T = 1500), the main path of these kernels, in f32 and bf16: in
    f32 the forward (both variants) ``bilstm_fwd.cu``, the sweep
    ``bilstm_bwd_f32_onestage.cu`` (three tf32 passes) and wgrad
    ``bilstm_wgrad.cu``; in bf16 ``bilstm_fwd.cu``, ``bilstm_bwd.cu`` and
    ``bilstm_wgrad_mma.cu`` (its last gate tile masked: 4H = 320; the other
    tensor-core kernels take H <= 64). Each is held against its plain twin
    with the main path's lengths (groups at 0, 1 and T; in f32
    ``bilstm_bwd.cu`` by name too, in bf16 ``bilstm_wgrad.cu``), then timed
    at full lengths beside the twin (timed once, in the check), its bound
    (the one-stage sweep at 495/3 TFLOP/s, the others at their dtype's
    rate), cuDNN's one-layer training forward, inference forward and
    backward for the input in the same dtype, and cuBLAS's products for
    wgrad, TF32 off; the one-stage sweep in turns with ``bilstm_bwd.cu`` by
    name and the bf16 wgrad with ``bilstm_wgrad.cu`` by name (new, old,
    old, new). One dict per dtype and kernel: "fwd", "fwd_eval", "bwd",
    "wgrad"."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep, bidir_layer_wgrad

    E_parts, H, G, ny = [80], 80, G_TRAIN, 2
    picked = {torch.float32: ("bilstm_fwd", "bilstm_bwd_f32_onestage", "bilstm_wgrad"),
              torch.bfloat16: ("bilstm_fwd", "bilstm_bwd", "bilstm_wgrad_mma")}
    # the kernel each dtype's yardstick by name takes the same operands to
    by_name = {"bwd": (torch.float32, "bilstm_bwd"), "wgrad": (torch.bfloat16, "bilstm_wgrad")}
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    flat = lambda r: list(r[0]) + list(r[1]) + list(r[2:])  # noqa: E731
    result = {}
    for cd in (torch.float32, torch.bfloat16):
        f32 = cd == torch.float32
        kernels = (L.fwd_kernel(E_parts, H, cd), L.sweep_kernel(E_parts, H, cd),
                   L.wgrad_kernel(E_parts, H, cd))
        if kernels != picked[cd]:
            raise AssertionError(f"embedding 80's forward, sweep and wgrad in {cd} are {kernels}")
        shape = {"B": B_TRAIN, "T": T_TRAIN, "H": H, "G": G, "E_parts": E_parts, "ny": ny,
                 "dtype": str(cd).replace("torch.", ""), "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out = {k: {"kernel": name, **shape} for k, name in (
            ("fwd", "bilstm_fwd (train)"), ("fwd_eval", "bilstm_fwd (eval)"),
            ("bwd", picked[cd][1]), ("wgrad", picked[cd][2]))}
        size = torch.empty((), dtype=cd).element_size()
        work = train_layer_work(sum(E_parts), H, size, ny)
        peaks = {"bwd": kernel_peak(cd, picked[cd][1])}
        for full in (False, True):
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                E_parts, H, G, cd, dev, SEED + 30, full_lengths=full, ny=ny)
            fwd_args = (parts, lengths, w_ih, w_hh, bias, cd)
            calls = {"fwd": lambda: L.bilstm_layer_fwd_train(*fwd_args),
                     "fwd_eval": lambda: L.bilstm_layer_fwd(*fwd_args)}
            hs_f, hs_b, _, _, cs_f, cs_b = calls["fwd"]()
            args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn,
                    dcn, cd)
            calls["bwd"] = lambda: L.bilstm_bwd(*args)
            dgc = calls["bwd"]()[2]
            calls["wgrad"] = lambda: L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G)
            # the CUDA-core kernel asked for by name on the same operands
            old = {"bwd": lambda: L.bilstm_bwd(*args, kernel="bilstm_bwd"),
                   "wgrad": lambda: L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G,
                                                   kernel="bilstm_wgrad")}
            if full:
                for k, call in calls.items():
                    if by_name.get(k, (None,))[0] == cd:
                        # new, old, old, new: both kernels in one run, on one card
                        out[k]["ms"], out[k]["ms_again"], out[k]["cuda_core_ms"] = in_turns(
                            call, old[k], 3)
                        out[k]["cuda_core_bound_ms"], _ = bound(
                            [(*work[k], kernel_peak(torch.float32, by_name[k][1]))])
                    else:
                        out[k]["ms"] = time_ms(call, 3)
                    add_bounds(out[k], {k: work[k]}, cd, peaks)
                out["wgrad"]["library_ms"] = time_ms(wgrad_library(dgc, parts, hs_f, hs_b, G), 3)
            else:
                want, out["fwd"]["plain_ms"] = timed_once(
                    lambda: L.bilstm_layer_fwd_plain(*fwd_args, with_states=True))
                _, out["fwd_eval"]["plain_ms"] = timed_once(
                    lambda: L.bilstm_layer_fwd_plain(*fwd_args))
                ref, out["bwd"]["plain_ms"] = timed_once(lambda: bidir_layer_sweep(*args))
                ref_w, out["wgrad"]["plain_ms"] = timed_once(
                    lambda: bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G))
                gnames = sweep_names(*ref[:2])
                res = {"fwd": {n: rel_err(a, b, TOL[cd])
                               for n, a, b in zip(names, calls["fwd"](), want)},
                       "fwd_eval": {n: rel_err(a, b, TOL[cd])
                                    for n, a, b in zip(names, calls["fwd_eval"](), want)},
                       "bwd": {n: rel_err(a, b, TOL[cd])
                               for n, a, b in zip(gnames, flat(calls["bwd"]()), flat(ref))},
                       "wgrad": {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(
                           ("dW_ih", "dW_hh"), calls["wgrad"](), ref_w)}}
                if f32:
                    res["bwd"].update({f"cuda_core_{n}": rel_err(a, b, TOL[cd]) for n, a, b in zip(
                        gnames, flat(old["bwd"]()), flat(ref))})
                    out["bwd"]["scaled_err"] = max(scaled_err(a, b) for a, b in zip(
                        flat(calls["bwd"]()), flat(ref)))
                else:
                    res["wgrad"].update({f"cuda_core_{n}": rel_err(a, b, TOL[cd]) for n, a, b in
                                         zip(("dW_ih", "dW_hh"), old["wgrad"](), ref_w)})
                    out["wgrad"]["scaled_err"] = max(scaled_err(a, b) for a, b in zip(
                        calls["wgrad"](), ref_w))
                torch.cuda.synchronize()
                for k, r in res.items():
                    out[k]["max_abs_err"] = {n: e for n, (e, _) in r.items()}
                    if not all(ok for _, ok in r.values()):
                        emit({"phase": "train_kernel", "failed": out[k]})
                        raise AssertionError(
                            f"{out[k]['kernel']} disagrees with its twin: {out[k]}")
                del want, ref, ref_w, res
            del parts, hs_f, hs_b, cs_f, cs_b, args, fwd_args, calls, dgc, old
        lib = cudnn_stack_times(dev, cd, E=80, H=80, layers=1)
        for k, key in (("fwd", "cudnn_fwd_ms"), ("fwd_eval", "cudnn_inference_ms"),
                       ("bwd", "cudnn_bwd_data_ms")):
            out[k]["library_ms"] = lib[key]
        result[shape["dtype"]] = out
    return result


def in_turns(new, old, reps: int) -> tuple:
    """Two kernels on the same operands timed new, old, old, new in one run
    on one card: (first new ms, second new ms, mean old ms)."""
    a, b, c, d = time_ms(new, reps), time_ms(old, reps), time_ms(old, reps), time_ms(new, reps)
    return a, d, 0.5 * (b + c)


def phase_train_kernel(dev) -> dict:
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep, bidir_layer_wgrad

    layers = [([E_SERVE], G_TRAIN), ([H_SERVE, H_SERVE], 1)]
    H = H_SERVE
    err = rel_err
    checks = []
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    # the kernels the dispatch names: bf16 the tensor-core ones; f32 the
    # 3xTF32 tensor-core forward, sweep and wgrad
    picked = {torch.float32: ("bilstm_fwd_f32", "bilstm_bwd_f32", "bilstm_wgrad_f32"),
              torch.bfloat16: ("bilstm_fwd_mma", "bilstm_bwd_mma", "bilstm_wgrad_mma")}
    # the plain versions (Python loops over T) are timed here, once each
    plain_ms = {dtype: {"fwd": 0.0, "fwd_eval": 0.0, "bwd": 0.0, "wgrad": 0.0}
                for dtype in (torch.float32, torch.bfloat16)}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for i, (E_parts, G) in enumerate(layers):
            if (L.fwd_kernel(E_parts, H, dtype), L.sweep_kernel(E_parts, H, dtype),
                    L.wgrad_kernel(E_parts, H, dtype)) != picked[dtype]:
                raise AssertionError(f"unexpected kernels for {E_parts}, {dtype}")
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                E_parts, H, G, dtype, dev, SEED + 10 + i)
            fwd_args = (parts, lengths, w_ih, w_hh, bias, dtype)
            got = L.bilstm_layer_fwd_train(*fwd_args)
            want, ms = timed_once(lambda: L.bilstm_layer_fwd_plain(*fwd_args, with_states=True))
            plain_ms[dtype]["fwd"] += ms
            res = {n: err(a, b, TOL[dtype]) for n, a, b in zip(names, got, want)}
            got = L.bilstm_layer_fwd(*fwd_args)
            res.update({f"eval_{n}": err(a, b, TOL[dtype]) for n, a, b in zip(names, got, want)})
            # the CUDA-core forward by name, both variants
            old = L.bilstm_layer_fwd_train(*fwd_args, kernel="bilstm_fwd")
            res.update({f"cuda_core_{n}": err(a, b, TOL[dtype])
                        for n, a, b in zip(names, old, want)})
            old = L.bilstm_layer_fwd(*fwd_args, kernel="bilstm_fwd")
            res.update({f"cuda_core_eval_{n}": err(a, b, TOL[dtype])
                        for n, a, b in zip(names, old, want)})
            del old
            _, ms = timed_once(lambda: L.bilstm_layer_fwd_plain(*fwd_args))
            plain_ms[dtype]["fwd_eval"] += ms
            del got
            hs_f, hs_b, _, _, cs_f, cs_b = want
            bwd_args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                        dhn, dcn, dtype)
            ref, ms = timed_once(lambda: bidir_layer_sweep(*bwd_args))
            plain_ms[dtype]["bwd"] += ms
            ref_w, ms = timed_once(lambda: bidir_layer_wgrad(ref[2], parts, hs_f, hs_b, G))
            plain_ms[dtype]["wgrad"] += ms
            refs = list(ref[0]) + list(ref[1]) + list(ref[2:])
            gnames = sweep_names(*ref[:2])
            # the sweep the dispatch picks (a tensor-core kernel in either
            # dtype), and the CUDA-core kernel by name
            dxf, dxb, dgc, dbias = L.bilstm_bwd(*bwd_args)
            got = list(dxf) + list(dxb) + [dgc, dbias]
            res.update({n: err(a, b, TOL[dtype]) for n, a, b in zip(gnames, got, refs)})
            scaled = {}
            if not bf16:
                # the control the f32 tolerance must tell apart from the
                # kernels: the twins with their products in one tf32 pass (cuBLAS)
                torch.backends.cuda.matmul.allow_tf32 = True
                one_pass = bidir_layer_sweep(*bwd_args)
                one_pass_fwd = L.bilstm_layer_fwd_plain(*fwd_args, with_states=True)
                torch.backends.cuda.matmul.allow_tf32 = False
                fwd_got = L.bilstm_layer_fwd_train(*fwd_args)
                scaled = {"scaled_err": max(scaled_err(a, b) for a, b in zip(got, refs)),
                          "tf32_one_pass_scaled_err": max(scaled_err(a, b) for a, b in zip(
                              list(one_pass[0]) + list(one_pass[1]) + list(one_pass[2:]),
                              refs)),
                          "fwd_scaled_err": max(scaled_err(a, b) for a, b in zip(fwd_got, want)),
                          "fwd_tf32_one_pass_scaled_err": max(
                              scaled_err(a, b) for a, b in zip(one_pass_fwd, want))}
                del one_pass, one_pass_fwd, fwd_got
            del got
            old = L.bilstm_bwd(*bwd_args, kernel="bilstm_bwd")
            res.update({f"cuda_core_{n}": err(a, b, TOL[dtype]) for n, a, b in zip(
                gnames, list(old[0]) + list(old[1]) + list(old[2:]), refs)})
            del old
            dw_ih, dw_hh = L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G)
            res["dW_ih"], res["dW_hh"] = (err(dw_ih, ref_w[0], TOL[dtype]),
                                          err(dw_hh, ref_w[1], TOL[dtype]))
            if not bf16:
                scaled["wgrad_scaled_err"] = max(scaled_err(dw_ih, ref_w[0]),
                                                 scaled_err(dw_hh, ref_w[1]))
            # the dispatch took a tensor-core wgrad (bf16, or 3xTF32 in
            # f32); the CUDA-core one by name
            dw_ih, dw_hh = L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G, kernel="bilstm_wgrad")
            res["cuda_core_dW_ih"], res["cuda_core_dW_hh"] = (
                err(dw_ih, ref_w[0], TOL[dtype]), err(dw_hh, ref_w[1], TOL[dtype]))
            torch.cuda.synchronize()
            check = {"layer": i, "B": B_TRAIN, "T": T_TRAIN, "H": H, "G": G,
                     "E_parts": E_parts, "dtype": str(dtype).replace("torch.", ""),
                     "kernels": picked[dtype],
                     "max_abs_err": {n: e for n, (e, _) in res.items()}, **scaled,
                     "tol": f"{TOL[dtype]} x max(1, max|ref|)"}
            checks.append(check)
            del parts, want, ref, ref_w, refs, dgc, dxf, dxb, bwd_args
            if not all(ok for _, ok in res.values()):
                emit({"phase": "train_kernel", "failed": check})
                raise AssertionError(f"a train kernel disagrees with its plain version: {check}")
    ragged = ragged_sweep_check(dev) + ragged_fwd_wgrad_check(dev)

    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        name = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        keys = ["fwd", "fwd_eval", "bwd", "wgrad"]
        t = {f"{k}_ms": 0.0 for k in keys}
        t["wgrad_library_ms"] = 0.0
        t.update({f"{k}_plain_ms": v for k, v in plain_ms[dtype].items() if v})
        # every kernel in turns with the CUDA-core one, in both dtypes
        t.update({f"{k}_{what}": 0.0 for k in keys for what in ("ms_again", "cuda_core_ms")})
        work = {k: [0.0, 0.0] for k in keys}
        for i, (E_parts, G) in enumerate(layers):
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                E_parts, H, G, dtype, dev, SEED + 20 + i, full_lengths=True)
            fwd_args = (parts, lengths, w_ih, w_hh, bias, dtype)
            hs_f, hs_b, _, _, cs_f, cs_b = L.bilstm_layer_fwd_train(*fwd_args)
            bwd_args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                        dhn, dcn, dtype)
            dgc = L.bilstm_bwd(*bwd_args)[2]
            calls = {
                "fwd": (lambda: L.bilstm_layer_fwd_train(*fwd_args),
                        lambda: L.bilstm_layer_fwd_train(*fwd_args, kernel="bilstm_fwd")),
                "fwd_eval": (lambda: L.bilstm_layer_fwd(*fwd_args),
                             lambda: L.bilstm_layer_fwd(*fwd_args, kernel="bilstm_fwd")),
                "bwd": (lambda: L.bilstm_bwd(*bwd_args),
                        lambda: L.bilstm_bwd(*bwd_args, kernel="bilstm_bwd")),
                "wgrad": (lambda: L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G),
                          lambda: L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G,
                                                 kernel="bilstm_wgrad")),
            }
            for k, (new, old) in calls.items():
                # new, old, old, new: both kernels in one run, on one card
                a, b, c = in_turns(new, old, 5 if k != "bwd" else 3)
                t[f"{k}_ms"] += a
                t[f"{k}_ms_again"] += b
                t[f"{k}_cuda_core_ms"] += c
            t["wgrad_library_ms"] += time_ms(wgrad_library(dgc, parts, hs_f, hs_b, G), 5)
            for k, (f, b) in train_layer_work(sum(E_parts), H, size, len(dyf)).items():
                work[k][0] += f
                work[k][1] += b
            del parts, hs_f, hs_b, cs_f, cs_b, dgc, fwd_args, bwd_args, calls
        add_bounds(t, work, dtype, {"fwd": kernel_peak(dtype, picked[dtype][0]),
                                    "fwd_eval": kernel_peak(dtype, picked[dtype][0]),
                                    "bwd": kernel_peak(dtype, picked[dtype][1]),
                                    "wgrad": kernel_peak(dtype, picked[dtype][2])})
        t["kernels"] = picked[dtype]
        # the yardstick the port never calls: cuDNN in the same dtype
        t.update(cudnn_stack_times(dev, dtype))
        timings[name] = t

    out = {"phase": "train_kernel", "checks": checks, "ragged_checks": ragged,
           "timings": timings, "embedding_80": embedding_80_kernels(dev),
           "shape": {"B": B_TRAIN, "groups": G_TRAIN, "T": T_TRAIN, "H": H,
                     "layers": "E=64 (grouped W_hh) + E=2x64"}}
    emit(out)
    return out


# ------------------------------------------------------------------ train
def quintuplet_batch(rng, B, T, vocab=250) -> dict:
    """Synthetic quintuplet batch as bench.py builds it: ids in [1, vocab),
    lengths uniform in [T/2, T] with the first row at full length, random
    labels."""
    def ids():
        a = rng.integers(1, vocab, size=(B, T))
        lens = rng.integers(T // 2, T + 1, size=B)
        lens[0] = T
        for i, n in enumerate(lens):
            a[i, n:] = 0
        return a.astype(np.int32)

    batch = {k: ids() for k in ("p1", "p2", "anchor", "positive", "negative")}
    batch["label"] = (rng.random(B) > 0.5).astype(np.int32)
    return batch


def train_counters():
    from intrepppid_tpu_torch.ops import lstm_cuda as L

    return {"bilstm_layer_fwd_train": L.bilstm_layer_fwd_train,
            "bilstm_layer_fwd_train_mma": L.bilstm_layer_fwd_train_mma,
            "bilstm_bwd": L.bilstm_bwd, "bilstm_bwd_mma": L.bilstm_bwd_mma,
            "bilstm_bwd_f32": L.bilstm_bwd_f32,
            "bilstm_bwd_f32_onestage": L.bilstm_bwd_f32_onestage,
            "bilstm_wgrad": L.bilstm_wgrad, "bilstm_wgrad_mma": L.bilstm_wgrad_mma,
            "bilstm_layer_fwd": L.bilstm_layer_fwd,
            "bilstm_layer_fwd_mma": L.bilstm_layer_fwd_mma,
            "bilstm_layer_fwd_f32": L.bilstm_layer_fwd_f32,
            "bilstm_layer_fwd_train_f32": L.bilstm_layer_fwd_train_f32,
            "bilstm_gates": L.bilstm_gates, "bilstm_gates_mma": L.bilstm_gates_mma,
            "bilstm_fwd_wide_train": L.bilstm_fwd_wide_train,
            "bilstm_fwd_wide": L.bilstm_fwd_wide, "bilstm_bwd_lite": L.bilstm_bwd_lite,
            "bilstm_bwd_lite_mma": L.bilstm_bwd_lite_mma,
            "bilstm_fwd_wide_train_mma": L.bilstm_fwd_wide_train_mma,
            "bilstm_fwd_wide_mma": L.bilstm_fwd_wide_mma,
            "bilstm_wgrad_f32": L.bilstm_wgrad_f32,
            "lstm_recurrence_fwd": L.lstm_recurrence_fwd,
            "lstm_recurrence_bwd": L.lstm_recurrence_bwd,
            "lstm_recurrence_bwd_mma": L.lstm_recurrence_bwd_mma,
            "lstm_recurrence_bwd_f32": L.lstm_recurrence_bwd_f32,
            "lstm_recurrence_wgrad": L.lstm_recurrence_wgrad,
            "lstm_recurrence_wgrad_mma": L.lstm_recurrence_wgrad_mma}


def phase_train(dev, warmup=2, steps=12) -> dict:
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.train import Trainer

    rng = np.random.default_rng(SEED)
    net = intrepppid_network(steps_per_epoch=100, compute_dtype=torch.bfloat16,
                             optimizer_type="ranger21_xx", device=dev, seed=SEED)
    trainer = Trainer(net, seed=SEED)
    batches = [quintuplet_batch(rng, PAIRS_TRAIN, T_TRAIN) for _ in range(4)]
    counters = train_counters()
    # the main path: every train step and the eval step below go through the kernels
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    for i in range(warmup + steps):
        t = time.perf_counter()
        aux = trainer.train_step(batches[i % len(batches)])
        losses.append(aux["loss"].item())
        if i >= warmup:
            step_ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    eval_loss = trainer.eval_step(batches[0])["loss"].item()
    eval_ms = (time.perf_counter() - t) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    breakdown = profile_device(
        lambda: trainer.train_step(batches[0])["loss"].item(), top=10,
        groups={"fwd_mma": "bilstm_fwd_mma_kernel", "fwd_f32": "bilstm_fwd_f32_kernel",
                "fwd_cuda_core": "bilstm_layer_fwd_kernel",
                "sweep_mma": "bilstm_bwd_mma_kernel", "sweep_f32": "bilstm_bwd_f32_",
                "sweep_cuda_core": "bilstm_bwd_kernel",
                "wgrad_mma": "bilstm_wgrad_mma_kernel", "wgrad_f32": "bilstm_wgrad_f32_kernel",
                "wgrad_cuda_core": "bilstm_wgrad_kernel"})
    if not all(np.isfinite(losses + [eval_loss])):
        raise AssertionError(f"non-finite train loss: {losses}, eval {eval_loss}")
    new = ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma", "bilstm_bwd_mma",
           "bilstm_wgrad_mma")
    old = ("bilstm_layer_fwd_train", "bilstm_layer_fwd", "bilstm_bwd", "bilstm_bwd_f32",
           "bilstm_bwd_f32_onestage", "bilstm_wgrad", "bilstm_wgrad_f32", "bilstm_layer_fwd_f32",
           "bilstm_layer_fwd_train_f32")
    missing = [n for n in new if launches[n] <= 0]
    ran_old = [n for n in old if launches[n] != 0]
    if missing or ran_old:
        raise AssertionError(
            f"the bf16 train and eval steps never launched {missing}, or ran the CUDA-core "
            f"{ran_old}")
    del trainer, net
    f32 = f32_steps(dev, batches,
                    ("bilstm_layer_fwd_train_f32", "bilstm_bwd_f32", "bilstm_wgrad_f32"),
                    ("bilstm_layer_fwd_train_mma", "bilstm_bwd_mma", "bilstm_wgrad_mma",
                     "bilstm_wgrad", "bilstm_bwd", "bilstm_layer_fwd_train", "bilstm_layer_fwd",
                     "bilstm_bwd_f32_onestage"))
    # the default two-layer model at embedding 80, an eval step after its
    # train steps: layer 0 (E = H = 80) is resident, its forward (both
    # variants) bilstm_fwd.cu, its wgrad bilstm_wgrad.cu in f32 and
    # bilstm_wgrad_mma.cu (the masked gate tile) in bf16, its sweep the
    # one-stage 3xTF32 kernel in f32 and bilstm_bwd.cu in bf16; the stacked
    # layer (E = 2 x 80) runs padded to H = 96 on the wide route
    e80 = {}
    for dtype, expect, never in (
        (torch.float32, ("bilstm_bwd_f32_onestage", "bilstm_gates", "bilstm_wgrad_f32",
                         "bilstm_wgrad"),
         ("bilstm_bwd", "bilstm_bwd_f32", "bilstm_gates_mma", "bilstm_wgrad_mma")),
        (torch.bfloat16, ("bilstm_bwd", "bilstm_gates_mma", "bilstm_wgrad_mma"),
         ("bilstm_bwd_f32_onestage", "bilstm_bwd_mma", "bilstm_gates", "bilstm_wgrad_f32",
          "bilstm_wgrad")),
    ):
        e80[str(dtype).replace("torch.", "")] = f32_steps(
            dev, batches, ("bilstm_layer_fwd_train", "bilstm_layer_fwd",
                           "bilstm_fwd_wide_train", "bilstm_fwd_wide", "bilstm_bwd_lite")
            + expect, ("bilstm_layer_fwd_f32", "bilstm_layer_fwd_train_f32",
                       "bilstm_layer_fwd_mma", "bilstm_bwd_lite_mma") + never,
            eval_step=True, dtype=dtype, embedding_size=80)
    grad_check = train_grad_check(dev)
    grad_check_80 = {str(dtype).replace("torch.", ""): train_grad_check(
        dev, dtype=dtype, eval_step=True, expect=expect, embedding_size=80)
        for dtype, expect in (
            (torch.float32, ("bilstm_bwd_f32_onestage", "bilstm_layer_fwd", "bilstm_bwd_lite",
                             "bilstm_fwd_wide", "bilstm_wgrad_f32", "bilstm_wgrad")),
            (torch.bfloat16, ("bilstm_bwd", "bilstm_layer_fwd", "bilstm_bwd_lite",
                              "bilstm_fwd_wide", "bilstm_wgrad_mma")))}
    grad_check_bf16 = train_grad_check(dev, dtype=torch.bfloat16)
    median = float(np.median(step_ms))
    out = {"phase": "train", "pairs": PAIRS_TRAIN, "T": T_TRAIN, "dtype": "bfloat16",
           "optimizer": "ranger21_xx", "dropout": 0.3, "step_ms": step_ms,
           "median_step_ms": median, "pairs_per_s": PAIRS_TRAIN / median * 1e3,
           "losses": losses, "eval_loss": eval_loss, "eval_step_ms": eval_ms,
           "launches": launches, "peak_memory_gib": peak_gib,
           "step_profile": breakdown, "float32_steps": f32,
           "steps_embedding_80": e80, "grad_check": grad_check,
           "grad_check_embedding_80": grad_check_80, "grad_check_bf16": grad_check_bf16}
    emit(out)
    return out


def f32_steps(dev, batches, expect, never, steps=2, eval_step=False, dtype=torch.float32,
              **widths) -> dict:
    """The same train step with the model in ``dtype`` (by default f32, the
    factory's default compute dtype), a main path of its own: the counts
    are set to 0 just before and read just after (with ``eval_step``, after
    an eval step that follows the train steps). The dispatch is by dtype
    and shape: the kernels in ``expect`` must launch and those in ``never``
    must not. ``widths`` (embedding_size, rnn_num_layers) as the factory
    takes them. Then one more step, profiled, after the counts are read."""
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.train import Trainer

    net = intrepppid_network(steps_per_epoch=100, compute_dtype=dtype,
                             optimizer_type="ranger21_xx", device=dev, seed=SEED, **widths)
    trainer = Trainer(net, seed=SEED)
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms = [], []
    for i in range(steps):
        t = time.perf_counter()
        losses.append(trainer.train_step(batches[i % len(batches)])["loss"].item())
        step_ms.append((time.perf_counter() - t) * 1e3)
    if eval_step:
        losses.append(trainer.eval_step(batches[0])["loss"].item())
    launches = {name: fn.launches for name, fn in counters.items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite f32 train loss: {losses}")
    missing = [n for n in expect if launches[n] <= 0]
    wrong = [n for n in never if launches[n] != 0]
    if missing or wrong:
        raise AssertionError(f"the {dtype} train steps never launched {missing} or ran {wrong}")
    profile = profile_device(
        lambda: trainer.train_step(batches[0])["loss"].item(), top=10,
        groups={"fwd": ("bilstm_fwd_f32_kernel", "bilstm_layer_fwd_kernel",
                        "lstm_recurrence_fwd_kernel", "bilstm_fwd_wide_kernel",
                        "bilstm_fwd_mma_kernel", "bilstm_fwd_wide_mma_kernel"),
                "sweep": ("bilstm_bwd_f32_kernel", "bilstm_bwd_kernel",
                          "lstm_recurrence_bwd_f32_kernel",
                          "lstm_recurrence_bwd_kernel", "bilstm_bwd_lite_kernel",
                          "bilstm_bwd_mma_kernel", "bilstm_bwd_lite_mma_kernel",
                          "lstm_recurrence_bwd_mma_kernel"),
                "wgrad": ("bilstm_wgrad_kernel", "bilstm_wgrad_f32_kernel",
                          "bilstm_wgrad_mma_kernel", "lstm_recurrence_wgrad_kernel",
                          "lstm_recurrence_wgrad_mma_kernel"),
                "gates": "bilstm_gates",
                "gemm": ("gemm", "nvjet", "xmma")})
    return {"dtype": str(dtype).replace("torch.", ""), "steps": steps, "eval_step": eval_step,
            **widths,
            "step_ms": step_ms, "losses": losses, "launches": launches, "step_profile": profile}


def train_grad_check(dev, pairs=8, T=64, dtype=torch.float32, eval_step=False, expect=(),
                     **widths) -> dict:
    """One step's gradients on the card (the kernels) against the port's CPU
    plain path: same seeded weights and batch, every dropout rate 0;
    ``widths`` (embedding_size, rnn_num_layers) as the factory takes them.
    f32: tolerance 1e-4 x max(1, max|grad|) per parameter (f32 sums in
    another order, on the card and in the kernels, over T x 5 x pairs rows).
    bf16: 2^-7 x max(1, max|grad|): the streams (hs, cs, dgc, dx) are bf16
    on both sides and the kernels sum in another order, so a stream value
    may land one bf16 ulp (2^-8 relative) apart, and the tensor-core sweep
    takes its sigmoid and tanh from ex2 and a fast reciprocal. With
    ``eval_step``, an eval step of the same model on the same batch follows
    the backward (no grad: the eval-variant forwards), and its loss is held
    to the same tolerance. The card's steps are a main path of their own:
    the launch counts are set to 0 just before them and read just after
    (``launches``); each kernel named in ``expect`` must have launched."""
    from intrepppid_tpu_torch.models.factory import intrepppid_network

    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    batch = quintuplet_batch(np.random.default_rng(SEED + 1), pairs, T)
    grads, eval_losses = {}, {}
    counters = train_counters()
    for device in (dev, torch.device("cpu")):
        net = intrepppid_network(steps_per_epoch=100, device=device, seed=SEED,
                                 compute_dtype=dtype,
                                 rnn_dropout_rate=0.0, embedding_droprate=0.0, do_rate=0.0,
                                 **widths)
        tb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if device == dev:
            for fn in counters.values():
                fn.launches = 0
        loss, _ = net.step(tb, torch.Generator(device=device).manual_seed(0), train=True)
        loss.backward()
        if eval_step:
            with torch.no_grad():
                eval_losses[device.type] = float(net.step(
                    tb, torch.Generator(device=device).manual_seed(0), train=False)[0])
        if device == dev:
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
        grads[device.type] = {n: p.grad.detach().float().cpu()
                              for n, p in net.named_parameters() if p.grad is not None}
    errs = {}
    for name, ref in grads["cpu"].items():
        got = grads["cuda"][name]
        errs[name] = float((got - ref).abs().max())
        if not errs[name] <= tol * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"card gradient of {name} differs from the CPU's by {errs[name]}")
    if set(grads["cpu"]) != set(grads["cuda"]) or not any(
            n.startswith("encoder.lstm.") for n in grads["cuda"]):
        raise AssertionError("the card's step did not reach the same parameters")
    missing = [n for n in expect if launches[n] <= 0]
    if missing:
        raise AssertionError(f"the card's step ({dtype}, {widths}) never launched {missing}")
    extra = {}
    if eval_step:
        extra["eval_loss_err"] = abs(eval_losses["cuda"] - eval_losses["cpu"])
        if not extra["eval_loss_err"] <= tol * max(1.0, abs(eval_losses["cpu"])):
            raise AssertionError(f"the card's eval loss differs from the CPU's: {eval_losses}")
    return {"pairs": pairs, "T": T, "dtype": str(dtype).replace("torch.", ""),
            "params": len(errs), **widths, **extra, "max_abs_err": max(errs.values()),
            "tol": f"{tol} x max(1, max|grad|)",
            "launches": {n: v for n, v in launches.items() if v}}


# ------------------------------------------------------------------ widths
# the train-variant wrapper of each resident forward kernel
RESIDENT_TRAIN_FWD = {"bilstm_fwd_mma": "bilstm_layer_fwd_train_mma",
                      "bilstm_fwd_f32": "bilstm_layer_fwd_train_f32",
                      "bilstm_fwd": "bilstm_layer_fwd_train"}
# the layers the width repairs open (E parts, H, weight groups), each run at
# its padded shape: the stacked layer at embedding 80 (96, wide), layer 0
# and the stacked layer at embedding 112 (128, wide), layer 0 at embedding
# 50 (H 64, E 56 in f32 and 64 in bf16, resident), both layers at embedding
# 100 (H 128, parts of 112, wide) and at 272 (288, wide: the 288-thread
# CUDA-core wide kernels in bf16 and f32)
PADDED_LAYERS = ((("stacked", 80), [80, 80], 80, 1), (("layer 0", 112), [112], 112, G_TRAIN),
                 (("stacked", 112), [112, 112], 112, 1), (("layer 0", 50), [50], 50, G_TRAIN),
                 (("layer 0", 100), [100], 100, G_TRAIN), (("stacked", 100), [100, 100], 100, 1),
                 (("layer 0", 272), [272], 272, G_TRAIN), (("stacked", 272), [272, 272], 272, 1))
# the wide route's kernels, by dtype (the tensor-core ones at 128 and 256;
# at 96 and 288 the CUDA-core forward and sweep in bf16 too)
WIDE_BF16 = ("bilstm_gates_mma", "bilstm_fwd_wide_train_mma", "bilstm_fwd_wide_mma",
             "bilstm_bwd_lite_mma", "bilstm_wgrad_mma")
WIDE_F32 = ("bilstm_gates", "bilstm_fwd_wide_train", "bilstm_fwd_wide", "bilstm_bwd_lite",
            "bilstm_wgrad_f32")
WIDE_288_BF16 = ("bilstm_gates_mma", "bilstm_fwd_wide_train", "bilstm_fwd_wide",
                 "bilstm_bwd_lite", "bilstm_wgrad_mma")
# two-layer models at these embeddings, and the recurrence backend at 80:
# the kernels each one's gradient step and eval step must launch
WIDTH_STEPS = (
    ("layer", 48, torch.float32, ("bilstm_layer_fwd_train_f32", "bilstm_layer_fwd_f32",
                                  "bilstm_bwd_f32", "bilstm_wgrad")),
    ("layer", 48, torch.bfloat16, ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma",
                                   "bilstm_layer_fwd_train", "bilstm_layer_fwd",
                                   "bilstm_bwd_mma", "bilstm_wgrad_mma")),
    ("layer", 50, torch.float32, ("bilstm_layer_fwd_train_f32", "bilstm_layer_fwd_f32",
                                  "bilstm_bwd_f32", "bilstm_wgrad_f32")),
    ("layer", 50, torch.bfloat16, ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma",
                                   "bilstm_bwd_mma", "bilstm_wgrad_mma")),
    ("layer", 100, torch.float32, WIDE_F32),
    ("layer", 100, torch.bfloat16, WIDE_BF16),
    ("layer", 272, torch.bfloat16, WIDE_288_BF16),
    ("layer", 112, torch.float32, ("bilstm_gates", "bilstm_fwd_wide_train", "bilstm_fwd_wide",
                                   "bilstm_bwd_lite", "bilstm_wgrad_f32")),
    ("layer", 112, torch.bfloat16, ("bilstm_gates_mma", "bilstm_fwd_wide_train_mma",
                                    "bilstm_fwd_wide_mma", "bilstm_bwd_lite_mma",
                                    "bilstm_wgrad_mma")),
    ("recurrence", 80, torch.float32, ("lstm_recurrence_fwd", "lstm_recurrence_bwd",
                                       "lstm_recurrence_wgrad")),
    ("recurrence", 80, torch.bfloat16, ("lstm_recurrence_fwd", "lstm_recurrence_bwd",
                                        "lstm_recurrence_wgrad_mma")),
)


def padded_layer_timings(dev) -> list:
    """Each layer of ``PADDED_LAYERS`` on its route at its padded shape
    (``lstm_cuda.layer_fwd`` train variant, and ``layer_bwd``: the sweep and
    the weight gradients), 400 rows, f32 and bf16: held against the plain
    layer at its true widths (``bidir_layer``, ``bidir_layer_bwd``) at
    T = 300 with the main path's lengths, the kernels it launched, then
    timed at T = 1500, full lengths, beside its bound at the true widths
    and at the padded ones (the dtype's rate; what the padding costs) and
    cuDNN's one-layer training forward and backward (input and weights) at
    the true widths in the same dtype, TF32 off."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer, bidir_layer_bwd

    counters = train_counters()
    out = []
    for (what, width), E_parts, H, G in PADDED_LAYERS:
        ny = 2 if len(E_parts) == 1 else 1
        for cd in (torch.float32, torch.bfloat16):
            Hp, Ep = L.padded_width(E_parts, H, cd), L.padded_parts(E_parts, H, cd)
            row = {"layer": f"{what}, embedding {width}", "E_parts": E_parts, "H": H,
                   "padded_H": Hp, "padded_parts": list(Ep),
                   "route": L.layer_route(E_parts, H, cd), "G": G, "ny": ny,
                   "B": B_TRAIN, "T": T_TRAIN, "check_T": 300,
                   "dtype": str(cd).replace("torch.", ""), "tol": f"{TOL[cd]} x max(1, max|ref|)"}
            size = torch.empty((), dtype=cd).element_size()
            for full in (False, True):
                parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                    E_parts, H, G, cd, dev, SEED + 40 + H, full_lengths=full, ny=ny,
                    T=T_TRAIN if full else 300)
                fwd_args = (parts, lengths, w_ih, w_hh, bias, cd)
                fwd = lambda: L.layer_fwd(*fwd_args, with_states=True)  # noqa: E731
                hs_f, hs_b, _, _, cs_f, cs_b = fwd()
                args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                        dhn, dcn, cd)
                bwd = lambda: L.layer_bwd(*args)  # noqa: E731
                if full:
                    row["fwd_ms"], row["bwd_ms"] = time_ms(fwd, 3), time_ms(bwd, 3)
                    continue
                for fn in counters.values():
                    fn.launches = 0
                got_f, got_b = fwd(), bwd()
                torch.cuda.synchronize()
                row["kernels"] = sorted(n for n, fn in counters.items() if fn.launches)
                if row["route"] == "wide":
                    want = {L.gates_kernel(Ep, Hp, cd), L.lite_kernel(Hp, cd),
                            L.wide_fwd_kernel(Hp, cd).replace("wide", "wide_train")}
                else:
                    want = {RESIDENT_TRAIN_FWD[L.fwd_kernel(Ep, Hp, cd)],
                            L.sweep_kernel(Ep, Hp, cd)}
                want.add(L.wgrad_kernel(Ep, Hp, cd))
                if not want <= set(row["kernels"]):
                    raise AssertionError(f"a padded layer ran {row['kernels']}, not {want}")
                want_f = bidir_layer(*fwd_args, with_states=True)
                want_b = bidir_layer_bwd(*args)
                flat = lambda r: list(r[0]) + list(r[1]) + list(r[2:])  # noqa: E731
                res = {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(
                    ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b"), got_f, want_f)}
                res.update({n: rel_err(a, b, TOL[cd]) for n, a, b in zip(
                    sweep_names(*want_b[:2])[:-2] + ["dW_ih", "dW_hh", "dbias"], flat(got_b),
                    flat(want_b))})
                row["max_abs_err"] = {n: e for n, (e, _) in res.items()}
                if not all(ok for _, ok in res.values()):
                    emit({"phase": "widths", "failed": row})
                    raise AssertionError(f"a padded layer disagrees with its plain layer: {row}")
                del got_f, got_b, want_f, want_b
            for key, Ew, Hw in (("", sum(E_parts), H), ("padded_", sum(Ep), Hp)):
                work = train_layer_work(Ew, Hw, size, ny, G=G)
                peak = kernel_peak(cd)
                row[f"fwd_{key}bound_ms"], row[f"fwd_{key}bound_by"] = bound(
                    [(*work["fwd"], peak)])
                row[f"bwd_{key}bound_ms"], row[f"bwd_{key}bound_by"] = bound(
                    [(*work["bwd"], peak), (*work["wgrad"], peak)])
            lib = cudnn_stack_times(dev, cd, E=sum(E_parts), H=H, layers=1)
            row["fwd_library_ms"], row["bwd_library_ms"] = lib["cudnn_fwd_ms"], lib["cudnn_bwd_ms"]
            out.append(row)
            del parts, hs_f, hs_b, cs_f, cs_b, args, fwd_args
    return out


def wide_288_kernels(dev) -> dict:
    """The CUDA-core wide forward (both variants) and lite sweep at H = 288,
    their 288-thread instances, at their main path's shapes: layer 0 of the
    bf16 two-layer model at embedding 272 (E = 272, run at H = 288, 5
    weight groups, two dy streams a direction, 400 rows, T = 1500), its
    input gates from ``bilstm_gates_mma``. Each held against its plain twin
    with the main path's lengths, then timed at full lengths beside the
    twin (timed once, in the check), its bound at the bf16 rate at H = 288
    (the kernel's own work) and at the true 272, and cuDNN's one-layer bf16
    training forward, inference forward and backward for the input at
    E = H = 272, TF32 off. One dict per kernel: "fwd", "fwd_eval", "lite"."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep_lite, bidir_recurrence

    cd, E, H, G, ny = torch.bfloat16, 272, 272, G_TRAIN, 2
    Hp = L.padded_width([E], H, cd)
    picked = (Hp, L.wide_fwd_kernel(Hp, cd), L.lite_kernel(Hp, cd))
    if picked != (288, "bilstm_fwd_wide", "bilstm_bwd_lite"):
        raise AssertionError(f"embedding 272's layer 0 in bf16 runs {picked}")
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    shape = {"B": B_TRAIN, "T": T_TRAIN, "E": E, "H": H, "padded_H": Hp, "G": G, "ny": ny,
             "dtype": "bfloat16", "tol": f"{TOL[cd]} x max(1, max|ref|)"}
    out = {k: {"kernel": name, **shape} for k, name in (
        ("fwd", "bilstm_fwd_wide (train)"), ("fwd_eval", "bilstm_fwd_wide (eval)"),
        ("lite", "bilstm_bwd_lite"))}
    for full in (False, True):
        parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
            [E], Hp, G, cd, dev, SEED + 50, full_lengths=full, ny=ny)
        xg = L.bilstm_gates(parts, w_ih, bias, cd)
        calls = {"fwd": lambda: L.bilstm_fwd_wide_train(xg, lengths, w_hh, cd),
                 "fwd_eval": lambda: L.bilstm_fwd_wide(xg, lengths, w_hh, cd)}
        hs_f, hs_b, _, _, cs_f, cs_b = calls["fwd"]()
        args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, cd)
        calls["lite"] = lambda: L.bilstm_bwd_lite(*args)
        if full:
            for k, call in calls.items():
                out[k]["ms"] = time_ms(call, 3)
        else:
            want, out["fwd"]["plain_ms"] = timed_once(
                lambda: bidir_recurrence(xg, lengths, w_hh, cd, with_states=True))
            _, out["fwd_eval"]["plain_ms"] = timed_once(
                lambda: bidir_recurrence(xg, lengths, w_hh, cd))
            ref, out["lite"]["plain_ms"] = timed_once(lambda: bidir_layer_sweep_lite(*args))
            res = {"fwd": {n: rel_err(a, b, TOL[cd])
                           for n, a, b in zip(names, calls["fwd"](), want)},
                   "fwd_eval": {n: rel_err(a, b, TOL[cd])
                                for n, a, b in zip(names, calls["fwd_eval"](), want)},
                   "lite": {"dgates": rel_err(calls["lite"](), ref, TOL[cd])}}
            torch.cuda.synchronize()
            for k, r in res.items():
                out[k]["max_abs_err"] = {n: e for n, (e, _) in r.items()}
                if not all(ok for _, ok in r.values()):
                    emit({"phase": "widths", "failed": out[k]})
                    raise AssertionError(f"{out[k]['kernel']} disagrees with its twin: {out[k]}")
            del want, ref, res
        del parts, xg, hs_f, hs_b, cs_f, cs_b, args, calls
    for key, Hw in (("", Hp), ("true_", H)):
        work = wide_layer_work(E, Hw, G, 2, ny)
        for k in out:
            out[k][f"{key}bound_ms"], out[k][f"{key}bound_by"] = bound(
                [(*work[k], kernel_peak(cd))])
    lib = cudnn_stack_times(dev, cd, E=E, H=H, layers=1)
    for k, key in (("fwd", "cudnn_fwd_ms"), ("fwd_eval", "cudnn_inference_ms"),
                   ("lite", "cudnn_bwd_data_ms")):
        out[k]["library_ms"] = lib[key]
    return out


def phase_widths(dev) -> dict:
    """The widths the JAX package's kernels take and the port's kernels did
    not, on the card: ``padded_layer_timings``; the two-layer model at
    embedding 100 at the train shape (80 pairs, T = 1500, dropout on, 2
    steps and an eval step) in f32 and bf16 and one at embedding 272 in
    bf16 (its steps timed), each with the kernels it launched;
    ``wide_288_kernels``; then for each of ``WIDTH_STEPS`` one gradient
    step and an eval step of the two-layer model (8 pairs, T = 64, dropout
    0) on the card against the CPU plain path, in f32 and bf16, the listed
    kernels launched (on the recurrence backend with
    ``ops.lstm.DEFAULT_BACKEND = "recurrence"``)."""
    from intrepppid_tpu_torch.ops import lstm

    layers = padded_layer_timings(dev)
    rng = np.random.default_rng(SEED + 7)
    batches = [quintuplet_batch(rng, PAIRS_TRAIN, T_TRAIN) for _ in range(2)]
    resident = tuple(n for n in train_counters()
                     if n.startswith(("bilstm_layer_fwd", "bilstm_bwd")) and "lite" not in n)
    models = {}
    for key, dtype, width, expect in (("embedding_100_float32", torch.float32, 100, WIDE_F32),
                                      ("embedding_100_bfloat16", torch.bfloat16, 100, WIDE_BF16),
                                      ("embedding_272_bfloat16", torch.bfloat16, 272,
                                       WIDE_288_BF16)):
        others = set(WIDE_BF16 + WIDE_F32 + WIDE_288_BF16 + ("bilstm_wgrad",)) - set(expect)
        models[key] = f32_steps(dev, batches, expect, resident + tuple(sorted(others)),
                                eval_step=True, dtype=dtype, embedding_size=width)
    kernels_288 = wide_288_kernels(dev)
    steps = []
    for backend, width, dtype, expect in WIDTH_STEPS:
        lstm.DEFAULT_BACKEND = "recurrence" if backend == "recurrence" else "auto"
        try:
            check = train_grad_check(dev, dtype=dtype, eval_step=True, expect=expect,
                                     embedding_size=width)
        finally:
            lstm.DEFAULT_BACKEND = "auto"
        steps.append({"backend": backend, **check})
    out = {"phase": "widths", "padded_layers": layers, "models": models,
           "kernels_288": kernels_288, "grad_checks": steps}
    emit(out)
    return out


# ------------------------------------------------------------ wide kernels
def wide_layer_work(E, H, G, size, ny, T=T_TRAIN, B=B_TRAIN):
    """(flops, bytes) of each wide-route kernel for one layer at full
    lengths: multiply-adds x 2 over both directions; each input read once
    and each output written once (xg and dgates are f32)."""
    rows = 2 * B * T
    stream = B * T * size
    xg = rows * 4 * H * 4
    state = B * 4 + 2 * 2 * B * H * 4
    w_hh = 2 * G * 4 * H * H * size
    return {
        "gates": (2 * rows * 4 * H * E, stream * E + 2 * 4 * H * E * size + 2 * 4 * H * 4 + xg),
        "fwd": (2 * rows * 4 * H * H, xg + w_hh + state + 4 * stream * H),
        "fwd_eval": (2 * rows * 4 * H * H, xg + w_hh + state + 2 * stream * H),
        # gate recompute and dh: 2 x 4H x H per (direction, row, step)
        "lite": (2 * rows * 4 * H * 2 * H,
                 xg + w_hh + state + 4 * stream * H + 2 * ny * stream * H + xg),
        "wgrad": (2 * rows * 4 * H * (E + H),
                  2 * stream * 4 * H + stream * E + 2 * stream * H + 2 * 4 * H * (E + G * H) * 4),
    }


def wide_layer_check(E_parts, H, G, dtype, dev, seed, T):
    """The wide kernels and wgrad against their plain versions on one
    layer's operands; each kernel takes the same inputs as its twin."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import (
        bidir_layer_sweep_lite,
        bidir_layer_wgrad,
        bidir_recurrence,
        input_gates,
    )

    parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
        E_parts, H, G, dtype, dev, seed, T=T)
    tol = TOL[dtype]
    res = {}
    xg = L.bilstm_gates(parts, w_ih, bias, dtype)
    ref = input_gates(parts, w_ih, bias, dtype)
    res["xg"] = rel_err(xg, ref, tol)
    # the backward recomputes the gates with the same dispatch: the same bits
    again = L.bilstm_gates(parts, w_ih, bias, dtype)
    res["xg_recompute_vs_first"] = (float((again - xg).abs().max()), bool(torch.equal(again, xg)))
    del again
    if dtype == torch.bfloat16:
        # the dispatch took the tensor-core gates; the CUDA-core kernel by name
        res["cuda_core_xg"] = rel_err(
            L.bilstm_gates(parts, w_ih, bias, dtype, kernel="bilstm_gates"), ref, tol)
    del ref
    want = bidir_recurrence(xg, lengths, w_hh, dtype, with_states=True)
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    got = L.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype)
    res.update({f"train_{n}": rel_err(a, b, tol) for n, a, b in zip(names, got, want)})
    ev = L.bilstm_fwd_wide(xg, lengths, w_hh, dtype)
    res.update({f"eval_{n}": rel_err(a, b, tol) for n, a, b in zip(names, ev, want)})
    if L.wide_fwd_kernel(H, dtype) == "bilstm_fwd_wide_mma":
        # the dispatch took the tensor-core forward: both variants give the
        # same hs bits; the CUDA-core kernel by name
        res["eval_vs_train_hs"] = (
            max(float((a.float() - b.float()).abs().max()) for a, b in zip(ev[:2], got[:2])),
            all(torch.equal(a, b) for a, b in zip(ev[:2], got[:2])))
        del got, ev
        got = L.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype, kernel="bilstm_fwd_wide")
        res.update({f"cuda_core_train_{n}": rel_err(a, b, tol) for n, a, b in zip(names, got, want)})
        ev = L.bilstm_fwd_wide(xg, lengths, w_hh, dtype, kernel="bilstm_fwd_wide")
        res.update({f"cuda_core_eval_{n}": rel_err(a, b, tol) for n, a, b in zip(names, ev, want)})
    del got, ev
    hs_f, hs_b, _, _, cs_f, cs_b = want
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, dtype)
    dgates = bidir_layer_sweep_lite(*args)
    res["dgates"] = rel_err(L.bilstm_bwd_lite(*args), dgates, tol)
    if L.lite_kernel(H, dtype) == "bilstm_bwd_lite_mma":
        # the dispatch took the tensor-core sweep; the CUDA-core one by name
        res["cuda_core_dgates"] = rel_err(L.bilstm_bwd_lite(*args, kernel="bilstm_bwd_lite"),
                                          dgates, tol)
    del xg, args
    dgc = dgates.to(dtype)
    del dgates
    got = L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G)
    ref = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
    res["dW_ih"], res["dW_hh"] = rel_err(got[0], ref[0], tol), rel_err(got[1], ref[1], tol)
    # the dispatch took a tensor-core wgrad (bf16, or 3xTF32 in f32); the
    # CUDA-core one by name
    got = L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G, kernel="bilstm_wgrad")
    res["cuda_core_dW_ih"], res["cuda_core_dW_hh"] = (rel_err(got[0], ref[0], tol),
                                                      rel_err(got[1], ref[1], tol))
    torch.cuda.synchronize()
    return res


def resident_layer_check(E_parts, H, G, dtype, dev, seed, T):
    """Row 4's shape on the resident route: the forward (both variants, the
    train variant against the plain forward), the sweep and wgrad against
    the plain layer backward."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_bwd

    parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
        E_parts, H, G, dtype, dev, seed, T=T)
    tol = TOL[dtype]
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    fwd_args = (parts, lengths, w_ih, w_hh, bias, dtype)
    want = L.bilstm_layer_fwd_plain(*fwd_args, with_states=True)
    got = L.bilstm_layer_fwd_train(*fwd_args)
    res = {n: rel_err(a, b, tol) for n, a, b in zip(names, got, want)}
    res.update({f"eval_{n}": rel_err(a, b, tol)
                for n, a, b in zip(names, L.bilstm_layer_fwd(*fwd_args), want)})
    hs_f, hs_b, _, _, cs_f, cs_b = want
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, dtype)
    dxf, dxb, dgc, dbias = L.bilstm_bwd(*args)
    dw_ih, dw_hh = L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G)
    ref = bidir_layer_bwd(*args)
    grads = list(dxf) + list(dxb) + [dw_ih, dw_hh, dbias]
    refs = list(ref[0]) + list(ref[1]) + list(ref[2:])
    gnames = ([f"dxf{k}" for k in range(len(dxf))] + [f"dxb{k}" for k in range(len(dxb))]
              + ["dW_ih", "dW_hh", "dbias"])
    res.update({n: rel_err(a, b, tol) for n, a, b in zip(gnames, grads, refs)})
    if dtype == torch.float32:
        # the dispatch took the 3xTF32 sweep; the CUDA-core one by name
        old = L.bilstm_bwd(*args, kernel="bilstm_bwd")
        nx = 2 * len(dxf)
        res.update({f"cuda_core_{n}": rel_err(a, b, tol) for n, a, b in zip(
            gnames[:nx] + gnames[-1:], list(old[0]) + list(old[1]) + [old[3]],
            refs[:nx] + refs[-1:])})
    # the dispatch took a tensor-core forward (bf16, or 3xTF32 in f32); the
    # CUDA-core one by name
    res.update({f"cuda_core_{n}": rel_err(a, b, tol) for n, a, b in zip(
        names, L.bilstm_layer_fwd_train(*fwd_args, kernel="bilstm_fwd"), want)})
    # the dispatch took a tensor-core wgrad (bf16, or 3xTF32 in f32); the
    # CUDA-core one by name
    old = L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G, kernel="bilstm_wgrad")
    res["cuda_core_dW_ih"], res["cuda_core_dW_hh"] = (rel_err(old[0], ref[2], tol),
                                                      rel_err(old[1], ref[3], tol))
    torch.cuda.synchronize()
    return res


def row4_timings(dev, T=300) -> dict:
    """Kernel row 4's function (a layer's backward with dx, dW_ih, dW_hh
    and dbias) at its TPU shapes, full lengths, 400 rows, f32 and bf16 at
    H = 128 and 32: the port's layer backward on its route (``layer_bwd``:
    its sweep, then ``bilstm_wgrad``), the plain layer backward, and
    cuDNN's backward for input and weights (training forward and backward,
    less the forward) in the same dtype."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_bwd

    out = {}
    for H, dtype in ((128, torch.float32), (128, torch.bfloat16), (32, torch.float32),
                     (32, torch.bfloat16)):
        t = {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
        work = []  # (flops, bytes, peak) of each kernel the route runs
        size = torch.empty((), dtype=dtype).element_size()
        for i, (E_parts, G) in enumerate((([H], G_TRAIN), ([H, H], 1))):
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                E_parts, H, G, dtype, dev, SEED + 50 + i, full_lengths=True, T=T)
            hs_f, hs_b, _, _, cs_f, cs_b = L.layer_fwd(parts, lengths, w_ih, w_hh, bias,
                                                       dtype, with_states=True)
            args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn,
                    dtype)

            def kernels(**kernel):
                if not kernel:
                    return L.layer_bwd(*args)
                dgc = L.bilstm_bwd(*args, **kernel)[2]
                return L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G)

            if dtype == torch.float32 and L.layer_route(E_parts, H, dtype) == "resident":
                # new, old, old, new: the 3xTF32 sweep and the CUDA-core one
                a, b, c = in_turns(kernels, lambda: kernels(kernel="bilstm_bwd"), 3)
                t["kernel_ms"] += a
                t["kernel_ms_again"] = t.get("kernel_ms_again", 0.0) + b
                t["kernel_cuda_core_ms"] = t.get("kernel_cuda_core_ms", 0.0) + c
            else:
                t["kernel_ms"] += time_ms(kernels, 3)
            t["plain_ms"] += timed_once(lambda: bidir_layer_bwd(*args))[1]
            lstm = torch.nn.LSTM(sum(E_parts), H, bidirectional=True).to(dev).to(dtype)
            x = (torch.rand(T, B_TRAIN, sum(E_parts), device=dev) * 2 - 1).to(dtype)
            x.requires_grad_()
            dy = (torch.rand(T, B_TRAIN, 2 * H, device=dev) * 2 - 1).to(dtype)
            fwd_ms = time_ms(lambda: lstm(x), 3)
            full_ms = time_ms(
                lambda: torch.autograd.grad(lstm(x)[0], [x, *lstm.parameters()], dy), 3)
            t["library_ms"] += full_ms - fwd_ms
            route = L.layer_route(E_parts, H, dtype)
            wgrad_peak = kernel_peak(dtype, L.wgrad_kernel(E_parts, H, dtype))
            if route == "wide":
                w = wide_layer_work(sum(E_parts), H, G, size, len(dyf), T=T)
                peaks = {"gates": kernel_peak(dtype), "lite": kernel_peak(dtype),
                         "wgrad": wgrad_peak}
            else:
                w = train_layer_work(sum(E_parts), H, size, len(dyf), T=T, G=G)
                peaks = {"bwd": kernel_peak(dtype, L.sweep_kernel(E_parts, H, dtype)),
                         "wgrad": wgrad_peak}
            work += [(*w[k], peak) for k, peak in peaks.items()]
            t[f"route_{i}"] = route
            del parts, hs_f, hs_b, cs_f, cs_b, args, lstm, x, dy
        t["bwd_flops"], t["bwd_bytes"] = (sum(w[0] for w in work), sum(w[1] for w in work))
        t["bwd_bound_ms"], t["bwd_bound_by"] = bound(work)
        out[f"H{H}_{str(dtype).replace('torch.', '')}"] = {
            "T": T, "layers": f"E={H} (5 groups) + E=2x{H}", **t}
    return out


def ragged_wide_wgrad_check(dev, H=E_SCALED) -> list:
    """The tensor-core wgrads against their twin at the scaled width where no
    size is round: 27 rows in 3 weight groups of 9 with one input part and
    in 1 group with two, T = 1 (every h_prev past an end), in bf16
    (``bilstm_wgrad_mma``) and f32 (``bilstm_wgrad_f32``)."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_wgrad

    B, T, out = 27, 1, []
    for i, (E_parts, G, cd) in enumerate((([H], 3, torch.bfloat16), ([H, H], 1, torch.bfloat16),
                                          ([H], 3, torch.float32), ([H, H], 1, torch.float32))):
        kernel = L.bilstm_wgrad_mma if cd == torch.bfloat16 else L.bilstm_wgrad_f32
        g = torch.Generator(device=dev).manual_seed(SEED + 85 + i % 2)
        parts = tuple((torch.rand(T, B, e, generator=g, device=dev) * 2 - 1).to(cd)
                      for e in E_parts)
        hs_f, hs_b = ((torch.rand(T, B, H, generator=g, device=dev) * 2 - 1).to(cd)
                      for _ in range(2))
        dgc = (torch.rand(2, T, B, 4 * H, generator=g, device=dev) * 2 - 1).to(cd)
        ref = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
        got = kernel(dgc, parts, hs_f, hs_b, G)
        res = {"dW_ih": rel_err(got[0], ref[0], TOL[cd]), "dW_hh": rel_err(got[1], ref[1], TOL[cd])}
        torch.cuda.synchronize()
        check = {"kernel": kernel.__name__, "B": B, "G": G, "T": T, "H": H,
                 "E_parts": E_parts, "dtype": str(cd).replace("torch.", ""),
                 "max_abs_err": {n: e for n, (e, _) in res.items()},
                 "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out.append(check)
        if not all(ok for _, ok in res.values()):
            emit({"phase": "wide_kernel", "failed": check})
            raise AssertionError(f"the ragged wide wgrad disagrees with its twin: {check}")
    return out


def at_rows(candidates, rows, fn, *args):
    """``fn(*args)`` with a tensor-core wide kernel's plan held to row tiles
    of ``rows``: ``candidates`` names the plan's row tiles in
    ``ops/lstm_cuda.py`` ("LITE_MMA_ROWS", "FWD_WIDE_MMA_ROWS"), set to
    ``(rows,)`` for the call."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L

    keep = getattr(L, candidates)
    setattr(L, candidates, (rows,))
    try:
        return fn(*args)
    finally:
        setattr(L, candidates, keep)


def ragged_wide_sweep_check(dev, H=E_SCALED) -> list:
    """The tensor-core input gates, wide forward (both variants) and lite
    sweep against their twins at the scaled width where no size is round:
    27 rows in 3 weight groups of 9 (one input part) and in 1 group (two
    parts), T = 1 and 5, lengths mixing 0, 1 and T, every row tile the
    forward and the sweep take, bf16; the forward's two variants give the
    same hs bits."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep_lite, bidir_recurrence, input_gates

    cd, B, out = torch.bfloat16, 27, []
    for i, (E_parts, G, T) in enumerate((([H], 3, 1), ([H, H], 1, 1), ([H], 3, 5),
                                         ([H, H], 1, 5))):
        g = torch.Generator(device=dev).manual_seed(SEED + 90 + i)

        def u(*shape):
            return torch.rand(*shape, generator=g, device=dev) * 2 - 1

        parts = tuple(u(T, B, e).to(cd) for e in E_parts)
        w_ih = (u(2, 4 * H, sum(E_parts)) * H ** -0.5).to(cd)
        w_hh = (u(2, G, 4 * H, H) * H ** -0.5).to(cd)
        bias = u(2, 4 * H)
        lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
        lengths[:3] = torch.tensor([0, 1, T], dtype=torch.int32, device=dev)
        xg = L.bilstm_gates_mma(parts, w_ih, bias, cd)
        res = {"xg": rel_err(xg, input_gates(parts, w_ih, bias, cd), TOL[cd])}
        fwd = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
        names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
        for rows in L.FWD_WIDE_MMA_ROWS:
            got = at_rows("FWD_WIDE_MMA_ROWS", rows, L.bilstm_fwd_wide_train_mma, xg, lengths,
                          w_hh, cd)
            ev = at_rows("FWD_WIDE_MMA_ROWS", rows, L.bilstm_fwd_wide_mma, xg, lengths, w_hh, cd)
            res.update({f"fwd_rows{rows}_{n}": rel_err(a, b, TOL[cd])
                        for n, a, b in zip(names, got, fwd)})
            res.update({f"fwd_eval_rows{rows}_{n}": rel_err(a, b, TOL[cd])
                        for n, a, b in zip(names, ev, fwd)})
            res[f"fwd_rows{rows}_eval_vs_train_hs"] = (
                max(float((a.float() - b.float()).abs().max()) for a, b in zip(ev[:2], got[:2])),
                all(torch.equal(a, b) for a, b in zip(ev[:2], got[:2])))
        hs_f, hs_b, _, _, cs_f, cs_b = fwd
        ny = 2 if G > 1 else 1
        dy = [u(T, B, H).to(cd) for _ in range(2 * ny)]
        args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[ny:], u(2, B, H),
                u(2, B, H), cd)
        want = bidir_layer_sweep_lite(*args)
        for rows in L.LITE_MMA_ROWS:
            if L.wide_smem("lite_mma", H, rows) <= L.SMEM_LIMIT:
                res[f"dgates_rows{rows}"] = rel_err(
                    at_rows("LITE_MMA_ROWS", rows, L.bilstm_bwd_lite_mma, *args), want, TOL[cd])
        torch.cuda.synchronize()
        check = {"kernels": ["bilstm_gates_mma", "bilstm_fwd_wide_mma", "bilstm_bwd_lite_mma"],
                 "B": B, "G": G, "T": T,
                 "H": H, "E_parts": E_parts, "dtype": "bfloat16",
                 "max_abs_err": {n: e for n, (e, _) in res.items()},
                 "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out.append(check)
        if not all(ok for _, ok in res.values()):
            emit({"phase": "wide_kernel", "failed": check})
            raise AssertionError(f"a ragged tensor-core wide kernel disagrees with its twin: {check}")
    return out


def phase_wide_kernel(dev) -> dict:
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import (
        bidir_layer_sweep_lite,
        bidir_layer_wgrad,
        bidir_recurrence,
        input_gates,
    )

    H = E_SCALED
    scaled = [([E_SCALED], G_TRAIN), ([H, H], 1)]
    cases = [("wide", H, E_parts, G, T_TRAIN) for E_parts, G in scaled]
    # row 4's shapes (lstm_pallas_layer.py:603): H = 128 routes wide, H = 32
    # stays resident; layer 0 with grouped W_hh and a stacked layer of two parts
    cases += [("wide", 128, E_parts, G, 300) for E_parts, G in (([128], G_TRAIN), ([128, 128], 1))]
    cases += [("resident", 32, E_parts, G, 300) for E_parts, G in (([32], G_TRAIN), ([32, 32], 1))]
    checks = []
    for i, (route, h, E_parts, G, T) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            if L.layer_route(E_parts, h, dtype) != route:
                raise AssertionError(f"H={h}, E_parts={E_parts} does not take the {route} route")
            run = wide_layer_check if route == "wide" else resident_layer_check
            res = run(E_parts, h, G, dtype, dev, SEED + 30 + i, T)
            check = {"route": route, "B": B_TRAIN, "T": T, "H": h, "G": G, "E_parts": E_parts,
                     "dtype": str(dtype).replace("torch.", ""),
                     "kernels": ([L.gates_kernel(E_parts, h, dtype), L.wide_fwd_kernel(h, dtype),
                                  L.lite_kernel(h, dtype), L.wgrad_kernel(E_parts, h, dtype)]
                                 if route == "wide" else []),
                     "max_abs_err": {n: e for n, (e, _) in res.items()},
                     "tol": f"{TOL[dtype]} x max(1, max|ref|)"}
            checks.append(check)
            if not all(ok for _, ok in res.values()):
                emit({"phase": "wide_kernel", "failed": check})
                raise AssertionError(f"a {route}-route kernel disagrees with its twin: {check}")

    ragged = ragged_wide_wgrad_check(dev) + ragged_wide_sweep_check(dev)

    # times at full lengths, summed over layer 0 and one stacked layer
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        bf16 = dtype == torch.bfloat16
        t: dict = {}
        work = {k: [0.0, 0.0] for k in ("gates", "fwd", "fwd_eval", "lite", "wgrad")}

        def add(key, ms):
            t[key] = t.get(key, 0.0) + ms

        for i, (E_parts, G) in enumerate(scaled):
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                E_parts, H, G, dtype, dev, SEED + 40 + i, full_lengths=True)
            xg = L.bilstm_gates(parts, w_ih, bias, dtype)
            hs_f, hs_b, _, _, cs_f, cs_b = L.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype)
            lite_args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, dtype)
            dgc = L.bilstm_bwd_lite(*lite_args).to(dtype)
            fwd_args = (xg, lengths, w_hh, dtype)
            # new, old, old, new: a tensor-core kernel and the CUDA-core one
            # by name, on the same operands; in bf16 every kernel, in f32 wgrad
            turns = [("wgrad", lambda: L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G),
                      lambda: L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G, kernel="bilstm_wgrad"))]
            if bf16:
                turns += [
                    ("gates", lambda: L.bilstm_gates(parts, w_ih, bias, dtype),
                     lambda: L.bilstm_gates(parts, w_ih, bias, dtype, kernel="bilstm_gates")),
                    ("fwd", lambda: L.bilstm_fwd_wide_train(*fwd_args),
                     lambda: L.bilstm_fwd_wide_train(*fwd_args, kernel="bilstm_fwd_wide")),
                    ("fwd_eval", lambda: L.bilstm_fwd_wide(*fwd_args),
                     lambda: L.bilstm_fwd_wide(*fwd_args, kernel="bilstm_fwd_wide")),
                    ("lite", lambda: L.bilstm_bwd_lite(*lite_args),
                     lambda: L.bilstm_bwd_lite(*lite_args, kernel="bilstm_bwd_lite")),
                ]
            else:
                add("gates_ms", time_ms(lambda: L.bilstm_gates(parts, w_ih, bias, dtype), 3))
                add("fwd_ms", time_ms(lambda: L.bilstm_fwd_wide_train(*fwd_args), 3))
                add("fwd_eval_ms", time_ms(lambda: L.bilstm_fwd_wide(*fwd_args), 3))
                add("lite_ms", time_ms(lambda: L.bilstm_bwd_lite(*lite_args), 3))
            for key, new, old in turns:
                a, b, c = in_turns(new, old, 3)
                add(f"{key}_ms", a)
                add(f"{key}_ms_again", b)
                add(f"{key}_cuda_core_ms", c)
            if bf16:
                # the forward's and the sweep's row tiles on the same operands
                for rows in L.FWD_WIDE_MMA_ROWS:
                    add(f"fwd_rows{rows}_ms", time_ms(lambda: at_rows(
                        "FWD_WIDE_MMA_ROWS", rows, L.bilstm_fwd_wide_train_mma, *fwd_args), 3))
                    add(f"fwd_eval_rows{rows}_ms", time_ms(lambda: at_rows(
                        "FWD_WIDE_MMA_ROWS", rows, L.bilstm_fwd_wide_mma, *fwd_args), 3))
                for rows in L.LITE_MMA_ROWS:
                    if L.wide_smem("lite_mma", H, rows) <= L.SMEM_LIMIT:
                        add(f"lite_rows{rows}_ms",
                            time_ms(lambda: at_rows("LITE_MMA_ROWS", rows, L.bilstm_bwd_lite_mma,
                                                    *lite_args), 3))
            # the plain versions, timed once each (Python loops over T)
            add("gates_plain_ms", timed_once(lambda: input_gates(parts, w_ih, bias, dtype))[1])
            add("fwd_plain_ms", timed_once(
                lambda: bidir_recurrence(xg, lengths, w_hh, dtype, with_states=True))[1])
            add("fwd_eval_plain_ms", timed_once(
                lambda: bidir_recurrence(xg, lengths, w_hh, dtype))[1])
            add("lite_plain_ms", timed_once(lambda: bidir_layer_sweep_lite(*lite_args))[1])
            add("wgrad_plain_ms", timed_once(
                lambda: bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G))[1])
            # yardsticks the port never calls, in the same dtype: one cuBLAS
            # call for the input gates of both directions (f32 out), cuBLAS for
            # the weight gradients, cuDNN for the recurrence and the sweep
            x = torch.cat(parts, dim=-1).reshape(T_TRAIN * B_TRAIN, -1)
            w_t, b = w_ih.reshape(8 * H, -1).t(), bias.reshape(-1)
            if bf16:
                add("gates_library_ms",
                    time_ms(lambda: torch.addmm(b, x, w_t, out_dtype=torch.float32), 3))
                add("gates_library_bf16_out_ms",
                    time_ms(lambda: torch.addmm(b.to(dtype), x, w_t).float(), 3))
            else:
                add("gates_library_ms", time_ms(lambda: torch.addmm(b, x, w_t), 3))
            add("wgrad_library_ms", time_ms(wgrad_library(dgc, parts, hs_f, hs_b, G), 3))
            del x, w_t
            lstm = torch.nn.LSTM(sum(E_parts), H, bidirectional=True).to(dev).to(dtype)
            xl = (torch.rand(T_TRAIN, B_TRAIN, sum(E_parts), device=dev) * 2 - 1).to(dtype)
            xl.requires_grad_()
            dy = (torch.rand(T_TRAIN, B_TRAIN, 2 * H, device=dev) * 2 - 1).to(dtype)
            fwd_ms = time_ms(lambda: lstm(xl), 3)
            with torch.inference_mode():
                add("fwd_eval_library_ms", time_ms(lambda: lstm(xl), 3))
            for prm in lstm.parameters():
                prm.requires_grad_(False)
            data_ms = time_ms(lambda: torch.autograd.grad(lstm(xl)[0], [xl], dy), 3)
            add("fwd_library_ms", fwd_ms)
            add("lite_library_ms", data_ms - fwd_ms)
            del lstm, xl, dy
            for k, (f, b) in wide_layer_work(sum(E_parts), H, G, size, len(dyf)).items():
                work[k][0] += f
                work[k][1] += b
            del parts, xg, hs_f, hs_b, cs_f, cs_b, dgc, lite_args, fwd_args, turns
        # the f32 wgrad runs three tf32 products for each f32 one; the
        # CUDA-core kernel's bound at the f32 rate beside it
        add_bounds(t, work, dtype, None if bf16 else {
            "wgrad": kernel_peak(dtype, "bilstm_wgrad_f32")})
        if not bf16:
            t["wgrad_cuda_core_bound_ms"], t["wgrad_cuda_core_bound_by"] = bound(
                [(*work["wgrad"], PEAK_F32_FLOPS)])
        timings[name] = t
    timings["row4"] = row4_timings(dev)
    cluster_counts = {f"{k[0]} {str(k[1]).replace('torch.', '')} H={k[2]} R={k[3]}": v
                      for k, v in L._cluster_counts.items()}
    out = {"phase": "wide_kernel", "checks": checks, "ragged_checks": ragged,
           "timings": timings,
           "max_active_clusters": cluster_counts,
           "shape": {"B": B_TRAIN, "groups": G_TRAIN, "T": T_TRAIN, "H": H,
                     "layers": "E=256 (grouped W_hh) + E=2x256"}}
    emit(out)
    return out


def phase_train_scaled(dev, warmup=2, steps=6) -> dict:
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.train import Trainer

    rng = np.random.default_rng(SEED + 2)
    net = intrepppid_network(steps_per_epoch=100, embedding_size=E_SCALED,
                             rnn_num_layers=LAYERS_SCALED, compute_dtype=torch.bfloat16,
                             optimizer_type="ranger21_xx", device=dev, seed=SEED)
    trainer = Trainer(net, seed=SEED)
    batches = [quintuplet_batch(rng, PAIRS_TRAIN, T_TRAIN) for _ in range(3)]
    counters = train_counters()
    # the main path: the train steps and the eval step below
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    for i in range(warmup + steps):
        t = time.perf_counter()
        aux = trainer.train_step(batches[i % len(batches)])
        losses.append(aux["loss"].item())
        if i >= warmup:
            step_ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    eval_loss = trainer.eval_step(batches[0])["loss"].item()
    eval_ms = (time.perf_counter() - t) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    breakdown = profile_device(
        lambda: trainer.train_step(batches[0])["loss"].item(), top=12,
        groups={"gates_mma": "bilstm_gates_mma_kernel",
                "gates_cuda_core": "bilstm_gates_kernel",
                "fwd_wide_mma": "bilstm_fwd_wide_mma_kernel",
                "fwd_wide": "bilstm_fwd_wide_kernel",
                "lite_mma": "bilstm_bwd_lite_mma_kernel",
                "lite_cuda_core": "bilstm_bwd_lite_kernel",
                "wgrad_mma": "bilstm_wgrad_mma_kernel",
                "wgrad_cuda_core": ("bilstm_wgrad_kernel", "bilstm_wgrad_f32_kernel"),
                "gemm": ("gemm", "nvjet", "xmma")})
    if not all(np.isfinite(losses + [eval_loss])):
        raise AssertionError(f"non-finite scaled loss: {losses}, eval {eval_loss}")
    missing = [n for n in ("bilstm_gates_mma", "bilstm_fwd_wide_train_mma", "bilstm_fwd_wide_mma",
                           "bilstm_bwd_lite_mma", "bilstm_wgrad_mma") if launches[n] <= 0]
    old = [n for n in ("bilstm_layer_fwd_train", "bilstm_layer_fwd_train_mma", "bilstm_bwd",
                       "bilstm_bwd_mma", "bilstm_layer_fwd", "bilstm_layer_fwd_mma",
                       "bilstm_wgrad", "bilstm_wgrad_f32", "bilstm_layer_fwd_f32",
                       "bilstm_layer_fwd_train_f32", "bilstm_bwd_f32", "bilstm_gates",
                       "bilstm_fwd_wide_train", "bilstm_fwd_wide", "bilstm_bwd_lite")
           if launches[n] != 0]
    if missing or old:
        raise AssertionError(
            f"the scaled steps missed {missing} or ran the resident kernels or the CUDA-core "
            f"gates, forward, sweep or wgrad: {old}")
    del trainer, net
    # card gradients at the scaled widths: in f32 (the CUDA-core gates, wide
    # forward and lite sweep, whose main path this step and the eval step
    # after it are, and the 3xTF32 wgrad) and in bf16 (the tensor-core ones)
    grad_check = train_grad_check(dev, eval_step=True, embedding_size=E_SCALED,
                                  rnn_num_layers=LAYERS_SCALED)
    grad_check_bf16 = train_grad_check(dev, dtype=torch.bfloat16, embedding_size=E_SCALED,
                                       rnn_num_layers=LAYERS_SCALED)
    for check, want, never in (
            (grad_check, ("bilstm_gates", "bilstm_bwd_lite", "bilstm_fwd_wide_train",
                          "bilstm_fwd_wide", "bilstm_wgrad_f32"),
             ("bilstm_gates_mma", "bilstm_bwd_lite_mma", "bilstm_fwd_wide_train_mma",
              "bilstm_fwd_wide_mma", "bilstm_wgrad")),
            (grad_check_bf16, ("bilstm_gates_mma", "bilstm_bwd_lite_mma", "bilstm_wgrad_mma",
                               "bilstm_fwd_wide_train_mma"),
             ("bilstm_gates", "bilstm_bwd_lite", "bilstm_wgrad", "bilstm_fwd_wide_train"))):
        ran = check["launches"]
        if any(ran.get(n, 0) <= 0 for n in want) or any(ran.get(n, 0) for n in never):
            raise AssertionError(f"the {check['dtype']} gradient step at the scaled widths ran "
                                 f"{ran}; it must run {want} and never {never}")
    median = float(np.median(step_ms))
    out = {"phase": "train_scaled", "embedding": E_SCALED, "layers": LAYERS_SCALED,
           "pairs": PAIRS_TRAIN, "T": T_TRAIN, "dtype": "bfloat16", "optimizer": "ranger21_xx",
           "dropout": 0.3, "step_ms": step_ms, "median_step_ms": median,
           "pairs_per_s": PAIRS_TRAIN / median * 1e3, "losses": losses,
           "eval_loss": eval_loss, "eval_step_ms": eval_ms, "launches": launches,
           "peak_memory_gib": peak_gib, "step_profile": breakdown, "grad_check": grad_check,
           "grad_check_bf16": grad_check_bf16}
    emit(out)
    return out


# ------------------------------------------------- the time-major recurrence
D_REC = 2
# (H, G, T): the manuscript width with the train step's 5 weight groups and
# with shared weights, the scaled width, and H = 32
REC_SHAPES = ((H_SERVE, G_TRAIN, T_TRAIN), (H_SERVE, 1, T_TRAIN), (E_SCALED, G_TRAIN, T_TRAIN),
              (32, G_TRAIN, 300))


def recurrence_inputs(T, H, G, dtype, dev, mask, seed, B=B_TRAIN, D=D_REC):
    """Operands of the recurrence op. ``mask`` "lengths": ``valid`` as the
    layer builds it, a prefix for direction 0 and a suffix for direction 1,
    lengths mixing 0, 1, T and random values; "holes": drawn at random
    (70 % on) with an all-zero and an all-one row."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 2 - 1

    xg = u(T, D, B, 4 * H)
    w = (u(D, G, H, 4 * H) * H ** -0.5).to(dtype).contiguous()
    if mask == "lengths":
        lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev)
        lengths[0], lengths[1], lengths[2] = 0, 1, T
        lengths[3::4] = T
        steps = torch.arange(T, device=dev)
        valid = torch.stack([steps[:, None] < lengths[None, :],
                             (T - 1 - steps)[:, None] < lengths[None, :]], dim=1)
    else:
        valid = torch.rand(T, D, B, generator=g, device=dev) < 0.7
        valid[:, :, 0] = False
        valid[:, :, 1] = True
    return xg, valid, w, u(T, D, B, H), u(D, B, H), u(D, B, H)


def recurrence_work(T, H, G, size, B=B_TRAIN, D=D_REC):
    """(flops, bytes) of each recurrence kernel: every step is computed
    whatever the mask, 4H x H multiply-adds per row, step and direction
    (twice in the sweep: gate recompute and dh); each input read once and
    each output written once (every stream f32, the mask one byte)."""
    rows = D * B * T
    state = D * B * H * 4
    w = D * G * H * 4 * H
    xg, st = rows * 4 * H * 4, rows * H * 4
    return {
        "fwd": (2 * rows * 4 * H * H, xg + rows + w * size + 2 * st + 2 * state),
        "bwd": (2 * rows * 4 * H * 2 * H, xg + rows + w * size + 3 * st + 2 * state + xg),
        "wgrad": (2 * D * B * (T - 1) * 4 * H * H, st + xg + w * 4),
    }


def timed_once(fn):
    """(result, ms) of one call, CUDA events around it: for the plain
    versions, whose Python loops over T are too slow to repeat."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def recurrence_library(T, H, dev, B=B_TRAIN, dtype=torch.float32):
    """cuDNN yardstick in ``dtype``, TF32 off: one bidirectional ``nn.LSTM``
    layer (input width H) at full lengths. It also does the input
    projection, which the op takes precomputed. Training-mode forward, and
    the backward for the input alone (training forward and backward, less
    the forward)."""
    lstm = torch.nn.LSTM(H, H, bidirectional=True).to(dev).to(dtype)
    lstm.flatten_parameters()
    x = (torch.rand(T, B, H, device=dev) * 2 - 1).to(dtype).requires_grad_()
    dy = (torch.rand(T, B, 2 * H, device=dev) * 2 - 1).to(dtype)
    fwd_ms = time_ms(lambda: lstm(x), 3)
    for prm in lstm.parameters():
        prm.requires_grad_(False)
    data_ms = time_ms(lambda: torch.autograd.grad(lstm(x)[0], [x], dy), 3)
    return fwd_ms, data_ms - fwd_ms


def ragged_recurrence_check(dev) -> list:
    """The tensor-core recurrence sweeps against their twin where no size is
    round: 27 rows in 3 weight groups of 9, T = 1, D = 2, both masks, bf16
    and f32 (3xTF32); then the tensor-core wgrad there at T = 1 (no row), 2
    and 5, at H = 64 and at H = 96 (a partial column tile)."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import (
        recurrence_fwd,
        recurrence_sweep,
        recurrence_wgrad,
    )

    cd, out = torch.bfloat16, []
    for sweep, mask in ((sweep, mask) for sweep in (L.lstm_recurrence_bwd_mma,
                                                    L.lstm_recurrence_bwd_f32)
                        for mask in ("lengths", "holes")):
        dt = torch.bfloat16 if sweep is L.lstm_recurrence_bwd_mma else torch.float32
        xg, valid, w, dhs, dhn, dcn = recurrence_inputs(1, H_SERVE, 3, dt, dev, mask,
                                                        SEED + 80, B=27)
        hs, cs, _, _ = recurrence_fwd(xg, valid, w, 3, dt)
        args = (xg, valid, w, hs, cs, dhs, dhn, dcn, 3, dt)
        e, ok = rel_err(sweep(*args), recurrence_sweep(*args), TOL[dt])
        torch.cuda.synchronize()
        check = {"kernel": sweep.__name__, "B": 27, "G": 3, "T": 1, "D": D_REC,
                 "H": H_SERVE, "dtype": str(dt).replace("torch.", ""), "mask": mask,
                 "max_abs_err": {"dxg": e}, "tol": f"{TOL[dt]} x max(1, max|ref|)"}
        out.append(check)
        if not ok:
            emit({"phase": "recurrence_kernel", "failed": check})
            raise AssertionError(f"the ragged recurrence sweep disagrees with its twin: {check}")
    for H in (H_SERVE, 96):
        for T in (1, 2, 5):
            g = torch.Generator(device=dev).manual_seed(SEED + 85 + T)
            hs = torch.rand(T, D_REC, 27, H, generator=g, device=dev) * 2 - 1
            dxg = torch.rand(T, D_REC, 27, 4 * H, generator=g, device=dev) * 2 - 1
            e, ok = rel_err(L.lstm_recurrence_wgrad_mma(hs, dxg, 3, cd),
                            recurrence_wgrad(hs, dxg, 3, cd), TOL[cd])
            torch.cuda.synchronize()
            check = {"kernel": "lstm_recurrence_wgrad_mma", "B": 27, "G": 3, "T": T, "D": D_REC,
                     "H": H, "dtype": "bfloat16", "max_abs_err": {"dw": e},
                     "tol": f"{TOL[cd]} x max(1, max|ref|)"}
            out.append(check)
            if not ok:
                emit({"phase": "recurrence_kernel", "failed": check})
                raise AssertionError(
                    f"the ragged recurrence wgrad disagrees with its twin: {check}")
    return out


def cluster_sweep_h128(dev, H=128) -> dict:
    """The cluster sweep ``lstm_recurrence_bwd.cu`` at the shapes of its main
    path, the f32 recurrence-backend steps of a one-layer model at
    embedding 128 (H = 128 > 64, which the tensor-core sweeps do not take):
    D = 2, 400 rows in 5 weight groups, T = 1500, masks from lengths; held
    against its plain twin (timed once), then timed beside its bound at the
    CUDA cores' f32 rate and cuDNN's one-layer backward for the input, TF32
    off."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import recurrence_fwd, recurrence_sweep

    cd, G = torch.float32, G_TRAIN
    if L.recurrence_sweep_kernel(H, cd) != "lstm_recurrence_bwd":
        raise AssertionError(f"H={H}'s sweep is {L.recurrence_sweep_kernel(H, cd)}")
    xg, valid, w, dhs, dhn, dcn = recurrence_inputs(T_TRAIN, H, G, cd, dev, "lengths", SEED + 90)
    hs, cs, _, _ = recurrence_fwd(xg, valid, w, G, cd)
    args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
    want, plain_ms = timed_once(lambda: recurrence_sweep(*args))
    e, ok = rel_err(L.lstm_recurrence_bwd(*args), want, TOL[cd])
    torch.cuda.synchronize()
    out = {"kernel": "lstm_recurrence_bwd", "B": B_TRAIN, "T": T_TRAIN, "D": D_REC, "H": H,
           "G": G, "dtype": "float32", "mask": "lengths", "max_abs_err": {"dxg": e},
           "tol": f"{TOL[cd]} x max(1, max|ref|)", "plain_ms": plain_ms,
           "ms": time_ms(lambda: L.lstm_recurrence_bwd(*args), 3)}
    if not ok:
        emit({"phase": "recurrence_kernel", "failed": out})
        raise AssertionError(f"the cluster sweep disagrees with its plain version: {out}")
    add_bounds(out, {"bwd": recurrence_work(T_TRAIN, H, G, 4)["bwd"]}, cd)
    del xg, valid, w, dhs, hs, cs, want, args
    out["library_ms"] = recurrence_library(T_TRAIN, H, dev)[1]
    return out


def recurrence_past_288(dev) -> dict:
    """The recurrence op's kernels past the 256 units they once stopped at:
    H = 288 (the cluster kernels' 288-thread instance) and 512 and 1024 (the
    global-weight instance, its slices read from an L2-resident copy), D =
    2, 16 rows in 2 weight groups, T = 64, masks from lengths, f32 and
    bf16: the forward, the sweep and the weight gradient against their plain
    twins (``checks``). Then one call of each at H = 512, 400 rows in 5
    groups, T = 300, full-length masks, timed beside its plain twin (timed
    once, in the check), its bound (f32 CUDA cores; the bf16 wgrad at the
    bf16 rate) and cuDNN's one-layer bidirectional LSTM at that width in
    the same dtype, TF32 off (``h512``)."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import (
        recurrence_fwd,
        recurrence_sweep,
        recurrence_wgrad,
    )

    checks, h512 = [], {}
    for H in (288, 512, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[dtype]
            xg, valid, w, dhs, dhn, dcn = recurrence_inputs(64, H, 2, dtype, dev, "lengths",
                                                            SEED + H, B=16)
            ref = recurrence_fwd(xg, valid, w, 2, dtype)
            res = {n: rel_err(a, b, tol) for n, a, b in zip(
                ("hs", "cs", "hn", "cn"), L.lstm_recurrence_fwd(xg, valid, w, 2, dtype), ref)}
            args = (xg, valid, w, ref[0], ref[1], dhs, dhn, dcn, 2, dtype)
            dxg = recurrence_sweep(*args)
            res["dxg"] = rel_err(L.lstm_recurrence_bwd(*args), dxg, tol)
            res["dw"] = rel_err(L.lstm_recurrence_wgrad(ref[0], dxg, 2, dtype),
                                recurrence_wgrad(ref[0], dxg, 2, dtype), tol)
            torch.cuda.synchronize()
            check = {"B": 16, "T": 64, "D": D_REC, "H": H, "G": 2, "mask": "lengths",
                     "dtype": str(dtype).replace("torch.", ""),
                     "sweep": L.recurrence_sweep_kernel(H, dtype),
                     "wgrad": L.recurrence_wgrad_kernel(H, dtype),
                     "global_weights": H > L.WIDE_MAX_THREADS,
                     "max_abs_err": {n: e for n, (e, _) in res.items()},
                     "tol": f"{tol} x max(1, max|ref|)"}
            checks.append(check)
            if not all(ok for _, ok in res.values()):
                emit({"phase": "recurrence_kernel", "failed": check})
                raise AssertionError(f"the recurrence op past 288 disagrees: {check}")
            del xg, valid, w, dhs, ref, args, dxg
    H, G, T = 512, G_TRAIN, 300
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.empty((), dtype=dtype).element_size()
        xg, valid, w, dhs, dhn, dcn = recurrence_inputs(T, H, G, dtype, dev, "lengths",
                                                        SEED + 95)
        valid.fill_(True)
        ref, fwd_plain_ms = timed_once(lambda: recurrence_fwd(xg, valid, w, G, dtype))
        hs, cs = ref[:2]
        args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, dtype)
        dxg, bwd_plain_ms = timed_once(lambda: recurrence_sweep(*args))
        _, wgrad_plain_ms = timed_once(lambda: recurrence_wgrad(hs, dxg, G, dtype))
        t = {"B": B_TRAIN, "T": T, "D": D_REC, "H": H, "G": G,
             "dtype": str(dtype).replace("torch.", ""),
             "wgrad": L.recurrence_wgrad_kernel(H, dtype),
             "max_abs_err": {"hs": rel_err(L.lstm_recurrence_fwd(xg, valid, w, G, dtype)[0],
                                           hs, TOL[dtype])[0],
                             "dxg": rel_err(L.lstm_recurrence_bwd(*args), dxg, TOL[dtype])[0]},
             "fwd_ms": time_ms(lambda: L.lstm_recurrence_fwd(xg, valid, w, G, dtype), 3),
             "bwd_ms": time_ms(lambda: L.lstm_recurrence_bwd(*args), 3),
             "wgrad_ms": time_ms(lambda: L.lstm_recurrence_wgrad(hs, dxg, G, dtype), 3),
             "fwd_plain_ms": fwd_plain_ms, "bwd_plain_ms": bwd_plain_ms,
             "wgrad_plain_ms": wgrad_plain_ms}
        add_bounds(t, recurrence_work(T, H, G, size), torch.float32,
                   {"wgrad": kernel_peak(dtype)})
        del xg, valid, w, dhs, ref, hs, cs, args, dxg
        t["fwd_library_ms"], t["bwd_library_ms"] = recurrence_library(T, H, dev, dtype=dtype)
        h512[t["dtype"]] = t
    return {"checks": checks, "h512": h512}


def phase_recurrence_kernel(dev) -> dict:
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import (
        recurrence_fwd,
        recurrence_sweep,
        recurrence_wgrad,
    )

    checks, timings = [], []
    for i, (H, G, T) in enumerate(REC_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            size = torch.empty((), dtype=dtype).element_size()
            for mask in ("lengths", "holes"):
                xg, valid, w, dhs, dhn, dcn = recurrence_inputs(
                    T, H, G, dtype, dev, mask, SEED + 60 + i)
                tol = TOL[dtype]
                ref, fwd_plain_ms = timed_once(lambda: recurrence_fwd(xg, valid, w, G, dtype))
                got = L.lstm_recurrence_fwd(xg, valid, w, G, dtype)
                res = {n: rel_err(a, b, tol)
                       for n, a, b in zip(("hs", "cs", "hn", "cn"), got, ref)}
                del got
                hs, cs = ref[:2]
                args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, dtype)
                dxg, bwd_plain_ms = timed_once(lambda: recurrence_sweep(*args))
                # the sweep the dispatch picks (at H <= 64 a tensor-core kernel:
                # bf16, or 3xTF32 in f32), and there also the cluster kernel by name
                sweep = L.recurrence_sweep_kernel(H, dtype)
                res["dxg"] = rel_err(L.lstm_recurrence_bwd(*args), dxg, tol)
                if sweep != "lstm_recurrence_bwd":
                    res["cluster_dxg"] = rel_err(
                        L.lstm_recurrence_bwd(*args, kernel="lstm_recurrence_bwd"), dxg, tol)
                dw, wgrad_plain_ms = timed_once(lambda: recurrence_wgrad(hs, dxg, G, dtype))
                # the wgrad the dispatch picks (bf16: the tensor-core kernel),
                # and there also the CUDA-core kernel by name
                wgrad = L.recurrence_wgrad_kernel(H, dtype)
                res["dw"] = rel_err(L.lstm_recurrence_wgrad(hs, dxg, G, dtype), dw, tol)
                if wgrad == "lstm_recurrence_wgrad_mma":
                    res["cuda_core_dw"] = rel_err(L.lstm_recurrence_wgrad(
                        hs, dxg, G, dtype, kernel="lstm_recurrence_wgrad"), dw, tol)
                torch.cuda.synchronize()
                shape = {"B": B_TRAIN, "T": T, "D": D_REC, "H": H, "G": G,
                         "dtype": str(dtype).replace("torch.", ""), "mask": mask,
                         "sweep": sweep, "wgrad": wgrad}
                check = {**shape, "valid_share": float(valid.float().mean()),
                         "max_abs_err": {n: e for n, (e, _) in res.items()},
                         "tol": f"{tol} x max(1, max|ref|)"}
                checks.append(check)
                if not all(ok for _, ok in res.values()):
                    emit({"phase": "recurrence_kernel", "failed": check})
                    raise AssertionError(
                        f"a recurrence kernel disagrees with its plain version: {check}")
                t = {**shape,
                     "fwd_ms": time_ms(lambda: L.lstm_recurrence_fwd(xg, valid, w, G, dtype), 3),
                     "bwd_ms": time_ms(lambda: L.lstm_recurrence_bwd(*args), 3),
                     "fwd_plain_ms": fwd_plain_ms, "bwd_plain_ms": bwd_plain_ms,
                     "wgrad_plain_ms": wgrad_plain_ms}
                new_wgrad = lambda: L.lstm_recurrence_wgrad(hs, dxg, G, dtype)  # noqa: E731
                if wgrad == "lstm_recurrence_wgrad_mma":
                    # new, old, old, new: both wgrads in one run, on one card
                    t["wgrad_ms"], t["wgrad_ms_again"], t["wgrad_cuda_core_ms"] = in_turns(
                        new_wgrad, lambda: L.lstm_recurrence_wgrad(
                            hs, dxg, G, dtype, kernel="lstm_recurrence_wgrad"), 3)
                else:
                    t["wgrad_ms"] = time_ms(new_wgrad, 3)
                if sweep != "lstm_recurrence_bwd":
                    # new, old, old, new: both sweeps in one run, on one card
                    old = [time_ms(lambda: L.lstm_recurrence_bwd(
                        *args, kernel="lstm_recurrence_bwd"), 3) for _ in range(2)]
                    t["bwd_cluster_ms"] = 0.5 * (old[0] + old[1])
                    t["bwd_ms_again"] = time_ms(lambda: L.lstm_recurrence_bwd(*args), 3)
                add_bounds(t, recurrence_work(T, H, G, size), dtype,
                           {"bwd": kernel_peak(dtype, sweep)})
                library = mask == "lengths" and (dtype == torch.float32 or H != E_SCALED)
                if library:
                    # yardsticks the port never calls: cuDNN for the recurrence
                    # and the sweep (it also does the input projection), one
                    # batched cuBLAS product for the weight gradient, on the
                    # operands rounded to the compute dtype as the kernel reads
                    # them ("bmm alone") and, in bf16, the whole function in
                    # PyTorch from the f32 streams: round, lay out, multiply
                    Bg = B_TRAIN // G

                    def operands(cast):
                        hp = hs[:-1].to(cast).view(T - 1, D_REC, G, Bg, H).permute(
                            1, 2, 4, 0, 3).reshape(D_REC, G, H, (T - 1) * Bg)
                        dg = dxg[1:].to(cast).view(T - 1, D_REC, G, Bg, 4 * H).permute(
                            1, 2, 0, 3, 4).reshape(D_REC, G, (T - 1) * Bg, 4 * H)
                        return hp, dg

                    hp, dg = operands(dtype)
                    t["wgrad_library_ms"] = time_ms(lambda: torch.matmul(hp, dg), 3)
                    del hp, dg
                    if dtype == torch.bfloat16:
                        t["wgrad_round_bmm_ms"] = time_ms(
                            lambda: torch.matmul(*operands(dtype)), 3)
                del xg, valid, w, dhs, ref, hs, cs, dxg, dw, args
                if library:
                    t["fwd_library_ms"], t["bwd_library_ms"] = recurrence_library(
                        T, H, dev, dtype=dtype)
                timings.append(t)
    cluster_counts = {f"{k[0]} {str(k[1]).replace('torch.', '')} H={k[2]} R={k[3]}": v
                      for k, v in L._cluster_counts.items() if k[0].startswith("lstm_rec")}
    ragged = ragged_recurrence_check(dev)
    out = {"phase": "recurrence_kernel", "checks": checks, "ragged_checks": ragged,
           "timings": timings, "cluster_h128": cluster_sweep_h128(dev),
           "past_288": recurrence_past_288(dev),
           "max_active_clusters": cluster_counts,
           "library": "one bidirectional nn.LSTM layer (cuDNN, full lengths; f32, and bf16 at "
                      "H = 64 and 32), which also does the input projection; cuBLAS for wgrad "
                      "in the compute dtype"}
    emit(out)
    return out


def phase_recurrence_path(dev, warmup=2, steps=4) -> dict:
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.ops import lstm
    from intrepppid_tpu_torch.train import Trainer

    new = ("lstm_recurrence_fwd", "lstm_recurrence_bwd_mma", "lstm_recurrence_wgrad_mma")
    lstm.DEFAULT_BACKEND = "recurrence"
    try:
        rng = np.random.default_rng(SEED)
        net = intrepppid_network(steps_per_epoch=100, compute_dtype=torch.bfloat16,
                                 optimizer_type="ranger21_xx", device=dev, seed=SEED)
        trainer = Trainer(net, seed=SEED)
        batches = [quintuplet_batch(rng, PAIRS_TRAIN, T_TRAIN) for _ in range(4)]
        counters = train_counters()
        # the main path: the train steps and the eval step below
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms = [], []
        for i in range(warmup + steps):
            t = time.perf_counter()
            aux = trainer.train_step(batches[i % len(batches)])
            losses.append(aux["loss"].item())
            if i >= warmup:
                step_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        eval_loss = trainer.eval_step(batches[0])["loss"].item()
        eval_ms = (time.perf_counter() - t) * 1e3
        launches = {name: fn.launches for name, fn in counters.items()}
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        breakdown = profile_device(
            lambda: trainer.train_step(batches[0])["loss"].item(), top=12,
            groups={"fwd": "lstm_recurrence_fwd_kernel",
                    "sweep_mma": "lstm_recurrence_bwd_mma_kernel",
                    "sweep_f32": "lstm_recurrence_bwd_f32_kernel",
                    "sweep_cluster": "lstm_recurrence_bwd_kernel",
                    "wgrad_mma": "lstm_recurrence_wgrad_mma_kernel",
                    "wgrad": "lstm_recurrence_wgrad_kernel", "gemm": ("gemm", "nvjet", "xmma")})
        if not all(np.isfinite(losses + [eval_loss])):
            raise AssertionError(
                f"non-finite loss on the recurrence backend: {losses}, eval {eval_loss}")
        missing = [n for n in new if launches[n] <= 0]
        layer = [n for n, c in launches.items() if n not in new and c != 0]
        if missing or layer:
            raise AssertionError(
                f"the recurrence-backend steps missed {missing} or ran the cluster sweep, the "
                f"CUDA-core wgrad or a layer kernel: {layer}")
        del trainer, net
        layer_kernels = tuple(n for n in train_counters() if n.startswith("bilstm_"))
        f32 = f32_steps(dev, batches,
                        ("lstm_recurrence_fwd", "lstm_recurrence_bwd_f32",
                         "lstm_recurrence_wgrad"),
                        ("lstm_recurrence_bwd_mma", "lstm_recurrence_wgrad_mma",
                         "lstm_recurrence_bwd") + layer_kernels)
        # the cluster sweep keeps the widths past 64: a one-layer f32 model
        # at embedding 128 runs it
        f32_cluster = f32_steps(dev, batches,
                                ("lstm_recurrence_fwd", "lstm_recurrence_bwd",
                                 "lstm_recurrence_wgrad"),
                                ("lstm_recurrence_bwd_mma", "lstm_recurrence_bwd_f32",
                                 "lstm_recurrence_wgrad_mma") + layer_kernels,
                                embedding_size=128, rnn_num_layers=1)
        # the card's gradients against the CPU's, both on this backend
        grad_check = train_grad_check(dev)
        grad_check_bf16 = train_grad_check(dev, dtype=torch.bfloat16)
        # a one-layer model at embedding 320: the forward and the cluster
        # sweep past 288, on their global-weight instance
        grad_check_320 = {str(dtype).replace("torch.", ""): train_grad_check(
            dev, dtype=dtype, eval_step=True, expect=(
                "lstm_recurrence_fwd", "lstm_recurrence_bwd", wgrad), embedding_size=320,
            rnn_num_layers=1)
            for dtype, wgrad in ((torch.float32, "lstm_recurrence_wgrad"),
                                 (torch.bfloat16, "lstm_recurrence_wgrad_mma"))}
    finally:
        lstm.DEFAULT_BACKEND = "auto"
    median = float(np.median(step_ms))
    out = {"phase": "recurrence_path", "backend": "recurrence", "pairs": PAIRS_TRAIN,
           "T": T_TRAIN, "dtype": "bfloat16", "optimizer": "ranger21_xx", "dropout": 0.3,
           "step_ms": step_ms, "median_step_ms": median,
           "pairs_per_s": PAIRS_TRAIN / median * 1e3, "losses": losses,
           "eval_loss": eval_loss, "eval_step_ms": eval_ms, "launches": launches,
           "peak_memory_gib": peak_gib, "step_profile": breakdown, "float32_steps": f32,
           "float32_steps_embedding_128": f32_cluster, "grad_check": grad_check,
           "grad_check_bf16": grad_check_bf16, "grad_check_embedding_320": grad_check_320}
    emit(out)
    return out


# ------------------------------------------------------------------ infer
def phase_infer(dev, n_seqs=1200, n_pairs=4000, trunc_len=1500, batch=64, vocab=258) -> dict:
    """``infer from_csv`` file to file on a synthetic proteome, built as
    ``tools/bench_infer.py`` builds it."""
    from intrepppid_tpu_torch.__main__ import main as cli
    from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
    from intrepppid_tpu_torch.ops.lstm_cuda import bilstm_layer_fwd, bilstm_layer_fwd_f32
    from intrepppid_tpu_torch.utils.convert import save_reference_checkpoint

    spm = ROOT / "tests" / "fixtures" / "golden_spm.model"
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fasta, pairs, head = tmp / "proteome.fasta", tmp / "pairs.csv", tmp / "head.csv"
        seqs = ["".join(rng.choice(list(AAS), int(rng.integers(200, 2 * trunc_len))))
                for _ in range(n_seqs)]
        fasta.write_text("".join(f">P{i:05d}\n{s}\n" for i, s in enumerate(seqs)))
        rows = [f"itx{i},P{rng.integers(n_seqs):05d},P{rng.integers(n_seqs):05d}"
                for i in range(n_pairs)]
        pairs.write_text("\n".join(rows) + "\n")
        head.write_text("\n".join(rows[:batch]) + "\n")
        ckpt = tmp / "model.ckpt"
        save_reference_checkpoint(random_jax_params(SEED, V=vocab), ckpt)

        def run(csv_in, out, device):
            return cli(["infer", "from_csv", "--interactions_path", str(csv_in),
                        "--sequences_path", str(fasta), "--weights_path", str(ckpt),
                        "--spm_path", str(spm), "--out_path", str(out),
                        "--trunc_len", str(trunc_len), "--batch_size", str(batch),
                        "--vocab_size", str(vocab), "--device", device])

        # the main path: the command, file to file, through the f32
        # tensor-core forward and never bilstm_fwd.cu
        bilstm_layer_fwd.launches = bilstm_layer_fwd_f32.launches = 0
        t = time.perf_counter()
        n = run(pairs, tmp / "scores.csv", str(dev))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches, cuda_core_launches = bilstm_layer_fwd_f32.launches, bilstm_layer_fwd.launches
        got = [ln.split(",") for ln in (tmp / "scores.csv").read_text().splitlines()]
        # where the time goes: the same command under the profiler (device
        # busy time and idle share), and the sequence library's tokenising
        # on its own
        breakdown = profile_device(lambda: run(pairs, tmp / "again.csv", str(dev)))
        spp = SentencePieceTokenizer(spm)
        t = time.perf_counter()
        spp.encode_batch_padded(seqs, trunc_len, workers=8)
        tokenise_s = time.perf_counter() - t
        # the first batch on the CPU: the same command, the plain forward
        t = time.perf_counter()
        run(head, tmp / "head_scores.csv", "cpu")
        cpu_s = time.perf_counter() - t
        ref = [ln.split(",") for ln in (tmp / "head_scores.csv").read_text().splitlines()]
    ids = [r[0] for r in got]
    probs = np.array([float(r[1]) for r in got])
    if n != n_pairs or ids != [f"itx{i}" for i in range(n_pairs)]:
        raise AssertionError(f"infer wrote {len(ids)} rows (returned {n}), or out of input order")
    if not np.all(np.isfinite(probs)) or not np.all((probs > 0) & (probs < 1)):
        raise AssertionError("infer wrote probabilities that are not finite values in (0, 1)")
    if launches <= 0 or cuda_core_launches != 0:
        raise AssertionError(
            f"infer launched the f32 tensor-core forward {launches} times and bilstm_fwd.cu "
            f"{cuda_core_launches} times (want > 0 and 0)")
    if [r[0] for r in ref] != ids[:batch]:
        raise AssertionError("the CPU run of the first batch wrote other ids")
    err = float(np.abs(probs[:batch] - np.array([float(r[1]) for r in ref])).max())
    if not err <= 1e-4:
        raise AssertionError(f"infer probabilities differ from the CPU forward by {err}")
    out = {"phase": "infer", "sequences": n_seqs, "pairs": n_pairs, "trunc_len": trunc_len,
           "batch_size": batch, "vocab": vocab, "file_to_file_s": seconds,
           "pairs_per_s": n_pairs / seconds, "launches": launches,
           "cuda_core_launches": cuda_core_launches, "max_abs_err_vs_cpu": err, "cpu_sample": batch, "cpu_reference_s": cpu_s,
           "tokenise_library_s": tokenise_s, "second_run_profile": breakdown}
    emit(out)
    return out


# ------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import intrepppid_tpu_torch  # noqa: F401  (fails outside a checkout)

    # the plain versions and the cuDNN yardstick in true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    seconds = {}

    def run(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - t, 1)
        return out

    run(phase_build)
    kern = run(phase_kernel, dev)
    serve = run(phase_serve, dev)
    tk = run(phase_train_kernel, dev)
    train = run(phase_train, dev)
    widths = run(phase_widths, dev)
    wk = run(phase_wide_kernel, dev)
    scaled = run(phase_train_scaled, dev)
    rk = run(phase_recurrence_kernel, dev)
    rpath = run(phase_recurrence_path, dev)
    infer = run(phase_infer, dev)

    # the f32 eval forward on the tensor cores (3xTF32): the serve path;
    # bilstm_fwd.cu by name on the same operands, in turns, is a yardstick
    f32 = kern["timings"]["float32"]
    h32 = kern["timings"]["h32_float32"]
    kernels = [{
        "name": "bilstm_layer_fwd_f32",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/bilstm_fwd_f32.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas_packed.py:256",
        "launches": serve["launches"],
        "max_abs_err": max(max(c["max_abs_err"][n] for n in ("hs_f", "hs_b", "hn", "cn"))
                           for c in kern["checks"] if c["dtype"] == "float32"),
        "ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "ms_again": f32["kernel_ms_again"],
        "cuda_core_ms": f32["cuda_core_ms"],
        "h32_ms": h32["kernel_ms"], "h32_cuda_core_ms": h32["cuda_core_ms"],
        "h32_plain_ms": h32["plain_ms"], "h32_bound_ms": h32["bound_ms"],
        "h32_library_ms": h32["library_ms"],
        "infer_launches": infer["launches"],
        "work": "eval variant, both layers of one bulk serve dispatch, f32, B=800, T=1500, H=64 "
                "(16-row tiles); bound at 495/3 TFLOP/s (three tf32 passes); cuda_core_ms: "
                "bilstm_fwd.cu by name on the same operands (new, old, old, new); library: "
                "cuDNN nn.LSTM inference, TF32 off; h32_*: row 3 at H=32, 96 rows, T=300",
    }]
    t32, t16 = tk["timings"]["float32"], tk["timings"]["bfloat16"]
    sweep_errs = ("dxf0", "dxf1", "dxb0", "dxb1", "dgc", "dbias")
    train_errs = {
        "fwd": ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b"),
        "bwd": sweep_errs,
        "wgrad": ("dW_ih", "dW_hh"),
    }
    library = {"fwd": t32["cudnn_fwd_ms"], "bwd": t32["cudnn_bwd_data_ms"],
               "wgrad": t32["wgrad_library_ms"]}
    # the 3xTF32 forward and wgrad: the f32 step
    path_launches = train["float32_steps"]["launches"]
    w32 = wk["timings"]["float32"]
    for key, name, source, replaces in (
        ("fwd", "bilstm_layer_fwd_train_f32", "bilstm_fwd_f32.cu", "lstm_pallas_packed.py:256"),
        ("wgrad", "bilstm_wgrad_f32", "bilstm_wgrad_f32.cu", "lstm_pallas_packed.py:494"),
    ):
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{source}",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": path_launches[name],
            "max_abs_err": max(v for c in tk["checks"] + tk["ragged_checks"]
                               if c["dtype"] == "float32"
                               for n, v in c["max_abs_err"].items() if n in train_errs[key]),
            "ms": t32[f"{key}_ms"],
            "plain_ms": t32[f"{key}_plain_ms"],
            "bound_ms": t32[f"{key}_bound_ms"],
            "bound_by": t32[f"{key}_bound_by"],
            "library_ms": library[key],
            "work": "both layers of one train step, f32, 400 rows (5 groups), T=1500, H=64",
        }
        if key == "fwd":
            entry.update({
                "ms_again": t32["fwd_ms_again"], "cuda_core_ms": t32["fwd_cuda_core_ms"],
                "eval_ms": t32["fwd_eval_ms"], "eval_cuda_core_ms": t32["fwd_eval_cuda_core_ms"],
                "eval_bound_ms": t32["fwd_eval_bound_ms"],
                "eval_library_ms": t32["cudnn_inference_ms"],
                "scaled_err": max(c["fwd_scaled_err"] for c in tk["checks"]
                                  if c["dtype"] == "float32"),
                "tf32_one_pass_scaled_err": max(c["fwd_tf32_one_pass_scaled_err"]
                                                for c in tk["checks"] if c["dtype"] == "float32"),
            })
            entry["work"] += ("; 8-row tiles; bound at 495/3 TFLOP/s (three tf32 passes); "
                              "cuda_core_ms: bilstm_fwd.cu by name on the same operands (new, "
                              "old, old, new); eval_*: the eval variant on them; library: cuDNN "
                              "nn.LSTM training forward, TF32 off; tf32_one_pass_scaled_err: the "
                              "twin in one tf32 pass, against the f32 tolerance 1e-4")
        else:
            # the scaled widths: layer 0 and one E = 2 x 256 layer at H = 256,
            # whose f32 main path is the f32 gradient step there
            entry.update({
                "ms_again": t32["wgrad_ms_again"], "cuda_core_ms": t32["wgrad_cuda_core_ms"],
                "scaled_err": max(c["wgrad_scaled_err"] for c in tk["checks"]
                                  if c["dtype"] == "float32"),
                **{f"h256_{k}": w32[f"wgrad_{k}"]
                   for k in ("ms", "ms_again", "cuda_core_ms", "library_ms", "plain_ms",
                             "bound_ms", "bound_by", "cuda_core_bound_ms")},
                "h256_launches": scaled["grad_check"]["launches"].get(name, 0),
                "h256_max_abs_err": max(v for c in wk["checks"] + wk["ragged_checks"]
                                        if c["dtype"] == "float32" and c["H"] == E_SCALED
                                        for n, v in c["max_abs_err"].items()
                                        if n in train_errs[key]),
            })
            entry["work"] += ("; bound at 495/3 TFLOP/s (three tf32 passes); cuda_core_ms: "
                              "bilstm_wgrad.cu by name on the same operands (new, old, old, "
                              "new); library: cuBLAS f32 products, TF32 off; h256_*: layer 0 "
                              "(E=256, 5 groups) + one E=2x256 layer at H=256, T=1500, its "
                              "launches in the f32 gradient step at the scaled widths")
        kernels.append(entry)
    # the f32 step's sweep, 3xTF32; bilstm_bwd.cu asked for by name on the
    # same operands, in turns (new, old, old, new), is a yardstick there
    f32_sweep = [c for c in tk["checks"] + tk["ragged_checks"] if c["dtype"] == "float32"
                 and c.get("kernel") != "bilstm_bwd_f32_onestage"]
    kernels.append({
        "name": "bilstm_bwd_f32",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/bilstm_bwd_f32.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas_packed.py:494",
        "launches": path_launches["bilstm_bwd_f32"],
        "max_abs_err": max(v for c in f32_sweep for n, v in c["max_abs_err"].items()
                           if n in sweep_errs),
        "ms": t32["bwd_ms"],
        "plain_ms": t32["bwd_plain_ms"],
        "bound_ms": t32["bwd_bound_ms"],
        "bound_by": t32["bwd_bound_by"],
        "library_ms": t32["cudnn_bwd_data_ms"],
        "ms_again": t32["bwd_ms_again"],
        "cuda_core_ms": t32["bwd_cuda_core_ms"],
        "scaled_err": max(c["scaled_err"] for c in tk["checks"] if c["dtype"] == "float32"),
        "tf32_one_pass_scaled_err": max(c["tf32_one_pass_scaled_err"] for c in tk["checks"]
                                        if c["dtype"] == "float32"),
        "work": "both layers of one train step, f32, 400 rows (5 groups), T=1500, H=64; bound "
                "at 495/3 TFLOP/s (three tf32 passes); cuda_core_ms: bilstm_bwd.cu by name on "
                "the same operands; tf32_one_pass_scaled_err: the twin with one tf32 pass, "
                "against the f32 tolerance 1e-4; library: cuDNN nn.LSTM backward (input) in "
                "f32, TF32 off",
    })
    # the CUDA-core forward (both variants), sweep and wgrad at their main
    # path's shapes: the f32 model at embedding 80 (its train steps and an
    # eval step)
    # the CUDA-core forward (both variants), sweep and wgrad and the
    # one-stage sweep at their main path's shapes: layer 0 of the two-layer
    # model at embedding 80 (its train steps and an eval step); f32 is the
    # main path of the forward, wgrad and the one-stage sweep, bf16 of
    # bilstm_bwd.cu
    e80 = tk["embedding_80"]
    e80_launches = {d: train["steps_embedding_80"][d]["launches"] for d in e80}
    library = {"fwd_eval": "cuDNN one-layer nn.LSTM inference",
               "fwd": "cuDNN one-layer nn.LSTM training forward",
               "bwd": "cuDNN one-layer nn.LSTM backward (input)", "wgrad": "cuBLAS products"}
    for key, name, source, dtype in (
        ("fwd_eval", "bilstm_layer_fwd", "bilstm_fwd.cu", "float32"),
        ("fwd", "bilstm_layer_fwd_train", "bilstm_fwd.cu", "float32"),
        ("bwd", "bilstm_bwd_f32_onestage", "bilstm_bwd_f32_onestage.cu", "float32"),
        ("bwd", "bilstm_bwd", "bilstm_bwd.cu", "bfloat16"),
        ("wgrad", "bilstm_wgrad", "bilstm_wgrad.cu", "float32"),
    ):
        e = e80[dtype][key]
        other = "bfloat16" if dtype == "float32" else "float32"
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{source}",
            "replaces": "intrepppid_tpu/ops/lstm_pallas_layer.py:"
                        + ("285" if key.startswith("fwd") else "436"),
            "launches": e80_launches[dtype][name],
            "max_abs_err": max(v for n, v in e["max_abs_err"].items()
                               if not n.startswith("cuda_core_")),
            "ms": e["ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": e[f"{key}_bound_ms"],
            "bound_by": e[f"{key}_bound_by"],
            "library_ms": e["library_ms"],
            "work": f"layer 0 of the {dtype} two-layer model at embedding 80 (E=H=80, 5 groups, "
                    f"two dy streams a direction), 400 rows, T=1500; library: {library[key]} in "
                    f"{dtype}, TF32 off",
        }
        if name == "bilstm_bwd_f32_onestage":
            ragged = [c for c in tk["ragged_checks"] if c["kernel"] == name]
            entry.update({
                "max_abs_err": max([entry["max_abs_err"]] + [max(c["max_abs_err"].values())
                                                             for c in ragged]),
                "ms_again": e["ms_again"], "cuda_core_ms": e["cuda_core_ms"],
                "cuda_core_bound_ms": e["cuda_core_bound_ms"], "scaled_err": e["scaled_err"],
                "cuda_core_max_abs_err": max(v for n, v in e["max_abs_err"].items()
                                             if n.startswith("cuda_core_"))})
            entry["work"] += ("; bound at 495/3 TFLOP/s (three tf32 passes); cuda_core_ms: "
                              "bilstm_bwd.cu by name on the same operands (new, old, old, new), "
                              "its bound cuda_core_bound_ms at 67 TFLOP/s; max_abs_err also over "
                              "the ragged cases (27 rows, 3 groups, T = 1 and 5)")
        elif key == "wgrad":
            # bf16 at embedding 80 takes bilstm_wgrad_mma; this kernel there by name
            o = e80[other][key]
            entry.update({"bfloat16_by_name_ms": o["cuda_core_ms"],
                          "bfloat16_by_name_max_abs_err": max(
                              v for n, v in o["max_abs_err"].items()
                              if n.startswith("cuda_core_"))})
            entry["work"] += ("; bfloat16_by_name_*: this kernel asked for by name on the bf16 "
                              "layer's operands, in turns with bilstm_wgrad_mma")
        else:
            # the same kernel in the other dtype, at the same shapes
            o = e80[other][key] if key != "bwd" else None
            if o is not None:
                entry.update({f"{other}_{k}": o[k] for k in ("ms", "plain_ms", "library_ms")})
                entry[f"{other}_bound_ms"] = o[f"{key}_bound_ms"]
                entry[f"{other}_launches"] = e80_launches[other][name]
                entry["work"] += f"; {other}_*: the same layer in {other}"
        kernels.append(entry)
    kernels.append({
        "name": "bilstm_bwd_mma",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/bilstm_bwd_mma.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas_packed.py:494",
        "launches": train["launches"]["bilstm_bwd_mma"],
        "max_abs_err": max(v for c in tk["checks"] + tk["ragged_checks"]
                           if c["dtype"] == "bfloat16"
                           for n, v in c["max_abs_err"].items() if n in sweep_errs),
        "ms": t16["bwd_ms"],
        "plain_ms": t16["bwd_plain_ms"],
        "bound_ms": t16["bwd_bound_ms"],
        "bound_by": t16["bwd_bound_by"],
        "library_ms": t16["cudnn_bwd_data_ms"],
        "cuda_core_ms": t16["bwd_cuda_core_ms"],
        "work": "both layers of one train step, bf16, 400 rows (5 groups), T=1500, H=64; "
                "cuda_core_ms: bilstm_bwd.cu on the same operands in the same run; library: "
                "cuDNN nn.LSTM backward (input) in bf16",
    })
    # the tensor-core forward (both variants) and wgrad: the bf16 step and its eval step
    w16 = wk["timings"]["bfloat16"]
    mma_errs = {"fwd": train_errs["fwd"], "wgrad": train_errs["wgrad"],
                "fwd_eval": tuple(f"eval_{n}" for n in train_errs["fwd"])}
    for key, name, source, replaces, library16, library32 in (
        ("fwd", "bilstm_layer_fwd_train_mma", "bilstm_fwd_mma.cu", "lstm_pallas_packed.py:256",
         "cudnn_fwd_ms", "cudnn_fwd_ms"),
        ("fwd_eval", "bilstm_layer_fwd_mma", "bilstm_fwd_mma.cu", "lstm_pallas_packed.py:256",
         "cudnn_inference_ms", "cudnn_inference_ms"),
        ("wgrad", "bilstm_wgrad_mma", "bilstm_wgrad_mma.cu", "lstm_pallas_packed.py:494",
         "wgrad_library_ms", None),
    ):
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{source}",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": train["launches"][name],
            "max_abs_err": max(v for c in tk["checks"] + tk["ragged_checks"]
                               + wk["ragged_checks"] if c["dtype"] == "bfloat16"
                               for n, v in c["max_abs_err"].items() if n in mma_errs[key]),
            "ms": t16[f"{key}_ms"],
            "plain_ms": t16[f"{key}_plain_ms"],
            "bound_ms": t16[f"{key}_bound_ms"],
            "bound_by": t16[f"{key}_bound_by"],
            "library_ms": t16[library16],
            "cuda_core_ms": t16[f"{key}_cuda_core_ms"],
            "ms_again": t16[f"{key}_ms_again"],
            "work": f"both layers of one train step, bf16, 400 rows (5 groups), T=1500, H=64; "
                    f"cuda_core_ms: the CUDA-core kernel on the same operands in the same run "
                    f"(new, old, old, new); library: {library16} in bf16",
        }
        if library32:
            entry["library_f32_ms"] = t32[library32]
        else:
            # the scaled step's shapes: layer 0 and one E = 2 x 256 layer at H = 256
            entry.update({f"h256_{k}": w16[f"wgrad_{k}"]
                          for k in ("ms", "cuda_core_ms", "library_ms", "plain_ms", "bound_ms",
                                    "bound_by")})
            entry["h256_launches"] = scaled["launches"][name]
            # layer 0 of the bf16 model at embedding 80 (H = 80: the masked gate tile)
            h80 = e80["bfloat16"]["wgrad"]
            entry.update({f"h80_{k}": h80[k] for k in (
                "ms", "ms_again", "cuda_core_ms", "cuda_core_bound_ms", "plain_ms",
                "library_ms", "scaled_err")})
            entry.update({"h80_bound_ms": h80["wgrad_bound_ms"],
                          "h80_bound_by": h80["wgrad_bound_by"],
                          "h80_launches": e80_launches["bfloat16"][name],
                          "h80_max_abs_err": max(v for n, v in h80["max_abs_err"].items()
                                                 if not n.startswith("cuda_core_"))})
            entry["work"] += ("; h80_*: layer 0 of the bf16 two-layer model at embedding 80 "
                              "(E=H=80, 5 groups), its launches in that model's steps, "
                              "cuda_core_ms: bilstm_wgrad.cu by name in turns, library: "
                              "cuBLAS bf16 products")
        kernels.append(entry)
    wide_errs = {
        "gates": ("xg",),
        "fwd": tuple(f"train_{n}" for n in ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")),
        "fwd_eval": tuple(f"eval_{n}" for n in ("hs_f", "hs_b", "hn", "cn")),
        "lite": ("dgates",),
    }
    # the CUDA-core gates, wide forward and lite sweep keep f32, whose main
    # path is the f32 gradient step at the scaled widths and the eval step
    # after it (train_scaled's grad_check)
    f32_scaled = scaled["grad_check"]["launches"]
    for key, name, source, replaces in (
        ("gates", "bilstm_gates", "bilstm_gates.cu", "lstm_pallas_layer.py:285"),
        ("fwd", "bilstm_fwd_wide_train", "bilstm_fwd_wide.cu", "lstm_pallas_layer.py:285"),
        ("fwd_eval", "bilstm_fwd_wide", "bilstm_fwd_wide.cu", "lstm_pallas_layer.py:285"),
        ("lite", "bilstm_bwd_lite", "bilstm_bwd_lite.cu", "lstm_pallas_layer.py:436"),
    ):
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{source}",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": f32_scaled.get(name, 0),
            "max_abs_err": max(v for c in wk["checks"] if c["dtype"] == "float32"
                               and c["route"] == "wide"
                               for n, v in c["max_abs_err"].items() if n in wide_errs[key]),
            "ms": w32[f"{key}_ms"],
            "plain_ms": w32[f"{key}_plain_ms"],
            "bound_ms": w32[f"{key}_bound_ms"],
            "bound_by": w32[f"{key}_bound_by"],
            "library_ms": w32[f"{key}_library_ms"],
            "work": "layer 0 (E=256, 5 groups) + one E=2x256 layer of the scaled step, f32, "
                    "400 rows, T=1500, H=256",
        }
        entry.update({f"bf16_{k}": w16[f"{key}_{k}"] for k in ("cuda_core_ms", "plain_ms")})
        entry["work"] += ("; launches: the f32 gradient step at the scaled widths and the eval "
                          "step after it; bf16_cuda_core_ms: this kernel on the bf16 operands "
                          "of the tensor-core one's row, by name")
        if key != "gates":
            # the 288-thread instance: layer 0 of the bf16 model at embedding 272
            k288 = widths["kernels_288"][key]
            entry.update({f"h288_{k}": k288[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "true_bound_ms", "library_ms")})
            entry["h288_max_abs_err"] = max(k288["max_abs_err"].values())
            entry["h288_launches"] = widths["models"]["embedding_272_bfloat16"]["launches"][name]
            entry["work"] += ("; h288_*: its 288-thread instance on layer 0 of the bf16 "
                              "two-layer model at embedding 272 (E=272, run at H=288), bf16, "
                              "400 rows, T=1500, bound at H=288 (true_bound_ms at 272), "
                              "launches in that model's steps, library: cuDNN one-layer bf16 "
                              "at E=H=272")
        kernels.append(entry)
    # the tensor-core gates, wide forward (both variants) and lite sweep: the
    # bf16 scaled step and its eval step; each error name the checks give
    # the kernel, ragged row tiles included
    for key, name, source, replaces, library, picks in (
        ("gates", "bilstm_gates_mma", "bilstm_gates_mma", "lstm_pallas_layer.py:255",
         "one torch.addmm on the bf16 operands with out_dtype=float32 (cuBLAS); "
         "library_bf16_out_ms: bf16 addmm then .float()", lambda n: n == "xg"),
        ("fwd", "bilstm_fwd_wide_train_mma", "bilstm_fwd_wide_mma", "lstm_pallas_layer.py:285",
         "cuDNN training forward of one bidirectional nn.LSTM layer in bf16; library_f32_ms: "
         "the same in f32, TF32 off",
         lambda n: n.startswith("train_") or (n.startswith("fwd_rows") and "_vs_" not in n)),
        ("fwd_eval", "bilstm_fwd_wide_mma", "bilstm_fwd_wide_mma", "lstm_pallas_layer.py:285",
         "cuDNN inference forward of one bidirectional nn.LSTM layer in bf16; library_f32_ms: "
         "the same in f32, TF32 off",
         lambda n: n.startswith("eval_") or n.startswith("fwd_eval_rows")),
        ("lite", "bilstm_bwd_lite_mma", "bilstm_bwd_lite_mma", "lstm_pallas_layer.py:436",
         "cuDNN backward (input) of one bidirectional nn.LSTM layer in bf16; library_f32_ms: "
         "the same in f32, TF32 off", lambda n: n.startswith("dgates")),
    ):
        picked = [v for c in wk["checks"] + wk["ragged_checks"]
                  if c["dtype"] == "bfloat16" and source in c.get("kernels", ())
                  for n, v in c["max_abs_err"].items() if picks(n)]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{source}.cu",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": scaled["launches"][name],
            "max_abs_err": max(picked),
            "ms": w16[f"{key}_ms"],
            "plain_ms": w16[f"{key}_plain_ms"],
            "bound_ms": w16[f"{key}_bound_ms"],
            "bound_by": w16[f"{key}_bound_by"],
            "library_ms": w16[f"{key}_library_ms"],
            "ms_again": w16[f"{key}_ms_again"],
            "cuda_core_ms": w16[f"{key}_cuda_core_ms"],
            "library_f32_ms": w32[f"{key}_library_ms"],
            "work": "layer 0 (E=256, 5 groups) + one E=2x256 layer of the scaled step, bf16, "
                    "400 rows, T=1500, H=256; cuda_core_ms: the CUDA-core kernel by name on the "
                    f"same operands (new, old, old, new); library: {library}",
        }
        if key == "gates":
            entry["library_bf16_out_ms"] = w16["gates_library_bf16_out_ms"]
        else:
            entry["rows_ms"] = {k: v for k, v in w16.items() if k.startswith(f"{key}_rows")}
        kernels.append(entry)
    # the recurrence op: both layers of one recurrence-backend step (layer 0
    # with 5 weight groups, layer 1 with shared weights), f32, masks from lengths
    step = [t for t in rk["timings"] if t["dtype"] == "float32" and t["mask"] == "lengths"
            and t["H"] == H_SERVE and t["T"] == T_TRAIN]
    rec_errs = {"fwd": ("hs", "cs", "hn", "cn"), "bwd": ("dxg",), "wgrad": ("dw",)}
    # the f32 sweep's and the CUDA-core wgrad's main path is the f32 step,
    # the forward's the bf16 step
    rec_launches = {**rpath["launches"], **{
        n: rpath["float32_steps"]["launches"][n]
        for n in ("lstm_recurrence_bwd_f32", "lstm_recurrence_wgrad")}}
    for key, name, replaces in (("fwd", "lstm_recurrence_fwd", "lstm_pallas.py:116"),
                                ("bwd", "lstm_recurrence_bwd_f32", "lstm_pallas.py:185"),
                                ("wgrad", "lstm_recurrence_wgrad", "lstm_pallas.py:185")):
        ms_bound, bound_by = bound([(sum(t[f"{key}_flops"] for t in step),
                                     sum(t[f"{key}_bytes"] for t in step),
                                     kernel_peak(torch.float32, name))])
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{name}.cu",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": rec_launches[name],
            "max_abs_err": max(v for c in rk["checks"] + rk["ragged_checks"]
                               if c["dtype"] == "float32" and (key != "bwd" or name in (
                                   c.get("sweep"), c.get("kernel")))
                               for n, v in c["max_abs_err"].items() if n in rec_errs[key]),
            "ms": sum(t[f"{key}_ms"] for t in step),
            "plain_ms": sum(t[f"{key}_plain_ms"] for t in step),
            "bound_ms": ms_bound,
            "bound_by": bound_by,
            "library_ms": sum(t[f"{key}_library_ms"] for t in step),
            "work": "both layers of one recurrence-backend step (5 weight groups + 1), f32, "
                    "D=2, 400 rows, T=1500, H=64; library: cuDNN nn.LSTM layers, which also "
                    "do the input projection (cuBLAS for wgrad)",
        }
        past = rk["past_288"]
        if key != "bwd":
            # past 288 (the global-weight instance): one call at H = 512, f32
            h512 = past["h512"]["float32"]
            entry.update({f"h512_{k}": h512[f"{key}_{k}"]
                          for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
            entry["h512_library_ms"] = h512.get(f"{key}_library_ms")
            entry["h512_max_abs_err"] = max(
                v for c in past["checks"] if c["dtype"] == "float32"
                for n, v in c["max_abs_err"].items() if n in rec_errs[key])
            entry["work"] += ("; h512_*: one call at H=512 (400 rows, 5 groups, T=300), f32, "
                              "library: cuDNN one bidirectional nn.LSTM layer at that width; "
                              "h512_max_abs_err over H=288, 512 and 1024")
            if key == "fwd":
                entry["h320_launches"] = rpath["grad_check_embedding_320"]["bfloat16"][
                    "launches"][name]
                entry["work"] += "; h320_launches: the bf16 model at embedding 320, one layer"
        if key == "bwd":
            entry.update({"ms_again": sum(t["bwd_ms_again"] for t in step),
                          "cluster_ms": sum(t["bwd_cluster_ms"] for t in step),
                          "g5_ms": step[0]["bwd_ms"], "g5_cluster_ms": step[0]["bwd_cluster_ms"],
                          "g5_library_ms": step[0]["bwd_library_ms"]})
            entry["work"] += ("; bound at 495/3 TFLOP/s (three tf32 passes); cluster_ms: "
                              "lstm_recurrence_bwd.cu by name on the same operands (new, old, "
                              "old, new); g5_*: layer 0 (5 groups) alone")
        kernels.append(entry)
    # the cluster sweep at its main path's shapes: the f32 recurrence-backend
    # steps of a one-layer model at embedding 128
    c128 = rk["cluster_h128"]
    kernels.append({
        "name": "lstm_recurrence_bwd",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/lstm_recurrence_bwd.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas.py:185",
        "launches": rpath["float32_steps_embedding_128"]["launches"]["lstm_recurrence_bwd"],
        "max_abs_err": c128["max_abs_err"]["dxg"],
        "ms": c128["ms"],
        "plain_ms": c128["plain_ms"],
        "bound_ms": c128["bwd_bound_ms"],
        "bound_by": c128["bwd_bound_by"],
        "library_ms": c128["library_ms"],
        **{f"h512_{k}": rk["past_288"]["h512"]["float32"][f"bwd_{k}"]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "h512_bf16_ms": rk["past_288"]["h512"]["bfloat16"]["bwd_ms"],
        "h512_max_abs_err": max(c["max_abs_err"]["dxg"] for c in rk["past_288"]["checks"]),
        "h320_launches": rpath["grad_check_embedding_320"]["bfloat16"]["launches"][
            "lstm_recurrence_bwd"],
        "work": "the layer of the f32 recurrence-backend model at embedding 128 (5 weight "
                "groups), D=2, 400 rows, T=1500, H=128, masks from lengths; library: cuDNN "
                "one-layer nn.LSTM backward (input), with the projection's dx; h512_*: its "
                "global-weight instance, one call at H=512 (400 rows, 5 groups, T=300), f32 "
                "(h512_bf16_ms: bf16 compute dtype), max_abs_err over H=288, 512 and 1024 in "
                "both dtypes; h320_launches: the bf16 model at embedding 320, one layer",
    })
    step16 = [t for t in rk["timings"] if t["dtype"] == "bfloat16" and t["mask"] == "lengths"
              and t["H"] == H_SERVE and t["T"] == T_TRAIN]
    ops_ms = sum(t["bwd_flops"] for t in step16) / PEAK_BF16_FLOPS * 1e3
    bytes_ms = sum(t["bwd_bytes"] for t in step16) / PEAK_BYTES * 1e3
    kernels.append({
        "name": "lstm_recurrence_bwd_mma",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/lstm_recurrence_bwd_mma.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas.py:185",
        "launches": rpath["launches"]["lstm_recurrence_bwd_mma"],
        "max_abs_err": max(c["max_abs_err"]["dxg"] for c in rk["checks"] + rk["ragged_checks"]
                           if c.get("sweep", c.get("kernel")) == "lstm_recurrence_bwd_mma"),
        "ms": sum(t["bwd_ms"] for t in step16),
        "plain_ms": sum(t["bwd_plain_ms"] for t in step16),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": sum(t["bwd_library_ms"] for t in step16),
        "cluster_ms": sum(t["bwd_cluster_ms"] for t in step16),
        "work": "both layers of one recurrence-backend step (5 weight groups + 1), bf16 "
                "compute dtype, D=2, 400 rows, T=1500, H=64; cluster_ms: "
                "lstm_recurrence_bwd.cu on the same operands in the same run; library: cuDNN "
                "nn.LSTM backward (input) in bf16, with the projection's dx",
    })
    ops_ms = sum(t["wgrad_flops"] for t in step16) / PEAK_BF16_FLOPS * 1e3
    bytes_ms = sum(t["wgrad_bytes"] for t in step16) / PEAK_BYTES * 1e3
    kernels.append({
        "name": "lstm_recurrence_wgrad_mma",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/lstm_recurrence_wgrad_mma.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas.py:185",
        "launches": rpath["launches"]["lstm_recurrence_wgrad_mma"],
        "max_abs_err": max(c["max_abs_err"]["dw"] for c in rk["checks"] + rk["ragged_checks"]
                           if c.get("wgrad", c.get("kernel")) == "lstm_recurrence_wgrad_mma"),
        "ms": sum(t["wgrad_ms"] for t in step16),
        "ms_again": sum(t["wgrad_ms_again"] for t in step16),
        "plain_ms": sum(t["wgrad_plain_ms"] for t in step16),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": sum(t["wgrad_round_bmm_ms"] for t in step16),
        "bmm_ms": sum(t["wgrad_library_ms"] for t in step16),
        "cuda_core_ms": sum(t["wgrad_cuda_core_ms"] for t in step16),
        "work": "both layers of one recurrence-backend step (5 weight groups + 1), bf16 "
                "compute dtype, D=2, 400 rows, T=1500, H=64; cuda_core_ms: "
                "lstm_recurrence_wgrad.cu on the same operands in the same run (new, old, old, "
                "new); library: the f32 streams rounded to bf16, laid out and multiplied in "
                "one batched cuBLAS product; bmm_ms: that product alone",
    })
    if len(kernels) != 27 or any(k["launches"] <= 0 for k in kernels):
        raise AssertionError(f"a kernel of a main path was never launched: "
                             f"{[(k['name'], k['launches']) for k in kernels]}")
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s ({seconds})", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
