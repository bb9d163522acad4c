#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``intrepppid_tpu_torch``) on one
NVIDIA card, from a checkout of the repository:

    python3 chip_smoke.py

Phases, each printing one JSON line (a failed check raises, and the script
exits non-zero with no result):

1. build — compile every kernel from ``intrepppid_tpu_torch/csrc`` with
   ``nvcc`` (and the native tokenizer with ``g++``) in parallel, and print
   the ``-Xptxas -v`` summary (registers, shared memory, spills);
2. kernel — the bidirectional-LSTM layer kernel against its plain PyTorch
   version on the card, at the serve path's shapes (800 rows, T = 1500,
   H = 64, layer 0 at E = 64 and layer 1 at E = 2 x 64) in f32 and bf16,
   with lengths mixing 0, 1, T and random values, plus H = 32 at a smaller
   size; then the kernel, the plain version and cuDNN's
   ``nn.LSTM(bidirectional=True)`` (a yardstick the port never calls)
   timed with CUDA events at full lengths;
3. serve — ``Serve.start`` at the manuscript width (vocab 250, E = 64,
   2 layers, f32) with seeded random weights written as a reference-layout
   ``.ckpt``, answering real HTTP requests on 127.0.0.1; probabilities are
   checked against the port's CPU plain forward, and the kernel's launch
   counter must rise during the requests;
4. the ``kernels`` line, the card's name and power limit, and the result.

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
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# H100 SXM published peaks (dense): f32 on CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
AAS = "ACDEFGHIKLMNPQRSTVWY"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ build
def phase_build() -> dict:
    from intrepppid_tpu_torch.native import load_spm_library
    from intrepppid_tpu_torch.ops import _build
    from intrepppid_tpu_torch.ops.lstm_cuda import launch_plan

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
        f"{str(dtype).replace('torch.', '')} E={E}": launch_plan([E], H_SERVE, dtype)[2]
        for dtype in (torch.float32, torch.bfloat16)
        for E in (E_SERVE, 2 * H_SERVE)
    }
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
        torch.cuda.synchronize()
        errs = {
            name: float((a.float() - b.float()).abs().max())
            for name, a, b in zip(("hs_f", "hs_b", "hn", "cn"), got, want)
        }
        check = {"B": B, "T": T, "H": H, "E_parts": E_parts,
                 "dtype": str(dtype).replace("torch.", ""),
                 "max_abs_err": errs, "tol": TOL[dtype]}
        checks.append(check)
        del got, want, args
        if not max(errs.values()) <= TOL[dtype]:
            emit({"phase": "kernel", "failed": check})
            raise AssertionError(f"bilstm kernel disagrees with its plain version: {check}")

    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        k_ms = p_ms = flops = nbytes = 0.0
        for E_parts in ([E_SERVE], [H_SERVE, H_SERVE]):
            args = layer_inputs(B_SERVE, T_SERVE, E_parts, H_SERVE, dtype, dev,
                                SEED, full_lengths=True)
            k_ms += time_ms(lambda: bilstm_layer_fwd(*args, dtype), 5)
            p_ms += time_ms(lambda: bilstm_layer_fwd_plain(*args, dtype), 2)
            f, b = layer_work(B_SERVE, T_SERVE, sum(E_parts), H_SERVE, size)
            flops, nbytes = flops + f, nbytes + b
            del args
        timings[name] = {"kernel_ms": k_ms, "plain_ms": p_ms,
                         "flops": flops, "bytes": nbytes}

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


def profile_device(fn, top: int = 6) -> dict:
    """Wall and device time of ``fn()`` under ``torch.profiler``: the sum
    of the device events' durations (one stream, so they do not overlap),
    the idle share of the wall time, the device time by kernel name, and
    the host operators' own time (what keeps the host from feeding the
    device)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    device_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(((e.key, e.self_cpu_time_total) for e in prof.key_averages()),
                  key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
            "idle_share": 1.0 - device_us / wall_us,
            "top_device_ms": {name[:80]: us / 1e3 for name, us in ranked},
            "top_host_self_ms": {name[:80]: us / 1e3 for name, us in host}}


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
    from intrepppid_tpu_torch.ops.lstm_cuda import bilstm_layer_fwd
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
            # the main path: every request below goes through the kernel
            bilstm_layer_fwd.launches = 0
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
            launches = bilstm_layer_fwd.launches
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
        if launches <= 0:
            raise AssertionError("the requests never launched the bilstm kernel")
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
        "launches": launches, "max_abs_err_vs_cpu": err,
        "cpu_reference_s": cpu_s,
        "engine_bulk_s": engine_s, "engine_bulk_profile": breakdown,
    }
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
    phase_build()
    kern = phase_kernel(dev)
    serve = phase_serve(dev)

    f32 = kern["timings"]["float32"]
    bound_ops = f32["flops"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = f32["bytes"] / PEAK_BYTES * 1e3
    f32_err = max(max(c["max_abs_err"].values())
                  for c in kern["checks"] if c["dtype"] == "float32")
    emit({"kernels": [{
        "name": "bilstm_layer_fwd",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/bilstm_fwd.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas_packed.py:256",
        "launches": serve["launches"],
        "max_abs_err": f32_err,
        "ms": f32["kernel_ms"],
        "kernel_ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": f32["library_ms"],
        "work": "both layers of one bulk dispatch, f32, B=800, T=1500, H=64",
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
