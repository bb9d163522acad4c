"""Stdlib HTTP front end for :class:`~intrepppid_tpu_torch.serve.engine.ScoringEngine`
(a copy of `intrepppid_tpu/serve/server.py`; ``/healthz`` also names the
device).

No dependencies beyond ``http.server``. Endpoints:

* ``GET /healthz`` — liveness + model manifest
  (``{"status": "ok", "model": {...}}``).
* ``GET /statsz`` — serving metrics: request/pair/error totals, uptime,
  and scoring latency quantiles (p50/p90/p99/mean over a sliding window
  of the last 1024 scored requests).
* ``POST /reload`` — re-load the model weights from the path the server
  was started with and swap them in with zero downtime (train writes a
  new checkpoint, serve picks it up). Only enabled when a ``reload_cb``
  was provided (the CLI's ``--allow_reload``); otherwise 403. The body is
  ignored — the path is fixed at startup, so a request can never point
  the server at an attacker-chosen file.
* ``POST /score`` — body ``{"pairs": [[seq_a, seq_b], ...]}`` or
  ``{"pairs": [{"seq_a": ..., "seq_b": ..., "id": ...}, ...]}``; returns
  ``{"probabilities": [...]}`` in input order, plus ``"ids"`` when the
  dict form carried them. Malformed requests get a 400 with
  ``{"error": ...}``; oversized ones (> ``max_pairs``) a 413.

Handlers run on threads (``ThreadingHTTPServer``). With ``coalesce=True``
(the default) concurrent requests merge into shared device dispatches via
:class:`~intrepppid_tpu_torch.serve.coalesce.CoalescingScorer`; otherwise each
handler calls the engine directly and requests serialize on its lock.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple


class _Stats:
    """Thread-safe serving counters + a sliding latency window."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.requests = 0
        self.pairs = 0
        self.errors = 0
        self.t0 = time.time()
        self._lat = deque(maxlen=window)

    def record(self, n_pairs: int, dt_s: float, error: bool = False) -> None:
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            else:
                self.pairs += n_pairs
                self._lat.append(dt_s)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            out = {
                "requests": self.requests,
                "pairs_scored": self.pairs,
                "errors": self.errors,
                "uptime_s": round(time.time() - self.t0, 3),
            }
        if lat:
            def q(p):
                return lat[min(len(lat) - 1, int(p * len(lat)))]

            out["latency_ms"] = {
                "mean": round(sum(lat) / len(lat) * 1e3, 3),
                "p50": round(q(0.50) * 1e3, 3),
                "p90": round(q(0.90) * 1e3, 3),
                "p99": round(q(0.99) * 1e3, 3),
            }
        return out


def _parse_pairs(payload) -> Tuple[List[Tuple[str, str]], Optional[list]]:
    if not isinstance(payload, dict) or "pairs" not in payload:
        raise ValueError('body must be a JSON object with a "pairs" list')
    raw = payload["pairs"]
    if not isinstance(raw, list) or not raw:
        raise ValueError('"pairs" must be a non-empty list')
    pairs: List[Tuple[str, str]] = []
    ids: list = []
    saw_id = False
    for item in raw:
        if isinstance(item, dict):
            a, b = item.get("seq_a"), item.get("seq_b")
            if "id" in item:
                saw_id = True
            ids.append(item.get("id"))
        elif isinstance(item, (list, tuple)) and len(item) == 2:
            a, b = item
            ids.append(None)
        else:
            raise ValueError(
                "each pair must be [seq_a, seq_b] or "
                '{"seq_a": ..., "seq_b": ...}'
            )
        if not isinstance(a, str) or not isinstance(b, str) or not a or not b:
            raise ValueError("seq_a and seq_b must be non-empty strings")
        pairs.append((a, b))
    return pairs, (ids if saw_id else None)


class PPIServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000,
                 max_pairs: int = 4096, quiet: bool = False,
                 coalesce: bool = True, reload_cb=None):
        self.engine = engine
        self.max_pairs = int(max_pairs)
        self.quiet = quiet
        self.stats = _Stats()
        # zero-arg callable loading fresh params for engine.swap_params;
        # None disables POST /reload entirely
        self.reload_cb = reload_cb
        self._scorer = None
        if coalesce:
            from intrepppid_tpu_torch.serve.coalesce import CoalescingScorer

            self._scorer = CoalescingScorer(
                engine, max_pairs_per_dispatch=self.max_pairs
            )
        super().__init__((host, port), _Handler)

    def score(self, pairs):
        if self._scorer is not None:
            return self._scorer.submit(pairs)
        return self.engine.score_pairs(pairs)

    def server_close(self):
        if self._scorer is not None:
            self._scorer.close()
            self._scorer = None
        super().server_close()


class _Handler(BaseHTTPRequestHandler):
    server: PPIServer

    def _send_json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # noqa: N802
        if not self.server.quiet:
            super().log_message(fmt, *args)

    def do_GET(self):  # noqa: N802
        if self.path == "/statsz":
            self._send_json(200, self.server.stats.snapshot())
            return
        if self.path != "/healthz":
            self._send_json(404, {"error": "not found"})
            return
        eng = self.server.engine
        cfg = eng.net.cfg.encoder
        self._send_json(
            200,
            {
                "status": "ok",
                "model": {
                    "vocab_size": cfg.vocab_size,
                    "embedding_size": cfg.embedding_size,
                    "rnn_num_layers": cfg.rnn_num_layers,
                    "bi_reduce": cfg.bi_reduce,
                    "trunc_len": eng.trunc_len,
                    "batch_size": eng.batch_size,
                    "bulk_batch_size": eng.bulk_batch_size,
                    "n_data_parallel": eng.n_data_parallel,
                    "sampling": eng.sampling,
                    "device": str(eng.device),
                },
            },
        )

    def do_POST(self):  # noqa: N802
        if self.path == "/reload":
            if self.server.reload_cb is None:
                self._send_json(403, {"error": "reload not enabled"})
                return
            try:
                self.server.engine.swap_params(self.server.reload_cb())
            except Exception as e:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_json(200, {"reloaded": True})
            return
        if self.path != "/score":
            self._send_json(404, {"error": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            pairs, ids = _parse_pairs(payload)
        except (ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": str(e)})
            return
        if len(pairs) > self.server.max_pairs:
            self._send_json(
                413,
                {"error": f"too many pairs (max {self.server.max_pairs})"},
            )
            return
        t0 = time.perf_counter()
        try:
            probs = self.server.score(pairs)
        except Exception as e:  # scorer closed mid-shutdown, device error...
            # ...must surface as a JSON 500, not a dropped connection
            self.server.stats.record(len(pairs), 0.0, error=True)
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self.server.stats.record(len(pairs), time.perf_counter() - t0)
        out = {"probabilities": [float(p) for p in probs]}
        if ids is not None:
            out["ids"] = ids
        self._send_json(200, out)
