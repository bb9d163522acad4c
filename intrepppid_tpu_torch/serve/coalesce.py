"""Request coalescing: merge concurrent /score requests into one dispatch
(a copy of `intrepppid_tpu/serve/coalesce.py`).

Without it, N concurrent small requests serialize on the engine lock and
each pays its own device dispatch, whose time at the small batch shape is
mostly the full T-step recurrence, whatever the number of rows. The
:class:`CoalescingScorer` puts a scoring worker thread behind
a queue: while one dispatch is on the device, every request that arrives
queues up, and the worker scores all of them as ONE concatenated
``score_pairs`` call (the engine chunks to its batch shapes
internally, so coalescing turns many padded partial batches into few full
ones). Under load the batch size self-tunes to the arrival rate — the
dense-traffic behavior of a continuous-batching serving stack — while an
idle server still scores a lone request immediately (no artificial
latency window; the only wait is the dispatch already in flight).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np


class _Request:
    __slots__ = ("pairs", "event", "result", "error")

    def __init__(self, pairs):
        self.pairs = pairs
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class CoalescingScorer:
    """Thread-safe facade over a :class:`ScoringEngine` that batches
    concurrent callers into shared dispatches.

    ``submit(pairs)`` blocks until the pairs are scored and returns their
    probabilities in input order. ``max_pairs_per_dispatch`` bounds how
    many pairs one worker iteration concatenates (backpressure: later
    requests wait for the next iteration).
    """

    def __init__(self, engine, max_pairs_per_dispatch: int = 4096):
        self.engine = engine
        self.max_pairs = int(max_pairs_per_dispatch)
        self._queue: List[_Request] = []
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, name="intrepppid-scorer", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------- client
    def submit(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        if not pairs:
            return np.zeros((0,), np.float32)
        req = _Request(list(pairs))
        with self._cv:
            if self._closed:
                raise RuntimeError("scorer is closed")
            self._queue.append(req)
            self._cv.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=10)

    # ------------------------------------------------------------- worker
    def _take_batch(self) -> Optional[List[_Request]]:
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue:
                return None  # closed and drained
            batch: List[_Request] = []
            total = 0
            while self._queue:
                nxt = len(self._queue[0].pairs)
                if batch and total + nxt > self.max_pairs:
                    break
                req = self._queue.pop(0)
                batch.append(req)
                total += nxt
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            flat: List[Tuple[str, str]] = []
            for req in batch:
                flat.extend(req.pairs)
            try:
                probs = self.engine.score_pairs(flat)
            except BaseException as e:  # propagate to every waiter
                for req in batch:
                    req.error = e
                    req.event.set()
                continue
            lo = 0
            for req in batch:
                hi = lo + len(req.pairs)
                req.result = probs[lo:hi]
                req.event.set()
                lo = hi
