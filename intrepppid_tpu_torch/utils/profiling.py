"""Profiling and step timing (`intrepppid_tpu/utils/profiling.py`
counterpart).

``trace(logdir)`` / ``start_trace(logdir)``: ``torch.profiler`` over CPU
activity, plus the CUDA activity of the kernels on a machine with a card,
written to ``logdir`` as a ``*.pt.trace.json`` that TensorBoard's profiler
plugin or Perfetto loads. The JAX module swallows a profiler that fails to
start; ``torch.profiler`` is always there, so a failure here raises.

``StepTimer``: wall-clock step and throughput counters; the trainer logs
``epoch_time_s`` and ``seq_pairs_per_s`` the same way. Work on a card is
asynchronous: wait on it (``torch.cuda.synchronize()``, or read a result on
the host) before stopping a timer.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional, Union

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


def start_trace(logdir: Union[str, Path]) -> profile:
    """A started profiler whose ``stop()`` writes the trace under
    ``logdir`` (created if missing)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir)))
    prof.start()
    return prof


@contextlib.contextmanager
def trace(logdir: Union[str, Path]) -> Iterator[profile]:
    """Profile the block onto ``logdir``."""
    prof = start_trace(logdir)
    try:
        yield prof
    finally:
        prof.stop()


class StepTimer:
    """Accumulates step wall times; reports mean step time and items/s."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self.total_items = 0
        self.total_time = 0.0
        self.steps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_items: int = 0) -> float:
        dt = time.perf_counter() - self._t0
        self.total_time += dt
        self.total_items += n_items
        self.steps += 1
        return dt

    @property
    def mean_step_s(self) -> float:
        return self.total_time / max(self.steps, 1)

    @property
    def items_per_s(self) -> float:
        return self.total_items / max(self.total_time, 1e-9)
