"""One CPU for the port's test modules when the suite runs in xdist workers.

The suite runs in several xdist workers on one machine, beside the
reference's thread-scaling timing test
(``tests/test_tokenizer.py::TestThreadedBatchEncode::test_threads_scale_throughput``,
which wants 4 tokenizer threads to beat 1 by 1.8 x). It needs four idle
CPUs for a few milliseconds. A port test runs the JAX package as its
reference, and JAX's XLA CPU client spreads its work over a thread pool as
wide as the machine; torch's intra-op pool does the same.

Each ``tests/test_torch_port_*.py`` imports the fixture below; it is autouse
and module-scoped, so it applies while that module's tests run and gives
the previous settings back afterwards: torch at one intra-op thread and,
under xdist, every thread of the worker process (XLA's pool included) on one
CPU, a different one per worker. A call at import would change every
worker, since each worker imports every test module while collecting.
"""
import os

import pytest
import torch


def _worker_cpu():
    """The CPU of this xdist worker (``gw<N>``), or None outside xdist."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    if not worker.startswith("gw") or not hasattr(os, "sched_getaffinity"):
        return None
    cpus = sorted(os.sched_getaffinity(0))
    return cpus[int(worker[2:]) % len(cpus)]


def _pin_threads(cpus):
    """Every thread of this process on ``cpus``; threads started later
    inherit the mask of the thread that starts them."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:  # the thread ended meanwhile
            pass


@pytest.fixture(autouse=True, scope="module")
def one_thread_one_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cpu = _worker_cpu()
    mask = os.sched_getaffinity(0) if cpu is not None else None
    if cpu is not None:
        _pin_threads({cpu})
    yield
    if cpu is not None:
        _pin_threads(mask)
    torch.set_num_threads(threads)
