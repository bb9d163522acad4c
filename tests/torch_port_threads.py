"""One torch thread for the port's test modules and, when the suite runs in
xdist workers, none of the first four CPUs and only time no other work wants.

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
under xdist, every thread of the worker process (XLA's pool included) on
the CPUs past the first ``FREE_CPUS`` under the idle scheduling policy (a
thread runs only where no other work wants its CPU). Setting the policy
back raises where it is refused, so no later module runs at idle priority
unseen. A call at import would change every worker, since each worker
imports every test module while collecting.
"""
import os

import pytest
import torch

# CPUs no port worker runs on: the timing test's four threads
FREE_CPUS = 4


def _port_cpus():
    """The CPUs past the first ``FREE_CPUS`` (the last CPU where none
    remain) in an xdist worker (``gw<N>``), or None outside xdist."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    if not worker.startswith("gw") or not hasattr(os, "sched_getaffinity"):
        return None
    cpus = sorted(os.sched_getaffinity(0))
    return set(cpus[FREE_CPUS:] or cpus[-1:])


def _pin_threads(cpus, policy):
    """Every thread of this process on ``cpus`` under scheduling ``policy``;
    threads started later inherit both from the thread that starts them."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
            os.sched_setscheduler(int(tid), policy, os.sched_param(0))
        except ProcessLookupError:  # the thread ended meanwhile
            pass


@pytest.fixture(autouse=True, scope="module")
def one_thread_one_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cpus = _port_cpus()
    if cpus is not None:
        mask, policy = os.sched_getaffinity(0), os.sched_getscheduler(0)
        _pin_threads(cpus, os.SCHED_IDLE)
    yield
    if cpus is not None:
        _pin_threads(mask, policy)  # raises PermissionError where refused
    torch.set_num_threads(threads)
