"""Session guards for every test of the repo (``tests/`` and ``bench/``).

* **A time limit for each phase of each test.** A test's setup, call
  and teardown get ``PHASE_LIMIT_S`` seconds each (a module or session
  fixture counts against the first test that requests it). At the
  limit every thread's stack goes to the test's stderr, that phase
  fails with the test's node id, and the session goes on with the
  next test. The limit is a ``SIGALRM`` timer, so it
  is armed only on the main thread, where pytest and pytest-xdist's
  workers run their tests; a test blocked inside one C call fails when
  that call returns.
* **Each xdist worker's share of the cores.** Under pytest-xdist each
  worker's thread pools get ``cores // workers`` threads, at least one:
  torch's intra- and inter-op pools, OpenMP and MKL, and XLA's CPU
  client (``PJRT_NPROC``). The environment is set when this file is
  imported, before a test imports torch or jax, so that the processes
  tests spawn inherit it. Without xdist nothing changes.
"""

from __future__ import annotations

import faulthandler
import os
import signal
import sys
import threading

import pytest

#: over twice the slowest test phase of the suite under six xdist workers
#: on 8 cores (``test_ring_properties.py::test_random_long_schedules_drain``,
#: 319-330 s), and under half the 1,470 s the whole run is given
PHASE_LIMIT_S = 720.0
_POOL_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "PJRT_NPROC")


def thread_share(cores: int, workers: int) -> int:
    """Threads each of ``workers`` processes gets of ``cores``."""
    return max(1, cores // workers)


def _worker_share() -> int | None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return thread_share(len(os.sched_getaffinity(0)), int(workers))


_SHARE = _worker_share()
if _SHARE is not None:
    for _var in _POOL_VARS:
        os.environ.setdefault(_var, str(_SHARE))


def pytest_configure(config):
    if _SHARE is None:
        return
    import torch

    torch.set_num_threads(_SHARE)
    try:
        torch.set_num_interop_threads(_SHARE)
    except RuntimeError:  # the pool already started
        pass


def _limited(item, phase):
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def overrun(signum, frame):
        out = sys.stderr
        try:
            out.fileno()
        except (AttributeError, OSError, ValueError):
            out = sys.__stderr__
        out.flush()
        faulthandler.dump_traceback(file=out, all_threads=True)
        pytest.fail(
            f"{item.nodeid}: {phase} overran its {PHASE_LIMIT_S:g} s limit",
            pytrace=False,
        )

    previous = signal.signal(signal.SIGALRM, overrun)
    signal.setitimer(signal.ITIMER_REAL, PHASE_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True, tryfirst=True)
def pytest_runtest_setup(item):
    yield from _limited(item, "setup")


@pytest.hookimpl(hookwrapper=True, tryfirst=True)
def pytest_runtest_call(item):
    yield from _limited(item, "call")


@pytest.hookimpl(hookwrapper=True, tryfirst=True)
def pytest_runtest_teardown(item):
    yield from _limited(item, "teardown")
