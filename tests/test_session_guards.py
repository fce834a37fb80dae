"""The root ``conftest.py``'s guards, each in an inner pytest session:

* a test that overruns the time limit of a phase fails alone, with its
  node id and every thread's stack, and the session goes on;
* under pytest-xdist, each worker runs its tests on its main thread
  (where the limit's timer can be armed) with its share of the cores.
"""

from __future__ import annotations

import importlib.util
import re
import time
from pathlib import Path

import pytest

pytest_plugins = ["pytester"]

ROOT = Path(__file__).resolve().parents[1]
_XDIST_VARS = ("PYTEST_XDIST_WORKER", "PYTEST_XDIST_WORKER_COUNT")
_POOL_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "PJRT_NPROC")


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def inner(pytester, monkeypatch):
    """A pytester directory holding the root conftest, its environment
    free of the outer session's xdist worker and thread share."""
    for var in _XDIST_VARS + _POOL_VARS:
        monkeypatch.delenv(var, raising=False)
    pytester.makeconftest((ROOT / "conftest.py").read_text())
    return pytester


def test_an_overrunning_test_fails_alone_with_every_threads_stack(inner):
    source = inner.path.joinpath("conftest.py").read_text()
    source, n = re.subn(r"(?m)^PHASE_LIMIT_S = .*$", "PHASE_LIMIT_S = 2.0", source)
    assert n == 1
    inner.makeconftest(source)
    inner.makepyfile(
        test_inner="""
        import threading
        import time

        def test_sleeps_past_the_limit():
            threading.Thread(target=time.sleep, args=(30,), daemon=True).start()
            time.sleep(60)

        def test_passes():
            assert True
        """
    )
    t0 = time.monotonic()
    result = inner.runpytest_subprocess("-p", "no:cacheprovider", timeout=60)
    wall = time.monotonic() - t0
    result.assert_outcomes(passed=1, failed=1)
    out = result.stdout.str()
    node = "test_inner.py::test_sleeps_past_the_limit"
    assert f"{node}: call overran its 2 s limit" in out
    assert f"FAILED {node}" in out
    assert "Current thread 0x" in out and "in test_sleeps_past_the_limit" in out
    assert out.count("(most recent call first)") >= 2  # the sleeper's stack too
    assert wall < 2 + 10


def test_xdist_workers_run_tests_on_their_main_thread_with_their_share(inner):
    inner.makepyfile(
        test_inner="""
        import os
        import threading

        import torch

        def test_share():
            share = max(1, len(os.sched_getaffinity(0)) // 2)
            assert threading.current_thread() is threading.main_thread()
            assert torch.get_num_threads() == share
            for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "PJRT_NPROC"):
                assert os.environ[var] == str(share)
        """
    )
    args = ("-p", "no:cacheprovider", "-p", "xdist", "-n", "2")
    inner.runpytest_subprocess(*args, timeout=120).assert_outcomes(passed=1)


def test_without_xdist_the_pools_are_left_alone(inner):
    inner.makepyfile(
        test_inner="""
        import os

        def test_untouched():
            for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "PJRT_NPROC"):
                assert var not in os.environ
        """
    )
    result = inner.runpytest_subprocess("-p", "no:cacheprovider", timeout=60)
    result.assert_outcomes(passed=1)


@pytest.mark.parametrize(
    "cores, workers, share",
    [(8, 6, 1), (8, 4, 2), (8, 2, 4), (8, 1, 8), (4, 6, 1), (32, 6, 5)],
)
def test_thread_share(cores, workers, share):
    assert _root_conftest().thread_share(cores, workers) == share
