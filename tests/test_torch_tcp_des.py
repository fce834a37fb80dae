"""The port's TCP lane engine on its own draws against the port's DES.

The counterpart of ``test_tcpjax.py::test_distributional_parity_with_des_plane``
inside ``repro_torch``: twelve flows of 50 packets starting 4 apart, six
seeds, all five policies in one fused port call; the port's DES plane
(``repro_torch.core.tcp``, three seeds, steered by the lane engine's
32-bit hash through ``queue_hints``) pools its FCTs the same way.
Pooled FCT p50 and p99 per policy within ``test_tcpjax.py``'s
tolerances.  The recipe is ``chip_smoke.py`` phase 18b's
(``xp_tcp_request``, ``xp_tcp_des``), which runs the lane engine on the
card; the port's ``simulate_tcp`` itself equals the reference's exactly
(``tests/test_torch_des.py``).
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import run_sweep, torch_policies

ROOT = Path(__file__).resolve().parents[1]
POLICIES = torch_policies()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()
P50_RTOL = CHIP.P50_RTOL
P99_RTOL = CHIP.P99_RTOL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The lane tensors are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _port_sweep():
    return run_sweep(CHIP.xp_tcp_request(), device="cpu")


@pytest.mark.parametrize("name", POLICIES)
def test_distributional_parity_with_des_plane(name):
    res = _port_sweep()[name]
    assert bool(res.done.all())
    sends = res.sends
    assert bool((res.claimed_popcount == sends).all())
    assert bool((res.claimed_prefix == sends).all())
    j = res.fct.numpy().ravel()
    d = CHIP.xp_tcp_des(name)
    assert len(d) == CHIP.XP_TCP_FLOWS * CHIP.XP_DES_SEEDS
    for q, rtol in ((50, P50_RTOL), (99, P99_RTOL)):
        got, want = np.percentile(j, q), np.percentile(d, q)
        assert got == pytest.approx(want, rel=rtol), (name, q, got, want)
