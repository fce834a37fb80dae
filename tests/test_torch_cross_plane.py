"""The port's lane engine against the port's own DES plane, on the CPU.

The paper's check that the vectorized plane reproduces the simulated
one, inside ``repro_torch`` alone: the lane engine (``run_sweep``, here
on ``device="cpu"``, its plain routes) and the DES plane on matched
configs, with the reference's setups and bands -- the same recipes
``chip_smoke.py`` phase 18b runs with the lane engine on the card:

* forwarder (``tests/test_jaxplane.py:210``): every policy, the means
  over seeds of p50 within 15% and of p99 within 35%;
* faulted forwarder (``tests/test_fault_jax.py:206``): worker 1 crashes
  at t = 10 with a lease of 2; the bands on corec and hybrid (the
  policies the reference asserts), adaptive-batch and scaleout drain on
  both planes, and ``locked`` (no lease) strands on both;
* serving (``tests/test_servingjax.py:40-97``): every policy, the median
  SLO attainment within 15% and the median p99 within 35%.

TCP's cross-plane check is ``tests/test_torch_tcp_des.py``.
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The lane tensors are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _lanes(scenario: str):
    if scenario == "serving":
        req = CHIP.xp_serving_request()
    else:
        req = CHIP.xp_forwarder_request(faulted=scenario == "faulted")
    return run_sweep(req, device="cpu")


def _mean(t) -> float:
    return float(t.numpy().mean())


@pytest.mark.parametrize("name", POLICIES)
def test_forwarder_lane_engine_within_bands_of_des(name):
    res = _lanes("forwarder")[name]
    assert int(res.undelivered.sum()) == 0
    assert bool((res.claimed_prefix == CHIP.XP_PACKETS).all())
    des = CHIP.xp_forwarder_des(name, faulted=False)
    assert des["lost"] == 0
    assert _mean(res.p50) == pytest.approx(des["p50"], rel=CHIP.P50_RTOL)
    assert _mean(res.p99) == pytest.approx(des["p99"], rel=CHIP.P99_RTOL)


@pytest.mark.parametrize("name", POLICIES)
def test_faulted_forwarder_against_des(name):
    res = _lanes("faulted")[name]
    des = CHIP.xp_forwarder_des(name, faulted=True)
    undelivered = int(res.undelivered.sum())
    if name == "locked":  # no lease: the dead holder's claim strands
        assert undelivered > 0 and des["lost"] > 0
        return
    assert undelivered == 0 and des["lost"] == 0
    if name in CHIP.XP_FAULT_BANDED:
        assert _mean(res.p50) == pytest.approx(des["p50"], rel=CHIP.P50_RTOL)
        assert _mean(res.p99) == pytest.approx(des["p99"], rel=CHIP.P99_RTOL)


def test_faulted_band_policies_are_the_references():
    assert CHIP.XP_FAULT_BANDED == ("corec", "hybrid")
    assert (CHIP.P50_RTOL, CHIP.P99_RTOL, CHIP.SLO_RTOL) == (0.15, 0.35, 0.15)


@pytest.mark.parametrize("name", POLICIES)
def test_serving_lane_engine_within_bands_of_des(name):
    res = _lanes("serving")[name]
    des = CHIP.xp_serving_des(name)
    d_slo = float(np.median([r.slo_attained for r in des]))
    d_p99 = float(np.median([r.p99 for r in des]))
    j_slo = float(np.median(res.slo_attained.numpy()))
    j_p99 = float(np.median(res.p99.numpy()))
    assert j_slo == pytest.approx(d_slo, rel=CHIP.SLO_RTOL), (name, j_slo, d_slo)
    assert j_p99 == pytest.approx(d_p99, rel=CHIP.P99_RTOL), (name, j_p99, d_p99)
    # shed volumes in the same regime (the same admission valve)
    d_shed = float(np.median([r.shed for r in des]))
    j_shed = float(np.median(res.shed.numpy()))
    assert j_shed == pytest.approx(d_shed, rel=0.5, abs=10.0), (name, j_shed, d_shed)
