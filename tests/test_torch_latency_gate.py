"""The latency-reactive autoscale gate vs ``repro.core.jaxplane``.

The ``scale_latency`` scenario of ``tests/test_torch_serving_plane.py``:
naive retries (backoff = jitter = 0, so a retry can arrive at the same
instant as another request's copy) and workers above ``base_workers``
woken by the lane's own p99 sojourn estimate (a Robbins-Monro tracker
fed by every claim) instead of by queue length.  On the reference's
setups, all five policies fused: integers exact, floats at
``rtol=1e-6`` with the same +-inf pattern, the per-step ClaimRecords of
one lane per policy, and the setups built from the reference's traffic.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_serving_plane import (  # noqa: E402
    POLICIES,
    assert_port_equals_reference,
    assert_records_equal_reference,
    assert_setup_equals_reference,
    scenario_runs,
)


@pytest.mark.parametrize("name", POLICIES)
def test_latency_gate_port_equals_reference_on_injected_setups(name):
    assert_port_equals_reference("scale_latency", name)
    ref = scenario_runs("scale_latency")[0][name][2]
    assert (np.asarray(ref.attempts) > np.asarray(ref.offered)).all()


@pytest.mark.parametrize("name", POLICIES)
def test_latency_gate_claim_records_equal_reference_scan(name):
    assert_records_equal_reference("scale_latency", name)


@pytest.mark.parametrize("name", ["corec", "scaleout"])
def test_latency_gate_setup_equals_reference_on_its_traffic(name, monkeypatch):
    assert_setup_equals_reference("scale_latency", name, monkeypatch)
