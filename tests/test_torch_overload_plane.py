"""The port's overload plane vs ``repro.core.jaxplane`` on the same state.

The scenarios and helpers of ``tests/test_torch_serving_plane.py`` (the
reference's serving setups carried across, all five policies fused),
with the client and overload knobs armed:

* retries with backoff and jitter, a hedge copy, a timeout and
  per-lane response loss (4 copies per request);
* the registry's graceful preset (bounded retries, breaker, matched
  admission) on the shared-queue policies beside a breaker without
  retries on the per-worker queues: segments with 3 and 1 copies per
  request share one slot count, the single-copy ones padded with
  never-arriving slots;
integers exact, floats at ``rtol=1e-6`` with the same +-inf pattern,
the per-step ClaimRecords (``shed`` included) of one lane per policy,
the setups built from the reference's traffic; then the attempt
expansion's stable order on exact ties, and the counter hash bit for
bit against both reference mirrors.  ``tests/test_torch_latency_gate.py``
runs the latency-reactive gate the same way.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_serving_plane import (  # noqa: E402
    POLICIES,
    assert_port_equals_reference,
    assert_records_equal_reference,
    assert_setup_equals_reference,
    scenario_runs,
)

from repro.core.faults import hash_u01 as hash_u01_py  # noqa: E402
from repro.core.jaxplane import hash_u01 as hash_u01_jax  # noqa: E402
from repro_torch.core import torchplane as tp  # noqa: E402

OVERLOAD = ["retries_timeout", "breaker"]


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("scenario", OVERLOAD)
def test_overload_port_equals_reference_on_injected_setups(scenario, name):
    assert_port_equals_reference(scenario, name)
    runs, n_slots = scenario_runs(scenario)
    ref = runs[name][2]
    attempts, offered = np.asarray(ref.attempts), np.asarray(ref.offered)
    if scenario == "breaker":
        assert n_slots == 3 * 120
        assert np.asarray(ref.shed).sum() > 0
    else:  # every request fans out into copies
        assert (attempts > offered).all()
    if scenario == "retries_timeout":
        assert np.asarray(ref.expired).sum() + np.asarray(ref.dup_served).sum() > 0


@pytest.mark.parametrize("name", POLICIES)
def test_overload_claim_records_equal_reference_scan(name):
    assert_records_equal_reference("breaker", name)


@pytest.mark.parametrize("name", ["corec", "scaleout"])
@pytest.mark.parametrize("scenario", OVERLOAD)
def test_overload_setup_equals_reference_on_its_traffic(scenario, name, monkeypatch):
    assert_setup_equals_reference(scenario, name, monkeypatch)


def test_attempt_expansion_keeps_the_stable_order_on_ties():
    # naive retries: request k's copy at arr_k + 2 lands exactly on
    # request i's arrival (and +inf requests tie among themselves); the
    # reference's jnp.argsort is stable, and so must the port's sort be
    arr = np.array([[0.5, 1.0, 2.5, 3.0, 4.5, np.inf, np.inf]], np.float32)
    n, n_slots = arr.shape[1], 3 * arr.shape[1] + 2
    ov = tp.OverloadConfig(timeout=2.0, retries=2)
    svc = np.arange(1, n + 1, dtype=np.float32)[None] / 8
    flows = np.arange(n, dtype=np.int64)[None] * 3
    got = tp._expand_attempts(
        torch.tensor(arr),
        torch.tensor(svc),
        torch.tensor(flows),
        n_slots,
        ov,
        None,
        torch.tensor([7]),
    )
    arr_e = np.concatenate([arr, arr + 2.0, arr + 4.0, np.full((1, 2), np.inf)], 1)
    order = np.argsort(arr_e[0], kind="stable")
    assert (np.asarray(jnp.argsort(jnp.asarray(arr_e[0]))) == order).all()
    assert len(set(arr_e[0][np.isfinite(arr_e[0])])) < np.isfinite(arr_e).sum()
    parent = np.concatenate([np.tile(np.arange(n), 3), [0, 0]])[order]
    att = np.concatenate([np.repeat(np.arange(3), n), [4, 4]])[order]
    np.testing.assert_array_equal(got[0][0].numpy(), arr_e[0][order])
    np.testing.assert_array_equal(got[3][0].numpy(), parent)
    np.testing.assert_array_equal(got[4][0].numpy(), att)
    finite = np.isfinite(arr_e[0][order])
    np.testing.assert_array_equal(
        got[1][0].numpy(), np.where(finite, svc[0][parent], 0.0)
    )
    np.testing.assert_array_equal(got[2][0].numpy(), flows[0][parent])


@pytest.mark.parametrize("seed", [0, 1, 7, 0xDEADBEEF])
def test_hash_u01_equals_both_reference_mirrors_bit_for_bit(seed):
    # mirrors tests/test_impairment.py::test_hash_u01_planes_agree_bit_for_bit
    a = np.arange(64, dtype=np.uint32)
    b = np.arange(16, dtype=np.uint32)
    py = np.array(
        [[np.float32(hash_u01_py(seed, int(x), int(y))) for y in b] for x in a],
        dtype=np.float32,
    )
    jx = np.asarray(hash_u01_jax(seed, a[:, None], b[None, :]))
    got = tp.hash_u01(seed, torch.tensor(a[:, None]), torch.tensor(b[None, :]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jx)
    np.testing.assert_array_equal(got.numpy(), py)
    # the full 32-bit range: large counters and seeds wrap as uint32
    rng = np.random.default_rng(seed & 0xFFFF)
    big = rng.integers(0, 2**32, size=(256,), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(hash_u01_jax(seed ^ 0xA5A5A5A5, big, big[::-1]))
    got = tp.hash_u01(
        seed ^ 0xA5A5A5A5,
        torch.tensor(big.astype(np.int64)),
        torch.tensor(big[::-1].astype(np.int64)),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_u01_rate_zero_never_fires():
    u = tp.hash_u01(3, torch.arange(1024)[:, None], torch.arange(4)[None, :])
    assert bool(((u >= 0) & (u < 1)).all())
    assert abs(float(u.double().mean()) - 0.5) < 0.02
    assert not bool((u < 0.0).any())
