"""The port's serving scenario on its own draws, on the CPU.

Mirrors of the reference's serving and overload tests on the port's
torch-RNG traffic (``tests/test_servingjax.py``, the jax-side overload
tests of ``tests/test_impairment.py``): exactly-once under admission,
the SLO metrics against a numpy oracle, compacted == per-claim
reference engine with serving and overload knobs armed, the registry's
presets pinned to ``repro.core.policy``, the overload knobs' off
identity, the extended exactly-once invariant, and the metastable
cliff (naive retries collapse, the graceful preset degrades).  Then the
claim check's plain route against the reference's three steps (pack,
popcount, packed done-prefix) on ``chip_smoke.py``'s edge set.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import policy as jpolicy  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import (  # noqa: E402
    SweepRequest,
    overload_defaults,
    run_sweep,
    serving_defaults,
    sweep_serving_torch,
    torch_policies,
)
from repro_torch.core import torchplane as tp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
POLICIES = torch_policies()
N_WORKERS = 4
#: tests/test_servingjax.py's knobs and its overload regime
#: (tests/test_impairment.py: rho ~ 3/4 per worker before retries)
KNOBS = dict(admit_limit=24.0, base_workers=2.0, scale_backlog=16.0)
OV_RATE, OV_TIMEOUT, OV_DROP = 3.0, 2.0, 0.1


@pytest.fixture(scope="module")
def port_serving():
    """One fused serving call over every policy (diurnal arrivals at
    ~rho=1 peak, admission + autoscale armed, a finite horizon)."""
    res = run_sweep(
        SweepRequest(
            scenario="serving",
            policies=POLICIES,
            seeds=np.arange(6),
            arrival="diurnal",
            traffic_params=dict(rate=4.0),
            serving_params=dict(horizon=80.0, slo_target=30.0, **KNOBS),
            use_policy_serving_defaults=False,
            n_packets=400,
            n_workers=N_WORKERS,
            max_batch=32,
        ),
        device="cpu",
    )
    return {p: res[p] for p in POLICIES}


@pytest.mark.parametrize("name", POLICIES)
def test_exactly_once_under_admission(name, port_serving):
    # mirrors tests/test_servingjax.py::test_exactly_once_under_admission
    res = port_serving[name]
    items, shed, offered = (
        getattr(res, f).numpy() for f in ("items", "shed", "offered")
    )
    pop = res.claimed_popcount.numpy()
    assert (pop == items + shed).all()
    assert (offered <= 400).all() and (offered > 0).all()
    undelivered = offered - items - shed
    assert (undelivered >= 0).all()
    assert (res.undelivered.numpy() == undelivered).all()
    if name != "scaleout":
        # work-conserving disciplines drain what they admit, so the claim
        # bits form one prefix; static RSS may strand gated tails
        assert (undelivered == 0).all(), name
        assert (res.claimed_prefix.numpy() == pop).all()
    slo = res.slo_attained.numpy()
    assert (slo >= 0).all() and (slo <= 1).all()


def test_slo_metrics_match_numpy_oracle():
    # mirrors tests/test_servingjax.py::test_slo_metrics_match_numpy_oracle
    sp = dict(horizon=80.0, slo_target=25.0, **KNOBS)
    res = sweep_serving_torch(
        "corec",
        np.arange(4),
        capacity=400,
        arrival="diurnal",
        traffic_params=dict(rate=4.0),
        serving_params=sp,
        max_batch=32,
        return_times=True,
        device="cpu",
    )
    soj = res.sojourn.numpy()
    offered = res.offered.numpy()
    assert (res.shed.numpy() > 0).any()
    for lane in range(soj.shape[0]):
        delivered = soj[lane][np.isfinite(soj[lane])]
        assert delivered.size == int(res.items[lane])
        for f, q in (("p50", 50), ("p99", 99)):
            assert float(getattr(res, f)[lane]) == pytest.approx(
                np.percentile(delivered, q), rel=1e-5
            )
        assert float(res.mean[lane]) == pytest.approx(delivered.mean(), rel=1e-5)
        oracle = (delivered <= sp["slo_target"]).sum() / max(offered[lane], 1)
        assert float(res.slo_attained[lane]) == pytest.approx(oracle, rel=1e-6)


@pytest.mark.parametrize(
    "extra",
    [{}, dict(timeout=OV_TIMEOUT, retries=2, breaker_age=1.0, drop_rate=OV_DROP)],
    ids=["admission", "overload"],
)
def test_serving_compacted_matches_reference_engine(extra):
    # mirrors tests/test_servingjax.py::test_serving_compacted_matches_reference
    kw = dict(
        scenario="serving",
        policies=POLICIES,
        seeds=np.arange(3),
        arrival="diurnal",
        traffic_params=dict(rate=4.0),
        serving_params=dict(horizon=60.0, slo_target=20.0, **KNOBS, **extra),
        use_policy_serving_defaults=False,
        n_packets=200,
        n_workers=N_WORKERS,
        max_batch=16,
        return_times=True,
    )
    compacted = run_sweep(SweepRequest(engine="compacted", **kw), device="cpu")
    reference = run_sweep(SweepRequest(engine="reference", **kw), device="cpu")
    for name in POLICIES:
        for f in tp.LaneResult._fields:
            a = getattr(compacted[name], f).numpy()
            b = getattr(reference[name], f).numpy()
            np.testing.assert_array_equal(a, b, err_msg=f"{name}: {f}")


@pytest.mark.parametrize("name", POLICIES)
def test_registry_presets_equal_reference(name):
    assert serving_defaults(name) == jpolicy.serving_defaults(name)
    assert overload_defaults(name) == jpolicy.overload_defaults(name)
    # fresh dicts: a caller's edit never reaches the table
    serving_defaults(name)["admit_limit"] = -1.0
    overload_defaults(name)["retries"] = 99
    assert serving_defaults(name) == jpolicy.serving_defaults(name)
    assert overload_defaults(name) == jpolicy.overload_defaults(name)


def test_registry_serving_defaults_seed_run_sweep():
    # mirrors tests/test_servingjax.py::test_registry_serving_defaults
    shared = serving_defaults("corec")
    per_queue = serving_defaults("scaleout")
    assert set(shared) == {"admit_limit", "base_workers", "scale_backlog"}
    assert per_queue["admit_limit"] < shared["admit_limit"]
    res = run_sweep(
        SweepRequest(
            scenario="serving",
            policies=["corec"],
            seeds=np.arange(2),
            n_packets=150,
            traffic_params=dict(rate=2.0),
            serving_params=dict(horizon=40.0),
            max_batch=16,
        ),
        device="cpu",
    )["corec"]
    assert (res.shed.numpy() >= 0).all()
    assert (res.offered.numpy() < 150).any()


def _serving(pol, seeds, capacity, **serving_params):
    return sweep_serving_torch(
        pol,
        np.asarray(seeds),
        capacity=capacity,
        traffic_params=dict(rate=OV_RATE),
        serving_params=serving_params,
        n_workers=N_WORKERS,
        max_batch=16,
        device="cpu",
    )


def test_overload_knobs_off_is_bit_identical():
    # mirrors tests/test_impairment.py::test_overload_knobs_off_is_bit_identical
    base = _serving("corec", np.arange(2), 150)
    off = _serving("corec", np.arange(2), 150, retries=0, drop_rate=0.0)
    for f in tp.LaneResult._fields:
        np.testing.assert_array_equal(
            getattr(base, f).numpy(), getattr(off, f).numpy(), err_msg=f
        )
    assert torch.equal(base.attempts, base.offered)
    assert torch.equal(base.delivered, base.goodput)
    assert torch.equal(base.delivered, base.items)
    assert not base.expired.any() and not base.dup_served.any()


def test_extended_exactly_once_and_duplicate_bound():
    # mirrors tests/test_impairment.py::test_extended_exactly_once_and_
    # duplicate_bound_jax
    retries, hedge = 2, 0.5
    cpr = 1 + retries + 1
    res = _serving(
        "corec",
        np.arange(3),
        200,
        timeout=OV_TIMEOUT,
        retries=retries,
        backoff=1.0,
        jitter=0.5,
        hedge=hedge,
        drop_rate=OV_DROP,
    )
    pop, delivered, expired, shed, goodput, dup, offered, attempts = (
        getattr(res, f).numpy()
        for f in (
            "claimed_popcount",
            "delivered",
            "expired",
            "shed",
            "goodput",
            "dup_served",
            "offered",
            "attempts",
        )
    )
    assert (pop == delivered + expired + shed).all()
    assert (delivered == goodput + dup).all()
    assert (attempts <= offered * cpr).all()
    assert (dup <= goodput * (cpr - 1)).all()
    assert (goodput <= offered).all()
    assert attempts.sum() > offered.sum()
    assert expired.sum() + dup.sum() > 0


def test_naive_retries_collapse_but_graceful_degrades():
    # mirrors tests/test_impairment.py::test_naive_retries_collapse_but_
    # graceful_degrades_jax
    seeds, cap = np.arange(3), 240
    healthy = _serving("corec", seeds, cap, timeout=OV_TIMEOUT, drop_rate=OV_DROP)
    naive = _serving(
        "corec", seeds, cap, timeout=OV_TIMEOUT, retries=2, drop_rate=OV_DROP
    )
    graceful = _serving(
        "corec", seeds, cap, drop_rate=OV_DROP, **overload_defaults("corec")
    )
    h, n, g = (float(r.goodput.double().sum()) for r in (healthy, naive, graceful))
    assert n < 0.5 * h, (n, h)
    assert g > 0.75 * h, (g, h)
    assert g > 3.0 * n, (g, n)


def test_serving_sweep_has_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_serving_torch("corec", np.arange(2), capacity=50)
    with pytest.raises(ValueError, match="retries"):
        sweep_serving_torch(
            "corec", np.arange(2), capacity=50, serving_params=dict(retries=1.5),
            device="cpu",
        )


# ---------------------------------------------------------------------
# The claim check's plain route against the reference's three steps
# ---------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", _chip_smoke().CLAIM_NS)
def test_claim_check_plain_equals_reference_steps(n):
    claimed, limits = _chip_smoke().claim_rows(n, seed=n)
    words_j = jops.pack_bits_u32(claimed)
    pop_j = np.asarray(jax.lax.population_count(words_j)).sum(axis=1)
    prefix_j = jops.done_prefix_packed(words_j, limits, n_bits=n, impl="xla")
    words, pop, prefix = ops.claim_check(torch.tensor(claimed), torch.tensor(limits))
    assert words.dtype == pop.dtype == prefix.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(words_j))
    np.testing.assert_array_equal(pop.numpy(), pop_j)
    np.testing.assert_array_equal(prefix.numpy(), np.asarray(prefix_j))
    # one scalar limit for every row equals the same limit per row
    _, _, at_n = ops.claim_check(torch.tensor(claimed), n)
    full = jops.done_prefix_packed(
        words_j, np.full(len(claimed), n, np.int32), n_bits=n, impl="xla"
    )
    np.testing.assert_array_equal(at_n.numpy(), np.asarray(full))
    run = np.where(claimed.all(1), n, np.argmin(claimed, axis=1))
    np.testing.assert_array_equal(prefix.numpy(), np.minimum(run, limits))
    np.testing.assert_array_equal(pop.numpy(), claimed.sum(1))


@pytest.mark.parametrize(
    "address,n,want",
    [
        (0, 2000, 16),  # the forwarder grid's rows
        (0, 1000, 8),  # the serving grid's: every odd row 8 bytes off
        (1000, 1200, 8),  # a segment's rows at an 8-byte offset
        (0, 4097, 1),
        (4, 1200, 4),
        (3, 2000, 1),
        (256, 33, 1),
        (512, 32, 16),
    ],
)
def test_claim_vector_bytes_picks_the_widest_aligned_load(address, n, want):
    from repro_torch.kernels.doneprefix import claim_check_grid, claim_vector_bytes

    assert claim_vector_bytes(address, n) == want
    # every row start and chunk is aligned to the width chosen
    assert all((address + r * n) % want == 0 for r in range(4))
    assert claim_check_grid(5040) == (630, 256)


def test_claim_check_dispatch_rules():
    from repro_torch.kernels.doneprefix import claim_check_cuda

    claimed = torch.ones(3, 40, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.claim_check(claimed, 40, impl="cuda")
    with pytest.raises(ValueError, match="TPU route"):
        ops.claim_check(claimed, 40, impl="pallas")
    with pytest.raises(ValueError, match="CUDA device"):
        claim_check_cuda(claimed, 40, 40)  # the wrapper has no CPU path
    words, pop, prefix = ops.claim_check(claimed, 40, impl="plain")
    assert words.shape == (3, 2) and (pop == 40).all() and (prefix == 40).all()
