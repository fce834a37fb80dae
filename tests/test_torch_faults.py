"""The port's fault plane on the DES and on real threads, on the CPU.

The DES runs are deterministic, so each is held against the reference's
run on the same inputs exactly (every completion and every counter):
crash mid-claim with lease reclamation on every lease policy, a crash
between claims, a straggler, ``locked``'s wedge (it has no lease), a
run without a lease that strands and whose strict audit raises, and a
hypothesis chaos property over random fault schedules.

The threaded runs (real threads over the port's ``CorecRing``) are
held to the same contract as the reference's tests: a killed claim
holder is reclaimed by a peer within its lease (deterministic through
an injected clock), every lease policy drains after a crash, a stalled
holder is recovered, ``locked`` with a dead holder is reported wedged
(within a 1 s drain timeout) instead of hanging, a straggler drains.
And the reference's own ``scaleout/stall@pre`` stranding is pinned: a
worker parked before its first claim holds no lease and is not dead, so
exactly the items ``rss_hash`` pins to its ring stay undelivered, on
both packages.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import des as rdes
from repro.core import dispatch as rdispatch
from repro.core import faults as rfaults
from repro.core import policy as rpolicy
from repro_torch.core import des, dispatch, faults
from repro_torch.core.faults import FaultSpec, StrandedRunError, faults_by_worker
from repro_torch.core.policy import available_policies, get_spec, make_policy
from repro_torch.core.ring import CorecRing
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

ROOT = Path(__file__).resolve().parents[1]
ALL_POLICIES = available_policies()
LEASE_POLICIES = [p for p in ALL_POLICIES if get_spec(p).leases]
N_WORKERS = 4
PORT = (des, faults, make_policy)
REF = (rdes, rfaults, rpolicy.make_policy)


def _run_des(
    mods,
    policy_name,
    faults_=(),
    lease=None,
    n_items=400,
    seed=0,
    at_zero=False,
    claim_overhead=0.05,
    unit_service=False,
    batch=8,
):
    """Drive n_items through the faulted DES plane of either package
    (``mods``: its des and faults modules and make_policy); returns the
    completions and the plane (its stats not yet finalized)."""
    mod, fmod, make = mods
    rng = np.random.default_rng(seed)
    arr = np.zeros(n_items) if at_zero else np.cumsum(rng.exponential(0.3, n_items))

    def service(item):
        return 1.0 if unit_service else float(rng.exponential(1.0))

    done: list = []
    loop = mod.EventLoop()
    plane = mod.WorkerPlane(
        loop,
        make(policy_name, N_WORKERS, batch=batch),
        N_WORKERS,
        service_fn=service,
        on_complete=lambda t, item: done.append((t, item.payload)),
        rng=rng,
        claim_overhead=claim_overhead,
        faults=[fmod.FaultSpec(**f) for f in faults_],
        lease=lease,
    )
    loop.on("arrive", plane.enqueue)
    for i in range(n_items):
        loop.schedule(float(arr[i]), "arrive", mod.DesItem(flow=i % 64, payload=i))
    loop.run()
    return done, plane


def _both(policy_name, **kw):
    """The port's run, its finalized stats, and whether the reference's
    same run gave the same completions and counters."""
    done, plane = _run_des(PORT, policy_name, **kw)
    stats = plane.finalize()
    ref_done, ref_plane = _run_des(REF, policy_name, **kw)
    same = done == ref_done and stats.snapshot() == ref_plane.finalize().snapshot()
    return done, stats, same


# ---------------------------------------------------------------------
# FaultSpec
# ---------------------------------------------------------------------
def test_fault_spec_validates_like_reference():
    for bad, match in (
        (dict(worker=0, kind="meteor"), "kind"),
        (dict(worker=0, point="lunch"), "point"),
        (dict(worker=0, kind="straggler", factor=0.5), "factor"),
    ):
        with pytest.raises(ValueError, match=match):
            FaultSpec(**bad)
        with pytest.raises(ValueError, match=match):
            rfaults.FaultSpec(**bad)
    with pytest.raises(ValueError, match="worker"):
        faults_by_worker([FaultSpec(worker=9)], n_workers=4)
    by_w = faults_by_worker(
        [FaultSpec(worker=1, t=3.0), FaultSpec(worker=1, kind="stall", t=9.0)], 4
    )
    assert len(by_w[1]) == 2
    assert faults.FAULT_POINTS == rfaults.FAULT_POINTS


# ---------------------------------------------------------------------
# DES plane, port == reference exactly
# ---------------------------------------------------------------------
@pytest.mark.parametrize("name", LEASE_POLICIES)
def test_des_crash_mid_claim_reclaims_and_drains(name):
    # unit service + items at t = 0 put the crash at t = 5 mid-batch
    n = 200
    done, stats, same = _both(
        name,
        faults_=[dict(worker=1, t=5.0)],
        lease=2.0,
        n_items=n,
        at_zero=True,
        unit_service=True,
    )
    assert same
    assert Counter(p for _, p in done) == Counter(range(n))
    assert stats.dead_workers == 1 and stats.reclaims >= 1
    assert stats.reclaimed_items >= 1 and stats.duplicates <= 8
    assert not stats.wedged


@pytest.mark.parametrize("name", LEASE_POLICIES)
def test_des_crash_between_claims_drains_without_reclaim(name):
    n = 150
    done, stats, same = _both(
        name, faults_=[dict(worker=2, t=1e9)], lease=2.0, n_items=n
    )
    assert same
    assert Counter(p for _, p in done) == Counter(range(n))
    assert stats.duplicates == 0 and not stats.wedged


def test_des_straggler_slows_but_drains():
    n = 300
    slow = [dict(worker=0, kind="straggler", t=0.0, factor=6.0)]
    done_f, stats, same = _both("corec", faults_=slow, n_items=n, seed=3)
    done_b, _, _ = _both("corec", n_items=n, seed=3)
    assert same
    assert Counter(p for _, p in done_f) == Counter(range(n))
    assert stats.dead_workers == 0 and not stats.wedged
    assert max(t for t, _ in done_f) > max(t for t, _ in done_b)


def test_des_locked_wedges_without_lease_and_is_reported():
    n = 64
    done, stats, same = _both(
        "locked",
        faults_=[dict(worker=0, t=0.5)],
        lease=2.0,
        n_items=n,
        at_zero=True,
        claim_overhead=1.0,
        unit_service=True,
    )
    assert same
    assert done == [] and stats.dead_workers == 1 and stats.wedged
    assert stats.reclaims == 0 and stats.stranded_items > 0
    assert stats.undrained == n - stats.stranded_items


def test_des_no_lease_strands_and_strict_finalize_raises():
    n = 200
    kw = dict(
        faults_=[dict(worker=1, t=5.0)], n_items=n, at_zero=True, unit_service=True
    )
    done, stats, same = _both("corec", **kw)
    assert same
    assert stats.wedged and stats.stranded_items > 0 and stats.reclaims == 0
    assert all(v == 1 for v in Counter(p for _, p in done).values())
    assert len(done) == n - stats.stranded_items
    _, plane = _run_des(PORT, "corec", **kw)
    with pytest.raises(StrandedRunError, match="stranded"):
        plane.finalize(strict=True)


@given(data=st.data())
@settings(max_examples=12, deadline=None)
def test_chaos_des_random_fault_schedules_equal_reference(data):
    """Any fault schedule with >= 1 survivor: unique first deliveries, a
    drain unless the policy is ``locked``, and the reference's run."""
    name = data.draw(st.sampled_from(ALL_POLICIES))
    specs = [
        dict(
            worker=data.draw(st.integers(0, N_WORKERS - 2), label=f"worker{i}"),
            kind=data.draw(
                st.sampled_from(["crash", "stall", "straggler"]), label=f"kind{i}"
            ),
            t=data.draw(st.floats(0.0, 60.0, allow_nan=False), label=f"t{i}"),
            factor=data.draw(st.floats(1.5, 8.0), label=f"factor{i}"),
        )
        for i in range(data.draw(st.integers(0, 3)))
    ]
    n = 150
    seed = data.draw(st.integers(0, 2**16), label="seed")
    done, stats, same = _both(name, faults_=specs, lease=2.0, n_items=n, seed=seed)
    assert same
    got = Counter(p for _, p in done)
    assert all(v == 1 for v in got.values())
    if stats.wedged:
        assert name == "locked"
    else:
        assert got == Counter(range(n))
    assert stats.duplicates <= 8 * max(1, len(specs))


# ---------------------------------------------------------------------
# Threaded plane: the chaos harness on real threads
# ---------------------------------------------------------------------
def _pool_run(
    mod, policy, n, faults_=(), drain_timeout=30.0, size=128, n_flows=32, **qkw
):
    """One burst of n items through ``mod``'s queue and 3-thread pool."""
    q = mod.make_queue(policy, 3, size, **qkw)
    items = [mod.Item(seqno=i, flow=i % n_flows) for i in range(n)]
    pool = mod.WorkerPool(q, 3, lambda it: None, max_batch=8, faults=faults_)
    return pool.run_open_loop(items, rate=None, drain_timeout=drain_timeout)


def test_threaded_kill_claim_holder_peer_reclaims_within_lease():
    # Deterministic lease expiry through an injected clock (as
    # tests/test_faults.py does): time stands at 0 until the holder is
    # really dead and its claim is the only lease left, then jumps past
    # the lease; live workers block until the kill lands.
    n = 400
    boxes: dict = {}

    def clock() -> float:
        pool = boxes.get("pool")
        if pool is not None and any(pool.dead) and boxes["q"].leases_outstanding() <= 1:
            return 10.0
        return 0.0

    def work_fn(it) -> None:
        pool = boxes["pool"]
        while not (any(pool.dead) or pool._stop.is_set()):
            time.sleep(0.001)

    q = dispatch.make_queue("corec", 3, 128, lease_timeout=0.2, clock=clock)
    boxes["q"] = q
    items = [dispatch.Item(seqno=i, flow=i % 32) for i in range(n)]
    faults_ = [FaultSpec(worker=0, after_claims=0, point="hold")]
    pool = dispatch.WorkerPool(q, 3, work_fn=work_fn, max_batch=8, faults=faults_)
    boxes["pool"] = pool
    t0 = time.perf_counter()
    res = pool.run_open_loop(items, rate=None, drain_timeout=30)
    assert Counter(it.seqno for it in res.items) == Counter(range(n))
    assert res.dead_workers == 1 and res.reclaims >= 1 and res.duplicates <= 8
    assert res.stranded == 0 and not res.wedged
    assert time.perf_counter() - t0 < 15.0  # the lease, not the drain timeout


@pytest.mark.parametrize("point", ["pre", "hold"])
@pytest.mark.parametrize("name", LEASE_POLICIES)
def test_threaded_crash_drains_on_every_lease_policy(name, point):
    # 'pre' fires on worker 1's first loop; 'hold' on its first claim,
    # which the peers leave it by holding theirs until the kill lands
    n = 300
    pools: list = []

    def work_fn(it) -> None:
        while point == "hold" and not (any(pools[0].dead) or pools[0]._stop.is_set()):
            time.sleep(0.001)

    q = dispatch.make_queue(name, 3, 128, lease_timeout=0.2)
    pools.append(
        dispatch.WorkerPool(
            q, 3, work_fn, max_batch=8,
            faults=[FaultSpec(worker=1, after_claims=0, point=point)],
        )
    )
    items = [dispatch.Item(seqno=i, flow=i % 32) for i in range(n)]
    res = pools[0].run_open_loop(items, rate=None, drain_timeout=30)
    assert Counter(it.seqno for it in res.items) == Counter(range(n)), name
    assert res.dead_workers == 1 and not res.wedged
    if point == "hold":  # died holding its first claim: a peer re-served it
        assert res.reclaims >= 1 and res.duplicates <= 8


def test_threaded_stall_holder_is_recovered_by_peers():
    n = 300
    res = _pool_run(
        dispatch, "corec", n, lease_timeout=0.2,
        faults_=[FaultSpec(worker=0, kind="stall", after_claims=1, point="hold")],
    )
    assert Counter(it.seqno for it in res.items) == Counter(range(n))
    assert not res.wedged


def test_threaded_locked_crash_holder_wedges_reported_not_hung():
    n = 300
    t0 = time.perf_counter()
    res = _pool_run(
        dispatch, "locked", n, size=64, drain_timeout=1.0,
        faults_=[FaultSpec(worker=0, after_claims=0, point="hold")],
    )
    assert res.wedged and res.dead_workers >= 1 and len(res.items) < n
    assert time.perf_counter() - t0 < 10.0


def test_threaded_straggler_drains_with_skewed_work():
    n = 200
    res = _pool_run(
        dispatch, "hybrid", n,
        faults_=[FaultSpec(worker=0, kind="straggler", t=0.0, factor=8.0)],
    )
    assert Counter(it.seqno for it in res.items) == Counter(range(n))
    assert res.dead_workers == 0 and not res.wedged


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scaleout_stall_before_first_claim_strands_its_ring_like_reference():
    """tests/test_faults.py::test_chaos_threaded_random_fault_schedules
    fails on the reference at ``scaleout/stall@pre`` after 0 claims: the
    parked worker holds no lease (nothing to reclaim) and is not dead
    (``ScaleOutDriver`` adopts only a dead worker's ring), so the items
    RSS pins to its ring wait out the drain timeout.  The port does the
    same, item for item; ``chip_smoke.py`` phase 18c runs this case."""
    res, pinned = _chip_smoke().stall_pre_stranding()
    assert res.wedged and res.dead_workers == 1 and res.reclaims == 0
    assert 0 < len(pinned) < 150
    delivered = sorted(it.seqno for it in res.items)
    assert delivered == sorted(set(range(150)) - set(pinned))
    ref = _pool_run(
        rdispatch, "scaleout", 150, drain_timeout=1.0, lease_timeout=0.2,
        n_flows=16,
        faults_=[rfaults.FaultSpec(worker=0, kind="stall", after_claims=0,
                                   point="pre")],
    )
    assert ref.wedged and sorted(it.seqno for it in ref.items) == delivered


# ---------------------------------------------------------------------
# The packed ring: lease reclamation publishes the hole
# ---------------------------------------------------------------------
def test_packed_ring_reclaim_hole_then_refill_matches_prefix_oracle():
    now = [0.0]
    ring = CorecRing(64, packed=True, lease_timeout=1.0, clock=lambda: now[0])
    for i in range(24):
        assert ring.produce(i)
    c0 = ring.claim(8)  # strands: its owner "dies" before complete()
    c1, c2 = ring.claim(8), ring.claim(8)
    ring.complete(c1)
    ring.complete(c2)
    assert c0 is not None and ring.leases_outstanding() == 1

    def words():
        bits = torch.tensor([ring._done.test(i) for i in range(64)])
        return ops.pack_bits_u32(bits[None])

    limits = torch.tensor([64], dtype=torch.int32)
    assert int(ops.done_prefix_packed(words(), limits, n_bits=64)[0]) == 0
    now[0] = 2.0  # past the lease deadline
    rc = ring.reclaim_expired()
    assert len(rc) == 1 and list(rc[0].payloads) == list(c0.payloads)
    assert ring.stats.reclaims == 1 and ring.stats.reclaimed_items == 8
    w = words()
    got = int(ops.done_prefix_packed(w, limits, n_bits=64)[0])
    assert got == int(kref.done_prefix_packed_ref(w, limits, n_bits=64)[0]) == 24
    ring.complete(c0)  # the owner's late complete() backs off
    assert ring.leases_outstanding() == 0
    assert ring.try_release() == 24


def test_ring_lease_owner_completion_beats_early_reclaim():
    now = [0.0]
    ring = CorecRing(64, packed=True, lease_timeout=1.0, clock=lambda: now[0])
    for i in range(8):
        assert ring.produce(i)
    c = ring.claim(8)
    assert ring.reclaim_expired() == []
    ring.complete(c)
    now[0] = 5.0
    assert ring.reclaim_expired() == [] and ring.stats.reclaims == 0
    assert ring.try_release() == 8


def test_dispatch_result_fields_equal_reference():
    names = [f.name for f in dataclasses.fields(dispatch.DispatchResult)]
    assert names == [f.name for f in dataclasses.fields(rdispatch.DispatchResult)]
