"""The port's RxPolicy registry on its three planes, against the reference.

``repro_torch.core.policy`` keeps the reference's ``RxPolicy`` plugins
and registry over the port's own ``baseline`` drivers, and resolves the
same five names on

* the DES plane (``make_policy``),
* the threaded plane (``make_queue`` / ``make_thread_queue``),
* the lane engine (``make_torch_policy``, the spec's ``torch_factory``).

Covered here: the specs equal the reference's (names, docs, leases,
presets, plugin classes); every name resolves on all three planes; the
presets have one copy, read from the spec; a plugin without a tensor
formulation resolves on the host planes and is refused by name on the
lane engine; the registry-wide exactly-once property on the DES
(completions equal to the reference's) and on real threads; hybrid's
stealing, adaptive-batch's bounds and locked's lock horizon.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from repro.core import des as rdes
from repro.core import policy as rpolicy
from repro_torch.core import Item, WorkerPool, make_queue, rss_hash
from repro_torch.core import des, policy
from repro_torch.core.des import DesItem
from repro_torch.core.policy import (
    TORCH_POLICIES,
    AdaptiveBatchPolicy,
    HybridStealPolicy,
    PolicySpec,
    RxPolicy,
    SharedQueuePolicy,
    available_policies,
    get_spec,
    make_policy,
    make_thread_queue,
    make_torch_policy,
    overload_defaults,
    register_policy,
    serving_defaults,
    torch_policies,
)

ALL_POLICIES = available_policies()
N_WORKERS = 4
SURFACES = ("produce", "produce_batch", "claim", "complete", "try_release", "backlog")


def _run_des(mods, policy_name, n_items=800, seed=0, skew=False):
    """Drive n_items through a DES worker plane; (done, plane).  ``mods``
    is ``(des module, make_policy)`` of either package."""
    mod, make = mods
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(0.3, size=n_items))  # rho ~ 0.83
    flows = np.zeros(n_items, dtype=int) if skew else rng.integers(0, 64, n_items)
    done: list = []
    loop = mod.EventLoop()
    plane = mod.WorkerPlane(
        loop,
        make(policy_name, N_WORKERS, batch=8),
        N_WORKERS,
        service_fn=lambda item: float(rng.exponential(1.0)),
        on_complete=lambda t, item: done.append((t, item.payload)),
        rng=rng,
        claim_overhead=0.05,
    )
    loop.on("arrive", plane.enqueue)
    for i in range(n_items):
        loop.schedule(
            float(arr[i]), "arrive", mod.DesItem(flow=int(flows[i]), payload=i)
        )
    loop.run()
    return done, plane


PORT = (des, make_policy)
REF = (rdes, rpolicy.make_policy)


# ---------------------------------------------------------------------
# The registry against the reference's
# ---------------------------------------------------------------------
def test_registry_names_equal_reference():
    assert ALL_POLICIES == rpolicy.available_policies()
    assert torch_policies() == sorted(TORCH_POLICIES) == rpolicy.jax_policies()


@pytest.mark.parametrize("name", ALL_POLICIES)
def test_spec_equals_reference(name):
    got, want = get_spec(name), rpolicy.get_spec(name)
    assert (got.name, got.doc, got.leases) == (want.name, want.doc, want.leases)
    assert dict(got.serving_defaults) == dict(want.serving_defaults)
    assert dict(got.overload_defaults) == dict(want.overload_defaults)
    assert got.des_factory.__name__ == want.des_factory.__name__
    assert got.des_factory.supports_leases == want.des_factory.supports_leases
    assert type(make_thread_queue(name, 2, 64)).__name__ == type(
        rpolicy.make_thread_queue(name, 2, 64)
    ).__name__


@pytest.mark.parametrize("name", ALL_POLICIES)
def test_name_resolves_on_all_three_planes(name):
    pol = make_policy(name, N_WORKERS, batch=8)
    assert isinstance(pol, RxPolicy) and pol.n_workers == N_WORKERS
    assert pol.name == name
    q = make_queue(name, N_WORKERS, 64)
    for surface in SURFACES:
        assert callable(getattr(q, surface)), (name, surface)
    lane = make_torch_policy(name)
    assert lane is TORCH_POLICIES[name] is get_spec(name).torch_factory()
    assert lane.name == name and lane.leases == get_spec(name).leases


@pytest.mark.parametrize("name", ALL_POLICIES)
def test_presets_are_read_from_the_spec(name):
    spec = get_spec(name)
    assert serving_defaults(name) == dict(spec.serving_defaults)
    assert overload_defaults(name) == dict(spec.overload_defaults)
    # fresh dicts: a caller's edit never reaches the spec
    serving_defaults(name)["admit_limit"] = -1.0
    assert serving_defaults(name) == dict(spec.serving_defaults)


def test_unknown_policy_raises_with_catalog():
    with pytest.raises(ValueError, match="unknown rx policy 'nope'.*corec"):
        make_policy("nope", 4)
    with pytest.raises(ValueError, match="corec"):
        make_queue("nope", 4, 64)
    with pytest.raises(ValueError, match="no torch-plane analogue; vectorized"):
        make_torch_policy("nope")
    with pytest.raises(ValueError, match="corec"):
        serving_defaults("nope")


def test_plugin_without_tensor_form_resolves_on_host_planes_only():
    spec = PolicySpec(
        name="fifo-plugin",
        des_factory=SharedQueuePolicy,
        thread_factory=lambda n, size, **kw: make_queue("corec", n, size, **kw),
        doc="a plugin with no lane-engine formulation",
    )
    register_policy(spec)
    try:
        assert "fifo-plugin" in available_policies()
        assert "fifo-plugin" not in torch_policies()
        assert make_policy("fifo-plugin", 2).n_workers == 2
        assert callable(make_queue("fifo-plugin", 2, 64).claim)
        with pytest.raises(ValueError, match="'fifo-plugin' has no torch-plane"):
            make_torch_policy("fifo-plugin")
        with pytest.raises(ValueError, match="already registered"):
            register_policy(spec)
        assert serving_defaults("fifo-plugin") == {}
    finally:
        policy._REGISTRY.pop("fifo-plugin")
    assert available_policies() == ALL_POLICIES


# ---------------------------------------------------------------------
# Exactly-once over the registry, on both host planes
# ---------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL_POLICIES)
def test_des_exactly_once_and_equal_to_reference(name):
    n = 800
    done, plane = _run_des(PORT, name, n_items=n, seed=7)
    assert Counter(p for _, p in done) == Counter(range(n)), name
    assert min(t for t, _ in done) > 0
    ref_done, ref_plane = _run_des(REF, name, n_items=n, seed=7)
    assert done == ref_done
    assert plane.stats.snapshot() == ref_plane.stats.snapshot()


@pytest.mark.parametrize("name", ALL_POLICIES)
def test_threaded_exactly_once_no_loss(name):
    n = 600
    q = make_queue(name, 3, 128)
    items = [Item(seqno=i, flow=i % 32) for i in range(n)]
    pool = WorkerPool(q, 3, work_fn=lambda it: None, max_batch=8)
    res = pool.run_open_loop(items, rate=None, drain_timeout=30)
    assert Counter(it.seqno for it in res.items) == Counter(range(n)), name
    assert not res.wedged and res.duplicates == 0
    assert sum(res.per_worker) == n


# ---------------------------------------------------------------------
# Work conservation, stealing, adaptive batches, the lock horizon
# ---------------------------------------------------------------------
@pytest.mark.parametrize("name", ["corec", "hybrid", "adaptive-batch", "locked"])
def test_work_conserving_policies_never_idle_with_backlog(name):
    _, plane = _run_des(PORT, name, n_items=1200, seed=11, skew=True)
    assert plane.stats.idle_with_backlog == 0


def test_scaleout_is_not_work_conserving_under_skew():
    _, plane = _run_des(PORT, "scaleout", n_items=1200, seed=11, skew=True)
    _, ref_plane = _run_des(REF, "scaleout", n_items=1200, seed=11, skew=True)
    assert plane.stats.idle_with_backlog == ref_plane.stats.idle_with_backlog > 0


def test_hybrid_steals_under_skew_like_reference():
    _, plane = _run_des(PORT, "hybrid", n_items=1200, seed=11, skew=True)
    _, ref_plane = _run_des(REF, "hybrid", n_items=1200, seed=11, skew=True)
    pol, ref = plane.policy, ref_plane.policy
    assert (pol.steals, pol.stolen_items) == (ref.steals, ref.stolen_items)
    assert pol.steals > 0
    assert len([w for w in plane.stats.per_worker_items if w > 0]) > 1


def test_hybrid_unit_steal_from_longest_backlog():
    pol = HybridStealPolicy(n_workers=2, batch=4)
    for i in range(6):
        pol.enqueue(DesItem(flow=0, payload=i, queue_hint=0))
    assert [it.payload for it in pol.next_batch(1)] == [0, 1, 2, 3]
    assert pol.steals == 1 and pol.stolen_items == 4
    assert [it.payload for it in pol.next_batch(0)] == [4, 5]


def test_hybrid_threaded_steal():
    q = make_queue("hybrid", 2, 64)
    key0 = next(k for k in range(64) if rss_hash(k, 2) == 0)
    for i in range(8):
        assert q.produce(i, flow_key=key0)
    c = q.claim(1, max_batch=4)  # worker 1's own ring is empty -> steal
    assert c is not None and len(c.payloads) == 4 and q.steals == 1
    q.complete(1, c)
    assert q.try_release(1) >= 4


def test_adaptive_batch_bounds_and_scaling():
    pol = AdaptiveBatchPolicy(n_workers=4, batch=8, min_batch=2, max_batch=8)
    assert all(2 <= pol.effective_batch(b) <= 8 for b in range(200))
    assert [pol.effective_batch(b) for b in (1, 12, 1000)] == [2, 3, 8]
    pol = AdaptiveBatchPolicy(n_workers=2, batch=16, min_batch=1, max_batch=16)
    for i in range(6):
        pol.enqueue(DesItem(payload=i))
    assert [len(pol.next_batch(0)) for _ in range(4)] == [3, 2, 1, 0]
    with pytest.raises(ValueError):
        AdaptiveBatchPolicy(n_workers=4, batch=8, min_batch=0)
    with pytest.raises(ValueError):
        AdaptiveBatchPolicy(n_workers=4, batch=8, min_batch=4, max_batch=2)
    q = make_queue("adaptive-batch", 4, 64, min_batch=1, max_batch=4)
    for i in range(32):
        assert q.produce(i)
    c = q.claim(0, max_batch=32)
    assert c is not None and 1 <= len(c.payloads) <= 4


def test_locked_policy_serializes_claims():
    pol = make_policy("locked", 2, batch=4)
    assert not pol.supports_leases
    assert pol.claim_start(0, 5.0) == 5.0
    pol.claim_release(0, 9.0)  # lock held until t = 9
    assert pol.claim_start(1, 5.0) == 9.0
    assert pol.claim_start(1, 12.0) == 12.0


def test_dead_queue_adoption_only_for_per_worker_queues():
    rss = make_policy("scaleout", 2, batch=4)
    for i in range(3):
        rss.enqueue(DesItem(flow=0, payload=i, queue_hint=1))
    assert [it.payload for it in rss.next_batch_dead(0, [1])] == [0, 1, 2]
    shared = make_policy("corec", 2, batch=4)
    shared.enqueue(DesItem(payload=0))
    assert shared.next_batch_dead(0, [1]) == []
