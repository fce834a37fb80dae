"""Pluggable Rx scheduling policies and the one registry every plane shares.

The paper's thesis (sections 3.1-3.2) is that the *policy* -- who may
serve which packet -- not raw queue speed, drives tail latency.  This
module makes the policy a plugin: an :class:`RxPolicy` is
``select_queue(item)`` on enqueue plus ``next_batch(worker)`` on drain,
and a string registry resolves the same names for

* the DES plane (:mod:`repro_torch.core.des`, via :func:`make_policy`)
  used by ``queueing.py`` / ``forwarder.py`` / ``tcp.py`` and the DES
  half of ``servingtorch.py``;
* the threaded plane (:mod:`repro_torch.core.dispatch`'s ``make_queue``,
  via :func:`make_thread_queue`), built on the real ``CorecRing`` /
  ``ScaleOutDriver`` / ``LockedSharedQueue`` objects of
  :mod:`repro_torch.core.baseline`;
* the lane engine (:mod:`repro_torch.core.torchplane` and
  :mod:`repro_torch.core.tcptorch`, via :func:`make_torch_policy`): the
  :class:`TorchPolicy` flags and tensor ``select_queue`` /
  ``next_batch`` analogues of :data:`TORCH_POLICIES`.

Built-in policies and their paper anchors:

==============  ========================================================
``corec``       one shared queue, any worker claims a batch -- the work-
                conserving M/G/N discipline of section 3.2 / Listing 2.
``scaleout``    RSS: per-flow hash pins each packet to one worker's
                queue (N x M/G/1, the DPDK default the paper baselines
                against).
``locked``      one shared queue behind a big lock (the Metronome-class
                baseline): work-conserving but *blocking* -- claims
                serialize on a lock horizon, and a descheduled claim
                holder stalls every peer (section 3.3).
``hybrid``      RSS steering for per-flow order, plus work-stealing from
                the longest backlog when a worker's own queue is empty.
``adaptive-batch``
                the corec shared queue with the batch-vs-latency knob
                (section 4.2) made dynamic: claim size grows with the
                backlog (fair-shared across workers), clamped to
                [min_batch, max_batch].
==============  ========================================================

Each :class:`PolicySpec` also carries the policy's serving and overload
presets; :func:`serving_defaults` / :func:`overload_defaults` read them
from the spec, so the table below is their one copy.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional

from .baseline import (
    AdaptiveBatchSharedQueue,
    CorecSharedQueue,
    HybridStealDriver,
    LockedSharedQueue,
    ScaleOutDriver,
    rss_hash,
)
from .des import DesItem
from .torchplane import (
    TorchPolicy,
    _next_batch_adaptive,
    _next_batch_cap,
    _select_rss,
    _select_shared,
)

__all__ = [
    "RxPolicy",
    "SharedQueuePolicy",
    "RssPolicy",
    "LockedPolicy",
    "HybridStealPolicy",
    "AdaptiveBatchPolicy",
    "PolicySpec",
    "register_policy",
    "get_spec",
    "available_policies",
    "make_policy",
    "make_thread_queue",
    "TORCH_POLICIES",
    "TorchPolicy",
    "torch_policies",
    "make_torch_policy",
    "serving_defaults",
    "overload_defaults",
]


class RxPolicy:
    """Base class: a set of FIFO queues + the two policy decisions.

    ``select_queue(item)`` — which queue an arriving item joins (the
    NIC-side steering decision); ``next_batch(worker)`` — which items a
    free worker drains (the driver-side claim decision).  Timing hooks
    ``claim_start`` / ``claim_release`` let blocking policies model
    serialization; lock-free policies leave them as identities.
    """

    #: registry name, set by the subclass
    name: str = "?"

    #: Lease-based claim reclamation capability.  True for every
    #: non-blocking policy: a claim is a CAS, so a live worker can
    #: re-issue an expired peer claim without entering anyone's critical
    #: section.  The blocking 'locked' policy opts out — a lease on a
    #: mutex-guarded claim would have to break the mutex, which is
    #: exactly the operation a lock-based design cannot express — so a
    #: dead lock holder wedges every peer (paper section 3.3 under real
    #: failure instead of a transient deschedule).
    supports_leases: bool = True

    def __init__(self, n_workers: int, batch: int = 32, n_queues: int = 1):
        self.n_workers = n_workers
        self.batch = batch
        self.queues: List[deque] = [deque() for _ in range(n_queues)]

    # -- enqueue side ---------------------------------------------------
    def select_queue(self, item: DesItem) -> int:
        raise NotImplementedError

    def enqueue(self, item: DesItem) -> None:
        self.queues[self.select_queue(item)].append(item)

    # -- drain side -----------------------------------------------------
    def next_batch(self, worker: int) -> List[DesItem]:
        raise NotImplementedError

    def backlog(self) -> int:
        return sum(len(q) for q in self.queues)

    def next_batch_dead(self, worker: int, dead_queues) -> List[DesItem]:
        """Failover drain: adopt backlog pinned to a dead peer's queue.

        RSS-class policies pin flows to one consumer, so a dead worker
        leaves its queue without a drainer; a live worker with no work
        of its own pops the dead peer's queue head instead (lease-style
        helping at steering granularity).  Shared-queue policies have a
        single queue every live worker already drains — nothing extra
        to adopt.
        """
        if len(self.queues) <= 1:
            return []
        for q_idx in dead_queues:
            if q_idx < len(self.queues) and self.queues[q_idx]:
                return self._pop(self.queues[q_idx], self.batch)
        return []

    # -- serialization hooks (blocking policies only) -------------------
    def claim_start(self, worker: int, t: float) -> float:
        return t

    def claim_release(self, worker: int, t: float) -> None:
        return None

    # -- helpers --------------------------------------------------------
    def _pop(self, q: deque, k: int) -> List[DesItem]:
        return [q.popleft() for _ in range(min(k, len(q)))]


class SharedQueuePolicy(RxPolicy):
    """``corec``: one shared FIFO, any free worker claims up to batch."""

    name = "corec"

    def __init__(self, n_workers: int, batch: int = 32):
        super().__init__(n_workers, batch, n_queues=1)

    def select_queue(self, item: DesItem) -> int:
        return 0

    def next_batch(self, worker: int) -> List[DesItem]:
        return self._pop(self.queues[0], self.batch)


class RssPolicy(RxPolicy):
    """``scaleout``: per-flow hash pins items to one worker's queue.

    ``item.queue_hint`` (when set) bypasses the hash — the indirection-
    table override the queueing layer uses for uniform-random and
    round-robin assignment.
    """

    name = "scaleout"

    def __init__(self, n_workers: int, batch: int = 32):
        super().__init__(n_workers, batch, n_queues=n_workers)

    def select_queue(self, item: DesItem) -> int:
        if item.queue_hint is not None:
            return item.queue_hint
        return rss_hash(item.flow, self.n_workers)

    def next_batch(self, worker: int) -> List[DesItem]:
        return self._pop(self.queues[worker], self.batch)


class LockedPolicy(SharedQueuePolicy):
    """``locked``: the shared queue behind one big lock (Metronome-class).

    Claims serialize on a lock horizon; the lock is held through the
    claim overhead *and* any deschedule stall, so a preempted holder
    blocks all peers — the blocking pathology of paper section 3.3.
    Service itself runs outside the lock (the threaded
    ``LockedSharedQueue`` releases the mutex after claim+copy too).
    """

    name = "locked"
    supports_leases = False

    def __init__(self, n_workers: int, batch: int = 32):
        super().__init__(n_workers, batch)
        self._lock_free_t = 0.0

    def claim_start(self, worker: int, t: float) -> float:
        return t if t > self._lock_free_t else self._lock_free_t

    def claim_release(self, worker: int, t: float) -> None:
        self._lock_free_t = t


class HybridStealPolicy(RxPolicy):
    """``hybrid``: RSS steering + work stealing from the longest backlog.

    A worker drains its own hash-pinned queue (per-flow in-order, like
    scaleout) but when that queue is empty it claims a batch from the
    head of the currently longest peer queue — restoring work
    conservation under skew (Zipf elephants, bursts) at the price of
    corec-style cross-worker reordering only for stolen batches.
    """

    name = "hybrid"

    def __init__(self, n_workers: int, batch: int = 32):
        super().__init__(n_workers, batch, n_queues=n_workers)
        self.steals = 0
        self.stolen_items = 0

    def select_queue(self, item: DesItem) -> int:
        if item.queue_hint is not None:
            return item.queue_hint
        return rss_hash(item.flow, self.n_workers)

    def next_batch(self, worker: int) -> List[DesItem]:
        own = self.queues[worker]
        if own:
            return self._pop(own, self.batch)
        victim = max(range(self.n_workers), key=lambda i: len(self.queues[i]))
        if not self.queues[victim]:
            return []
        got = self._pop(self.queues[victim], self.batch)
        self.steals += 1
        self.stolen_items += len(got)
        return got


class AdaptiveBatchPolicy(SharedQueuePolicy):
    """``adaptive-batch``: shared queue, claim size scales with backlog.

    Effective claim size is ``clip(ceil(backlog / n_workers),
    min_batch, max_batch)`` — light load degenerates to per-packet
    claims (minimum added latency), bursts fair-share across workers
    with amortized claim overhead.
    """

    name = "adaptive-batch"

    def __init__(
        self,
        n_workers: int,
        batch: int = 32,
        min_batch: int = 1,
        max_batch: Optional[int] = None,
    ):
        super().__init__(n_workers, batch)
        if min_batch < 1:
            raise ValueError("min_batch must be >= 1")
        self.min_batch = min_batch
        self.max_batch = batch if max_batch is None else max_batch
        if self.max_batch < self.min_batch:
            raise ValueError("max_batch must be >= min_batch")

    def effective_batch(self, backlog: int) -> int:
        share = -(-backlog // self.n_workers)  # ceil
        return min(self.max_batch, max(self.min_batch, share))

    def next_batch(self, worker: int) -> List[DesItem]:
        q = self.queues[0]
        if not q:
            return []
        return self._pop(q, self.effective_batch(len(q)))


#: The lane engine's policy table: each name's flags and its tensor
#: ``select_queue`` / ``next_batch`` (``repro/core/jaxplane.py:530-542``).
TORCH_POLICIES = {
    "corec": TorchPolicy("corec", True, False, _select_shared, _next_batch_cap),
    "scaleout": TorchPolicy("scaleout", False, False, _select_rss, _next_batch_cap),
    "locked": TorchPolicy(
        "locked", True, True, _select_shared, _next_batch_cap, leases=False
    ),
    "hybrid": TorchPolicy(
        "hybrid", False, False, _select_rss, _next_batch_cap, steals=True
    ),
    "adaptive-batch": TorchPolicy(
        "adaptive-batch", True, False, _select_shared, _next_batch_adaptive
    ),
}


# ----------------------------------------------------------------------
# Registry: one name -> DES policy, threaded queue and lane-engine policy
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class PolicySpec:
    name: str
    des_factory: Callable[..., RxPolicy]  # (n_workers, batch, **kw)
    thread_factory: Callable[..., Any]  # (n_workers, size, **kw)
    doc: str = ""
    #: () -> :class:`TorchPolicy`, the policy's analogue on the lane
    #: engine, or None when the discipline has no tensor formulation
    #: (plugins may opt out).
    torch_factory: Optional[Callable[[], TorchPolicy]] = None
    #: whether claims made under this policy can carry a reclamation
    #: lease (see RxPolicy.supports_leases) -- False only for blocking
    #: disciplines, whose faulted runs wedge instead of recovering.
    leases: bool = True
    #: Baseline admission/autoscale knobs for the open-loop serving
    #: scenario: keys are :class:`~repro_torch.core.torchplane.ServingParams`
    #: fields.  ``admit_limit`` caps the backlog of the queue a claiming
    #: worker drains, so per-worker-queue disciplines carry ~1/N of the
    #: shared-queue cap for a comparable total admission budget.  Serving
    #: sweeps merge caller overrides on top (``run_sweep``); an empty
    #: mapping means "no per-policy preset".
    serving_defaults: Mapping[str, float] = field(default_factory=dict)
    #: Graceful-degradation preset for the overload scenario: the
    #: client/breaker knobs (``timeout``, ``retries``, ``backoff``,
    #: ``jitter``, ``breaker_age``; see
    #: :class:`~repro_torch.core.torchplane.OverloadConfig`) plus an
    #: ``admit_limit`` matched to the timeout.  Times are in units of the
    #: mean service time; an empty mapping means "no preset".
    overload_defaults: Mapping[str, float] = field(default_factory=dict)


_REGISTRY: Dict[str, PolicySpec] = {}


def register_policy(spec: PolicySpec) -> PolicySpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"policy {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> PolicySpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown rx policy {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_policies() -> List[str]:
    return sorted(_REGISTRY)


def make_policy(name: str, n_workers: int, batch: int = 32, **kw) -> RxPolicy:
    """Build a DES-plane policy instance from its registry name."""
    return get_spec(name).des_factory(n_workers, batch, **kw)


def make_thread_queue(name: str, n_workers: int, size: int, **kw):
    """Build a threaded-plane queue object from the same registry name."""
    return get_spec(name).thread_factory(n_workers, size, **kw)


def torch_policies() -> List[str]:
    """Policy names that run on the torch plane."""
    return sorted(n for n, s in _REGISTRY.items() if s.torch_factory is not None)


def make_torch_policy(name: str) -> TorchPolicy:
    """Resolve a policy name; an unknown one raises with the catalog."""
    spec = _REGISTRY.get(name)
    if spec is None or spec.torch_factory is None:
        raise ValueError(
            f"policy {name!r} has no torch-plane analogue; "
            f"vectorized: {torch_policies()}"
        )
    return spec.torch_factory()


def serving_defaults(name: str) -> dict:
    """The policy's baseline serving knobs (a fresh, mergeable dict)."""
    return dict(get_spec(name).serving_defaults)


def overload_defaults(name: str) -> dict:
    """The policy's graceful-degradation overload preset (a fresh dict)."""
    return dict(get_spec(name).overload_defaults)


def _fused_requests(seeds, lane_params=None, policies=None, **knob_dicts):
    """One request dict per policy for the fused lane engine.

    The sweep convention of ``repro.core.policy._fused_requests``:
    ``adaptive-batch``'s swept knob is its clamp, so when ``lane_params``
    sweeps ``batch`` and gives no ``max_batch``, the batch axis is
    mirrored into ``max_batch`` for that policy.  Extra keyword dicts
    (``traffic_params=...``, ``fault_params=...``) pass through.
    """
    names = torch_policies() if policies is None else list(policies)
    requests = []
    for name in names:
        lp = dict(lane_params or {})
        if name == "adaptive-batch" and "batch" in lp and "max_batch" not in lp:
            lp["max_batch"] = lp["batch"]
        req = {"policy": name, "seeds": seeds, "lane_params": lp}
        for key, val in knob_dicts.items():
            req[key] = dict(val) if val else {}
        requests.append(req)
    return requests


#: the baseline serving knobs of the shared-queue disciplines; per-worker
#: queues carry ~1/N of the admission budget (N = 4, the reference pool)
_SERVING_SHARED = {"admit_limit": 96.0, "base_workers": 2.0, "scale_backlog": 48.0}
_SERVING_PERQUEUE = {"admit_limit": 24.0, "base_workers": 2.0, "scale_backlog": 12.0}

#: graceful-degradation overload presets: bounded retries with backoff
#: and jitter, a breaker on a stale queue head, and an admission depth
#: matched to the client deadline (per-worker queues: ~1/N of it)
_GRACEFUL_SHARED = {
    "timeout": 2.0,
    "retries": 2,
    "backoff": 4.0,
    "jitter": 1.0,
    "breaker_age": 0.5,
    "admit_limit": 2.0,
}
_GRACEFUL_PERQUEUE = dict(_GRACEFUL_SHARED, admit_limit=1.0)


def _register(name: str, des_factory, thread_factory, doc: str, per_queue: bool):
    """Register a built-in policy: its lane-engine analogue is its
    :data:`TORCH_POLICIES` entry, its leases its plugin's, and its
    presets the per-worker-queue or the shared-queue ones."""
    register_policy(
        PolicySpec(
            name=name,
            des_factory=des_factory,
            thread_factory=thread_factory,
            doc=doc,
            torch_factory=lambda: TORCH_POLICIES[name],
            leases=des_factory.supports_leases,
            serving_defaults=_SERVING_PERQUEUE if per_queue else _SERVING_SHARED,
            overload_defaults=_GRACEFUL_PERQUEUE if per_queue else _GRACEFUL_SHARED,
        )
    )


_register(
    "corec",
    SharedQueuePolicy,
    lambda n, size, **kw: CorecSharedQueue(size, **kw),
    "one shared non-blocking queue, batch claims (the paper)",
    per_queue=False,
)
_register(
    "scaleout",
    RssPolicy,
    lambda n, size, **kw: ScaleOutDriver(n, size, **kw),
    "RSS: N per-worker queues, per-flow hash pinning (DPDK default)",
    per_queue=True,
)
_register(
    "locked",
    LockedPolicy,
    lambda n, size, **kw: LockedSharedQueue(size, **kw),
    "one shared queue behind a mutex (Metronome-class baseline)",
    per_queue=False,
)
_register(
    "hybrid",
    HybridStealPolicy,
    lambda n, size, **kw: HybridStealDriver(n, size, **kw),
    "RSS steering + work stealing from the longest backlog",
    per_queue=True,
)
_register(
    "adaptive-batch",
    AdaptiveBatchPolicy,
    lambda n, size, **kw: AdaptiveBatchSharedQueue(size, n, **kw),
    "shared queue, claim size scales with backlog in [min,max]",
    per_queue=False,
)
