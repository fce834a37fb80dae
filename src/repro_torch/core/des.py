"""Unified discrete-event simulation core for every simulator in the repo.

This is the single event engine behind the three scenario layers that
used to hand-roll their own heapq loops:

* ``core/queueing.py``  — M/G/N vs N x M/G/1 and the protocol-cost model
  (paper section 3.2, Figs 3-4; Tables 2-3 extrapolation),
* ``core/forwarder.py`` — the open-loop L3-forwarder reordering DES
  (section 4.3.1, Fig 7 and Table 4),
* ``core/tcp.py``       — TCP flows over the forwarder (section 4.3.2,
  Table 5 and Figs 8-10).

The split of responsibilities:

``EventLoop``
    A bare (time, tiebreak, kind, payload) heap with named handlers.
    Scenario layers register their own kinds ("arrive", "deliver",
    "ack", ...); the worker plane registers exactly one private kind for
    worker-free events.

``WorkerPlane``
    The paper's receive side: ``n_workers`` batch-claiming workers
    draining the queues owned by an :class:`repro_torch.core.policy.RxPolicy`.
    On every enqueue or worker-free event it sweeps the workers in index
    order and, for each free worker, asks the policy for a batch
    (``next_batch``), charges the batch claim overhead (section 3.4's
    DD-scan + CAS cost, plus the policy's serialization hook — the lock
    horizon of the Metronome-class 'locked' baseline), samples a rare
    deschedule stall (section 3.3's preemption pathology), then runs the
    per-item service times and reports each completion to the scenario.

The plane draws from its RNG in a fixed order per claimed batch — one
uniform for the deschedule Bernoulli (always drawn, hit or not), one
exponential on a hit, then one service sample per item — which is
exactly the draw order of the seed implementations, so the refactored
simulators reproduce the pre-refactor statistics draw-for-draw (see
``tests/test_des_parity.py``).

Policies come from :mod:`repro_torch.core.policy`; anything registered there
(corec / scaleout / locked / hybrid / adaptive-batch / ...) runs on this
plane unchanged, and the same registry also builds the threaded-plane
queue objects (``core/dispatch.make_queue``), so a policy written once
is measurable in simulated time and on real threads alike.
"""

from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

from .faults import FaultSpec, StrandedRunError, faults_by_worker

__all__ = ["DesItem", "EventLoop", "PlaneStats", "WorkerPlane"]


@dataclass(slots=True)
class DesItem:
    """A unit of work flowing through the plane.

    ``flow`` feeds hash-steering policies; ``queue_hint`` (when set)
    overrides steering with a precomputed queue id — the scenario-level
    equivalent of a NIC indirection table, used by the queueing layer to
    reproduce the seed's uniform-random / round-robin assignments.
    """

    flow: int = 0
    payload: Any = None
    queue_hint: Optional[int] = None


class EventLoop:
    """Heap of (t, tiebreak, kind, payload) with per-kind handlers."""

    def __init__(self) -> None:
        self._heap: list = []
        self._counter = itertools.count()
        self._handlers: dict = {}

    def on(self, kind: str, fn: Callable[[float, Any], None]) -> None:
        self._handlers[kind] = fn

    def schedule(self, t: float, kind: str, payload: Any = None) -> None:
        heapq.heappush(self._heap, (t, next(self._counter), kind, payload))

    def run(self, on_idle: Optional[Callable[[float], None]] = None) -> None:
        """Pump events until the heap is empty.

        ``on_idle(t)`` fires whenever the heap drains (after the event
        that emptied it); it may schedule more events, in which case the
        loop continues — the TCP layer uses this for its coarse RTO
        sweep.
        """
        heap = self._heap
        handlers = self._handlers
        while heap:
            t, _, kind, payload = heapq.heappop(heap)
            handlers[kind](t, payload)
            if on_idle is not None and not heap:
                on_idle(t)


@dataclass
class PlaneStats:
    """Batch-claim accounting for one simulation run."""

    batches: int = 0
    items: int = 0
    deschedules: int = 0
    rejected: int = 0  # items shed by admission control (serving runs)
    idle_with_backlog: int = 0  # dispatch sweeps that left a free worker
    # while some queue was non-empty (0 for any work-conserving policy)
    per_worker_items: List[int] = field(default_factory=list)
    # -- fault/recovery accounting (all zero on fault-free runs) --------
    dead_workers: int = 0  # crashed + permanently stalled workers
    reclaims: int = 0  # expired leases taken over by a live worker
    reclaimed_items: int = 0  # items recovered through lease reclamation
    duplicates: int = 0  # re-deliveries of items the dead worker already
    # served (batch-granular done loss: bounded by one batch per fault)
    stranded_items: int = 0  # claimed-but-undelivered at end of run
    undrained: int = 0  # enqueued-but-unclaimed at end of run
    wedged: bool = False  # run ended with undelivered work

    def snapshot(self) -> dict:
        return dict(self.__dict__)


@dataclass
class _Stranded:
    """A claim whose owner died before releasing it.

    ``delivered`` is the prefix of ``batch`` the dead worker completed
    before the fault (deliveries within a batch are in order); a lease
    reclaim re-serves the WHOLE batch — the done-marks were lost at
    batch granularity — counting that prefix as duplicates.
    """

    worker: int
    batch: List[DesItem]
    delivered: int
    deadline: float  # +inf when the policy has no lease capability


class WorkerPlane:
    """N batch-claiming workers draining an RxPolicy's queues.

    Parameters
    ----------
    loop, policy, n_workers : the event loop, a bound
        :class:`~repro_torch.core.policy.RxPolicy`, and the worker count
        (must equal ``policy.n_workers``).
    service_fn : item -> service time.  Scenario-owned so each layer
        keeps its own cost model (per-size forwarding cost, lognormal
        jitter, pre-drawn M/D/LN samples, ...).
    on_complete : (t_done, item) -> None, called once per item in
        completion order within the batch.
    rng : numpy Generator used for the deschedule draws (shared with the
        scenario's service sampling so draw order is well defined).
    claim_overhead : per-batch claim cost (DD scan + CAS, or the
        seed-calibrated effective overhead including CAS retries).
    deschedule_prob / deschedule_mean : per-batch Bernoulli stall with
        exponential length.  The Bernoulli uniform is drawn for every
        batch even when the probability is 0 — keeping the RNG stream
        identical across policy/overhead configurations (and to the seed
        implementations).
    faults : injected :class:`~repro_torch.core.faults.FaultSpec` schedule.
        A crash/stall at time ``t`` kills the worker: if a claim is in
        flight, only its completions at or before ``t`` are delivered
        and the claim strands with a lease deadline (``t0 + lease``); a
        straggler multiplies the worker's service times by ``factor``
        from ``t`` on.
    lease : lease duration for claim reclamation, or None to disable.
        With a lease, a live worker observing an expired deadline
        re-serves the stranded batch (non-blocking helping): items the
        dead worker already delivered are counted as duplicates (done
        marks are lost at batch granularity), the rest complete late —
        at-least-once for the reclaimed span, exactly-once elsewhere.
        Policies without lease capability ('locked') strand forever and
        the run is reported wedged by :meth:`finalize`.
    """

    _FREE = "_worker_free"
    _RETRY = "_worker_lock_retry"
    _FAULT = "_worker_fault"
    _RECLAIM = "_lease_reclaim"

    def __init__(
        self,
        loop: EventLoop,
        policy,
        n_workers: int,
        service_fn: Callable[[DesItem], float],
        on_complete: Callable[[float, DesItem], None],
        rng,
        claim_overhead: float = 0.0,
        deschedule_prob: float = 0.0,
        deschedule_mean: float = 0.0,
        faults: Optional[Sequence[FaultSpec]] = None,
        lease: Optional[float] = None,
        on_reject: Optional[Callable[[float, DesItem], None]] = None,
    ):
        if getattr(policy, "n_workers", n_workers) != n_workers:
            raise ValueError(
                f"policy bound for {policy.n_workers} workers, plane has {n_workers}"
            )
        self.loop = loop
        self.policy = policy
        self.n_workers = n_workers
        self.service_fn = service_fn
        self.on_complete = on_complete
        self.on_reject = on_reject
        self.rng = rng
        self.claim_overhead = claim_overhead
        self.deschedule_prob = deschedule_prob
        self.deschedule_mean = deschedule_mean
        self.free = [True] * n_workers
        self.dead = [False] * n_workers
        self.stats = PlaneStats(per_worker_items=[0] * n_workers)
        self.lease = lease
        # Per-worker fault views: first crash/stall time (+inf = none)
        # and the straggler (onset, factor) pair.
        self.fault_t = [math.inf] * n_workers
        self.slow_from = [math.inf] * n_workers
        self.slow_factor = [1.0] * n_workers
        self._had_faults = bool(faults)
        self._stranded: List[_Stranded] = []
        for w, specs in faults_by_worker(faults, n_workers).items():
            for spec in specs:
                if spec.kind == "straggler":
                    self.slow_from[w] = min(self.slow_from[w], spec.t)
                    self.slow_factor[w] = spec.factor
                else:
                    self.fault_t[w] = min(self.fault_t[w], spec.t)
        loop.on(self._FREE, self._on_free)
        loop.on(self._RETRY, self._on_free)
        loop.on(self._FAULT, self._on_fault)
        loop.on(self._RECLAIM, lambda t, _p: self.dispatch(t))
        for w in range(n_workers):
            if math.isfinite(self.fault_t[w]):
                loop.schedule(self.fault_t[w], self._FAULT, w)

    # ------------------------------------------------------------------
    def enqueue(self, t: float, item: DesItem) -> None:
        self.policy.enqueue(item)
        self.dispatch(t)

    def _on_free(self, t: float, worker: int) -> None:
        self.free[worker] = True
        self.dispatch(t)

    def _on_fault(self, t: float, worker: int) -> None:
        # An idle worker dies in place; a busy one is handled at claim
        # time (the batch in flight was truncated when it was formed).
        if self.free[worker] and not self.dead[worker]:
            self._kill(worker)
        self.dispatch(t)

    def _kill(self, worker: int) -> None:
        if not self.dead[worker]:
            self.dead[worker] = True
            self.free[worker] = False
            self.stats.dead_workers += 1

    # ------------------------------------------------------------------
    def _leases_enabled(self) -> bool:
        return self.lease is not None and getattr(
            self.policy, "supports_leases", True
        )

    def _strand(self, worker: int, t0: float, batch: List[DesItem], delivered: int):
        deadline = t0 + self.lease if self._leases_enabled() else math.inf
        self._stranded.append(_Stranded(worker, batch, delivered, deadline))
        if math.isfinite(deadline):
            self.loop.schedule(deadline, self._RECLAIM, None)

    def _pop_expired(self, t: float) -> Optional[_Stranded]:
        for i, ent in enumerate(self._stranded):
            if ent.deadline <= t:
                return self._stranded.pop(i)
        return None

    # ------------------------------------------------------------------
    def _run_batch(
        self, w: int, start: float, batch: List[DesItem], dup_prefix: int = 0
    ) -> None:
        """Charge overhead + stall, serve the batch, handle mid-batch death.

        RNG draw order on the fault-free path is unchanged from the
        original dispatch loop (one uniform, one exponential on a hit,
        one service sample per item) — pinned by tests/test_des_parity.
        ``dup_prefix`` marks the leading items of a reclaimed batch that
        the dead owner already delivered: they are re-served (the helper
        cannot know) but counted as duplicates instead of re-completed.
        """
        stats = self.stats
        rng = self.rng
        tt = start + self.claim_overhead
        if rng.random() < self.deschedule_prob:
            tt += float(rng.exponential(self.deschedule_mean))
            stats.deschedules += 1
        ft = self.fault_t[w]
        if ft <= tt:
            # Death during the claim overhead / stall window: nothing is
            # delivered, and a 'locked' holder dies INSIDE its critical
            # section — the lock horizon goes to +inf and every peer
            # wedges (the paper's case against blocking designs, now
            # under a real failure instead of a transient deschedule).
            self.policy.claim_release(w, math.inf)
            self._kill(w)
            stats.batches += 1
            self._strand(w, start, batch, delivered=max(dup_prefix, 0))
            return
        # The lock (if any) covers claim + any stall while holding it —
        # a descheduled lock holder blocks every peer, the paper's case
        # against Metronome-class designs.  Service runs outside it.
        self.policy.claim_release(w, tt)
        service_fn = self.service_fn
        on_complete = self.on_complete
        factor = self.slow_factor[w] if start >= self.slow_from[w] else 1.0
        served = 0
        for item in batch:
            dt = service_fn(item) * factor
            if tt + dt > ft:
                break
            tt += dt
            if served < dup_prefix:
                stats.duplicates += 1
            else:
                on_complete(tt, item)
            served += 1
        k = len(batch)
        if served < k:
            # Mid-claim crash: the delivered prefix is out, the claim is
            # stranded, the worker is gone.  No _FREE event is scheduled.
            self._kill(w)
            stats.batches += 1
            stats.items += max(served - dup_prefix, 0)
            stats.per_worker_items[w] += max(served - dup_prefix, 0)
            self._strand(w, start, batch, delivered=max(served, dup_prefix))
            return
        self.loop.schedule(tt, self._FREE, w)
        stats.batches += 1
        stats.items += k - dup_prefix
        stats.per_worker_items[w] += k - dup_prefix

    # ------------------------------------------------------------------
    def dispatch(self, t: float) -> None:
        """Sweep workers in index order; hand each free one a batch."""
        free = self.free
        dead = self.dead
        policy = self.policy
        stats = self.stats
        fault_t = self.fault_t
        # Serving-scenario hooks, both optional on the policy object
        # (see repro_torch.core.servingtorch.ServingPolicy): ``claim_gate``
        # models an autoscaled pool — a gated worker may not claim yet —
        # and ``shed_batch`` is dequeue-side admission control, run by
        # the claiming worker right before it forms its batch (the lane
        # engine's shed-at-claim, event for event).
        gate_fn = getattr(policy, "claim_gate", None)
        shed_fn = getattr(policy, "shed_batch", None)
        dead_queues = (
            [w for w in range(self.n_workers) if dead[w]]
            if self.stats.dead_workers
            else ()
        )
        for w in range(self.n_workers):
            if not free[w] or dead[w]:
                continue
            if t >= fault_t[w]:
                # crash-between-claims: due (or overdue) fault fires
                # before this worker can take another batch
                self._kill(w)
                continue
            if gate_fn is not None and not gate_fn(w, t):
                continue
            # Non-blocking helping first: a live worker that observes an
            # expired lease re-claims the stranded span.  This bypasses
            # claim_start — reclamation is a CAS, not a critical section
            # (and no leased policy has a lock horizon anyway).
            if self._stranded:
                ent = self._pop_expired(t)
                if ent is not None:
                    free[w] = False
                    stats.reclaims += 1
                    stats.reclaimed_items += len(ent.batch) - ent.delivered
                    self._run_batch(w, t, ent.batch, dup_prefix=ent.delivered)
                    continue
            # claim_start is the policy's serialization hook: identity
            # for lock-free policies, the lock-horizon wait for 'locked'.
            # A held lock means the batch cannot be formed yet (the real
            # driver claims *under* the mutex, so arrivals during the
            # wait join the batch): park the worker until the horizon
            # and pop the queue state as of lock-grant time instead.
            start = policy.claim_start(w, t)
            if math.isinf(start):
                # The lock died with its holder: this worker can never
                # claim again.  Skip (never park at +inf) — the run ends
                # with backlog and finalize() reports it wedged.
                continue
            if start > t:
                if not policy.backlog():
                    continue
                free[w] = False
                self.loop.schedule(start, self._RETRY, w)
                continue
            if shed_fn is not None:
                for item in shed_fn(w, start):
                    stats.rejected += 1
                    if self.on_reject is not None:
                        self.on_reject(start, item)
            batch = policy.next_batch(w)
            if not batch and dead_queues and self._leases_enabled():
                # Failover helping: adopt backlog stranded in a dead
                # peer's queue (RSS pinning has no live consumer for it).
                batch = policy.next_batch_dead(w, dead_queues)
            if not batch:
                continue
            free[w] = False
            self._run_batch(w, start, batch)
        if policy.backlog() and any(
            free[w]
            and not dead[w]
            and t < fault_t[w]
            and (gate_fn is None or gate_fn(w, t))
            for w in range(self.n_workers)
        ):
            stats.idle_with_backlog += 1

    # ------------------------------------------------------------------
    def finalize(self, strict: Optional[bool] = None) -> PlaneStats:
        """End-of-run audit: flag stranded claims instead of reporting a
        clean completion.

        ``stranded_items`` counts claimed-but-undelivered items,
        ``undrained`` the enqueued-but-unclaimed backlog; ``wedged`` is
        set when either is non-zero.  With ``strict`` (default: only
        when NO faults were injected) a wedged run raises
        :class:`~repro_torch.core.faults.StrandedRunError` — silent
        slot-stranding on a fault-free run is a protocol bug, while
        under injected faults it is the measured degraded mode.
        """
        stats = self.stats
        stats.stranded_items = sum(
            len(e.batch) - e.delivered for e in self._stranded
        )
        stats.undrained = int(self.policy.backlog())
        stats.wedged = bool(stats.stranded_items or stats.undrained)
        if strict is None:
            strict = not self._had_faults
        if strict and stats.wedged:
            raise StrandedRunError(
                f"run drained with {stats.stranded_items} stranded and "
                f"{stats.undrained} unclaimed items ({self.policy.name!r}, "
                "no faults injected)"
            )
        return stats
