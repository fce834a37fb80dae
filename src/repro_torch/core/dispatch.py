"""Work-conserving dispatcher: worker threads around a claim/release queue.

This is the paper's "driver threads" layer: each worker loops
``claim -> process -> complete -> try_release`` (Listing 2), against any
queue policy resolved from the shared registry in
``repro_torch/core/policy.py`` (corec / scaleout / locked / hybrid /
adaptive-batch / ...).  Used by the protocol tests and the threaded
benchmarks; the serving engine has its own specialised copy of this loop
(repro_torch/serving/scheduler.py).

Timing: items carry their enqueue timestamp; the dispatcher records
per-item sojourn latency (enqueue -> processing complete) so mean/p99 can
be compared across policies, plus per-worker processed counts to measure
work conservation (idle-ness skew).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

from .faults import FaultSpec, WorkerCrash, faults_by_worker
from .policy import make_thread_queue

__all__ = ["Item", "DispatchResult", "WorkerPool", "make_queue"]


@dataclass
class Item:
    """A unit of work (the 'packet'): payload + flow identity + timestamps."""

    seqno: int
    flow: int = 0
    payload: Any = None
    t_enqueue: float = 0.0
    t_done: float = 0.0
    worker: int = -1


@dataclass
class DispatchResult:
    items: List[Item]
    per_worker: List[int]
    wall_time: float
    stats: Any = None
    # -- degraded-mode accounting (all zero on fault-free runs) --------
    duplicates: int = 0  # re-deliveries of an already-seen seqno
    reclaims: int = 0  # expired-lease claims re-served by a helper
    dead_workers: int = 0  # threads killed/stalled by the chaos harness
    stranded: int = 0  # lease entries still outstanding at shutdown
    wedged: bool = False  # run ended without delivering every item

    def latencies(self) -> List[float]:
        return [it.t_done - it.t_enqueue for it in self.items]

    def completion_order(self) -> List[int]:
        """Sequence numbers in the order processing *finished* (global)."""
        return [it.seqno for it in sorted(self.items, key=lambda i: i.t_done)]


def make_queue(policy: str, n_workers: int, size: int, **kwargs):
    """Build the threaded queue for any registered rx policy name.

    Resolves through the shared registry (:mod:`repro_torch.core.policy`), so
    the same names the DES simulators accept — 'corec', 'scaleout',
    'locked', 'hybrid', 'adaptive-batch', ... (see
    ``available_policies()``) — work on real threads too.
    """
    return make_thread_queue(policy, n_workers, size, **kwargs)


class WorkerPool:
    """N consumer threads draining one queue object.

    ``work_fn(item) -> None`` is the per-item service (the NF: l3fwd-class
    cheap lookup or ipsec-class heavy transform).  The pool is policy
    agnostic: for 'scaleout' each worker only sees its own ring (by
    construction of ScaleOutDriver.claim).

    ``faults`` arms the chaos harness: each
    :class:`~repro_torch.core.faults.FaultSpec` really kills (WorkerCrash
    unwind), suspends (park on the stop event), or slows (per-item
    sleep) its worker thread at the injected point — ``pre`` between
    claims, ``hold`` mid-claim (inside the locked queue's critical
    section via its ``fault_hook``), ``post-work`` after processing but
    before ``complete()``.  Recovery is ring-level lease reclamation
    (build the queue with ``lease_timeout=...``): idle workers poll
    ``reclaim_expired`` and re-serve stranded spans, with delivered
    seqnos deduplicated so re-deliveries surface as ``duplicates``
    counts instead of double results.
    """

    def __init__(
        self,
        queue,
        n_workers: int,
        work_fn: Callable[[Item], None],
        max_batch: int = 32,
        poll_sleep: float = 0.0,
        faults: Sequence[FaultSpec] = (),
    ):
        self.queue = queue
        self.n_workers = n_workers
        self.work_fn = work_fn
        self.max_batch = max_batch
        self.poll_sleep = poll_sleep
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._done_lock = threading.Lock()
        self.done_items: List[Item] = []
        self.per_worker = [0] * n_workers
        # -- chaos harness state -------------------------------------
        self._fault_specs = faults_by_worker(faults, n_workers)
        self._fired: set = set()  # spec ids already injected
        self._claims_done = [0] * n_workers
        self._t0 = 0.0
        self.dead = [False] * n_workers
        self._dead_list: List[int] = []  # shared with driver adoption
        self._seen: set = set()  # delivered seqnos (dedup under _done_lock)
        self.duplicates = 0
        self.reclaims = 0

    # ------------------------------------------------------------------
    # chaos harness
    # ------------------------------------------------------------------
    def _fault_point(self, wid: int, point: str) -> None:
        """Fire any due crash/stall spec for ``wid`` at this site."""
        specs = self._fault_specs.get(wid)
        if not specs:
            return
        for spec in specs:
            if (
                spec.kind == "straggler"
                or spec.point != point
                or id(spec) in self._fired
            ):
                continue
            if spec.after_claims is not None:
                due = self._claims_done[wid] >= spec.after_claims
            else:
                due = time.perf_counter() - self._t0 >= spec.t
            if not due:
                continue
            self._fired.add(id(spec))
            if spec.kind == "stall":
                # SIGSTOP-class suspension: the thread parks holding
                # whatever it holds (a claim, the locked queue's mutex)
                # until pool shutdown, then unwinds like a crash.
                self._stop.wait()
            raise WorkerCrash(f"worker {wid} {spec.kind} at {point!r}")

    def _straggler_sleep(self, wid: int) -> float:
        specs = self._fault_specs.get(wid)
        if not specs:
            return 0.0
        for spec in specs:
            if spec.kind != "straggler":
                continue
            if spec.after_claims is not None:
                if self._claims_done[wid] < spec.after_claims:
                    continue
            elif time.perf_counter() - self._t0 < spec.t:
                continue
            return spec.factor * 1e-4  # per-item extra service time
        return 0.0

    # ------------------------------------------------------------------
    def _record(self, wid: int, batch: List[Item]) -> None:
        """Dedup-record delivered items: at-least-once under reclamation
        means a seqno can arrive twice (owner's prefix + helper's
        re-serve); the second copy is counted, not double-reported."""
        with self._done_lock:
            for it in batch:
                if it.seqno in self._seen:
                    self.duplicates += 1
                else:
                    self._seen.add(it.seqno)
                    self.done_items.append(it)
                    self.per_worker[wid] += 1

    def _process(self, wid: int, payloads) -> List[Item]:
        slow = self._straggler_sleep(wid)
        batch = []
        for it in payloads:
            if it is None:
                continue
            self.work_fn(it)
            if slow:
                time.sleep(slow)
            it.t_done = time.perf_counter()
            it.worker = wid
            batch.append(it)
        return batch

    def _worker_loop(self, wid: int) -> None:
        try:
            self._worker_body(wid)
        except WorkerCrash:
            self.dead[wid] = True
            self._dead_list.append(wid)

    def _worker_body(self, wid: int) -> None:
        q = self.queue
        reclaim = getattr(q, "reclaim_expired", None)
        # The locked queue injects 'hold' inside its critical section via
        # fault_hook; everywhere else the pool fires it inline post-claim.
        inline_hold = not hasattr(q, "fault_hook")
        while not self._stop.is_set():
            self._fault_point(wid, "pre")
            claim = q.claim(wid, self.max_batch)
            if claim is None:
                if reclaim is not None:
                    for rc in reclaim(wid):
                        # Lease helping: the span's done bits are already
                        # published by reclaim_expired — re-serve the
                        # payload snapshot, no second complete().
                        self._record(wid, self._process(wid, rc.payloads))
                        with self._done_lock:
                            self.reclaims += 1
                q.try_release(wid)
                if self.poll_sleep:
                    time.sleep(self.poll_sleep)
                continue
            if inline_hold:
                self._fault_point(wid, "hold")
            batch = self._process(wid, claim.payloads)
            self._fault_point(wid, "post-work")
            q.complete(wid, claim)
            q.try_release(wid)
            self._record(wid, batch)
            self._claims_done[wid] += 1

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._t0 = time.perf_counter()
        q = self.queue
        # Wire the harness onto queues that expose fault surfaces (only
        # when faults are armed: fault-free runs keep the plain blocking
        # acquire and the exact seed-era hot path).
        if self._fault_specs:
            if hasattr(q, "fault_hook"):
                q.fault_hook = lambda wid: self._fault_point(wid, "hold")
            if hasattr(q, "abort_wait"):
                q.abort_wait = self._stop.is_set
            if hasattr(q, "dead_workers"):
                q.dead_workers = self._dead_list
        for w in range(self.n_workers):
            t = threading.Thread(target=self._worker_loop, args=(w,), daemon=True)
            self._threads.append(t)
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)

    # ------------------------------------------------------------------
    def run_open_loop(
        self,
        items: List[Item],
        rate: Optional[float] = None,
        drain_timeout: float = 30.0,
    ) -> DispatchResult:
        """Producer-side open loop: offer items (optionally rate-paced),
        wait for full drain, return per-item results.

        A wedged consumer side (dead lock holder, all workers crashed)
        eventually exhausts ring credit; the producer loops then bail at
        ``drain_timeout`` instead of spinning forever, and the result is
        flagged ``wedged`` with the degraded-mode counters filled in.
        """
        t0 = time.perf_counter()
        self.start()
        offer_deadline = t0 + drain_timeout
        interval = (1.0 / rate) if rate else 0.0
        if interval:
            next_t = time.perf_counter()
            for it in items:
                while time.perf_counter() < next_t:
                    pass
                next_t += interval
                it.t_enqueue = time.perf_counter()
                while not self.queue.produce(it, it.flow):
                    # Ring full: producer backpressure (the NIC would drop;
                    # we spin so every item is accounted for in latency
                    # tests).
                    if time.perf_counter() > offer_deadline:
                        break
                    time.sleep(0)
                if time.perf_counter() > offer_deadline:
                    break
        else:
            # Burst mode: offer descriptor bursts through the batch surface
            # (one DD-word publish + one doorbell per burst).  Prefix
            # semantics let us retry the remainder on backpressure without
            # reordering any flow.
            i = 0
            stamped = 0  # items get t_enqueue once, at their FIRST offer —
            # a retry after backpressure must keep the wait in the latency
            while i < len(items):
                chunk = items[i : i + 256]
                if i + len(chunk) > stamped:
                    now = time.perf_counter()
                    for it in items[stamped : i + len(chunk)]:
                        it.t_enqueue = now
                    stamped = i + len(chunk)
                took = self.queue.produce_batch(chunk, [it.flow for it in chunk])
                i += took
                if took == 0:
                    if time.perf_counter() > offer_deadline:
                        break
                    time.sleep(0)
        deadline = time.perf_counter() + drain_timeout
        while time.perf_counter() < deadline:
            with self._done_lock:
                if len(self.done_items) >= len(items):
                    break
            if all(self.dead):
                break  # nobody left to make progress
            time.sleep(0.0005)
        self.stop()
        wall = time.perf_counter() - t0
        stranded = 0
        if hasattr(self.queue, "leases_outstanding"):
            stranded = self.queue.leases_outstanding()
        return DispatchResult(
            items=list(self.done_items),
            per_worker=list(self.per_worker),
            wall_time=wall,
            stats=getattr(self.queue, "ring", None)
            and self.queue.ring.stats.snapshot(),
            duplicates=self.duplicates,
            reclaims=self.reclaims,
            dead_workers=sum(self.dead),
            stranded=stranded,
            wedged=len(self.done_items) < len(items),
        )
