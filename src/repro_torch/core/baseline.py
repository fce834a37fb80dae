"""Threaded-plane queue drivers: COREC's baselines + registry extras.

* ``ScaleOutDriver`` — the state of the art (DPDK default): N independent
  rings, each owned by exactly one consumer thread; incoming items are
  hash-partitioned (RSS) across rings.  This is the ``N x M/G/1`` system.
* ``LockedSharedQueue`` — the Metronome-class alternative [12]: one ring
  shared by N threads, but the whole receive function is a critical
  section guarded by a mutex, so only one thread makes progress at a time.
* ``HybridStealDriver`` — RSS rings plus work stealing: a consumer whose
  own ring is empty claims from the longest peer ring.  Safe because
  every ring is a full MPMC ``CorecRing`` (the claim CAS is exactly the
  COREC protocol), so "foreign" consumers need no extra coordination.
* ``AdaptiveBatchSharedQueue`` — the COREC shared ring with a
  backlog-scaled claim size in ``[min_batch, max_batch]``.

All expose the same claim/complete/release surface as ``CorecRing`` so
the dispatcher and the benchmarks can swap policies freely; the string
registry in :mod:`repro.core.policy` maps policy names to these classes
(threaded plane) and to their DES twins (simulated plane).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence

from .ring import Claim, CorecRing, RingStats

__all__ = [
    "ScaleOutDriver",
    "LockedSharedQueue",
    "CorecSharedQueue",
    "HybridStealDriver",
    "AdaptiveBatchSharedQueue",
    "rss_hash",
]


def rss_hash(key: int, n_queues: int) -> int:
    """Toeplitz-flavoured integer hash -> queue id (deterministic RSS).

    The real RSS Toeplitz hash is keyed over the 5-tuple; for our purposes a
    well-mixed integer hash of the flow key gives the same *policy*:
    a flow always lands on the same queue.
    """
    h = key & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 33
    return h % n_queues


class ScaleOutDriver:
    """N per-thread rings with RSS partitioning (the paper's baseline).

    Each ring is still a ``CorecRing`` (so slot mechanics are identical) but
    the contract is that consumer ``i`` only ever touches ring ``i`` — the
    single-consumer special case, in which every CAS trivially succeeds.
    """

    def __init__(
        self,
        n_queues: int,
        size: int,
        lease_timeout: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.n_queues = n_queues
        self.lease_timeout = lease_timeout
        ck = {} if clock is None else {"clock": clock}
        self.rings = [
            CorecRing(size, lease_timeout=lease_timeout, **ck)
            for _ in range(n_queues)
        ]
        # Worker ids the chaos harness declared dead.  The WorkerPool
        # shares its own list object here so crash notifications are
        # visible without coupling the driver to the pool.
        self.dead_workers: List[int] = []
        self.adoptions = 0  # dead-ring claims by live workers (diagnostic)

    # -- producer side -------------------------------------------------
    def produce(self, payload: Any, flow_key: int) -> bool:
        """RSS: the flow key pins the item to one queue, full or not."""
        return self.rings[rss_hash(flow_key, self.n_queues)].produce(payload)

    def produce_batch(self, payloads: Sequence[Any], flow_keys: Sequence[int]) -> int:
        """Batch offer with *prefix* semantics: returns how many leading
        items were accepted, stopping at the first full queue so a caller
        can retry ``payloads[n:]`` without reordering any flow.  Runs of
        consecutive same-queue items are published as one descriptor burst
        (same surface as ``CorecRing.produce_batch``)."""
        n = 0
        total = len(payloads)
        while n < total:
            q = rss_hash(flow_keys[n], self.n_queues)
            run_end = n + 1
            while run_end < total and rss_hash(flow_keys[run_end], self.n_queues) == q:
                run_end += 1
            n += self.rings[q].produce_batch(payloads[n:run_end])
            if n < run_end:  # queue full mid-run: stop at the prefix
                break
        return n

    # -- consumer side ---------------------------------------------------
    def claim(self, worker: int, max_batch: int = 32) -> Optional[Claim]:
        c = self.rings[worker].claim(max_batch)
        if c is not None:
            c._ring_idx = worker
            return c
        # Failover adoption: RSS pins flows to one consumer, so a dead
        # worker's ring has backlog and no drainer.  Because every ring
        # is a full MPMC CorecRing, a live worker can claim from it with
        # no extra coordination — the claim CAS *is* the safety argument.
        for d in self.dead_workers:
            if d == worker:
                continue
            c = self.rings[d].claim(max_batch)
            if c is not None:
                c._ring_idx = d
                self.adoptions += 1
                return c
        return None

    def complete(self, worker: int, claim: Claim) -> None:
        self.rings[getattr(claim, "_ring_idx", worker)].complete(claim)

    def try_release(self, worker: int) -> int:
        n = self.rings[worker].try_release()
        for d in self.dead_workers:
            if d != worker:
                n += self.rings[d].try_release()
        return n

    def reclaim_expired(self, worker: int = 0) -> List[Claim]:
        """Lease helping across ALL rings: a live worker reclaims expired
        claims wherever they strand (its own ring or a dead peer's)."""
        out: List[Claim] = []
        for r in self.rings:
            out.extend(r.reclaim_expired())
        return out

    def leases_outstanding(self) -> int:
        return sum(r.leases_outstanding() for r in self.rings)

    def backlog(self) -> int:
        return sum(r.backlog() for r in self.rings)

    def stats(self) -> List[RingStats]:
        return [r.stats for r in self.rings]


class LockedSharedQueue:
    """One shared ring, one big lock around the whole Rx function.

    This is the 'obvious' shared-queue design the paper argues against:
    work-conserving (single queue) but *blocking* — a descheduled lock
    holder stalls every peer.  Claim+copy runs under the mutex, exactly as
    a critical-section driver would.

    Fault surface: ``fault_hook(worker)`` (set by the chaos harness) is
    called *inside* the critical section, after acquire and before any
    ring op.  A hook that raises ``WorkerCrash`` models the holder dying
    mid-claim — deliberately no try/finally, so the mutex stays locked
    forever and every peer wedges: a lease cannot help a design whose
    claim is a critical section (``lease_timeout`` / ``clock`` are
    accepted and ignored for interface parity).  ``abort_wait()`` (also harness-set)
    lets blocked waiters poll for shutdown instead of hanging the host
    process on a dead mutex.
    """

    def __init__(
        self,
        size: int,
        lease_timeout: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.ring = CorecRing(size)
        self._mutex = threading.Lock()
        self.fault_hook: Optional[Callable[[int], None]] = None
        self.abort_wait: Optional[Callable[[], bool]] = None

    def produce(self, payload: Any, flow_key: int = 0) -> bool:
        return self.ring.produce(payload)

    def produce_batch(
        self, payloads: Sequence[Any], flow_keys: Optional[Sequence[int]] = None
    ) -> int:
        return self.ring.produce_batch(payloads)

    def _acquire(self) -> bool:
        """Blocking acquire, abortable when the harness wired abort_wait."""
        if self.abort_wait is None:
            self._mutex.acquire()
            return True
        while not self._mutex.acquire(timeout=0.05):
            if self.abort_wait():
                return False
        return True

    def claim(self, worker: int, max_batch: int = 32) -> Optional[Claim]:
        if not self._acquire():
            return None  # shutdown observed while the mutex is wedged
        if self.fault_hook is not None:
            self.fault_hook(worker)  # may raise WorkerCrash: mutex stays held
        c = self.ring.claim(max_batch)
        if c is not None:
            # Under the big lock the whole claim..release is one
            # critical section: complete+release immediately.
            self.ring.complete(c)
            self.ring.try_release()
        self._mutex.release()
        return c

    def complete(self, worker: int, claim: Claim) -> None:
        # Already done under the mutex in claim().
        return None

    def try_release(self, worker: int = 0) -> int:
        return 0

    def backlog(self) -> int:
        return self.ring.backlog()


class CorecSharedQueue:
    """Adapter giving ``CorecRing`` the same (worker-indexed) surface."""

    def __init__(
        self,
        size: int,
        lease_timeout: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        ck = {} if clock is None else {"clock": clock}
        self.ring = CorecRing(size, lease_timeout=lease_timeout, **ck)

    def produce(self, payload: Any, flow_key: int = 0) -> bool:
        return self.ring.produce(payload)

    def produce_batch(
        self, payloads: Sequence[Any], flow_keys: Optional[Sequence[int]] = None
    ) -> int:
        return self.ring.produce_batch(payloads)

    def claim(self, worker: int, max_batch: int = 32) -> Optional[Claim]:
        return self.ring.claim(max_batch)

    def complete(self, worker: int, claim: Claim) -> None:
        self.ring.complete(claim)

    def try_release(self, worker: int = 0) -> int:
        return self.ring.try_release()

    def reclaim_expired(self, worker: int = 0) -> List[Claim]:
        return self.ring.reclaim_expired()

    def leases_outstanding(self) -> int:
        return self.ring.leases_outstanding()

    def backlog(self) -> int:
        return self.ring.backlog()


class HybridStealDriver(ScaleOutDriver):
    """RSS rings + work stealing from the longest backlog.

    Consumer ``w`` claims from ring ``w`` first; if that comes back
    empty it claims from the ring with the largest backlog.  Because
    every ring is an MPMC ``CorecRing``, a foreign claim is just another
    COREC consumer on that ring — the CAS ticket protocol already makes
    it safe, and the victim's owner keeps claiming concurrently.  The
    stolen ring is remembered per worker so ``complete``/``try_release``
    reach the right ring (releases are trylock-protected, so the thief
    and the owner can both attempt them).
    """

    def __init__(
        self,
        n_queues: int,
        size: int,
        lease_timeout: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        super().__init__(n_queues, size, lease_timeout=lease_timeout, clock=clock)
        self._steal_src = [-1] * n_queues  # last foreign ring per worker
        self.steals = 0  # diagnostic only (benign count race)

    def claim(self, worker: int, max_batch: int = 32) -> Optional[Claim]:
        c = self.rings[worker].claim(max_batch)
        if c is not None:
            c._ring_idx = worker
            return c
        victim = max(range(self.n_queues), key=lambda i: self.rings[i].backlog())
        if victim == worker or self.rings[victim].backlog() == 0:
            return None
        c = self.rings[victim].claim(max_batch)
        if c is not None:
            c._ring_idx = victim
            self._steal_src[worker] = victim
            self.steals += 1
        return c

    def complete(self, worker: int, claim: Claim) -> None:
        self.rings[getattr(claim, "_ring_idx", worker)].complete(claim)

    def try_release(self, worker: int) -> int:
        n = self.rings[worker].try_release()
        src = self._steal_src[worker]
        if src >= 0:
            # One release attempt per steal, then forget the victim:
            # anything not yet releasable (older claim still in flight)
            # is picked up by the victim owner's own polling.
            self._steal_src[worker] = -1
            n += self.rings[src].try_release()
        return n


class AdaptiveBatchSharedQueue(CorecSharedQueue):
    """COREC shared ring whose claim size scales with the backlog.

    Effective claim size is ``clip(ceil(backlog / n_workers), min_batch,
    min(max_batch, caller's max_batch))`` — per-packet claims when the
    ring is nearly empty (lowest added latency), fair-shared amortizing
    batches under bursts.  The DES twin is
    :class:`repro.core.policy.AdaptiveBatchPolicy`.
    """

    def __init__(
        self,
        size: int,
        n_workers: int,
        min_batch: int = 1,
        max_batch: Optional[int] = None,
        lease_timeout: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        super().__init__(size, lease_timeout=lease_timeout, clock=clock)
        self.n_workers = max(1, n_workers)
        self.min_batch = max(1, min_batch)
        self.max_batch = max_batch

    def claim(self, worker: int, max_batch: int = 32) -> Optional[Claim]:
        backlog = self.ring.backlog()
        if backlog == 0:
            return None
        cap = max_batch if self.max_batch is None else min(max_batch, self.max_batch)
        share = -(-backlog // self.n_workers)  # ceil
        eff = min(cap, max(self.min_batch, share))
        return self.ring.claim(eff)
