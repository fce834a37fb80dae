"""COREC: the concurrent non-blocking single-queue receive ring.

Paper mapping (Listing 2 + sections 3.4.1-3.4.4):

=====================================  =========================================
paper                                  here
=====================================  =========================================
NIC filling Rx descriptors             ``produce()`` / ``produce_batch()``
                                       (single producer; the producer is
                                       *unmodifiable*: it only sees head/tail
                                       credit, like a DMA engine — a batch is
                                       one burst of descriptor writes followed
                                       by one HEAD doorbell)
DD bit scan (lines 12-19)              DD *bitmap*: one bit per slot packed in
                                       AtomicU64 words; ``claim()`` finds the
                                       ready-run length with O(size/64) word
                                       loads + trailing-ones bit tricks — the
                                       descriptor-cacheline scan a real driver
                                       does, not one load per descriptor
CAS on queue->rx_index (line 21)       CAS on ``claim_head`` 64-bit ticket
descriptor copy + mempool swap         payload move-out in ``claim()``
write_batch_is_done (line 33)          ``complete()`` -> READ_DONE bitmask,
                                       one ``fetch_or`` per word span
trylock + TAIL write (35-42)           ``try_release()``: done-prefix counted
                                       word-at-a-time (trailing-ones
                                       popcount), whole word spans cleared
                                       and recycled with one RMW per word
epoch = id // RING_SIZE (Table 1)      same; 64-bit ticket kills ABA
=====================================  =========================================

Two data planes coexist so the cost model can be compared honestly:

* ``packed=True`` (default): the word-packed fast path above.  Per-item
  atomic cost is O(1/64) word ops amortised — the paper's "handful of RMW
  instructions" budget.
* ``packed=False``: the per-item reference path (one atomic load per DD
  scan step, one ``fetch_and`` per released bit), kept for the
  old-vs-new benchmark (benchmarks/ring_ops_bench.py) and the
  observational-equivalence property tests
  (tests/test_ring_properties.py).

``RingStats.atomic_ops`` counts every shared-memory atomic operation the
hot paths issue (loads, stores, RMWs; a fenced ``store_many`` batch counts
as one), so benchmarks can report atomic-ops-per-item for either plane.

The claim path is lock-free: a consumer that loses the CAS retries against
fresh state; a consumer that wins owns a disjoint ticket interval and never
interacts with its peers again until the O(1) bitmask write.  A stalled
consumer delays only the *reuse* of its own slots once the ring wraps
(section 3.4.4 corner case) — peers keep claiming and processing.

Epoch safety of the packed claim: the DD bit of slot ``t & mask`` is set
when ticket ``t`` is published and cleared when it is released, so a set
bit alone cannot distinguish ticket ``t`` from ``t - size``.  ``claim()``
therefore clamps the scan at ``head`` (loaded *after* ``claim_head``): a
ticket below head was necessarily published after its slot was recycled,
so within ``[claim_head, head)`` a set bit always means "this epoch".
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

from .atomics import AtomicBitmap, AtomicLease, AtomicU64, AtomicU64Array, TryLock

__all__ = ["Claim", "CorecRing", "RingStats"]


@dataclass
class Claim:
    """An exclusively-owned batch of ring tickets ``[start, end)``.

    ``payloads`` have already been moved out of the ring (the paper's
    descriptor copy + mempool replacement), so the application may process
    them at leisure — the slots become NIC-reusable as soon as
    ``complete()`` + a successful release run.
    """

    start: int
    end: int
    payloads: List[Any]

    def __len__(self) -> int:
        return self.end - self.start


#: RingStats' counters, in the order :meth:`RingStats.snapshot` lists them
_COUNTERS = (
    "claims",
    "claimed_items",
    "cas_failures",
    "empty_polls",
    "releases",
    "released_items",
    "trylock_failures",
    "produced",
    "full_producer_polls",
    "batch_publishes",
    "atomic_ops",  # every atomic load/store/RMW on the hot paths
    "reclaims",  # expired-lease claims re-issued by a helper
    "reclaimed_items",  # slots covered by those reclaims
)


class _Counts:
    """One thread's shard of a :class:`RingStats`."""

    __slots__ = _COUNTERS

    def __init__(self):
        for name in _COUNTERS:
            setattr(self, name, 0)


class RingStats:
    """Race/occupancy counters, exact under threads: each thread adds
    to a shard of its own (:meth:`shard`), and a read
    (``stats.claims``, :meth:`snapshot`) sums the shards."""

    __slots__ = ("_local", "_shards", "_lock")

    def __init__(self):
        self._local = threading.local()
        self._shards: List[_Counts] = []
        self._lock = threading.Lock()

    def shard(self) -> _Counts:
        """The calling thread's counters, made at its first count."""
        try:
            return self._local.counts
        except AttributeError:
            counts = self._local.counts = _Counts()
            with self._lock:
                self._shards.append(counts)
            return counts

    def __getattr__(self, name: str) -> int:
        if name not in _COUNTERS:
            raise AttributeError(name)
        return sum(getattr(c, name) for c in tuple(self._shards))

    def snapshot(self) -> dict:
        shards = tuple(self._shards)
        return {name: sum(getattr(c, name) for c in shards) for name in _COUNTERS}

    def __repr__(self) -> str:
        return f"RingStats({self.snapshot()})"


@dataclass
class _LeaseEntry:
    """One in-flight claim's reclamation record (lease table row).

    The ``word`` is the single CAS arbiter between the owner's
    ``complete()`` and a helper's ``reclaim_expired()``; ``payloads`` is
    the snapshot a helper re-serves, since the owner moved the originals
    out of the ring cells at claim time.
    """

    word: AtomicLease
    start: int
    n: int
    deadline: float
    payloads: List[Any]


class CorecRing:
    """Bounded MPMC ring with single producer and COREC consumer protocol.

    ``size`` must be a power of two (paper section 3.4.3: "the queue size is
    always a power of 2 ... this already happens in network drivers").

    ``packed`` selects the word-packed fast path (default) or the per-item
    reference path (see module docstring).

    ``lease_timeout`` (seconds on ``clock``, default ``time.monotonic``)
    arms lease-based claim reclamation: every claim registers a
    :class:`_LeaseEntry`, ``complete()`` retires it with a CAS, and
    :meth:`reclaim_expired` lets any live worker CAS-reclaim a claim
    whose owner died or stalled past the deadline — publishing the whole
    span as done (done-marks are lost at batch granularity) and handing
    the payload snapshot back for re-service.  Exactly-once degrades to
    at-least-once for reclaimed spans only; with ``lease_timeout=None``
    (default) behaviour is byte-identical to the lease-free ring.
    """

    def __init__(
        self,
        size: int,
        packed: bool = True,
        lease_timeout: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if size <= 0 or size & (size - 1):
            raise ValueError("ring size must be a power of two")
        self.size = size
        self.mask = size - 1
        self.packed = packed
        self.lease_timeout = lease_timeout
        self._clock = clock
        # Lease table: claim-start ticket -> _LeaseEntry.  The dict itself
        # is bookkeeping (guarded by a mutex never held across work); the
        # owner/helper race is decided by each entry's AtomicLease CAS.
        self._leases: dict = {}
        self._lease_mtx = threading.Lock()
        # Payload cells. Only the exclusive owner of a ticket touches cell
        # ticket & mask, so plain list slots are safe.
        self._cells: List[Any] = [None] * size
        # Slot sequence words (Vyukov-style epoch stamps standing in for the
        # DD bit):  seq == t      -> empty, awaiting producer ticket t
        #           seq == t + 1  -> filled for consumer ticket t (DD set)
        #           seq == t+size -> empty, awaiting next-epoch producer.
        self._seq = AtomicU64Array(range(size))
        # DD bitmap: consumer-facing "descriptor done" bits, one per slot,
        # packed in words so claim() scans a cacheline at a time.  Only
        # maintained on the packed plane (the per-item plane scans _seq).
        self._dd = AtomicBitmap(size)
        # Producer cursor (the NIC's HEAD). Single producer -> plain int
        # guarded by producer discipline, but atomic for observers.
        self._head = AtomicU64(0)
        # The global transaction ID consumers CAS on (paper's rx_index,
        # promoted to a monotonic 64-bit ticket -> epoch = id // size).
        self._claim_head = AtomicU64(0)
        # READ_DONE bitmask: one bit per slot, packed in atomic words.
        self._done = AtomicBitmap(size)
        # TAIL: last ticket (exclusive) returned to the producer as credit.
        self._tail = AtomicU64(0)
        self._tail_lock = TryLock()
        self.stats = RingStats()

    # ------------------------------------------------------------------
    # producer side (the "NIC")
    # ------------------------------------------------------------------
    def produce(self, payload: Any) -> bool:
        """Fill one slot. Returns False when out of credit (ring full).

        The producer role is intentionally minimal: check credit
        (head - tail < size), write the payload, then publish the DD stamp.
        A real DMA engine does exactly this, which is what keeps COREC
        *transparent* to an unmodifiable producer (section 3.4.2).
        """
        head = self._head.load()
        if head - self._tail.load() >= self.size:
            counts = self.stats.shard()
            counts.atomic_ops += 2
            counts.full_producer_polls += 1
            return False
        idx = head & self.mask
        # Slot must have been recycled for this epoch by the releaser.
        if self._seq.load(idx) != head:
            counts = self.stats.shard()
            counts.atomic_ops += 3
            counts.full_producer_polls += 1
            return False
        self._cells[idx] = payload
        self._seq.store(idx, head + 1)  # DD stamp: visible to consumers
        ops = 4
        if self.packed:
            ops += self._dd.set_range(idx, 1)  # DD bit for word-scan claims
        self._head.store(head + 1)
        counts = self.stats.shard()
        counts.atomic_ops += ops + 1
        counts.produced += 1
        return True

    def produce_batch(self, payloads: Sequence[Any]) -> int:
        """Fill up to ``len(payloads)`` slots; returns the accepted prefix.

        On the packed plane this is one burst: all cells written, the
        epoch stamps published under one fence, the DD word(s) OR'd in,
        then a single HEAD store — the descriptor-burst + doorbell of a
        real NIC, O(n/64) RMWs instead of O(n).
        """
        if not self.packed:
            n = 0
            for p in payloads:
                if not self.produce(p):
                    break
                n += 1
            return n
        head = self._head.load()
        tail = self._tail.load()
        n = min(len(payloads), self.size - (head - tail))
        if n <= 0:
            counts = self.stats.shard()
            counts.atomic_ops += 2
            counts.full_producer_polls += 1
            return 0
        # Credit implies recycled: try_release() restamps _seq and clears
        # the bitmaps *before* publishing the new TAIL, so any ticket
        # below tail + size has a clean, restamped slot.
        for k in range(n):
            self._cells[(head + k) & self.mask] = payloads[k]
        self._seq.store_many(
            ((head + k) & self.mask, head + k + 1) for k in range(n)
        )
        ops = 3 + self._dd.set_range(head & self.mask, n)
        self._head.store(head + n)  # the one doorbell write
        counts = self.stats.shard()
        counts.atomic_ops += ops + 1
        counts.produced += n
        counts.batch_publishes += 1
        return n

    # ------------------------------------------------------------------
    # consumer side (COREC workers)
    # ------------------------------------------------------------------
    def _ready(self, ticket: int) -> bool:
        """DD-stamp check, epoch-safe: slot is filled *for this ticket*."""
        return self._seq.load(ticket & self.mask) == ticket + 1

    def claim(self, max_batch: int = 32) -> Optional[Claim]:
        """Listing 2 lines 8-31: scan DD bits, CAS the ticket, copy out.

        Lock-free: on CAS failure we re-read fresh state and retry; each
        retry means another consumer made progress (lock-freedom), and the
        loop exits as soon as the queue looks empty.
        """
        if self.packed:
            return self._claim_packed(max_batch)
        return self._claim_peritem(max_batch)

    def _claim_peritem(self, max_batch: int) -> Optional[Claim]:
        """Reference path: one atomic _seq load per DD scan step."""
        while True:
            start = self._claim_head.load()
            ops = 1
            n = 0
            while n < max_batch and self._ready(start + n):
                n += 1
                ops += 1
            ops += 1  # the failing (or max_batch-bounded) scan load
            if n == 0:
                counts = self.stats.shard()
                counts.atomic_ops += ops
                counts.empty_polls += 1
                return None
            won = self._claim_head.compare_and_swap(start, start + n)
            self.stats.shard().atomic_ops += ops + 1
            if won:
                break
            self.stats.shard().cas_failures += 1
        return self._copy_out(start, n)

    def _claim_packed(self, max_batch: int) -> Optional[Claim]:
        """Fast path: ready-run length from DD words, O(size/64) loads.

        ``head`` is loaded after ``claim_head`` and clamps the scan so a
        stale DD bit from an unreleased previous-epoch ticket can never be
        claimed (see module docstring).
        """
        while True:
            start = self._claim_head.load()
            head = self._head.load()
            ops = 2
            want = min(max_batch, head - start)
            if want <= 0:
                counts = self.stats.shard()
                counts.atomic_ops += ops
                counts.empty_polls += 1
                return None
            n, w = self._dd.run_of_ones(start & self.mask, want)
            ops += w
            if n == 0:
                # Stale view: a peer claimed and released [start, ...) between
                # our claim_head load and the word scan.  Retry with fresh
                # cursors — the peer's progress is what failed us.
                counts = self.stats.shard()
                counts.atomic_ops += ops
                counts.cas_failures += 1
                continue
            won = self._claim_head.compare_and_swap(start, start + n)
            self.stats.shard().atomic_ops += ops + 1
            if won:
                break
            self.stats.shard().cas_failures += 1
        return self._copy_out(start, n)

    def _copy_out(self, start: int, n: int) -> Claim:
        # Race won: [start, start+n) is exclusively ours. Move payloads out
        # (descriptor copy + replacement with an empty buffer).
        payloads = []
        for t in range(start, start + n):
            idx = t & self.mask
            payloads.append(self._cells[idx])
            self._cells[idx] = None
        counts = self.stats.shard()
        counts.claims += 1
        counts.claimed_items += n
        if self.lease_timeout is not None:
            # Stamp the deadline BEFORE taking the lease mutex: the clock
            # is injectable (tests use fake clocks that may inspect lease
            # state) and must never run under an internal lock.
            deadline = self._clock() + self.lease_timeout
            with self._lease_mtx:
                self._leases[start] = _LeaseEntry(
                    AtomicLease(),
                    start,
                    n,
                    deadline,
                    list(payloads),
                )
        return Claim(start, start + n, payloads)

    def complete(self, claim: Claim) -> None:
        """Listing 2 line 33: publish [start, end) into READ_DONE.

        Slot->bit mapping is unambiguous without epoch tags because a slot
        cannot be re-claimed before its bit is cleared by a release (the
        producer has no credit for it until TAIL moves past it).

        Under a lease, completion must first win the entry's CAS: a
        slow-but-alive owner racing a helper that already reclaimed its
        claim loses here and backs off — the helper owns the span's done
        bits and its deliveries stand (the owner's copies surface as
        duplicates in the pool's seqno dedup, never as ring corruption).
        """
        if self.lease_timeout is not None:
            with self._lease_mtx:
                ent = self._leases.pop(claim.start, None)
            # a missing entry means a helper reclaimed AND retired the
            # span already — publishing again could stamp done bits onto
            # slots the producer has since refilled
            if ent is None or not ent.word.try_complete():
                return
        self.stats.shard().atomic_ops += self._done.set_range(
            claim.start & self.mask, claim.end - claim.start
        )

    def reclaim_expired(self, now: Optional[float] = None) -> List[Claim]:
        """Non-blocking helping: re-issue claims whose lease expired.

        Any live worker may call this.  For each expired entry the helper
        CASes HELD -> RECLAIMED (losing the race to a late ``complete()``
        is a free non-event), publishes the whole span into READ_DONE so
        the TAIL release can progress past the dead owner's hole, and
        returns the payload snapshot as a fresh :class:`Claim` for
        re-service.  Callers process the returned payloads but must NOT
        ``complete()`` them again — the span is already marked.
        """
        if self.lease_timeout is None:
            return []
        t = self._clock() if now is None else now
        with self._lease_mtx:
            expired = [e for e in self._leases.values() if e.deadline <= t]
        out: List[Claim] = []
        for ent in expired:
            if not ent.word.try_reclaim():
                continue
            counts = self.stats.shard()
            counts.atomic_ops += 1  # the winning reclamation CAS
            counts.atomic_ops += self._done.set_range(
                ent.start & self.mask, ent.n
            )
            with self._lease_mtx:
                self._leases.pop(ent.start, None)
            counts.reclaims += 1
            counts.reclaimed_items += ent.n
            out.append(Claim(ent.start, ent.start + ent.n, list(ent.payloads)))
        return out

    def leases_outstanding(self) -> int:
        """In-flight lease entries (diagnostic; 0 when leases disabled)."""
        with self._lease_mtx:
            return len(self._leases)

    def try_release(self) -> int:
        """Listing 2 lines 35-42: trylock, free the contiguous done-prefix.

        Returns the number of slots handed back to the producer (0 on
        trylock failure or no contiguous prefix — both are free non-events).
        """
        if not self._tail_lock.try_acquire():
            self.stats.shard().trylock_failures += 1
            return 0
        try:
            if self.packed:
                return self._release_packed()
            return self._release_peritem()
        finally:
            self._tail_lock.release()

    def _release_peritem(self) -> int:
        """Reference path: one load per scanned bit, one RMW per freed bit."""
        tail = self._tail.load()
        limit = self._claim_head.load()  # nothing beyond has a bit set
        ops = 3  # + the trylock
        freed = 0
        t = tail
        while t < limit:
            if not self._done.test(t & self.mask):
                ops += 1
                break
            ops += 1
            t += 1
            freed += 1
        if freed:
            # Clear bits and recycle slot seq for the next epoch before
            # publishing the new TAIL (paper line 39 before line 41;
            # order matters: once TAIL moves the producer may refill).
            for u in range(tail, t):
                idx = u & self.mask
                self._done.clear_bit(idx)
                self._seq.store(idx, u + self.size)
                ops += 2
            self._tail.store(t)
            ops += 1
            counts = self.stats.shard()
            counts.releases += 1
            counts.released_items += freed
        self.stats.shard().atomic_ops += ops
        return freed

    def _release_packed(self) -> int:
        """Fast path: trailing-ones popcount on READ_DONE words, then one
        RMW per word span to clear/recycle and a single TAIL store."""
        tail = self._tail.load()
        limit = self._claim_head.load()  # nothing beyond has a bit set
        ops = 3  # + the trylock
        freed, w = self._done.run_of_ones(tail & self.mask, limit - tail)
        ops += w
        if freed:
            # Word-span clear of READ_DONE and DD, vectorized _seq restamp
            # (one fenced batch), all before the TAIL publish.
            ops += self._done.clear_range(tail & self.mask, freed)
            ops += self._dd.clear_range(tail & self.mask, freed)
            self._seq.store_many(
                (u & self.mask, u + self.size) for u in range(tail, tail + freed)
            )
            self._tail.store(tail + freed)
            ops += 2
            counts = self.stats.shard()
            counts.releases += 1
            counts.released_items += freed
        self.stats.shard().atomic_ops += ops
        return freed

    # ------------------------------------------------------------------
    # observers
    # ------------------------------------------------------------------
    @property
    def head(self) -> int:
        return self._head.load()

    @property
    def tail(self) -> int:
        return self._tail.load()

    @property
    def claim_head(self) -> int:
        return self._claim_head.load()

    def epoch(self) -> int:
        """How many full rounds the queue has completed (Table 1)."""
        return self._tail.load() // self.size

    def backlog(self) -> int:
        """Filled-but-unclaimed items (global workload visibility)."""
        return self._head.load() - self._claim_head.load()

    def in_flight(self) -> int:
        """Claimed-but-unreleased slots (bounded by size)."""
        return self._claim_head.load() - self._tail.load()

    def credit(self) -> int:
        """Free slots from the producer's point of view."""
        return self.size - (self._head.load() - self._tail.load())
