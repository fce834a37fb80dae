"""Request ingestion schedulers: COREC scale-up vs RSS scale-out.

This is the paper's receive-driver story transplanted to serving:

* ``CorecScheduler`` — ONE shared request ring; any idle worker claims the
  next batch with the non-blocking CAS protocol (work-conserving: a slow
  worker — long prefill, GC pause — never strands queued requests).
* ``RssScheduler`` — requests are hash-pinned to a worker by session id
  (per-worker rings, the scale-out state of the art).  Per-session order
  is perfectly preserved, but a busy worker's queue cannot be drained by
  idle peers — head-of-line blocking, the M/G/1 tail.

Both speak claim/complete/release so the engine treats them uniformly.
"""

from __future__ import annotations

from typing import List, Optional

from ..core.baseline import CorecSharedQueue, ScaleOutDriver
from ..core.ring import Claim
from .request import Request

__all__ = ["CorecScheduler", "RssScheduler", "make_scheduler"]


class CorecScheduler:
    policy = "corec"

    def __init__(self, n_workers: int, ring_size: int = 1024):
        self.n_workers = n_workers
        self.q = CorecSharedQueue(ring_size)

    def submit(self, req: Request) -> bool:
        return self.q.produce(req, req.session)

    def submit_batch(self, reqs: List[Request]) -> int:
        """Burst submission through the ring's batch surface (one DD-word
        publish + one doorbell); returns the accepted prefix length."""
        return self.q.produce_batch(reqs, [r.session for r in reqs])

    def claim(self, worker: int, max_batch: int = 8) -> Optional[Claim]:
        return self.q.claim(worker, max_batch)

    def complete(self, worker: int, claim: Claim) -> None:
        self.q.complete(worker, claim)
        self.q.try_release(worker)

    def backlog(self) -> int:
        return self.q.backlog()

    def stats(self):
        return self.q.ring.stats.snapshot()


class RssScheduler:
    policy = "rss"

    def __init__(self, n_workers: int, ring_size: int = 1024):
        self.n_workers = n_workers
        self.q = ScaleOutDriver(n_workers, ring_size)

    def submit(self, req: Request) -> bool:
        return self.q.produce(req, req.session)

    def submit_batch(self, reqs: List[Request]) -> int:
        """Prefix-semantics burst across the per-worker rings (RSS runs
        are bursted per ring; stops at the first full ring)."""
        return self.q.produce_batch(reqs, [r.session for r in reqs])

    def claim(self, worker: int, max_batch: int = 8) -> Optional[Claim]:
        return self.q.claim(worker, max_batch)

    def complete(self, worker: int, claim: Claim) -> None:
        self.q.complete(worker, claim)
        self.q.try_release(worker)

    def backlog(self) -> int:
        return self.q.backlog()

    def stats(self):
        return [r.stats.snapshot() for r in self.q.rings]


def make_scheduler(policy: str, n_workers: int, ring_size: int = 1024):
    if policy == "corec":
        return CorecScheduler(n_workers, ring_size)
    if policy in ("rss", "scaleout"):
        return RssScheduler(n_workers, ring_size)
    raise ValueError(policy)
