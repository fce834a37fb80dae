"""Straggler mitigation (the port's own copy of ``repro.runtime.straggler``).

Two mechanisms, matching DESIGN.md section 7:

* ``StragglerDetector`` — step-time EWMA + MAD outlier flagging for
  device-step stragglers (drives re-mesh / hot-spare decisions upstream).
* ``ClaimExpiryReissuer`` — for host-side COREC queues: the paper's
  non-blocking property guarantees a stalled claimant never blocks peers'
  *processing*, but its unreleased claim eventually stalls slot *reuse*
  (section 3.4.4).  At fleet scale we bound that: claims carry deadlines;
  expired claims' items are re-produced (at-least-once) and consumers
  dedup by seqno.  This converts the unavoidable corner case into bounded
  staleness without giving up the non-blocking fast path.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

__all__ = ["StragglerDetector", "ClaimExpiryReissuer"]


class StragglerDetector:
    """EWMA + median-absolute-deviation outlier detection on step times."""

    def __init__(self, alpha: float = 0.1, mad_k: float = 5.0, window: int = 64):
        self.alpha = alpha
        self.mad_k = mad_k
        self.window = window
        self.ewma: Dict[int, float] = {}
        self.history: List[float] = []

    def observe(self, host: int, step_time: float) -> bool:
        """Returns True when this host's step is a straggler outlier."""
        prev = self.ewma.get(host, step_time)
        cur = (1 - self.alpha) * prev + self.alpha * step_time
        self.ewma[host] = cur
        self.history.append(step_time)
        if len(self.history) > self.window:
            self.history.pop(0)
        med = sorted(self.history)[len(self.history) // 2]
        mad = sorted(abs(x - med) for x in self.history)[len(self.history) // 2]
        return step_time > med + self.mad_k * max(mad, 1e-9)

    def slowest(self) -> Optional[int]:
        if not self.ewma:
            return None
        return max(self.ewma, key=self.ewma.get)


@dataclass
class _Outstanding:
    deadline: float
    items: List[Any]


class ClaimExpiryReissuer:
    """Track claims; re-produce items whose claim expired (at-least-once).

    Usage: wrap a CorecRing-compatible queue.  ``track(claim, items)``
    after claim; ``done(claim)`` after complete.  ``sweep()`` re-enqueues
    expired claims' items; consumers drop duplicates via ``seen``.
    """

    def __init__(self, produce_fn: Callable[[Any], bool], timeout: float = 0.5):
        self.produce_fn = produce_fn
        self.timeout = timeout
        self._outstanding: Dict[Tuple[int, int], _Outstanding] = {}
        self._lock = threading.Lock()
        self.seen: Set[int] = set()
        self.reissued = 0

    def track(self, claim, items: List[Any]):
        with self._lock:
            self._outstanding[(claim.start, claim.end)] = _Outstanding(
                deadline=time.monotonic() + self.timeout, items=list(items)
            )

    def done(self, claim):
        with self._lock:
            self._outstanding.pop((claim.start, claim.end), None)

    def first_time(self, seqno: int) -> bool:
        """Consumer-side dedup for at-least-once delivery."""
        with self._lock:
            if seqno in self.seen:
                return False
            self.seen.add(seqno)
            return True

    def sweep(self) -> int:
        now = time.monotonic()
        expired = []
        with self._lock:
            for key, rec in list(self._outstanding.items()):
                if rec.deadline < now:
                    expired.append(rec)
                    del self._outstanding[key]
        n = 0
        for rec in expired:
            for item in rec.items:
                if self.produce_fn(item):
                    n += 1
        self.reissued += n
        return n
