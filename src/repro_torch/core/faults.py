"""Fault model shared by all three execution planes.

COREC's liveness argument (paper section 3.3) is only half-told by the
benign Bernoulli deschedule the planes already model: the worker always
comes back.  This module defines the *unrecoverable* half — workers that
crash, stall forever, or run slow — as one declarative spec consumed by

* the DES plane (:class:`repro_torch.core.des.WorkerPlane`): fault events on
  the event heap, a ``dead`` worker state, and lease-based claim
  reclamation in simulated time,
* the threaded plane (:class:`repro_torch.core.dispatch.WorkerPool`): a chaos
  harness that really kills / suspends worker threads at the injected
  points, with ring-level lease reclamation
  (:meth:`repro_torch.core.ring.CorecRing.reclaim_expired`) as recovery,
* the torch lane engines (:mod:`repro_torch.core.torchplane` /
  :mod:`repro_torch.core.tcptorch`): per-worker fault times as lane-axis
  tensors (``fault_params``), derived from the same fields.

Failure semantics under reclamation are *at-least-once* for the faulted
claim only: done bits publish at batch granularity, so a worker that
dies mid-claim loses the done-marks of its whole batch and the helper
that reclaims the expired lease re-serves every item in it — duplicates
are bounded by one batch per fault, and exactly-once continues to hold
everywhere else.  See README "Failure semantics".

The module also owns the *stochastic impairment* RNG shared by the
planes: :func:`hash_u01` is a counter-based uniform draw (two murmur3
finalizer rounds over ``(seed, a, b)``) whose tensor mirror
(``torchplane.hash_u01``) is bit-identical, so a
random-loss or retry-jitter schedule keyed on stable identifiers
(flow + sequence block, request + attempt) is the SAME schedule on the
DES and lane planes for the same seed — no RNG-stream bookkeeping, and
lanes stay vmappable because every draw is a pure function of its
counters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

__all__ = [
    "FaultSpec",
    "WorkerCrash",
    "StrandedRunError",
    "FAULT_KINDS",
    "FAULT_POINTS",
    "faults_by_worker",
    "mix32",
    "hash_u01",
]

#: ``crash``     — the worker dies at the injection point and never returns.
#: ``stall``     — the worker suspends forever (SIGSTOP-class): same
#:                 plane-level consequences as a crash (its claim never
#:                 completes), but the thread parks instead of exiting.
#: ``straggler`` — the worker survives but serves ``factor`` times slower.
FAULT_KINDS = ("crash", "stall", "straggler")

#: Threaded-plane injection sites (crash / stall only):
#: ``pre``       — between claims: the worker dies holding nothing.
#: ``hold``      — mid-claim: after ``claim()`` returns (or, for the
#:                 locked driver, *inside* the critical section), before
#:                 any item is processed — the claim strands unreleased.
#: ``post-work`` — after processing every item but before ``complete()``:
#:                 the done bits are lost, so a lease reclaim re-delivers
#:                 the whole batch (the duplicate-visible case).
FAULT_POINTS = ("pre", "hold", "post-work")


_M32 = 0xFFFFFFFF


def mix32(h: int) -> int:
    """murmur3 fmix32 finalizer over a uint32 (pure-Python mirror).

    Must stay in lockstep with the tensor mirror in ``torchplane``:
    same constants, same shift pattern, 32-bit wrapping.
    """
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def hash_u01(seed: int, a: int, b: int) -> float:
    """Counter-based uniform draw in [0, 1) keyed on (seed, a, b).

    The cross-plane impairment RNG: two fmix32 rounds, each counter
    pre-scaled by an odd constant so adjacent (a, b) pairs decorrelate.
    Impairment processes compare ``hash_u01(...) < rate`` with strict
    ``<`` so ``rate == 0.0`` is an *exact* identity (no draw ever
    fires), preserving the bit-identical knob-off convention.
    """
    h = mix32((seed & _M32) ^ ((a * 0x9E3779B1) & _M32))
    h = mix32(h ^ ((b * 0x85EBCA77) & _M32))
    return h * (1.0 / 4294967296.0)


class WorkerCrash(Exception):
    """Raised inside a worker thread to simulate its death.

    The chaos harness raises it at an injected point; the worker loop
    lets it unwind past claim bookkeeping (stranding any held claim,
    exactly like a SIGKILL between two instructions) and terminates the
    thread.
    """


class StrandedRunError(RuntimeError):
    """A run drained with claimed-but-undelivered items and NO faults
    configured — the silent slot-stranding latent bug, surfaced loudly
    instead of reported as a clean completion."""


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault on one worker.

    ``t`` is the injection time: simulated time on the DES plane and the
    lane engines, wall-clock seconds from pool start on the threaded plane.
    ``after_claims`` (threaded plane only) overrides ``t`` with a
    deterministic trigger — fire once the worker has completed that many
    claims — so tests can pin the exact kill site.  ``point`` picks the
    threaded injection site (see :data:`FAULT_POINTS`); the DES/lane
    planes derive mid-claim vs between-claims from ``t`` alone (a claim
    in flight at ``t`` is truncated at its last completion before ``t``).
    ``factor`` is the straggler service multiplier (also the per-item
    extra sleep scale on the threaded plane).
    """

    worker: int
    kind: str = "crash"
    t: float = 0.0
    factor: float = 4.0
    after_claims: Optional[int] = None
    point: str = "hold"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; one of {FAULT_POINTS}"
            )
        if self.worker < 0:
            raise ValueError("worker must be >= 0")
        if self.kind == "straggler" and self.factor < 1.0:
            raise ValueError("straggler factor must be >= 1.0")
        if not math.isfinite(self.t) or self.t < 0:
            raise ValueError("fault time must be finite and >= 0")


def faults_by_worker(faults: Optional[Sequence[FaultSpec]], n_workers: int):
    """Validate a schedule and index it by worker id.

    Returns ``{worker: [specs...]}``; raises when a spec names a worker
    the plane does not have (silent no-op faults hide test bugs).
    """
    out: dict = {}
    for spec in faults or ():
        if spec.worker >= n_workers:
            raise ValueError(
                f"fault targets worker {spec.worker} but the plane has "
                f"{n_workers} workers"
            )
        out.setdefault(spec.worker, []).append(spec)
    return out
