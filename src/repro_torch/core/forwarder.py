"""Open-loop L3-forwarder scenario layer: packets -> k workers -> order.

Shared by the UDP-reordering (Fig 7), real-trace (Table 4) and
policy-sweep benchmarks: models the COREC driver's batch-claim pipeline
on simulated time (the reordering mechanics — batch boundaries across
workers + service jitter + rare descheduling — are the same ones the
threaded ring exhibits, but the DES gives deterministic,
load-controllable measurements on a 1-core box).

This layer owns only the traffic/cost model; the event heap, worker
lifecycle, deschedule sampling and batch-claim accounting come from the
unified DES core (:mod:`repro_torch.core.des`), and ``cfg.policy`` may be any
name in the shared registry (:mod:`repro_torch.core.policy`): 'corec',
'scaleout', 'locked', 'hybrid', 'adaptive-batch', ...

Service time is a fixed per-packet CPU cost (+ a tiny per-byte cache
term); wire serialization is the *arrival* process (line-rate caps pps by
size).  High-rate 64B traffic is then the worst case for reordering —
batches accumulate during worker busy periods and split across workers —
while large packets arrive slower than one worker drains them, exactly
the paper's Fig 7 shape.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .des import DesItem, EventLoop, WorkerPlane
from .faults import FaultSpec
from .policy import make_policy
from .traffic import Packet

__all__ = ["ForwarderConfig", "simulate_forwarder"]


@dataclass
class ForwarderConfig:
    policy: str = "corec"  # any registered rx policy name
    n_workers: int = 4
    batch: int = 32
    base_service: float = 0.07  # us per packet (l3fwd lookup + desc swap)
    per_byte: float = 0.00001  # us per byte (cache-line touch only: DMA
    # and wire serialization belong to the LINK model, not the CPU)
    service_jitter: float = 0.25  # lognormal sigma
    claim_overhead: float = 0.05  # us per batch
    deschedule_prob: float = 5e-4
    deschedule_mean: float = 30.0  # us
    seed: int = 0
    policy_kwargs: dict = field(default_factory=dict)
    faults: Tuple[FaultSpec, ...] = ()  # chaos schedule (crash/stall/straggler)
    lease: Optional[float] = None  # claim-lease timeout enabling reclamation


def simulate_forwarder(
    packets: List[Packet], cfg: ForwarderConfig, stats_out: Optional[dict] = None
) -> List[Tuple[float, Packet]]:
    """Returns [(completion_time, packet)] in completion order.

    With ``cfg.faults`` armed, crashed workers strand their claims and
    (when ``cfg.lease`` is finite) peers reclaim them after the lease —
    re-served items count as duplicates, first delivery keeps the
    latency.  Pass ``stats_out={}`` to receive the plane's degraded-mode
    counters (dead_workers / reclaims / duplicates / wedged, ...).
    """
    rng = np.random.default_rng(cfg.seed)
    out: List[Tuple[float, Packet]] = []

    def svc(item: DesItem) -> float:
        mean = cfg.base_service + cfg.per_byte * item.payload.size
        mu = np.log(mean) - cfg.service_jitter**2 / 2
        return float(rng.lognormal(mu, cfg.service_jitter))

    loop = EventLoop()
    plane = WorkerPlane(
        loop,
        make_policy(cfg.policy, cfg.n_workers, cfg.batch, **cfg.policy_kwargs),
        cfg.n_workers,
        service_fn=svc,
        on_complete=lambda t, item: out.append((t, item.payload)),
        rng=rng,
        claim_overhead=cfg.claim_overhead,
        deschedule_prob=cfg.deschedule_prob,
        deschedule_mean=cfg.deschedule_mean,
        faults=cfg.faults,
        lease=cfg.lease,
    )
    loop.on("arrive", plane.enqueue)
    for p in packets:
        loop.schedule(p.t_arrival, "arrive", DesItem(flow=p.flow, payload=p))
    loop.run()
    stats = plane.finalize()  # stranded-claim audit (raises on fault-free runs)
    if stats_out is not None:
        stats_out.update(stats.snapshot())
    # Completions are appended in claim order; a stable sort by time
    # yields the same global completion order the seed's (t, tiebreak)
    # "done"-event heap produced.
    out.sort(key=lambda x: x[0])
    return out
