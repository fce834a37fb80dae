"""Queueing-theory scenario layer — reproduces paper section 3.2.

Compares the disciplines of Figure 2 on the unified DES core
(:mod:`repro_torch.core.des`) with policies resolved from the shared registry
(:mod:`repro_torch.core.policy`):

* scale-up  (COREC):  one shared queue, N servers        ->  M/G/N
* scale-out (RSS):    N queues, one server each          ->  N x M/G/1

with Markovian arrivals and either Markovian ('M'), Deterministic ('D')
or lognormal ('LN') service times, for 4 and 8 servers (Figures 3-4).
This layer owns nothing but the arrival/service sampling and the result
statistics; the event heap, worker lifecycle and batch-claim accounting
live in the core, and the *policy* (who may serve which job) is an
``RxPolicy`` plugin — exactly the paper's claim that work conservation,
not raw speed, is the source of the win.  Any registered policy name
('corec', 'scaleout', 'locked', 'hybrid', 'adaptive-batch', ...) can be
simulated via :func:`simulate_policy`.

Also provides ``simulate_protocol`` — the COREC claim/release protocol
with explicit per-batch overheads, used by the scalability benchmark to
extrapolate thread-scaling beyond what a 1-core CPython host can
physically exhibit (calibrated against measured costs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .des import DesItem, EventLoop, WorkerPlane
from .policy import make_policy

__all__ = [
    "QueueSimResult",
    "simulate_policy",
    "simulate_scale_up",
    "simulate_scale_out",
    "sweep_load",
    "simulate_protocol",
]


@dataclass
class QueueSimResult:
    sojourn: np.ndarray  # per-job latency (wait + service)
    util: float

    @property
    def mean(self) -> float:
        return float(np.mean(self.sojourn))

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.sojourn, p))


def _service_samples(
    rng: np.random.Generator, n: int, mean_service: float, kind: str
) -> np.ndarray:
    if kind == "M":
        return rng.exponential(mean_service, size=n)
    if kind == "D":
        return np.full(n, mean_service)
    if kind == "LN":  # heavy-ish tail, for the realistic-NF scenario
        sigma = 0.8
        mu = math.log(mean_service) - sigma**2 / 2
        return rng.lognormal(mu, sigma, size=n)
    raise ValueError(f"unknown service kind {kind!r}")


def _arrivals(rng: np.random.Generator, n: int, rate: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def _run_jobs(
    arr: np.ndarray,
    svc: np.ndarray,
    n_workers: int,
    policy: str,
    batch: int,
    rng: np.random.Generator,
    claim_overhead: float = 0.0,
    hints: Optional[np.ndarray] = None,
    policy_kwargs: Optional[dict] = None,
) -> np.ndarray:
    """Drive pre-drawn (arrival, service) jobs through the DES plane.

    Returns per-job completion times indexed like ``arr``.  Service
    samples are pre-drawn (indexed by job id) so results are invariant
    to which worker serves which job.
    """
    n_jobs = len(arr)
    done = np.empty(n_jobs)
    loop = EventLoop()
    pol = make_policy(policy, n_workers, batch, **(policy_kwargs or {}))

    def on_complete(t: float, item: DesItem) -> None:
        done[item.payload] = t

    plane = WorkerPlane(
        loop,
        pol,
        n_workers,
        service_fn=lambda item: svc[item.payload],
        on_complete=on_complete,
        rng=rng,
        claim_overhead=claim_overhead,
    )
    loop.on("arrive", plane.enqueue)
    if hints is None:
        for i in range(n_jobs):
            loop.schedule(arr[i], "arrive", DesItem(flow=i, payload=i))
    else:
        for i in range(n_jobs):
            loop.schedule(
                arr[i], "arrive", DesItem(flow=i, payload=i, queue_hint=int(hints[i]))
            )
    loop.run()
    plane.finalize()  # raises StrandedRunError on silent slot-stranding
    return done


def simulate_policy(
    policy: str,
    rate: float,
    mean_service: float,
    n_workers: int,
    n_jobs: int = 200_000,
    service: str = "M",
    seed: int = 0,
    batch: int = 1,
    claim_overhead: float = 0.0,
    policy_kwargs: Optional[dict] = None,
) -> QueueSimResult:
    """M/G/system under any registered RxPolicy (batch=1, zero overhead
    by default — the pure queueing-theory view of the discipline)."""
    rng = np.random.default_rng(seed)
    arr = _arrivals(rng, n_jobs, rate)
    svc = _service_samples(rng, n_jobs, mean_service, service)
    done = _run_jobs(
        arr, svc, n_workers, policy, batch, rng,
        claim_overhead=claim_overhead, policy_kwargs=policy_kwargs,
    )
    return QueueSimResult(
        sojourn=done - arr, util=float(np.sum(svc) / (n_workers * done.max()))
    )


def simulate_scale_up(
    rate: float,
    mean_service: float,
    n_servers: int,
    n_jobs: int = 200_000,
    service: str = "M",
    seed: int = 0,
) -> QueueSimResult:
    """M/G/N: one FCFS queue, any idle server takes the next job."""
    return simulate_policy(
        "corec", rate, mean_service, n_servers, n_jobs, service, seed
    )


def simulate_scale_out(
    rate: float,
    mean_service: float,
    n_servers: int,
    n_jobs: int = 200_000,
    service: str = "M",
    seed: int = 0,
    assign: str = "hash",
) -> QueueSimResult:
    """N x M/G/1: jobs are pinned to a queue on arrival (RSS).

    ``assign='hash'`` models RSS on uniformly random flow keys (uniform
    random queue per job — the paper's 'traffic flow distribution is equal
    among cores' case); 'rr' is deterministic round-robin (best case for
    scale-out, zero skew).  The assignment is passed to the 'scaleout'
    policy as a per-job ``queue_hint`` (an indirection-table override).
    """
    rng = np.random.default_rng(seed)
    arr = _arrivals(rng, n_jobs, rate)
    svc = _service_samples(rng, n_jobs, mean_service, service)
    if assign == "hash":
        q = rng.integers(0, n_servers, size=n_jobs)
    elif assign == "rr":
        q = np.arange(n_jobs) % n_servers
    else:
        raise ValueError(assign)
    done = _run_jobs(arr, svc, n_servers, "scaleout", 1, rng, hints=q)
    return QueueSimResult(
        sojourn=done - arr, util=float(np.sum(svc) / (n_servers * done.max()))
    )


def sweep_load(
    n_servers: int,
    loads: Sequence[float],
    service: str = "M",
    mean_service: float = 1.0,
    n_jobs: int = 200_000,
    seed: int = 0,
) -> dict:
    """Figures 3-4: mean and p99 sojourn vs offered load, both policies.

    ``loads`` are utilisation fractions rho in (0,1); the arrival rate is
    rho * n_servers / mean_service.
    """
    out = {"load": list(loads), "scale_up": [], "scale_out": []}
    for j, rho in enumerate(loads):
        rate = rho * n_servers / mean_service
        up = simulate_scale_up(rate, mean_service, n_servers, n_jobs, service, seed + j)
        down = simulate_scale_out(
            rate, mean_service, n_servers, n_jobs, service, seed + j
        )
        out["scale_up"].append({"mean": up.mean, "p99": up.percentile(99)})
        out["scale_out"].append({"mean": down.mean, "p99": down.percentile(99)})
    return out


# ----------------------------------------------------------------------
# Protocol-cost model (simulated time) for thread-scaling extrapolation
# ----------------------------------------------------------------------
def simulate_protocol(
    n_workers: int,
    policy: str,
    rate: float,
    mean_service: float,
    claim_overhead: float,
    cas_retry_cost: float = 0.0,
    batch: int = 32,
    n_jobs: int = 100_000,
    service: str = "M",
    seed: int = 0,
    policy_kwargs: Optional[dict] = None,
) -> QueueSimResult:
    """COREC protocol on simulated time.

    Like ``simulate_scale_up`` but jobs are taken in *batches* (up to
    ``batch`` of whatever is queued — the DD-bit scan) and each batch
    costs ``claim_overhead`` plus an expected CAS-retry penalty that
    grows with contention (p_fail ~ (k-1)/k per concurrent claimant,
    geometric retries) for the contended shared-queue policies.  For
    'scaleout' there is never CAS contention, so each batch pays the
    plain overhead (scan + tail write) on its own hash-pinned queue;
    batches form from whatever has queued by claim time, same as every
    other policy (the seed implementation amortized scale-out overhead
    by job *count* instead — the unified model charges both disciplines
    identically, which is slightly more faithful and marginally kinder
    to scale-out at low load).

    Any registered policy name is accepted; CAS contention is charged to
    every shared-queue policy (all but 'scaleout' / 'hybrid').
    """
    rng = np.random.default_rng(seed)
    arr = _arrivals(rng, n_jobs, rate)
    svc = _service_samples(rng, n_jobs, mean_service, service)
    hints = None
    if policy in ("scaleout", "hybrid"):
        overhead = claim_overhead
        if policy == "scaleout":
            hints = rng.integers(0, n_workers, size=n_jobs)
    else:
        p_fail = (n_workers - 1) / max(n_workers, 1) * 0.5  # calibrated upper bound
        expected_retries = p_fail / (1 - p_fail) if p_fail < 1 else 0.0
        overhead = claim_overhead + cas_retry_cost * expected_retries
    done = _run_jobs(
        arr, svc, n_workers, policy, batch, rng,
        claim_overhead=overhead, hints=hints, policy_kwargs=policy_kwargs,
    )
    return QueueSimResult(
        sojourn=done - arr, util=float(np.sum(svc) / (n_workers * done.max()))
    )
