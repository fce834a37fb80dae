"""The open-loop serving scenario, on both planes.

Open-loop arrivals (Poisson, bursty MAWI-style, or diurnal
nonhomogeneous-Poisson), heavy-tailed per-user session sizes, admission
control and an autoscaled worker pool, with SLO attainment (the share
of offered users whose sojourn meets a latency target) as the headline
metric.  Two implementations share one model:

* :func:`simulate_serving_des` -- the DES plane.  A
  :class:`ServingPolicy` wrapper adds the two serving decisions to any
  registered :class:`~repro_torch.core.policy.RxPolicy` through the
  worker plane's optional hooks: ``claim_gate`` (autoscale -- worker
  ``w >= base_workers`` may claim only once its wake queue's backlog
  reaches ``(w - base_workers + 1) * scale_backlog``) and ``shed_batch``
  (admission -- the claiming worker first drops the over-``admit_limit``
  tail of its queue head, up to one batch per claim).
* :func:`sweep_serving_torch` -- the lane engine (the counterpart of
  ``repro.core.servingjax.sweep_serving_jax``): one serving
  configuration per (knob, seed) lane, every lane advanced by the
  claim-compacted engine in one call, with SLO attainment, offered,
  shed and the overload plane's accounting computed on the device --
  see :class:`~repro_torch.core.torchplane.ServingParams` and
  :class:`~repro_torch.core.torchplane.OverloadConfig` for the knobs.
  Multi-policy serving sweeps go through
  :func:`repro_torch.core.run_sweep` (``scenario="serving"``).

Parity between the two is distributional: medians over seeds within
15% at p50 and 35% at p99, and SLO attainment within 15%
(``tests/test_torch_cross_plane.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .des import DesItem, EventLoop, PlaneStats, WorkerPlane
from .faults import hash_u01
from .policy import make_policy
from .sweep import ARRIVAL_WORKLOADS
from .torchplane import _fused_lanes
from .traffic import diurnal_times, heavy_tail_service

__all__ = [
    "ServingSimConfig",
    "ServingPolicy",
    "ServingResult",
    "simulate_serving_des",
    "sweep_serving_torch",
]


@dataclass
class ServingSimConfig:
    """One DES serving run (the per-lane config of the lane sweep)."""

    policy: str = "corec"
    n_workers: int = 4
    batch: int = 32
    arrival: str = "poisson"  # poisson | bursty | diurnal
    rate: float = 4.0  # mean arrivals per unit time
    burstiness: float = 0.9  # lognormal sigma (bursty arrivals)
    diurnal_amp: float = 0.6
    diurnal_period: float = 50.0
    mean_service: float = 1.0  # mean session size (service time)
    session_alpha: float = 1.8  # Pareto tail index of session sizes
    capacity: int = 2000  # arrivals drawn (lane engine's n_packets)
    horizon: float = math.inf  # generation cutoff (offered = arrivals <= it)
    admit_limit: float = math.inf  # backlog cap per drained queue
    base_workers: float = math.inf  # always-on worker count
    scale_backlog: float = math.inf  # backlog per extra autoscaled worker
    slo_target: float = math.inf  # sojourn target for SLO attainment
    # -- overload-control knobs (identity defaults; the DES mirror of
    # torchplane.OverloadConfig — same attempt formulas, same hash keys) --
    timeout: float = math.inf  # client deadline per attempt
    retries: int = 0  # bounded retry budget per request
    backoff: float = 0.0  # base backoff added to each retry delay
    jitter: float = 0.0  # uniform jitter scale on the backoff
    hedge: float = 0.0  # 0 = off; else one hedged copy at arrival+hedge
    breaker_age: float = math.inf  # circuit-breaker head-age trip point
    scale_latency: float = math.inf  # latency-reactive autoscale target
    drop_rate: float = 0.0  # Bernoulli response-loss probability
    claim_overhead: float = 0.05
    deschedule_prob: float = 0.0
    deschedule_mean: float = 30.0
    n_flows: int = 256
    seed: int = 0
    policy_kwargs: dict = field(default_factory=dict)
    #: per-flow steering override (flow id -> queue): parity tests feed
    #: the lane engine's 32-bit hash so both planes steer identically.
    queue_hints: Optional[Dict[int, int]] = None


class ServingPolicy:
    """Admission + autoscale decorator over any registered RxPolicy.

    Delegates every queue operation to the wrapped policy and adds the
    two optional hooks the DES worker plane probes for — so any
    discipline in the registry serves open-loop traffic without
    modification, exactly as the lane engine arms
    :class:`~repro_torch.core.torchplane.ServingParams` on any
    :class:`~repro_torch.core.torchplane.TorchPolicy`.  Both knobs are inert at
    their ``+inf`` defaults (the gate admits every worker, the shed
    drops nothing), mirroring the lane engine's exact-identity convention.
    """

    def __init__(
        self,
        inner,
        admit_limit: float = math.inf,
        base_workers: float = math.inf,
        scale_backlog: float = math.inf,
        breaker_age: float = math.inf,
        scale_latency: float = math.inf,
        arrival_of=None,
    ):
        self._inner = inner
        self.admit_limit = admit_limit
        self.base_workers = base_workers
        self.scale_backlog = scale_backlog
        self.breaker_age = breaker_age
        self.scale_latency = scale_latency
        #: item -> arrival time, needed by the breaker's head-age check
        self.arrival_of = arrival_of
        self._lat_est = 0.0
        self._breaker_skip: set = set()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- the two serving decisions -------------------------------------
    def _wake_queue(self, worker: int):
        """The queue whose backlog wakes/feeds this worker."""
        queues = self._inner.queues
        return queues[0] if len(queues) == 1 else queues[worker]

    def claim_gate(self, worker: int, t: float) -> bool:
        """Autoscale: may this worker claim at all yet?

        Worker ``w >= base_workers`` joins the pool only once its wake
        queue's unclaimed backlog reaches ``(w - base_workers + 1) *
        scale_backlog`` — the DES statement of the lane engine's wake-time
        gate (the threshold-th unclaimed arrival must exist).  With a
        finite ``scale_latency`` the backlog threshold is replaced by
        the latency-reactive gate: scaled workers join while the
        measured p99 estimate exceeds the target (the lane engine's
        ``lat_est`` carry), and park again once it recovers.
        """
        if worker < self.base_workers:
            return True
        if math.isfinite(self.scale_latency):
            return self._lat_est > self.scale_latency
        thr = (worker - self.base_workers + 1.0) * max(self.scale_backlog, 1.0)
        if math.isinf(thr):
            return False
        return len(self._wake_queue(worker)) >= thr

    def note_done(self, sojourn: float) -> None:
        """Robbins-Monro p99 tracker feeding the latency gate.

        Same update rule as the lane engine's ``lat_est``: asymmetric
        steps of size ``0.25 * scale_latency`` move the estimate toward
        the 99th percentile of observed sojourns (up fast on a sample
        above the estimate, down slowly otherwise — the asymmetry is
        the hysteresis that keeps the gate from flapping).
        """
        if not math.isfinite(self.scale_latency):
            return
        lr = 0.25 * self.scale_latency
        step = lr * (0.99 - (1.0 if sojourn <= self._lat_est else 0.0))
        self._lat_est = max(self._lat_est + step, 0.0)

    def _drain_queue(self, worker: int):
        """The queue ``next_batch(worker)`` would pop — mirrored here so
        admission sheds from the same head the claim serves."""
        inner = self._inner
        queues = inner.queues
        if len(queues) == 1:
            return queues[0]
        own = queues[worker]
        if own or not hasattr(inner, "steals"):  # scaleout: always own
            return own
        victim = max(range(inner.n_workers), key=lambda i: len(queues[i]))
        return queues[victim]

    def shed_batch(self, worker: int, t: float) -> List[DesItem]:
        """Admission: drop the over-limit tail before forming the batch.

        The claiming worker pops up to one batch of requests beyond
        ``admit_limit`` from its drain queue's head (dequeue-side drop —
        a real driver still writes the descriptor-done bit for dropped
        frames).  Returns the dropped items for accounting.

        A tripped circuit breaker (queue-head age beyond
        ``breaker_age``) takes precedence: the whole would-be claim is
        shed instead of served and the worker takes no batch this round
        — the lane engine's brownout branch (``shed = min(backlog, mb),
        k = 0``), event for event.
        """
        q = self._drain_queue(worker)
        cap = getattr(self._inner, "max_batch", None) or self._inner.batch
        if (
            q
            and self.arrival_of is not None
            and t - self.arrival_of(q[0]) > self.breaker_age
        ):
            self._breaker_skip.add(worker)
            drop = int(min(len(q), cap))
            return [q.popleft() for _ in range(drop)]
        excess = len(q) - self.admit_limit
        if excess <= 0:
            return []
        drop = int(min(excess, cap))
        return [q.popleft() for _ in range(drop)]

    def next_batch(self, worker: int):
        """Breaker-aware claim: a worker whose claim was just shed by a
        tripped breaker forms no batch this round."""
        if worker in self._breaker_skip:
            self._breaker_skip.discard(worker)
            return []
        return self._inner.next_batch(worker)


@dataclass
class ServingResult:
    """One DES serving run's outputs (the lane engine's LaneResult counterpart)."""

    policy: str
    offered: int  # requests inside the generation horizon
    delivered: int  # attempt copies delivered (timely, not lost)
    shed: int  # attempt copies dropped by admission/breaker
    undelivered: int  # attempts - served - shed (stranded/gated)
    slo_attained: float  # requests delivered within target / offered
    p50: float  # delivered-only request sojourn percentiles
    p99: float
    mean_sojourn: float
    sojourns: np.ndarray  # delivered request sojourns, arrival order
    stats: PlaneStats
    # -- overload-extended accounting (classic identities when off) --
    attempts: int = 0  # attempt copies offered (== offered when off)
    expired: int = 0  # served copies that were late or lost in reply
    goodput: int = 0  # unique requests with >=1 timely response
    dup_served: int = 0  # delivered copies beyond the first per request


def _gen_arrivals(cfg: ServingSimConfig, rng) -> tuple:
    """Draw ``capacity`` open-loop arrivals + flows (pre-horizon-mask)."""
    n = cfg.capacity
    if cfg.arrival == "poisson":
        t = np.cumsum(rng.exponential(1.0 / cfg.rate, size=n))
        flows = rng.integers(0, cfg.n_flows, size=n)
    elif cfg.arrival == "bursty":
        sigma = cfg.burstiness
        mu = np.log(1.0 / cfg.rate) - sigma**2 / 2
        t = np.cumsum(rng.lognormal(mu, sigma, size=n))
        zipf = 1.0 / np.arange(1, cfg.n_flows + 1) ** 1.1
        flows = rng.choice(cfg.n_flows, size=n, p=zipf / zipf.sum())
    elif cfg.arrival == "diurnal":
        t = diurnal_times(
            n, cfg.rate, cfg.diurnal_amp, cfg.diurnal_period, rng=rng
        )
        flows = rng.integers(0, cfg.n_flows, size=n)
    else:
        raise ValueError(f"unknown arrival process {cfg.arrival!r}")
    return t, flows


def simulate_serving_des(cfg: ServingSimConfig) -> ServingResult:
    """One open-loop serving run on the unified DES worker plane.

    Matches the lane engine's model point for point: ``capacity`` arrivals
    are drawn, the generation ``horizon`` masks the suffix, heavy-tailed
    session sizes are pre-drawn per request, and the wrapped policy
    sheds/gates at claim time.  An autoscale-gated tail that never wakes
    (static steering under a fading diurnal load) strands as
    ``undelivered`` — reported, not raised.

    Overload control mirrors the lane engine's no-cancellation client
    model: each offered request expands into attempt copies (retry ``j``
    fires a further ``timeout + (backoff + jitter * u_j) * 2**(j-1)``
    after attempt ``j-1``, one optional hedge at ``arrival + hedge``)
    with the SAME counter-based jitter draws (``hash_u01(seed, request,
    attempt)``), copies inherit the parent's service time and flow, and
    accounting is post hoc: a served copy counts as delivered only if it
    beat the client deadline and survived the Bernoulli response-loss
    draw; ``goodput`` is unique requests with at least one timely
    response.  All knobs are identity at their defaults — the classic
    run is reproduced arrival for arrival.
    """
    rng = np.random.default_rng(cfg.seed)
    t_all, flows_all = _gen_arrivals(cfg, rng)
    svc_all = heavy_tail_service(
        cfg.capacity, cfg.mean_service, cfg.session_alpha, rng=rng
    )
    keep = t_all <= cfg.horizon
    arr = t_all[keep]
    flows = flows_all[keep]
    svc = svc_all[keep]
    offered = int(arr.shape[0])

    retries = int(cfg.retries)
    if retries < 0:
        raise ValueError("retries must be >= 0")
    hedged = cfg.hedge > 0.0
    extended = retries > 0 or hedged or math.isfinite(cfg.timeout)

    # Attempt expansion (mirrors torchplane._lane_setup): attempt 0 is the
    # original; retries are 1..R, the hedge is R+1.  Copies whose fire
    # time lands past the horizon "never happen".
    parents = np.arange(offered, dtype=np.int64)
    c_arr = [arr]
    c_par = [parents]
    c_att = [np.zeros(offered, dtype=np.int64)]
    if extended:
        acc = np.zeros(offered)
        for j in range(1, retries + 1):
            u_j = np.array([hash_u01(cfg.seed, int(p), j) for p in parents])
            acc = acc + cfg.timeout + (cfg.backoff + cfg.jitter * u_j) * (
                2.0 ** (j - 1)
            )
            c_arr.append(arr + acc)
            c_par.append(parents)
            c_att.append(np.full(offered, j, dtype=np.int64))
        if hedged:
            c_arr.append(arr + cfg.hedge)
            c_par.append(parents)
            c_att.append(np.full(offered, retries + 1, dtype=np.int64))
    arr_c = np.concatenate(c_arr)
    par_c = np.concatenate(c_par)
    att_c = np.concatenate(c_att)
    live = arr_c <= cfg.horizon
    arr_c, par_c, att_c = arr_c[live], par_c[live], att_c[live]
    order = np.argsort(arr_c, kind="stable")
    arr_c, par_c, att_c = arr_c[order], par_c[order], att_c[order]
    attempts = int(arr_c.shape[0])

    loop = EventLoop()
    policy = ServingPolicy(
        make_policy(cfg.policy, cfg.n_workers, cfg.batch, **cfg.policy_kwargs),
        admit_limit=cfg.admit_limit,
        base_workers=cfg.base_workers,
        scale_backlog=cfg.scale_backlog,
        breaker_age=cfg.breaker_age,
        scale_latency=cfg.scale_latency,
        arrival_of=lambda item: float(arr_c[item.payload]),
    )
    done: Dict[int, float] = {}

    def _complete(tt: float, item: DesItem) -> None:
        done[item.payload] = tt
        policy.note_done(tt - float(arr_c[item.payload]))

    plane = WorkerPlane(
        loop,
        policy,
        cfg.n_workers,
        service_fn=lambda item: float(svc[par_c[item.payload]]),
        on_complete=_complete,
        rng=rng,
        claim_overhead=cfg.claim_overhead,
        deschedule_prob=cfg.deschedule_prob,
        deschedule_mean=cfg.deschedule_mean,
    )
    hints = cfg.queue_hints or {}

    def _arrive(t: float, c: int) -> None:
        fl = int(flows[par_c[c]])
        plane.enqueue(
            t, DesItem(flow=fl, payload=c, queue_hint=hints.get(fl))
        )

    loop.on("arrive", _arrive)
    for c in range(attempts):
        loop.schedule(float(arr_c[c]), "arrive", c)
    loop.run()
    # Open loop: a gated/stranded tail is the measured degraded mode,
    # never a protocol bug to raise on.
    stats = plane.finalize(strict=False)

    # Post-hoc client accounting, same draws as the lane engine: a served
    # copy is delivered iff its response survived the Bernoulli loss
    # draw (keyed on request + attempt, salted seed) and beat the
    # client deadline.  Compared through float32 on both operands so
    # the schedule is the SAME schedule as on the lane engine.
    served_copies = len(done)
    drop_rate = np.float32(cfg.drop_rate)
    salt = cfg.seed ^ 0xA5A5A5A5
    first_ok = np.full(offered, math.inf)
    n_deliv_cp = 0
    for c, tt in done.items():
        if cfg.drop_rate > 0.0 and (
            np.float32(hash_u01(salt, int(par_c[c]), int(att_c[c])))
            < drop_rate
        ):
            continue
        if extended and tt > arr_c[c] + cfg.timeout:
            continue
        n_deliv_cp += 1
        p = par_c[c]
        if tt < first_ok[p]:
            first_ok[p] = tt
    deliv_req = np.isfinite(first_ok)
    sojourns = first_ok[deliv_req] - arr[deliv_req]
    goodput = int(np.sum(deliv_req))
    ok = int(np.sum(sojourns <= cfg.slo_target)) if goodput else 0
    return ServingResult(
        policy=cfg.policy,
        offered=offered,
        delivered=n_deliv_cp,
        shed=stats.rejected,
        undelivered=attempts - served_copies - stats.rejected,
        slo_attained=ok / max(offered, 1),
        p50=float(np.percentile(sojourns, 50)) if goodput else math.inf,
        p99=float(np.percentile(sojourns, 99)) if goodput else math.inf,
        mean_sojourn=float(np.mean(sojourns)) if goodput else math.inf,
        sojourns=sojourns,
        stats=stats,
        attempts=attempts,
        expired=served_copies - n_deliv_cp,
        goodput=goodput,
        dup_served=n_deliv_cp - goodput,
    )



def sweep_serving_torch(
    policy: str,
    seeds,
    capacity: int = 2000,
    arrival: str = "poisson",
    lane_params: dict | None = None,
    traffic_params: dict | None = None,
    serving_params: dict | None = None,
    fault_params: dict | None = None,
    n_workers: int = 4,
    max_batch: int = 64,
    device=None,
    **kw,
):
    """One policy's serving lanes; returns their
    :class:`~repro_torch.core.torchplane.LaneResult`.

    ``capacity`` is each lane's generation capacity (the engine's
    ``n_packets``); the per-lane ``horizon`` decides how much of it is
    offered.  Sessions are heavy-tailed (service kind ``HT``).  Runs on
    the CUDA device unless ``device="cpu"`` is passed; ``kw`` passes on
    to the engine (``return_times``, ``engine``, ``chunk``, ...).
    """
    return _fused_lanes(
        [
            dict(
                policy=policy,
                seeds=seeds,
                lane_params=lane_params,
                traffic_params=traffic_params,
                fault_params=fault_params,
                serving_params=serving_params or {},
            )
        ],
        workload=ARRIVAL_WORKLOADS[arrival],
        service="HT",
        serving=True,
        n_packets=capacity,
        n_workers=n_workers,
        max_batch=max_batch,
        device=device,
        **kw,
    )[0]
