"""SweepRequest in, SweepResult out: the port's sweep entry point.

The port's own copy of ``repro.core.sweep``'s request and result types,
field for field, and :func:`run_sweep` for the ``forwarder``,
``queueing`` and ``serving`` scenarios on
:mod:`repro_torch.core.torchplane` and the ``tcp`` scenario on
:mod:`repro_torch.core.tcptorch`.  ``shards=N`` splits the lane axis
over the N ranks of an initialised process group, each of which calls
:func:`run_sweep` with the same request (see
:mod:`repro_torch.distributed` to start them).

===========  =========================================================
forwarder    open-loop L3 forwarder (sec 4.3.1): per-size lognormal
             service, ``arrival`` picks the process (poisson / bursty
             MAWI mix / diurnal).
queueing     M/G/N vs N x M/G/1 (sec 3.2): Poisson arrivals, ``service``
             picks M / D / LN / HT.
tcp          closed-loop TCP (the paper's worst case, one large flow
             and its reordering): ``n_packets`` is the flow layout (an
             int or per-flow counts), ``t_start`` per-flow start times;
             FCT, retransmissions and exactly-once per lane;
             ``tcp_params`` may arm the SACK scoreboard (``sack``) and
             loss (``loss_rate``, ``loss_every``).
serving      open-loop serving: ``n_packets`` users per lane cut at the
             ``serving_params`` horizon, heavy-tailed (HT) sessions,
             admission, autoscale and SLO attainment; the overload
             knobs (``timeout``, ``retries``, ``breaker_age``, ...) ride
             in ``serving_params`` too.  Each policy's registry presets
             fill what ``serving_params`` leaves out
             (``use_policy_serving_defaults``).
===========  =========================================================
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

from .policy import _fused_requests, serving_defaults, torch_policies

__all__ = ["SweepRequest", "SweepResult", "run_sweep", "ARRIVAL_WORKLOADS"]

#: SweepRequest.arrival -> the lane engine's workload
ARRIVAL_WORKLOADS = {"poisson": "udp", "bursty": "mawi", "diurnal": "diurnal"}


@dataclass(frozen=True)
class SweepRequest:
    """A full sweep, declaratively (the fields of the reference's).

    Knob-dict values may be scalars (broadcast to every lane) or
    [lanes]-shaped arrays (a sweep axis); ``seeds`` defines the lane
    count per policy segment.
    """

    scenario: str = "forwarder"  # forwarder | queueing | tcp | serving
    policies: Optional[Sequence[str]] = None  # None = every torch policy
    seeds: Any = (0,)
    arrival: str = "poisson"  # poisson | bursty | diurnal
    service: Optional[str] = None  # service kind override (fwd/M/D/LN/HT)
    lane_params: Mapping[str, Any] = field(default_factory=dict)
    traffic_params: Mapping[str, Any] = field(default_factory=dict)
    fault_params: Mapping[str, Any] = field(default_factory=dict)
    serving_params: Mapping[str, Any] = field(default_factory=dict)
    tcp_params: Mapping[str, Any] = field(default_factory=dict)
    #: per-lane load (forwarder / queueing)
    n_packets: Any = 2000
    n_workers: int = 4
    max_batch: int = 64
    n_flows: int = 256
    t_start: Any = None  # tcp only: per-flow start times
    tx_budget: Optional[int] = None  # tcp only: transmission budget
    n_steps: Optional[int] = None  # tcp only: event budget
    engine: str = "compacted"
    shards: Union[int, str] = 1
    chunk: int = 64
    claim_budget: Optional[int] = None
    prefix_impl: str = "auto"
    prefix_interpret: bool = False
    return_times: bool = False
    #: merge each policy's serving presets under ``serving_params``
    #: (serving scenario only)
    use_policy_serving_defaults: bool = True


@dataclass(frozen=True)
class SweepResult:
    """Per-policy lane results of one fused call, in request order.

    ``lanes[name]`` is a :class:`~repro_torch.core.torchplane.LaneResult`
    of tensors on the sweep's device; ``timings`` carries ``compile_s``
    / ``run_s`` when the caller asked for them.
    """

    request: SweepRequest
    policies: Tuple[str, ...]
    lanes: Mapping[str, Any]

    def __getitem__(self, policy: str):
        return self.lanes[policy]

    timings: Mapping[str, float] = field(default_factory=dict)


def _check_ported(req: SweepRequest) -> None:
    if req.scenario not in ("forwarder", "queueing", "tcp", "serving"):
        raise ValueError(
            f"unknown scenario {req.scenario!r}; "
            "expected forwarder | queueing | tcp | serving"
        )
    if req.prefix_impl == "pallas" or req.prefix_interpret:
        raise NotImplementedError(
            "prefix_impl='pallas' / prefix_interpret are the JAX package's TPU "
            "route; the port's claim-check kernel is CUDA (ROADMAP.md Queue B, "
            "item 1): use prefix_impl='auto', 'cuda' or 'plain'"
        )


def _serving_knobs(req: SweepRequest, name: str) -> dict:
    base = serving_defaults(name) if req.use_policy_serving_defaults else {}
    base.update(req.serving_params)
    return base


def run_sweep(
    request: SweepRequest, timings: dict | None = None, device=None
) -> SweepResult:
    """Run every (policy, lane) of a :class:`SweepRequest` and return a
    :class:`SweepResult` keyed by policy name.

    ``device`` defaults to CUDA and raises on a host without it; pass
    ``"cpu"`` for the plain versions.  ``timings`` (a dict, filled in
    place and echoed on the result) reports ``compile_s`` / ``run_s``,
    and ``gather_s`` when the lanes are sharded.
    """
    req = request
    _check_ported(req)
    names = list(req.policies) if req.policies is not None else torch_policies()
    if req.scenario == "tcp":
        from .tcptorch import run_tcp_lanes_fused

        reqs = _fused_requests(
            req.seeds,
            lane_params=dict(req.lane_params),
            policies=names,
            tcp_params=dict(req.tcp_params),
            fault_params=dict(req.fault_params),
        )
        results = run_tcp_lanes_fused(
            reqs,
            n_pkts=req.n_packets,
            t_start=req.t_start,
            n_workers=req.n_workers,
            max_batch=req.max_batch,
            tx_budget=req.tx_budget,
            n_steps=req.n_steps,
            engine=req.engine,
            chunk=req.chunk,
            shards=req.shards,
            prefix_impl=req.prefix_impl,
            timings=timings,
            device=device,
        )
    else:
        results = _lane_sweep(req, names, timings, device)
    return SweepResult(
        request=replace(req, policies=tuple(names)),
        policies=tuple(names),
        lanes=dict(zip(names, results)),
        timings=dict(timings or {}),
    )


def _lane_sweep(req: SweepRequest, names, timings, device) -> list:
    """The forwarder, queueing and serving scenarios on the lane engine."""
    from .torchplane import _fused_lanes

    serving = req.scenario == "serving"
    if req.scenario == "queueing":
        workload, service = "udp", req.service or "M"
    else:
        workload = ARRIVAL_WORKLOADS[req.arrival]
        service = req.service or ("HT" if serving else "fwd")
    reqs = _fused_requests(
        req.seeds,
        lane_params=dict(req.lane_params),
        policies=names,
        traffic_params=dict(req.traffic_params),
        fault_params=dict(req.fault_params),
    )
    if serving:
        for r in reqs:
            r["serving_params"] = _serving_knobs(req, r["policy"])
    return _fused_lanes(
        reqs,
        workload=workload,
        service=service,
        n_packets=req.n_packets,
        n_workers=req.n_workers,
        max_batch=req.max_batch,
        n_flows=req.n_flows,
        engine=req.engine,
        serving=serving,
        claim_budget=req.claim_budget,
        chunk=req.chunk,
        shards=req.shards,
        prefix_impl=req.prefix_impl,
        return_times=req.return_times,
        timings=timings,
        device=device,
    )
