"""Vectorized PyTorch execution plane: the port of ``repro.core.jaxplane``.

The same receive-side model as the JAX reference, restated over an
explicit lane dimension instead of ``vmap``:

* one step = one batch claim on every lane at once: the worker with the
  earliest feasible claim time takes ``next_batch(backlog)`` packets
  from its queue.  The step carries only O(workers) state per lane and
  emits one :class:`ClaimRecord` per lane;
* after the scan, one batched scatter per policy segment rebuilds every
  packet's completion time from the records and writes the segment's
  claimed mask into its rows of one [lanes, slots] bool buffer; then
  the exactly-once check runs once for every lane of every policy: the
  CUDA claim-check kernel packs the masks into 32-bit words, counts
  them and takes their done prefix in one launch
  (:func:`repro_torch.kernels.ops.claim_check`);
* the scan is a Python loop over chunks of ``chunk`` steps with one host
  check of the "every lane drained or wedged" predicate per chunk --
  the reference's ``lax.cond`` short-circuit.  The scan state lives in
  tensors that each step updates in place (the reference's carry is
  immutable; here that would allocate a copy of every field per step).

The fault plane (crash truncation, lease gating, scale-out failover,
straggler inflation) is part of the step; every fault expression is an
exact identity at its default (``+inf`` crash time and lease, 1.0
service multiplier).  Serving mode (open-loop arrivals cut at a
horizon, shed-at-claim admission, an autoscaled pool, SLO metrics) and
the overload plane (client timeouts, retry and hedge copies, response
loss, a circuit breaker, a latency-reactive autoscale gate) are Python
branches that exist only when their knobs are armed, so knob-off lanes
stay bit-identical.  ``engine="reference"`` keeps the per-claim scan
that writes each claim's completion window inside the step; the tests
pin the compacted engine to it bit for bit.

Traffic is drawn per lane from a CPU ``torch.Generator`` seeded with
the lane's seed, so a lane's draws depend on its seed and parameters
only (fused == per-policy runs; lane count cannot shift draws) and do
not depend on the device.  The float prefix sums over those draws run
in a written-out order (:func:`_xla_cumsum`), so the lane count of a
call or of a shard cannot shift their rounding either.  ``torch``
draws differ from ``jax.random``, so parity with the reference on own
draws is distributional; exact parity is held on the reference's own
draws carried across with :func:`setups_from_reference`.  The counter-hash draws of the overload
plane (:func:`hash_u01`) are the reference's, bit for bit.

``shards=N`` splits the lane axis over the N ranks of a process group
(:mod:`repro_torch.core.shard`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import compat
from ..kernels import doneprefix
from ..kernels import ops as kernel_ops
from .shard import all_gather_lanes, shard_knobs, shard_seeds, shard_setup

__all__ = [
    "TorchPolicy",
    "LaneParams",
    "TrafficParams",
    "FaultParams",
    "ServingParams",
    "OverloadConfig",
    "hash_u01",
    "LaneResult",
    "ClaimRecord",
    "rss_hash32",
    "queue_heads",
    "rows_arrived",
    "steal_choice",
    "reorder_metrics",
    "setups_from_reference",
    "lane_grid",
]

_MAWI_SIZES = np.array([40, 64, 120, 576, 1420, 1500], dtype=np.float32)
_MAWI_WEIGHTS = np.array([0.28, 0.12, 0.08, 0.10, 0.12, 0.30])
_MAWI_WEIGHTS = _MAWI_WEIGHTS / _MAWI_WEIGHTS.sum()

_INF = math.inf
_M32 = 0xFFFFFFFF


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's weakly typed Python
    scalars and ``jnp.float32`` constants meet its fp32 arrays."""
    return float(np.float32(x))


# ----------------------------------------------------------------------
# Parameters: one float32 value per lane
# ----------------------------------------------------------------------
class LaneParams(NamedTuple):
    """Per-lane policy knobs (each field a [lanes] float32 tensor)."""

    batch: torch.Tensor  # claim-size cap (corec/scaleout/locked)
    min_batch: torch.Tensor  # adaptive-batch lower clamp
    max_batch: torch.Tensor  # adaptive-batch upper clamp
    claim_overhead: torch.Tensor  # per-batch claim cost (DD scan + CAS)
    deschedule_prob: torch.Tensor  # per-batch Bernoulli stall probability
    deschedule_mean: torch.Tensor  # exponential stall length


class TrafficParams(NamedTuple):
    """Per-lane workload knobs (forwarder cost model + arrival process)."""

    rate: torch.Tensor  # packets per unit time
    pkt_size: torch.Tensor  # bytes (udp workload)
    burstiness: torch.Tensor  # lognormal sigma of mawi gaps
    base_service: torch.Tensor  # per-packet CPU cost
    per_byte: torch.Tensor  # per-byte cache-touch cost
    service_jitter: torch.Tensor  # lognormal sigma of service times
    mean_service: torch.Tensor  # mean for the M/D/LN service kinds
    diurnal_amp: torch.Tensor  # diurnal rate modulation depth in [0, 0.95]
    diurnal_period: torch.Tensor  # diurnal cycle length (sim time units)
    session_alpha: torch.Tensor  # Pareto tail index of the HT service kind


class FaultParams(NamedTuple):
    """Per-lane fault knobs: one crash and one straggler per lane.

    ``crash_worker`` dies at ``crash_t`` (``+inf`` = never);
    ``straggler_worker`` serves ``straggler`` times slower; a claim
    stranded by a mid-claim crash re-opens at ``t_claim + lease``
    (``+inf`` = never: the lane reports ``undelivered > 0``; ``locked``
    always behaves as ``+inf``).
    """

    crash_t: torch.Tensor
    crash_worker: torch.Tensor
    straggler: torch.Tensor
    straggler_worker: torch.Tensor
    lease: torch.Tensor


class ServingParams(NamedTuple):
    """Per-lane serving knobs (each field a [lanes] float32 tensor).

    The fields of ``repro.core.jaxplane.ServingParams``, each an exact
    identity at its default: ``admit_limit`` backlog cap (a claiming
    worker first sheds up to ``max_batch`` requests over it),
    ``base_workers`` / ``scale_backlog`` the autoscaled pool (worker
    ``w >= base_workers`` joins once its wake queue holds ``(w -
    base_workers + 1) * scale_backlog`` unclaimed arrivals),
    ``horizon`` the open-loop generation cutoff, ``slo_target`` the
    sojourn target of the attainment metric, ``drop_rate`` the
    response-loss probability.
    """

    admit_limit: torch.Tensor
    base_workers: torch.Tensor
    scale_backlog: torch.Tensor
    horizon: torch.Tensor
    slo_target: torch.Tensor
    drop_rate: torch.Tensor


def default_serving_params(**kw) -> dict:
    d = dict(
        admit_limit=_INF,
        base_workers=_INF,
        scale_backlog=_INF,
        horizon=_INF,
        slo_target=_INF,
        drop_rate=0.0,
    )
    d.update(kw)
    return d


class OverloadConfig(NamedTuple):
    """Static client/overload knobs of one serving segment (Python
    scalars, as in ``repro.core.jaxplane.OverloadConfig``).

    ``timeout`` client deadline per attempt; ``retries`` / ``backoff`` /
    ``jitter``: attempt j re-submits a further ``timeout + (backoff +
    jitter * u_j) * 2**(j-1)`` later, ``u_j`` the counter hash of (lane
    seed, request, j); ``hedge`` a duplicate ``hedge`` after the
    original (0: off); ``breaker_age`` sheds a whole claim whose queue
    head waited longer; ``scale_latency`` wakes the scaled workers while
    the lane's p99 sojourn estimate exceeds it.  Retry copies change
    the lanes' slot count, and the breaker and latency gate exist in
    the step only when armed.
    """

    timeout: float = _INF
    retries: int = 0
    backoff: float = 0.0
    jitter: float = 0.0
    hedge: float = 0.0
    breaker_age: float = _INF
    scale_latency: float = _INF

    @property
    def cpr(self) -> int:
        """Copies per request (original + retries + optional hedge)."""
        return 1 + self.retries + (1 if self.hedge > 0 else 0)

    @property
    def extended(self) -> bool:
        """Whether request-level (copy-expanded) accounting is armed."""
        return self.cpr > 1 or math.isfinite(self.timeout)


_OV_OFF = OverloadConfig()

#: seed salt separating response-loss draws from retry-jitter draws
_DROP_SALT = 0xA5A5A5A5


def _pop_overload(sp: dict) -> OverloadConfig:
    """Pop the static overload knobs out of a serving_params dict; each
    must be a Python scalar (a swept array raises)."""
    kw = {}
    if "retries" in sp:
        r = sp.pop("retries")
        if not isinstance(r, int) or isinstance(r, bool) or r < 0:
            raise ValueError("serving_params['retries'] must be an int >= 0 (static)")
        kw["retries"] = r
    for name, low in (
        ("timeout", 0.0),
        ("backoff", 0.0),
        ("jitter", 0.0),
        ("hedge", 0.0),
        ("breaker_age", 0.0),
        ("scale_latency", 0.0),
    ):
        if name in sp:
            v = sp.pop(name)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(
                    f"serving_params[{name!r}] must be a scalar float (static)"
                )
            v = float(v)
            if not v >= low or (v == 0.0 and name in ("timeout", "breaker_age")):
                raise ValueError(f"serving_params[{name!r}] must be > 0")
            kw[name] = v
    return OverloadConfig(**kw)


def default_lane_params(**kw) -> dict:
    d = dict(
        batch=32,
        min_batch=1,
        max_batch=32,
        claim_overhead=0.05,
        deschedule_prob=0.0,
        deschedule_mean=30.0,
    )
    d.update(kw)
    return d


def default_traffic_params(**kw) -> dict:
    d = dict(
        rate=40.0,
        pkt_size=64.0,
        burstiness=0.9,
        base_service=0.07,
        per_byte=1e-5,
        service_jitter=0.25,
        mean_service=1.0,
        diurnal_amp=0.6,
        diurnal_period=50.0,
        session_alpha=1.8,
    )
    d.update(kw)
    return d


def default_fault_params(**kw) -> dict:
    d = dict(
        crash_t=_INF, crash_worker=0, straggler=1.0, straggler_worker=0, lease=_INF
    )
    d.update(kw)
    return d


class LaneResult(NamedTuple):
    """Per-lane outputs of one policy segment (each field is [lanes]).

    The fields of ``repro.core.jaxplane.LaneResult``; off serving mode
    the serving and overload fields hold their identities (offered ==
    attempts == n, shed == expired == dup_served == 0, delivered ==
    goodput == items).
    """

    p50: torch.Tensor
    p99: torch.Tensor
    mean: torch.Tensor
    reorder_pct: torch.Tensor  # RFC 4737 Type-P-Reordered ratio * 100
    max_distance: torch.Tensor  # RFC 4737 max reordering distance
    throughput: torch.Tensor  # packets per unit time over the busy span
    batches: torch.Tensor  # claims issued
    items: torch.Tensor  # packets claimed (== n_packets when lossless)
    deschedules: torch.Tensor
    claimed_popcount: torch.Tensor  # set bits in the packed claim bitmap
    claimed_prefix: torch.Tensor  # contiguous done prefix of that bitmap
    sojourn: torch.Tensor  # [lanes, n] per-packet latency, or [lanes, 0]
    reclaimed: torch.Tensor  # items re-opened to live workers by a lease
    duplicates: torch.Tensor  # crashed-claim prefix re-served at-least-once
    undelivered: torch.Tensor  # items never delivered (wedged lanes only)
    drain_t: torch.Tensor  # last *finite* completion time (recovery edge)
    offered: torch.Tensor
    shed: torch.Tensor
    slo_attained: torch.Tensor
    attempts: torch.Tensor
    delivered: torch.Tensor
    expired: torch.Tensor
    goodput: torch.Tensor
    dup_served: torch.Tensor


# ----------------------------------------------------------------------
# Policies as pure functions over lane tensors
# ----------------------------------------------------------------------
class TorchPolicy(NamedTuple):
    """A scheduling discipline as functions over lane tensors.

    ``select_queue(flows, n_workers)`` steers every packet up front;
    ``next_batch(backlog, params, n_workers)`` sizes a claim from the
    instantaneous backlog.  ``shared``: every worker drains queue 0;
    ``uses_lock``: claims serialize on a lock horizon; ``steals``: a
    worker with an empty queue takes from the longest backlog;
    ``leases``: a crashed claim can be reclaimed (False only for the
    blocking ``locked``).  The flags of ``repro.core.jaxplane.JaxPolicy``.
    """

    name: str
    shared: bool
    uses_lock: bool
    select_queue: object
    next_batch: object
    steals: bool = False
    leases: bool = True


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for ``0 <= h < 2**32`` in int64 without
    overflow: split ``c`` into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on the low 32 bits of int64 ``h`` -- the
    plane's RSS hash, bit for bit the reference's uint32 version."""
    h = h & 0xFFFFFFFF
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_u01(seed, a, b) -> torch.Tensor:
    """Counter-based uniform draw in [0, 1) keyed on ``(seed, a, b)``:
    ``repro.core.jaxplane.hash_u01`` (and ``faults.hash_u01``) bit for
    bit.  The uint32 words are carried in int64 masked to 32 bits; the
    hash converts to float32 from there (round to nearest even, as
    XLA's uint32 -> float32 does), and the scale by 2**-32 is exact."""

    def u32(x):
        return torch.as_tensor(x).to(torch.int64) & _M32

    h = _fmix32(u32(seed) ^ _mul32(u32(a), 0x9E3779B1))
    h = _fmix32(h ^ _mul32(u32(b), 0x85EBCA77))
    return h.to(torch.float32) * 2.0**-32


def rss_hash32(key, n_queues: int):
    """Host-side mirror of the plane's steering hash (numpy)."""
    h = np.asarray(key, dtype=np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h % np.uint32(n_queues)


def _select_shared(flows, n_workers):
    return torch.zeros_like(flows)


def _select_rss(flows, n_workers):
    return _fmix32(flows) % n_workers


def _next_batch_cap(backlog, params, n_workers):
    return torch.minimum(params.batch.to(torch.int64), backlog)


def _next_batch_adaptive(backlog, params, n_workers):
    share = (backlog + n_workers - 1) // n_workers
    lo = params.min_batch.to(torch.int64)
    return torch.minimum(torch.maximum(share, lo), params.max_batch.to(torch.int64))


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[l, idx[l]]`` for every lane l."""
    return x.gather(1, idx[:, None]).squeeze(1)


def queue_heads(q_arr, qptr):
    """Arrival time of each queue's next unclaimed item (+inf if none).

    ``q_arr`` [L, W, n+1] sorted arrival rows padded with +inf; ``qptr``
    [L, W] per-queue claim pointers.
    """
    pad = q_arr.shape[2] - 1
    return q_arr.gather(2, qptr.clamp(max=pad)[:, :, None]).squeeze(2)


def rows_arrived(q_arr, t0):
    """Arrivals <= ``t0[l]`` in every sorted row of lane l -> [L, W].

    One ``searchsorted`` over the contiguous [L*W, n+1] view with one
    value per row: selecting a row first would copy it every step.
    """
    lanes, w, m = q_arr.shape
    v = t0[:, None].expand(lanes, w).reshape(lanes * w, 1).contiguous()
    found = torch.searchsorted(q_arr.view(lanes * w, m), v, right=True)
    return found.view(lanes, w)


def steal_choice(q_arr, qptr, own, t0):
    """Hybrid victim selection at claim time ``t0`` (per lane).

    Returns ``(q, backlog_q)``: the worker's own queue when it has
    arrivals at ``t0``, else the argmax of instantaneous backlogs, plus
    the backlog vector it was chosen from.
    """
    backlog_q = rows_arrived(q_arr, t0) - qptr
    q = torch.where(_pick(backlog_q, own) > 0, own, backlog_q.argmax(1))
    return q, backlog_q


# ----------------------------------------------------------------------
# The reference's float32 summation orders, written out: every float
# prefix sum of the engines (arrival times, service prefixes, the TCP
# engine's claim windows) goes through these, so that a lane's value
# does not depend on how many lanes share its tensor.  torch.cumsum on
# the card picks its block shape from the row count, which moves its
# rounding with the lane count of a call (and of a shard).
# ----------------------------------------------------------------------
def _seq_prefix(x: torch.Tensor) -> torch.Tensor:
    """Sequential float32 prefix along the last axis (one add per column)."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def _xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` along the last axis in XLA's CPU order: blocks of
    16, a sequential prefix inside each, plus the exclusive prefix of the
    block totals (itself blocked the same way)."""
    n, block = x.shape[-1], 16
    if n <= block:
        return _seq_prefix(x)
    nb = -(-n // block)
    xb = torch.nn.functional.pad(x, (0, nb * block - n))
    inner = _seq_prefix(xb.reshape(*x.shape[:-1], nb, block))
    incl = _xla_cumsum(inner[..., -1])
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
    out = inner + excl[..., None]
    return out.reshape(*x.shape[:-1], nb * block)[..., :n]


def _xla_sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` along the last axis in XLA's CPU order: up to 32
    elements sequentially; past that the axis is padded with zeros to
    whole blocks of 32 (half the slack, rounded down, in front), each
    block summed sequentially, then the block totals the same way."""
    n, block = x.shape[-1], 32
    if n > block:
        nb = -(-n // block)
        slack = nb * block - n
        xb = torch.nn.functional.pad(x, (slack // 2, slack - slack // 2))
        return _xla_sum(_xla_sum(xb.reshape(*x.shape[:-1], nb, block)))
    acc = x[..., 0]
    for i in range(1, n):
        acc = acc + x[..., i]
    return acc


# ----------------------------------------------------------------------
# Traffic: standard draws per lane on the CPU, transforms on the device
# ----------------------------------------------------------------------
def _lane_draws(seeds, workload, service, n, n_flows, n_draws):
    """Standard variates of every lane from its own CPU generator, in a
    fixed order, so a lane's draws depend on its seed alone."""
    zipf = torch.from_numpy(1.0 / np.arange(1, n_flows + 1) ** 1.1)
    mawi_p = torch.from_numpy(_MAWI_WEIGHTS)
    out = {k: [] for k in ("gap", "flow", "size", "svc", "u", "stall")}
    for seed in seeds:
        g = torch.Generator().manual_seed(int(seed))
        if workload == "mawi":
            out["gap"].append(torch.randn(n, generator=g))
            out["flow"].append(torch.multinomial(zipf, n, True, generator=g))
            out["size"].append(torch.multinomial(mawi_p, n, True, generator=g))
        else:  # udp and diurnal: unit-rate exponential gaps
            out["gap"].append(torch.empty(n).exponential_(generator=g))
            out["flow"].append(torch.randint(0, n_flows, (n,), generator=g))
        if service in ("fwd", "LN"):
            out["svc"].append(torch.randn(n, generator=g))
        elif service == "M":
            out["svc"].append(torch.empty(n).exponential_(generator=g))
        elif service == "HT":
            out["svc"].append(torch.rand(n, generator=g))
        out["u"].append(torch.rand(n_draws, generator=g))
        out["stall"].append(torch.empty(n_draws).exponential_(generator=g))
    return {k: torch.stack(v) for k, v in out.items() if v}


def _gen_traffic(draws, tp: TrafficParams, workload: str, service: str):
    """Arrival times, service times and flow ids of every lane, [L, n]."""
    col = {f: getattr(tp, f)[:, None] for f in TrafficParams._fields}
    z = draws["gap"]
    if workload == "udp":
        arr = _xla_cumsum(z / col["rate"])
        sizes = col["pkt_size"]
    elif workload == "mawi":
        sigma = col["burstiness"]
        mu = torch.log(1.0 / col["rate"]) - sigma**2 / 2
        arr = _xla_cumsum(torch.exp(z * sigma + mu))
        table = torch.from_numpy(_MAWI_SIZES).to(z.device)
        sizes = table[draws["size"]]
    elif workload == "diurnal":
        # lambda(t) = rate * (1 + amp sin wt) by time-rescaling: invert
        # the cumulative intensity of a unit-rate process by damped
        # Newton (lambda >= rate * (1 - amp) > 0), as the reference does
        s = _xla_cumsum(z)
        rate = col["rate"]
        amp = col["diurnal_amp"].clamp(0.0, 0.95)
        w = 2.0 * math.pi / col["diurnal_period"]
        lam_min = rate * (1.0 - amp)
        t = s / rate
        for _ in range(12):
            big = rate * (t + amp / w * (1.0 - torch.cos(w * t)))
            lam = rate * (1.0 + amp * torch.sin(w * t))
            t = torch.clamp(t - (big - s) / torch.maximum(lam, lam_min), min=0.0)
        arr = torch.cummax(t, dim=1).values  # Newton residue keeps order
        sizes = col["pkt_size"]
    else:
        raise ValueError(f"unknown workload {workload!r}")
    if service == "fwd":  # the forwarder's per-size lognormal cost model
        mean = col["base_service"] + col["per_byte"] * sizes
        sj = col["service_jitter"]
        svc = torch.exp(draws["svc"] * sj + torch.log(mean) - sj**2 / 2)
    elif service == "M":
        svc = draws["svc"] * col["mean_service"]
    elif service == "D":
        svc = col["mean_service"].expand_as(arr)
    elif service == "LN":
        mu = torch.log(col["mean_service"]) - 0.8**2 / 2
        svc = torch.exp(draws["svc"] * 0.8 + mu)
    elif service == "HT":
        # heavy-tailed session sizes: Pareto with tail index alpha > 1 by
        # inverse CDF on a uniform clipped at 1e-4, scaled so the
        # truncated mean is mean_service
        alpha = col["session_alpha"]
        u = draws["svc"].clamp(min=1e-4)
        svc = col["mean_service"] * (alpha - 1.0) / alpha * u ** (-1.0 / alpha)
    else:
        raise ValueError(f"unknown service kind {service!r}")
    return arr.float().contiguous(), svc.float().contiguous(), draws["flow"]


# ----------------------------------------------------------------------
# RFC 4737 reordering, batched over lanes
# ----------------------------------------------------------------------
def reorder_metrics(done_times: torch.Tensor):
    """RFC 4737 NextExp metrics from completion times, per row.

    Packet i's sequence number is its index; the completion order is a
    *stable* argsort of ``done_times`` (ties, e.g. deterministic
    service, keep sequence order, as ``jnp.argsort`` does).  A packet is
    Type-P-Reordered iff its seqno is below the running max of seqnos
    completed before it.  Returns ``(reordered_ratio, max_distance)``.
    """
    n = done_times.shape[-1]
    order = torch.argsort(done_times, dim=-1, stable=True)
    reordered = order < torch.cummax(order, dim=-1).values
    seq = torch.arange(n, device=order.device).expand_as(order)
    pos_of = torch.empty_like(order).scatter_(-1, order, seq)  # seqno -> position
    disp = pos_of - seq
    dist = torch.where((disp > 0) & reordered.gather(-1, pos_of), disp, 0)
    return reordered.float().mean(dim=-1), dist.amax(dim=-1)


# ----------------------------------------------------------------------
# The claim-compacted step
# ----------------------------------------------------------------------
@dataclass
class _LaneState:
    """Scan state of every lane, updated in place by each step."""

    qptr: torch.Tensor  # [L, W] per-queue claim pointer
    free_t: torch.Tensor  # [L, W] fp32 per-worker free time
    lock_t: torch.Tensor  # [L] fp32 lock horizon (``locked`` only)
    batches: torch.Tensor  # [L] claims issued
    items: torch.Tensor  # [L] packets claimed (delivered, not stranded)
    deschs: torch.Tensor  # [L] deschedule stalls taken
    resume_t: torch.Tensor  # [L, W] fp32 lease expiry gating a stranded span
    resume_until: torch.Tensor  # [L, W] rank bound of the gated span
    reclaimed: torch.Tensor  # [L] items re-opened by a lease
    dups: torch.Tensor  # [L] crashed-prefix items re-served
    halted: torch.Tensor  # [L] bool: no claimable work remains
    shed: torch.Tensor  # [L] requests dropped by admission (0 off serving mode)
    lat_est: torch.Tensor  # [L] fp32 p99 sojourn estimate (latency gate only)


def _init_state(lanes: int, n_workers: int, device) -> _LaneState:
    def z(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=device)

    f32 = torch.float32
    return _LaneState(
        qptr=z(lanes, n_workers),
        free_t=z(lanes, n_workers, dtype=f32),
        lock_t=z(lanes, dtype=f32),
        batches=z(lanes),
        items=z(lanes),
        deschs=z(lanes),
        resume_t=z(lanes, n_workers, dtype=f32),
        resume_until=z(lanes, n_workers),
        reclaimed=z(lanes),
        dups=z(lanes),
        halted=z(lanes, dtype=torch.bool),
        shed=z(lanes),
        lat_est=z(lanes, dtype=f32),
    )


class ClaimRecord(NamedTuple):
    """One batch claim per lane: queue, start rank, size, post-overhead
    time, straggler multiplier and the admission-shed span before it.
    Masked steps carry ``k == shed == 0`` and the dump queue ``W``; ``k``
    is the delivered size (a claim cut by its worker's crash records
    only the pre-crash prefix).  ``shed`` (serving mode; 0 otherwise,
    and ``None`` for records stored off serving mode) is the span
    [ptr, ptr + shed): claimed, never served, so service starts at rank
    ``ptr + shed``."""

    q: torch.Tensor
    ptr: torch.Tensor
    k: torch.Tensor
    t1: torch.Tensor
    slow: torch.Tensor
    shed: torch.Tensor | None = None


@dataclass
class _LaneSetup:
    """One policy segment's pre-drawn traffic and per-queue views.

    ``n`` below is the segment's slot count: the requests, or in a
    fused call with retry copies ``requests * max copies per request``
    (surplus slots never arrive: +inf).  The serving fields are None
    off serving mode."""

    arr: torch.Tensor  # [L, n] fp32 arrival times in seqno order
    qid: torch.Tensor  # [L, n] int64 queue of each packet
    rank: torch.Tensor  # [L, n] int64 rank of each packet in its queue
    q_arr: torch.Tensor  # [L, W, n+1] fp32 sorted arrival rows, +inf pad
    cumsvc: torch.Tensor  # [L, W, n] fp32 service prefix sums in rank order
    u: torch.Tensor  # [L, S] fp32 deschedule uniforms, one per step
    stalls: torch.Tensor  # [L, S] fp32 unit exponential stall lengths
    crash_w: torch.Tensor  # [L, W] fp32 per-worker crash time (+inf: never)
    slow_w: torch.Tensor  # [L, W] fp32 per-worker service multiplier
    lease: torch.Tensor  # [L] fp32 reclamation offset (+inf: none)
    offered: torch.Tensor | None = None  # [L] attempt copies that arrive
    offered_req: torch.Tensor | None = None  # [L] requests behind them
    parent: torch.Tensor | None = None  # [L, n] int64 request of each slot
    att: torch.Tensor | None = None  # [L, n] int64 attempt id of each slot
    arr0: torch.Tensor | None = None  # [L, requests] fp32 request arrivals
    lseed: torch.Tensor | None = None  # [L] int64 lane seed (uint32 value)


def _gather_qr(x: torch.Tensor, q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[l, q[l], idx[l]]`` for every lane l of an [L, W, m] tensor."""
    lanes, w_count, m = x.shape
    return x.view(lanes, w_count * m).gather(1, (q * m + idx)[:, None]).squeeze(1)


def _scale_gate(pol, sp: ServingParams, ov: OverloadConfig, q_arr, st, n: int):
    """The autoscale wake gate of every worker, [L, W]: worker w >=
    base_workers may not claim before the ((w - base + 1) *
    scale_backlog)-th unclaimed arrival of its wake queue; with
    ``scale_latency`` armed, instead while the lane's p99 estimate is at
    or below it.  -inf (no gate) for the base pool."""
    lanes, w_count, _ = q_arr.shape
    widx = torch.arange(w_count, dtype=torch.float32, device=q_arr.device)
    base = sp.base_workers[:, None]
    scaled = widx >= base
    if math.isfinite(ov.scale_latency):
        hot = st.lat_est > _f32(ov.scale_latency)
        gate = torch.where(hot, -_INF, _INF)[:, None]
        return torch.where(scaled, gate, -_INF)
    thr = (widx - base + 1.0) * sp.scale_backlog.clamp(min=1.0)[:, None]
    thr_i = torch.where(scaled, thr.clamp(1.0, 2.0**30), 1.0).to(torch.int64)
    if pol.shared:  # every worker wakes on queue 0's backlog
        idx = (st.qptr[:, :1] + thr_i - 1).clamp(0, n)
        t_scale = q_arr[:, 0, :].gather(1, idx)
    else:
        idx = (st.qptr + thr_i - 1).clamp(0, n)
        t_scale = q_arr.gather(2, idx[:, :, None]).squeeze(2)
    return torch.where(scaled, t_scale, -_INF)


def _claim_step(
    pol, mb, params, su, st, u, stall, sparams=None, ov=_OV_OFF
) -> ClaimRecord:
    """One batch claim on every lane: updates ``st`` in place, returns
    the claims' records.  ``u``/``stall`` [L] are this step's draws.

    The lane-batched ``repro.core.jaxplane._claim_step``, faults
    included: a worker's busy span is the difference of two ``cumsvc``
    gathers, and every fault expression is an identity at the defaults.
    ``sparams`` (a :class:`ServingParams`, None off serving mode) arms
    the autoscale wake gate and shed-at-claim admission; ``ov`` arms the
    circuit breaker and the latency-reactive gate with its p99 tracker.
    Each is a branch that runs only when armed.
    """
    serving = sparams is not None
    q_arr, cumsvc, crash_w = su.q_arr, su.cumsvc, su.crash_w
    lanes, w_count, n = cumsvc.shape
    heads_raw = queue_heads(q_arr, st.qptr)
    # lease gate: a span stranded by a mid-claim crash re-opens only at
    # resume_t; until qptr passes the stranded bound the head waits
    gated = st.qptr < st.resume_until
    heads = torch.where(gated, torch.maximum(heads_raw, st.resume_t), heads_raw)
    if pol.steals:  # work conserving: wake for the earliest head anywhere
        arr_next = heads.amin(1, keepdim=True)
    elif pol.shared:
        arr_next = heads[:, :1]
    else:
        # scale-out failover: worker v also wakes for a crashed peer's
        # head, never before that peer's death (+inf crash: identity)
        eye = torch.eye(w_count, dtype=torch.bool, device=heads.device)
        cross = torch.where(eye, -_INF, crash_w[:, None, :])
        arr_next = torch.maximum(heads[:, None, :], cross).amin(2)
    t_cand = torch.maximum(st.free_t, arr_next)
    if pol.uses_lock:
        t_cand = torch.maximum(t_cand, st.lock_t[:, None])
    if serving:
        t_cand = torch.maximum(t_cand, _scale_gate(pol, sparams, ov, q_arr, st, n))
    # a worker whose next claim would start at/after its crash is dead
    t_cand = torch.where(t_cand >= crash_w, _INF, t_cand)
    w = t_cand.argmin(1)  # ties: first index, as jnp.argmin
    t0 = _pick(t_cand, w)
    active = torch.isfinite(t0)
    if pol.steals:
        # gated steal: a helper never steals a stranded span early
        backlog_q = rows_arrived(q_arr, t0) - st.qptr
        backlog_q = torch.where(gated & (st.resume_t > t0[:, None]), 0, backlog_q)
        q = torch.where(_pick(backlog_q, w) > 0, w, backlog_q.argmax(1))
        backlog = _pick(backlog_q, q)
    elif pol.shared:
        q = torch.zeros_like(w)
        backlog = rows_arrived(q_arr, t0)[:, 0] - st.qptr[:, 0]
    else:
        # own queue when claimable at t0, else the first claimable dead
        # peer's queue (the failover wake-up above guarantees one)
        backlog_q = rows_arrived(q_arr, t0) - st.qptr
        gate_t = torch.where(gated, st.resume_t, -_INF)
        widx = torch.arange(w_count, device=w.device)
        can = (widx == w[:, None]) | (crash_w <= t0[:, None])
        has = can & (backlog_q > 0) & (t0[:, None] >= gate_t)
        q = torch.where(_pick(has, w), w, has.to(torch.uint8).argmax(1))
        backlog = _pick(backlog_q, q)
    ptr = _pick(st.qptr, q)
    claims = active
    if serving:
        # shed-at-claim admission: the claiming worker first drops up to
        # max_batch over-limit requests from its queue head (they keep
        # their claim bit); admit_limit = +inf sheds exactly 0
        excess = (backlog.float() - sparams.admit_limit).clamp(min=0.0)
        shed = torch.where(active, excess.clamp(max=float(mb)).to(torch.int64), 0)
        if math.isfinite(ov.breaker_age):
            # circuit breaker: a queue head older than breaker_age sheds
            # the whole claim (up to max_batch) instead of serving it
            age = t0 - _gather_qr(q_arr, q, ptr)
            tripped = active & (backlog > 0) & (age > _f32(ov.breaker_age))
            shed = torch.where(tripped, backlog.clamp(max=mb), shed)
            claims = active & ~tripped
        backlog = backlog - shed
        ptr_s = ptr + shed  # first served rank
    else:
        shed = st.shed  # all zero off serving mode
        ptr_s = ptr
    k = pol.next_batch(backlog, params, w_count)
    k = torch.minimum(torch.maximum(k, backlog.clamp(max=1)), backlog.clamp(max=mb))
    k = torch.where(claims, k, 0)
    desch = active & (u < params.deschedule_prob)
    stall_t = torch.where(desch, stall * params.deschedule_mean, 0.0)
    t1 = t0 + params.claim_overhead + stall_t
    cs = cumsvc.view(lanes, w_count * n)
    qn = q * n
    base = torch.where(ptr_s > 0, _pick(cs, qn + (ptr_s - 1).clamp(min=0)), 0.0)
    # straggler inflation + crash truncation: worker w serves at slow x
    # real time and delivers the longest prefix of its claim that ends
    # strictly before its crash time c
    slow = _pick(su.slow_w, w)
    c = _pick(crash_w, w)
    svc_budget = base + (c - t1) / slow
    fits = rows_arrived(cumsvc, svc_budget)  # same search, over cumsvc rows
    k_eff = _pick(fits, q) - ptr_s
    k_eff = torch.where(active, torch.minimum(k_eff.clamp(min=0), k), 0)
    crashed = active & (k_eff < k)
    last = _pick(cs, qn + (ptr_s + k_eff - 1).clamp(0, n - 1))
    t_end = t1 + torch.where(k_eff > 0, (last - base) * slow, 0.0)
    free_w = torch.where(active, t_end, _pick(st.free_t, w))
    free_w = torch.where(crashed, _INF, free_w)
    st.free_t.scatter_(1, w[:, None], free_w[:, None])
    if pol.uses_lock:
        # lock held through claim + stall; a holder dying inside it
        # wedges every peer (the horizon goes to +inf)
        lock_dead = active & (c <= t1)
        st.lock_t = torch.where(active, torch.where(lock_dead, _INF, t1), st.lock_t)
    # a truncated claim strands [ptr_s + k_eff, ptr_s + k) until the lease
    lease = su.lease if pol.leases else torch.full_like(su.lease, _INF)
    resume = torch.where(crashed, t0 + lease, _pick(st.resume_t, q))
    st.resume_t.scatter_(1, q[:, None], resume[:, None])
    until = torch.where(crashed, ptr_s + k, _pick(st.resume_until, q))
    st.resume_until.scatter_(1, q[:, None], until[:, None])
    reclaim = crashed & torch.isfinite(lease)
    if serving and math.isfinite(ov.scale_latency):
        # Robbins-Monro p99 tracker fed by the claim's max sojourn (its
        # first served rank arrived first): the asymmetric steps converge
        # to the 0.99-quantile and give the gate its hysteresis
        samp = t_end - _gather_qr(q_arr, q, ptr_s)
        lr = _f32(0.25 * ov.scale_latency)
        step = lr * (_f32(0.99) - (samp <= st.lat_est).float())
        st.lat_est = torch.where(
            active & (k_eff > 0), (st.lat_est + step).clamp(min=0.0), st.lat_est
        )
    if serving:
        st.qptr.scatter_add_(1, q[:, None], (shed + k_eff)[:, None])
        st.shed += shed
        has_k = (k_eff + shed) > 0
    else:
        st.qptr.scatter_add_(1, q[:, None], k_eff[:, None])
        has_k = k_eff > 0
    st.batches += active
    st.items += k_eff
    st.deschs += desch
    st.reclaimed += torch.where(reclaim, k - k_eff, 0)
    st.dups += torch.where(reclaim, k_eff, 0)
    st.halted |= ~active
    return ClaimRecord(
        q=torch.where(has_k, q, w_count),
        ptr=torch.where(has_k, ptr, 0),
        k=k_eff,
        t1=t1,
        slow=slow,
        shed=shed,
    )


def _scatter_claims(rec: ClaimRecord, qid, rank, cumsvc, out=None):
    """Per-packet completion times from every lane's claim records.

    ``rec`` fields are [L, S].  Scatter each claim's index at its
    (queue, start-rank) slot, forward-fill along ranks with ``cummax``
    (claim indices grow with rank within a queue), then every packet's
    completion is ``t1[claim] + (cumsvc[rank] - cumsvc[start - 1]) *
    slow[claim]``, where start is the claim's first served rank (past
    its shed span; ``rec.shed`` None: no shed).  Returns ``(done [L, n],
    claimed [L, n])``; ``claimed`` is written into ``out`` when given
    (a [L, n] bool view, e.g. this segment's rows of the fused call's
    mask).
    """
    lanes, w_count, n = cumsvc.shape
    steps = rec.k.shape[1]
    live = rec.k > 0 if rec.shed is None else (rec.k + rec.shed) > 0
    s_idx = torch.arange(steps, device=qid.device).expand(lanes, steps)
    # masked steps all write -1 to one dump slot past the real rows
    slot = torch.where(live, rec.q.long() * (n + 1) + rec.ptr.long(), w_count * (n + 1))
    start = torch.full((lanes, (w_count + 1) * (n + 1)), -1, device=qid.device)
    start.scatter_(1, slot, torch.where(live, s_idx, -1))
    cid = torch.cummax(start.view(lanes, w_count + 1, n + 1)[:, :w_count], dim=2)
    cid_p = cid.values.reshape(lanes, w_count * (n + 1)).gather(1, qid * (n + 1) + rank)
    safe = cid_p.clamp(min=0)
    t1_p = rec.t1.gather(1, safe)
    ptr_p = rec.ptr.long().gather(1, safe)
    if rec.shed is not None:
        ptr_p = ptr_p + rec.shed.long().gather(1, safe)  # first served rank
    k_p = rec.k.long().gather(1, safe)
    slow_p = rec.slow.gather(1, safe)
    cs = cumsvc.view(lanes, w_count * n)
    prev = cs.gather(1, qid * n + (ptr_p - 1).clamp(min=0))
    base_p = torch.where(ptr_p > 0, prev, 0.0)
    claimed = torch.logical_and(cid_p >= 0, rank < ptr_p + k_p, out=out)
    served = claimed if rec.shed is None else claimed & (rank >= ptr_p)
    done_t = t1_p + (cs.gather(1, qid * n + rank) - base_p) * slow_p
    return torch.where(served, done_t, _INF), claimed


# ----------------------------------------------------------------------
# Lane setup: pre-drawn traffic -> per-queue views
# ----------------------------------------------------------------------
def _expand_attempts(arr, svc, flows, n_slots: int, ov: OverloadConfig, sp, lseed):
    """Each request's attempt copies as slots, re-sorted by arrival.

    Attempt j re-fires ``timeout + (backoff + jitter * u_j) * 2**(j-1)``
    after attempt j-1 (``u_j`` the counter hash of (seed, request, j)),
    the hedge a flat ``hedge`` after the original; copies of a request
    that never arrives, and copies past the horizon, never arrive.
    Surplus slots up to ``n_slots`` pad with +inf (attempt id ``retries
    + 2``).  The sort is stable: copies that arrive at one instant keep
    the reference's order.  Returns ``(arr, svc, flows, parent, att)``.
    """
    lanes, n = arr.shape
    dev = arr.device
    pidx = torch.arange(n, device=dev)
    rows = [arr]
    acc = torch.zeros_like(arr)
    for j in range(1, ov.retries + 1):
        u_j = hash_u01(lseed[:, None], pidx, j)
        delay = (_f32(ov.backoff) + _f32(ov.jitter) * u_j) * _f32(2.0 ** (j - 1))
        acc = acc + _f32(ov.timeout) + delay
        rows.append(arr + acc)
    if ov.hedge > 0:
        rows.append(arr + _f32(ov.hedge))
    c = len(rows)  # attempt ids 0 .. c - 1: original, retries, hedge
    arr_e = torch.cat(rows, dim=1)
    arr_e = torch.where(torch.isfinite(arr).repeat(1, c), arr_e, _INF)
    if sp is not None:
        arr_e = torch.where(arr_e <= sp.horizon[:, None], arr_e, _INF)
    parent = pidx.repeat(c)
    att = torch.arange(c, device=dev).repeat_interleave(n)
    pad = n_slots - c * n
    if pad:
        arr_e = torch.cat([arr_e, torch.full((lanes, pad), _INF, device=dev)], dim=1)
        parent = torch.cat([parent, torch.zeros(pad, dtype=parent.dtype, device=dev)])
        att = torch.cat([att, torch.full((pad,), ov.retries + 2, device=dev)])
    order = torch.argsort(arr_e, dim=1, stable=True)
    arr_s = arr_e.gather(1, order)
    parent = parent[order]
    att = att[order]
    svc = torch.where(torch.isfinite(arr_s), svc.gather(1, parent), 0.0)
    return arr_s, svc, flows.gather(1, parent), parent, att


def _lane_setup(
    pol,
    workload,
    service,
    n,
    n_flows,
    n_workers,
    n_draws,
    traffic,
    fparams,
    seeds,
    *,
    n_slots=None,
    sparams=None,
    ov=_OV_OFF,
):
    """Draw every lane's traffic and build its per-queue views.

    ``n`` requests are drawn; ``n_slots`` (default ``n``) is the fused
    call's attempt capacity, filled with retry and hedge copies and
    +inf pad.  ``sparams`` (serving mode) cuts arrivals at the horizon
    and fills the serving fields of the setup."""
    device = traffic.rate.device
    n_slots = n if n_slots is None else int(n_slots)
    draws = _lane_draws(seeds, workload, service, n, n_flows, n_draws)
    draws = {k: v.to(device) for k, v in draws.items()}
    arr, svc, flows = _gen_traffic(draws, traffic, workload, service)
    lseed = torch.as_tensor(np.asarray(seeds, dtype=np.int64), device=device)
    if sparams is not None:
        # arrivals past the horizon never happen: a per-queue rank
        # suffix of +inf, so the rows stay sorted
        arr = torch.where(arr <= sparams.horizon[:, None], arr, _INF)
    arr0 = arr
    parent = att = None
    if n_slots != n:
        arr, svc, flows, parent, att = _expand_attempts(
            arr, svc, flows, n_slots, ov, sparams, lseed
        )
    qid = pol.select_queue(flows, n_workers)
    rank = torch.zeros_like(qid)
    for w in range(n_workers):
        m = qid == w
        rank = torch.where(m, torch.cumsum(m, dim=1) - 1, rank)
    lanes = arr.shape[0]
    q_arr = torch.full((lanes, n_workers * (n_slots + 1)), _INF, device=device)
    q_arr.scatter_(1, qid * (n_slots + 1) + rank, arr)
    svc_qr = torch.zeros((lanes, n_workers * n_slots), device=device)
    svc_qr.scatter_(1, qid * n_slots + rank, svc)
    cumsvc = _xla_cumsum(svc_qr.view(lanes, n_workers, n_slots)).contiguous()
    widx = torch.arange(n_workers, device=device, dtype=torch.float32)
    crash_w = torch.where(
        widx == fparams.crash_worker[:, None], fparams.crash_t[:, None], _INF
    )
    slow_w = torch.where(
        widx == fparams.straggler_worker[:, None], fparams.straggler[:, None], 1.0
    )
    su = _LaneSetup(
        arr=arr,
        qid=qid,
        rank=rank,
        q_arr=q_arr.view(lanes, n_workers, n_slots + 1),
        cumsvc=cumsvc,
        u=draws["u"].float(),
        stalls=draws["stall"].float(),
        crash_w=crash_w.float(),
        slow_w=slow_w.float(),
        lease=fparams.lease.float(),
    )
    if sparams is not None:
        if parent is None:
            parent = torch.arange(n, device=device).expand(lanes, n)
            att = torch.zeros_like(parent)
        su.offered = torch.isfinite(arr).sum(dim=1)
        su.offered_req = torch.isfinite(arr0).sum(dim=1)
        su.parent, su.att, su.arr0, su.lseed = parent, att, arr0, lseed
    return su


#: the serving fields of a reference setup, with their dtypes
_SERVING_KEYS = {
    "offered": torch.int64,
    "offered_req": torch.int64,
    "parent": torch.int64,
    "att": torch.int64,
    "arr0": torch.float32,
    "lseed": torch.int64,
}
_PER_LANE = ("offered", "offered_req", "lseed")


def setups_from_reference(su: dict, device="cpu") -> _LaneSetup:
    """The reference's per-lane ``_lane_setup`` output (a dict of
    [lanes, ...] arrays: ``arr``, ``qid``, ``rank``, ``q_arr``,
    ``cumsvc``, ``u``, ``stalls``, ``crash_w``, ``slow_w``, ``lease``,
    and in serving mode ``offered``, ``offered_req``, ``parent``,
    ``att``, ``arr0``, ``lseed``) as the port's tensors -- this system's
    state, carried across."""
    dev = compat.resolve_device(device)

    def t(key, dtype):
        a = np.asarray(su[key])
        if dtype == torch.int64:
            a = a.astype(np.int64)  # uint32 seeds and int32 counters
        return torch.tensor(a, dtype=dtype, device=dev).contiguous()

    f32, i64 = torch.float32, torch.int64
    out = _LaneSetup(
        arr=t("arr", f32),
        qid=t("qid", i64),
        rank=t("rank", i64),
        q_arr=t("q_arr", f32),
        cumsvc=t("cumsvc", f32),
        u=t("u", f32),
        stalls=t("stalls", f32),
        crash_w=t("crash_w", f32),
        slow_w=t("slow_w", f32),
        lease=t("lease", f32).reshape(-1),
    )
    for key, dtype in _SERVING_KEYS.items():
        if key in su:
            v = t(key, dtype)
            setattr(out, key, v.reshape(-1) if key in _PER_LANE else v)
    return out


# ----------------------------------------------------------------------
# The two engines
# ----------------------------------------------------------------------
def _chunked_scan(body, n_steps: int, done_fn, chunk: int) -> None:
    """Run ``body(s)`` for every step in chunks of ``chunk`` steps; before
    each chunk, one host check of ``done_fn()`` (a device->host sync)
    ends the scan once every lane is done.  Skipped steps leave their
    records at zero, which downstream code masks."""
    for c0 in range(0, n_steps, chunk):
        if bool(done_fn()):
            return
        for s in range(c0, min(c0 + chunk, n_steps)):
            body(s)


def _compacted_lanes(
    pol, mb, params, su: _LaneSetup, n: int, chunk: int, sparams=None, ov=_OV_OFF,
    out=None,
):
    """Claim-compacted scan + one post-scan scatter; the claimed mask is
    written into ``out`` when given."""
    serving = sparams is not None
    lanes, w_count, _ = su.cumsvc.shape
    steps = su.u.shape[1]
    dev = su.arr.device
    st = _init_state(lanes, w_count, dev)
    u_t, stall_t = su.u.t().contiguous(), su.stalls.t().contiguous()

    def buf(dtype):
        return torch.zeros((steps, lanes), dtype=dtype, device=dev)

    i32, f32 = torch.int32, torch.float32
    # off serving mode the shed column is all zero and is not stored
    recs = [buf(i32), buf(i32), buf(i32), buf(f32), buf(f32)]
    if serving:
        recs.append(buf(i32))

    def body(s):
        rec = _claim_step(pol, mb, params, su, st, u_t[s], stall_t[s], sparams, ov)
        for b, val in zip(recs, rec):
            b[s] = val

    def done_fn():
        # a lane is finished when it drained OR wedged (no claimable work
        # remains: dead lock holder, unleased stranded span); a serving
        # lane drains at its own offered load, sheds included
        if serving:
            return (st.halted | (st.items + st.shed >= su.offered)).all()
        return (st.halted | (st.items >= n)).all()

    _chunked_scan(body, steps, done_fn, chunk)
    rec_l = ClaimRecord(*(x.t().contiguous() for x in recs))
    done, claimed = _scatter_claims(rec_l, su.qid, su.rank, su.cumsvc, out=out)
    return st, done, claimed


def _reference_lanes(pol, mb, params, su: _LaneSetup, sparams=None, ov=_OV_OFF):
    """The per-claim scan: each claim's completion window is written into
    a (queue, rank) grid inside the step -- the formulation the
    compacted engine is pinned to, bit for bit.  Runs every step.  In
    serving mode a claimed grid of its own takes each claim's shed span
    and served span (a shed slot is claimed with no completion)."""
    serving = sparams is not None
    lanes, w_count, n = su.cumsvc.shape
    m = n + mb
    dev = su.arr.device
    cs_pad = torch.zeros((lanes, w_count + 1, m), device=dev)
    cs_pad[:, :w_count, :n] = su.cumsvc
    cs_pad[:, :w_count, n:] = su.cumsvc[:, :, -1:]
    cs_pad = cs_pad.view(lanes, (w_count + 1) * m)
    done_qr = torch.full((lanes, (w_count + 1) * m), _INF, device=dev)
    clm_qr = torch.zeros((lanes, (w_count + 1) * m), dtype=torch.bool, device=dev)
    st = _init_state(lanes, w_count, dev)
    off = torch.arange(mb, device=dev)
    for s in range(su.u.shape[1]):
        rec = _claim_step(
            pol, mb, params, su, st, su.u[:, s], su.stalls[:, s], sparams, ov
        )
        ptr_s = rec.ptr + rec.shed if serving else rec.ptr
        start = rec.q * m + ptr_s
        idx = start[:, None] + off
        base = torch.where(
            ptr_s > 0, _pick(cs_pad, rec.q * m + (ptr_s - 1).clamp(min=0)), 0.0
        )
        span = cs_pad.gather(1, idx) - base[:, None]
        comp = rec.t1[:, None] + span * rec.slow[:, None]
        window = torch.where(off < rec.k[:, None], comp, done_qr.gather(1, idx))
        done_qr.scatter_(1, idx, window)
        if serving:
            for at, width in ((rec.q * m + rec.ptr, rec.shed), (start, rec.k)):
                cidx = at[:, None] + off
                row = clm_qr.gather(1, cidx) | (off < width[:, None])
                clm_qr.scatter_(1, cidx, row)
    done = done_qr.gather(1, su.qid * m + su.rank)
    if serving:
        return st, done, clm_qr.gather(1, su.qid * m + su.rank)
    return st, done, torch.isfinite(done)


def _percentile(x: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile`` (linear) along the last axis, same arithmetic:
    float32 rank ``pct / 100 * (n - 1)``, then ``lo * (1 - f) + hi * f``
    over the sorted row.  A wedged lane's +inf tail gives +inf, as in
    the reference (``torch.quantile`` would give NaN, and caps size)."""
    n = x.shape[-1]
    q = np.float32(pct) / np.float32(100.0) * np.float32(n - 1)
    lo = min(max(math.floor(q), 0), n - 1)
    hi = min(max(math.ceil(q), 0), n - 1)
    hw = np.float32(q - np.float32(math.floor(q)))
    lw = np.float32(1.0) - hw
    s = torch.sort(x, dim=-1).values
    return s[..., lo] * float(lw) + s[..., hi] * float(hw)


def _segment_outputs(st, done, arr, n: int, return_times: bool) -> dict:
    """The non-serving outputs of one segment (the reference's
    ``_sweep_core`` epilogue), without the claim check, which the fused
    call runs once for every segment."""
    ratio, max_dist = reorder_metrics(done)
    sojourn = done - arr
    # undelivered items (wedged lanes) carry done=+inf: the recovery edge
    # is the last finite completion, which also bounds the busy span
    drain_t = torch.where(torch.isfinite(done), done, -_INF).amax(dim=1)
    items = st.items
    i32 = torch.int32
    return dict(
        p50=_percentile(sojourn, 50.0),
        p99=_percentile(sojourn, 99.0),
        # summed in float64: XLA's float32 summation order is its own
        mean=(sojourn.double().sum(dim=1) / n).float(),
        reorder_pct=100.0 * ratio,
        max_distance=max_dist.to(i32),
        throughput=n / (drain_t - arr.amin(dim=1)),
        batches=st.batches.to(i32),
        items=items.to(i32),
        deschedules=st.deschs.to(i32),
        reclaimed=st.reclaimed.to(i32),
        duplicates=st.dups.to(i32),
        undelivered=(n - items).to(i32),
        drain_t=drain_t,
        offered=torch.full_like(items, n, dtype=i32),
        shed=torch.zeros_like(items, dtype=i32),
        slo_attained=items.float() / n,
        attempts=torch.full_like(items, n, dtype=i32),
        delivered=items.to(i32),
        expired=torch.zeros_like(items, dtype=i32),
        goodput=items.to(i32),
        dup_served=torch.zeros_like(items, dtype=i32),
        sojourn=sojourn if return_times else sojourn[:, :0],
    )


def _masked_percentile(svals, n_del, qv: float):
    """``np.percentile`` (linear) over the first ``n_del`` entries of each
    sorted row (+inf tail: undelivered), in the reference's arithmetic:
    the rank ``qv / 100 * (nd - 1)`` in float32."""
    nd = n_del.clamp(min=1)
    pos = _f32(qv / 100.0) * (nd - 1).float()
    lo = torch.floor(pos).long()
    frac = pos - lo.float()
    vlo = svals.gather(1, lo[:, None]).squeeze(1)
    vhi = svals.gather(1, torch.minimum(lo + 1, nd - 1)[:, None]).squeeze(1)
    # an exact rank skips the lerp (vhi may be the +inf pad of an empty
    # lane, and 0 * inf would be NaN)
    return torch.where(frac > 0, vlo + frac * (vhi - vlo), vlo)


def _serving_outputs(st, done, su, sp, ov, return_times: bool) -> dict:
    """The serving outputs of one segment (the reference's serving
    epilogue).  Only delivered requests have latencies: a served copy
    counts delivered when its response survives ``drop_rate`` (counter
    hash on request and attempt) and, with a timeout armed, returns
    within it; a request is good when any of its copies is (scatter-min
    of the copies' completions over ``parent``), later timely copies
    are duplicate work."""
    i32 = torch.int32
    served = torch.isfinite(done)
    lost = hash_u01(su.lseed[:, None] ^ _DROP_SALT, su.parent, su.att)
    delivered = served & ~(lost < sp.drop_rate[:, None])
    attempts = su.offered
    if ov.extended:
        delivered = delivered & (done <= su.arr + _f32(ov.timeout))
        first_ok = torch.full_like(su.arr0, _INF).scatter_reduce(
            1, su.parent, torch.where(delivered, done, _INF), "amin"
        )
        deliv_req = torch.isfinite(first_ok)
        sojourn = torch.where(deliv_req, first_ok - su.arr0, _INF)
        arr_lat, offered = su.arr0, su.offered_req
    else:
        sojourn = torch.where(delivered, done - su.arr, _INF)
        deliv_req, arr_lat, offered = delivered, su.arr, su.offered
    n_del = deliv_req.sum(dim=1)
    svals = torch.sort(sojourn, dim=1).values
    ok = deliv_req & (sojourn <= sp.slo_target[:, None])
    drain_t = torch.where(served, done, -_INF).amax(dim=1)
    span = (drain_t - arr_lat.amin(dim=1)).clamp(min=_f32(1e-9))
    n_deliv_cp = delivered.sum(dim=1)
    ratio, max_dist = reorder_metrics(done)
    return dict(
        p50=_masked_percentile(svals, n_del, 50.0),
        p99=_masked_percentile(svals, n_del, 99.0),
        # summed in float64: XLA's float32 summation order is its own
        mean=(
            torch.where(deliv_req, sojourn, 0.0).double().sum(dim=1)
            / n_del.clamp(min=1)
        ).float(),
        reorder_pct=100.0 * ratio,
        max_distance=max_dist.to(i32),
        throughput=st.items / span,
        batches=st.batches.to(i32),
        items=st.items.to(i32),
        deschedules=st.deschs.to(i32),
        reclaimed=st.reclaimed.to(i32),
        duplicates=st.dups.to(i32),
        undelivered=(attempts - st.items - st.shed).to(i32),
        drain_t=drain_t,
        offered=offered.to(i32),
        shed=st.shed.to(i32),
        slo_attained=(ok.sum(dim=1) / offered.clamp(min=1)).float(),
        attempts=attempts.to(i32),
        delivered=n_deliv_cp.to(i32),
        expired=(st.items - n_deliv_cp).to(i32),
        goodput=n_del.to(i32),
        dup_served=(n_deliv_cp - n_del).to(i32),
        sojourn=sojourn if return_times else sojourn[:, :0],
    )


# ----------------------------------------------------------------------
# The fused entry point: every policy segment, one claim-check launch
# ----------------------------------------------------------------------
def _lane_tensors(d: dict, cls, lanes: int, device):
    vals = []
    for f in cls._fields:
        v = torch.as_tensor(np.asarray(d[f], dtype=np.float32), device=device)
        if v.dim() == 0:
            v = v.expand(lanes)
        if v.shape != (lanes,):
            raise ValueError(f"param {f!r} has shape {tuple(v.shape)}, want ({lanes},)")
        vals.append(v.contiguous())
    return cls(*vals)


def _resolve_policy(policy) -> TorchPolicy:
    if isinstance(policy, TorchPolicy):
        return policy
    from .policy import make_torch_policy

    return make_torch_policy(policy)


def _fused_lanes(
    requests,
    *,
    workload: str = "udp",
    service: str = "fwd",
    n_packets: int = 2000,
    n_workers: int = 4,
    max_batch: int = 64,
    n_flows: int = 256,
    engine: str = "compacted",
    serving: bool = False,
    claim_budget: int | None = None,
    chunk: int = 64,
    shards: int | str = 1,
    prefix_impl: str = "auto",
    return_times: bool = False,
    timings: dict | None = None,
    device=None,
    setups=None,
):
    """Simulate every lane of every request; one :class:`LaneResult` each.

    ``requests`` are dicts ``{"policy", "seeds", "lane_params",
    "traffic_params", "fault_params", "serving_params"}``, one lane
    segment each.  The supported surface is
    :func:`repro_torch.core.run_sweep`.  ``serving`` (or any request
    with ``serving_params``) switches the open-loop serving scenario on:
    ``n_packets`` is then each lane's generation capacity, the
    per-lane horizon decides how much of it is offered, and the static
    overload knobs in ``serving_params`` (``timeout``, ``retries``, ...)
    may expand each request into attempt copies; every segment then
    shares ``n_packets * max copies per request`` slots.
    ``claim_budget`` bounds claims per lane (rounded up to a multiple of
    ``chunk``); the default, the slot count, always suffices, and a
    tighter one fails loudly (exactly-once counters short).  ``timings``
    receives ``compile_s`` (kernel build and load) and ``run_s`` (the
    sweep, between two device synchronisations).  ``setups``
    (internal, one per request, from :func:`setups_from_reference`)
    replaces the port's own draws.

    ``shards=N > 1`` (or ``"auto"``: the default process group's world
    size) splits the lane axis over the N ranks of the default process
    group, each of which makes this same call on its own ``device``
    (:mod:`repro_torch.core.shard`): rank r scans the r-th slice of every
    segment padded to a multiple of N, the ranks all-gather the per-lane
    outputs and each runs the claim check on every lane and returns every
    result; ``timings`` then also receives ``gather_s``.
    """
    dev = compat.resolve_device(device)
    n_shards = compat.resolve_shards(shards)
    rank = dist.get_rank() if n_shards > 1 else 0
    requests = list(requests)
    if not requests:
        raise ValueError("_fused_lanes: empty request list")
    serving = serving or any(req.get("serving_params") for req in requests)
    if engine not in ("compacted", "reference"):
        raise ValueError(f"unknown engine {engine!r}")
    if setups is not None and len(setups) != len(requests):
        raise ValueError("setups: one per request")
    chunk = max(1, int(chunk))
    n = int(n_packets)

    segs = []
    for req in requests:
        seeds = np.asarray(req["seeds"], dtype=np.uint32).reshape(-1)
        lp = default_lane_params(**(req.get("lane_params") or {}))
        tp = default_traffic_params(**(req.get("traffic_params") or {}))
        fp = default_fault_params(**(req.get("fault_params") or {}))
        sp = default_serving_params(**(req.get("serving_params") or {}))
        ov = _pop_overload(sp)  # static knobs, before the knob check
        unknown = set(lp) - set(LaneParams._fields)
        unknown |= set(tp) - set(TrafficParams._fields)
        unknown |= set(fp) - set(FaultParams._fields)
        unknown |= set(sp) - set(ServingParams._fields)
        if unknown:
            raise ValueError(f"unknown sweep knobs: {sorted(unknown)}")
        lanes = len(seeds)
        if n_shards > 1:
            lp, tp, fp, sp = (shard_knobs(d, lanes, n_shards, rank) for d in (lp, tp, fp, sp))
            seeds = shard_seeds(seeds, n_shards, rank)
        segs.append((_resolve_policy(req["policy"]), seeds, lp, tp, fp, sp, ov, lanes))
    # every segment shares the attempt-slot shape: requests x the largest
    # copy fan-out (1 without retry knobs); it and the budget are fixed
    # before the split, so every rank scans to the same bound
    n_slots = n * max(seg[6].cpr for seg in segs)
    budget = n_slots if claim_budget is None else int(claim_budget)
    budget = max(1, min(budget, n_slots))
    s_pad = -(-budget // chunk) * chunk

    t_start = time.perf_counter()
    if dev.type == "cuda":
        doneprefix._claim_launcher()  # build and load the kernel library
        torch.cuda.synchronize(dev)
    t_built = time.perf_counter()

    total = sum(len(seg[1]) for seg in segs)
    # every segment writes its claimed masks into its rows of one buffer:
    # the claim check then runs once over all of them
    claimed_all = torch.empty((total, n_slots), dtype=torch.bool, device=dev)
    outs, at = [], 0
    for i, (pol, seeds, lp, tp, fp, sp, ov, whole) in enumerate(segs):
        lanes = len(seeds)
        rows = claimed_all[at : at + lanes]
        params = _lane_tensors(lp, LaneParams, lanes, dev)
        sparams = _lane_tensors(sp, ServingParams, lanes, dev) if serving else None
        if setups is None:
            su = _lane_setup(
                pol,
                workload,
                service,
                n,
                n_flows,
                n_workers,
                s_pad,
                _lane_tensors(tp, TrafficParams, lanes, dev),
                _lane_tensors(fp, FaultParams, lanes, dev),
                seeds,
                n_slots=n_slots,
                sparams=sparams,
                ov=ov,
            )
        else:
            su = setups[i]
            if n_shards > 1:
                su = shard_setup(su, whole, n_shards, rank)
            want = (lanes, n_workers, n_slots)
            if tuple(su.cumsvc.shape) != want or su.u.shape[1] < s_pad:
                raise ValueError(
                    f"setup {i}: cumsvc {tuple(su.cumsvc.shape)} (want {want}), "
                    f"{su.u.shape[1]} draws (want >= {s_pad})"
                )
            if serving and su.offered is None:
                raise ValueError(f"setup {i}: no serving fields for a serving call")
        if engine == "compacted":
            st, done, _ = _compacted_lanes(
                pol, max_batch, params, su, n, chunk, sparams, ov, out=rows
            )
        else:
            st, done, claimed = _reference_lanes(
                pol, max_batch, params, su, sparams, ov
            )
            rows.copy_(claimed)
        if serving:
            outs.append(_serving_outputs(st, done, su, sparams, ov, return_times))
        else:
            outs.append(_segment_outputs(st, done, su.arr, n, return_times))
        at += lanes

    if n_shards > 1:
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_gather = time.perf_counter()
        outs, claimed_all = _gather_segments(outs, claimed_all, segs, n_shards)
        if timings is not None:
            timings["gather_s"] = time.perf_counter() - t_gather
    # exactly-once: pack, count and prefix every lane of every segment in
    # one launch; the bit width and the cap are the slot count
    _, popcount, prefix = kernel_ops.claim_check(
        claimed_all, n_slots, n_bits=n_slots, impl=prefix_impl
    )
    results, at = [], 0
    for o in outs:
        lanes = o["p50"].shape[0]
        o["claimed_popcount"] = popcount[at : at + lanes]
        o["claimed_prefix"] = prefix[at : at + lanes]
        results.append(LaneResult(**{f: o[f] for f in LaneResult._fields}))
        at += lanes
    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        timings["compile_s"] = t_built - t_start
        timings["run_s"] = t_end - t_built
    return results


def _gather_segments(outs, claimed, segs, n_shards: int):
    """Every rank's per-lane outputs and claimed rows, segment by segment,
    gathered in rank order with the padding dropped: the unsharded
    call's ``outs`` and claimed buffer, on every rank."""
    whole_outs, rows, at = [], [], 0
    for o, seg in zip(outs, segs):
        local, lanes = len(seg[1]), seg[7]
        got = all_gather_lanes(
            dict(o, claimed=claimed[at : at + local]), n_shards, lanes
        )
        rows.append(got.pop("claimed"))
        whole_outs.append(got)
        at += local
    return whole_outs, torch.cat(rows)


def lane_grid(axes: dict, seeds) -> Tuple[dict, list]:
    """Cartesian sweep helper: {knob: values} x seeds -> per-lane arrays.

    Returns ``(lane_arrays, points)``: ``lane_arrays`` maps each knob to
    a [n_configs * n_seeds] array (seed-major within each config) plus
    ``"__seeds__"``, and ``points`` lists one (config dict, seed) pair
    per lane.
    """
    names = sorted(axes)
    grids = np.meshgrid(*[np.asarray(axes[k]) for k in names], indexing="ij")
    flat = [g.reshape(-1) for g in grids]
    n_cfg = flat[0].shape[0] if flat else 1
    seeds = np.asarray(seeds)
    lane_arrays = {k: np.repeat(v, seeds.shape[0]) for k, v in zip(names, flat)}
    seed_lanes = np.tile(seeds, n_cfg)
    points = []
    for c in range(n_cfg):
        cfg = {k: flat[i][c].item() for i, k in enumerate(names)}
        for s in seeds:
            points.append((cfg, int(s)))
    lane_arrays["__seeds__"] = seed_lanes
    return lane_arrays, points
