"""Vectorized PyTorch execution plane: the port of ``repro.core.jaxplane``.

The same receive-side model as the JAX reference, restated over an
explicit lane dimension instead of ``vmap``:

* one step = one batch claim on every lane at once: the worker with the
  earliest feasible claim time takes ``next_batch(backlog)`` packets
  from its queue.  The step carries only O(workers) state per lane and
  emits one :class:`ClaimRecord` per lane;
* after the scan, one batched scatter rebuilds every packet's
  completion time from the records, the claimed mask is packed into
  32-bit words (:func:`repro_torch.kernels.ops.pack_bits_u32`), and the
  exactly-once check (popcount == done prefix == items) runs through the
  CUDA done-prefix kernel, one launch for every lane of every policy;
* the scan is a Python loop over chunks of ``chunk`` steps with one host
  check of the "every lane drained or wedged" predicate per chunk --
  the reference's ``lax.cond`` short-circuit.  The scan state lives in
  tensors that each step updates in place (the reference's carry is
  immutable; here that would allocate a copy of every field per step).

The fault plane (crash truncation, lease gating, scale-out failover,
straggler inflation) is part of the step; every fault expression is an
exact identity at its default (``+inf`` crash time and lease, 1.0
service multiplier).  ``engine="reference"`` keeps the per-claim scan
that writes each claim's completion window inside the step; the tests
pin the compacted engine to it bit for bit.

Traffic is drawn per lane from a CPU ``torch.Generator`` seeded with
the lane's seed, so a lane's draws depend on its seed and parameters
only (fused == per-policy runs; lane count cannot shift draws) and do
not depend on the device.  ``torch`` draws differ from ``jax.random``,
so parity with the reference on own draws is distributional; exact
parity is held on the reference's own draws carried across with
:func:`setups_from_reference`.

Not yet ported (each raises by name): serving/overload mode, the TCP
lane engine, lane sharding and the heavy-tailed ``HT`` service kind.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import compat
from ..kernels import doneprefix
from ..kernels import ops as kernel_ops

__all__ = [
    "TorchPolicy",
    "LaneParams",
    "TrafficParams",
    "FaultParams",
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
_NOT_PORTED = "not ported yet: ROADMAP.md Queue A, item {}"


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
        out["u"].append(torch.rand(n_draws, generator=g))
        out["stall"].append(torch.empty(n_draws).exponential_(generator=g))
    return {k: torch.stack(v) for k, v in out.items() if v}


def _gen_traffic(draws, tp: TrafficParams, workload: str, service: str):
    """Arrival times, service times and flow ids of every lane, [L, n]."""
    col = {f: getattr(tp, f)[:, None] for f in TrafficParams._fields}
    z = draws["gap"]
    if workload == "udp":
        arr = torch.cumsum(z / col["rate"], dim=1)
        sizes = col["pkt_size"]
    elif workload == "mawi":
        sigma = col["burstiness"]
        mu = torch.log(1.0 / col["rate"]) - sigma**2 / 2
        arr = torch.cumsum(torch.exp(z * sigma + mu), dim=1)
        table = torch.from_numpy(_MAWI_SIZES).to(z.device)
        sizes = table[draws["size"]]
    elif workload == "diurnal":
        # lambda(t) = rate * (1 + amp sin wt) by time-rescaling: invert
        # the cumulative intensity of a unit-rate process by damped
        # Newton (lambda >= rate * (1 - amp) > 0), as the reference does
        s = torch.cumsum(z, dim=1)
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
        raise NotImplementedError(
            "service 'HT' belongs to the serving scenario, " + _NOT_PORTED.format(4)
        )
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
    )


class ClaimRecord(NamedTuple):
    """One batch claim per lane: queue, start rank, size, post-overhead
    time and straggler multiplier.  Masked steps carry ``k == 0`` and
    the dump queue ``W``; ``k`` is the delivered size (a claim cut by
    its worker's crash records only the pre-crash prefix)."""

    q: torch.Tensor
    ptr: torch.Tensor
    k: torch.Tensor
    t1: torch.Tensor
    slow: torch.Tensor


@dataclass
class _LaneSetup:
    """One policy segment's pre-drawn traffic and per-queue views."""

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


def _claim_step(pol, mb, params, su, st, u, stall) -> ClaimRecord:
    """One batch claim on every lane: updates ``st`` in place, returns
    the claims' records.  ``u``/``stall`` [L] are this step's draws.

    The lane-batched ``repro.core.jaxplane._claim_step`` without its
    serving branches, faults included: a worker's busy span is the
    difference of two ``cumsvc`` gathers, and every fault expression is
    an identity at the defaults.
    """
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
    k = pol.next_batch(backlog, params, w_count)
    k = torch.minimum(torch.maximum(k, backlog.clamp(max=1)), backlog.clamp(max=mb))
    k = torch.where(active, k, 0)
    desch = active & (u < params.deschedule_prob)
    stall_t = torch.where(desch, stall * params.deschedule_mean, 0.0)
    t1 = t0 + params.claim_overhead + stall_t
    ptr = _pick(st.qptr, q)
    cs = cumsvc.view(lanes, w_count * n)
    qn = q * n
    base = torch.where(ptr > 0, _pick(cs, qn + (ptr - 1).clamp(min=0)), 0.0)
    # straggler inflation + crash truncation: worker w serves at slow x
    # real time and delivers the longest prefix of its claim that ends
    # strictly before its crash time c
    slow = _pick(su.slow_w, w)
    c = _pick(crash_w, w)
    svc_budget = base + (c - t1) / slow
    fits = rows_arrived(cumsvc, svc_budget)  # same search, over cumsvc rows
    k_eff = _pick(fits, q) - ptr
    k_eff = torch.where(active, torch.minimum(k_eff.clamp(min=0), k), 0)
    crashed = active & (k_eff < k)
    last = _pick(cs, qn + (ptr + k_eff - 1).clamp(0, n - 1))
    t_end = t1 + torch.where(k_eff > 0, (last - base) * slow, 0.0)
    free_w = torch.where(active, t_end, _pick(st.free_t, w))
    free_w = torch.where(crashed, _INF, free_w)
    st.free_t.scatter_(1, w[:, None], free_w[:, None])
    if pol.uses_lock:
        # lock held through claim + stall; a holder dying inside it
        # wedges every peer (the horizon goes to +inf)
        lock_dead = active & (c <= t1)
        st.lock_t = torch.where(active, torch.where(lock_dead, _INF, t1), st.lock_t)
    # a truncated claim strands [ptr + k_eff, ptr + k) until the lease
    lease = su.lease if pol.leases else torch.full_like(su.lease, _INF)
    resume = torch.where(crashed, t0 + lease, _pick(st.resume_t, q))
    st.resume_t.scatter_(1, q[:, None], resume[:, None])
    until = torch.where(crashed, ptr + k, _pick(st.resume_until, q))
    st.resume_until.scatter_(1, q[:, None], until[:, None])
    reclaim = crashed & torch.isfinite(lease)
    st.qptr.scatter_add_(1, q[:, None], k_eff[:, None])
    st.batches += active
    st.items += k_eff
    st.deschs += desch
    st.reclaimed += torch.where(reclaim, k - k_eff, 0)
    st.dups += torch.where(reclaim, k_eff, 0)
    st.halted |= ~active
    has_k = k_eff > 0
    return ClaimRecord(
        q=torch.where(has_k, q, w_count),
        ptr=torch.where(has_k, ptr, 0),
        k=k_eff,
        t1=t1,
        slow=slow,
    )


def _scatter_claims(rec: ClaimRecord, qid, rank, cumsvc):
    """Per-packet completion times from every lane's claim records.

    ``rec`` fields are [L, S].  Scatter each claim's index at its
    (queue, start-rank) slot, forward-fill along ranks with ``cummax``
    (claim indices grow with rank within a queue), then every packet's
    completion is ``t1[claim] + (cumsvc[rank] - cumsvc[start - 1]) *
    slow[claim]``.  Returns ``(done [L, n], claimed [L, n])``.
    """
    lanes, w_count, n = cumsvc.shape
    steps = rec.k.shape[1]
    live = rec.k > 0
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
    k_p = rec.k.long().gather(1, safe)
    slow_p = rec.slow.gather(1, safe)
    cs = cumsvc.view(lanes, w_count * n)
    prev = cs.gather(1, qid * n + (ptr_p - 1).clamp(min=0))
    base_p = torch.where(ptr_p > 0, prev, 0.0)
    claimed = (cid_p >= 0) & (rank < ptr_p + k_p)
    done_t = t1_p + (cs.gather(1, qid * n + rank) - base_p) * slow_p
    return torch.where(claimed, done_t, _INF), claimed


# ----------------------------------------------------------------------
# Lane setup: pre-drawn traffic -> per-queue views
# ----------------------------------------------------------------------
def _lane_setup(
    pol, workload, service, n, n_flows, n_workers, n_draws, traffic, fparams, seeds
):
    """Draw every lane's traffic and build its per-queue views."""
    device = traffic.rate.device
    draws = _lane_draws(seeds, workload, service, n, n_flows, n_draws)
    draws = {k: v.to(device) for k, v in draws.items()}
    arr, svc, flows = _gen_traffic(draws, traffic, workload, service)
    qid = pol.select_queue(flows, n_workers)
    rank = torch.zeros_like(qid)
    for w in range(n_workers):
        m = qid == w
        rank = torch.where(m, torch.cumsum(m, dim=1) - 1, rank)
    lanes = arr.shape[0]
    q_arr = torch.full((lanes, n_workers * (n + 1)), _INF, device=device)
    q_arr.scatter_(1, qid * (n + 1) + rank, arr)
    svc_qr = torch.zeros((lanes, n_workers * n), device=device)
    svc_qr.scatter_(1, qid * n + rank, svc)
    cumsvc = torch.cumsum(svc_qr.view(lanes, n_workers, n), dim=2)
    widx = torch.arange(n_workers, device=device, dtype=torch.float32)
    crash_w = torch.where(
        widx == fparams.crash_worker[:, None], fparams.crash_t[:, None], _INF
    )
    slow_w = torch.where(
        widx == fparams.straggler_worker[:, None], fparams.straggler[:, None], 1.0
    )
    return _LaneSetup(
        arr=arr,
        qid=qid,
        rank=rank,
        q_arr=q_arr.view(lanes, n_workers, n + 1),
        cumsvc=cumsvc,
        u=draws["u"].float(),
        stalls=draws["stall"].float(),
        crash_w=crash_w.float(),
        slow_w=slow_w.float(),
        lease=fparams.lease.float(),
    )


def setups_from_reference(su: dict, device="cpu") -> _LaneSetup:
    """The reference's per-lane ``_lane_setup`` output (a dict of
    [lanes, ...] arrays: ``arr``, ``qid``, ``rank``, ``q_arr``,
    ``cumsvc``, ``u``, ``stalls``, ``crash_w``, ``slow_w``, ``lease``)
    as the port's tensors -- this system's state, carried across."""
    dev = compat.resolve_device(device)

    def t(key, dtype):
        return torch.tensor(np.array(su[key]), dtype=dtype, device=dev)

    f32, i64 = torch.float32, torch.int64
    return _LaneSetup(
        arr=t("arr", f32).contiguous(),
        qid=t("qid", i64).contiguous(),
        rank=t("rank", i64).contiguous(),
        q_arr=t("q_arr", f32).contiguous(),
        cumsvc=t("cumsvc", f32).contiguous(),
        u=t("u", f32).contiguous(),
        stalls=t("stalls", f32).contiguous(),
        crash_w=t("crash_w", f32).contiguous(),
        slow_w=t("slow_w", f32).contiguous(),
        lease=t("lease", f32).reshape(-1).contiguous(),
    )


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


def _compacted_lanes(pol, mb, params, su: _LaneSetup, n: int, chunk: int):
    """Claim-compacted scan + one post-scan scatter."""
    lanes, w_count, _ = su.cumsvc.shape
    steps = su.u.shape[1]
    dev = su.arr.device
    st = _init_state(lanes, w_count, dev)
    u_t, stall_t = su.u.t().contiguous(), su.stalls.t().contiguous()
    recs = ClaimRecord(
        *(torch.zeros((steps, lanes), dtype=torch.int32, device=dev) for _ in range(3)),
        *(torch.zeros((steps, lanes), device=dev) for _ in range(2)),
    )

    def body(s):
        rec = _claim_step(pol, mb, params, su, st, u_t[s], stall_t[s])
        for buf, val in zip(recs, rec):
            buf[s] = val

    def done_fn():
        # a lane is finished when it drained OR wedged (no claimable work
        # remains: dead lock holder, unleased stranded span)
        return (st.halted | (st.items >= n)).all()

    _chunked_scan(body, steps, done_fn, chunk)
    rec_l = ClaimRecord(*(x.t().contiguous() for x in recs))
    done, claimed = _scatter_claims(rec_l, su.qid, su.rank, su.cumsvc)
    return st, done, claimed


def _reference_lanes(pol, mb, params, su: _LaneSetup):
    """The per-claim scan: each claim's completion window is written into
    a (queue, rank) grid inside the step -- the formulation the
    compacted engine is pinned to, bit for bit.  Runs every step."""
    lanes, w_count, n = su.cumsvc.shape
    m = n + mb
    dev = su.arr.device
    cs_pad = torch.zeros((lanes, w_count + 1, m), device=dev)
    cs_pad[:, :w_count, :n] = su.cumsvc
    cs_pad[:, :w_count, n:] = su.cumsvc[:, :, -1:]
    cs_pad = cs_pad.view(lanes, (w_count + 1) * m)
    done_qr = torch.full((lanes, (w_count + 1) * m), _INF, device=dev)
    st = _init_state(lanes, w_count, dev)
    off = torch.arange(mb, device=dev)
    for s in range(su.u.shape[1]):
        rec = _claim_step(pol, mb, params, su, st, su.u[:, s], su.stalls[:, s])
        start = rec.q * m + rec.ptr
        idx = start[:, None] + off
        base = torch.where(
            rec.ptr > 0, _pick(cs_pad, rec.q * m + (rec.ptr - 1).clamp(min=0)), 0.0
        )
        span = cs_pad.gather(1, idx) - base[:, None]
        comp = rec.t1[:, None] + span * rec.slow[:, None]
        window = torch.where(off < rec.k[:, None], comp, done_qr.gather(1, idx))
        done_qr.scatter_(1, idx, window)
    done = done_qr.gather(1, su.qid * m + su.rank)
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


def _segment_outputs(st, done, claimed, arr, n: int, return_times: bool) -> dict:
    """The non-serving outputs of one segment (the reference's
    ``_sweep_core`` epilogue), the packed claim words included."""
    words = kernel_ops.pack_bits_u32(claimed)
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
        claimed_popcount=kernel_ops.popcount32(words).sum(dim=1).to(i32),
        words=words,
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


# ----------------------------------------------------------------------
# The fused entry point: every policy segment, one prefix launch
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
    claim_budget: int | None = None,
    chunk: int = 64,
    prefix_impl: str = "auto",
    return_times: bool = False,
    timings: dict | None = None,
    device=None,
    setups=None,
):
    """Simulate every lane of every request; one :class:`LaneResult` each.

    ``requests`` are dicts ``{"policy", "seeds", "lane_params",
    "traffic_params", "fault_params"}``, one lane segment each.  The
    supported surface is :func:`repro_torch.core.run_sweep`.
    ``claim_budget`` bounds claims per lane (rounded up to a multiple of
    ``chunk``); the default ``n_packets`` always suffices, and a tighter
    one fails loudly (exactly-once counters short).  ``timings``
    receives ``compile_s`` (kernel build and load) and ``run_s`` (the
    sweep, between two device synchronisations).  ``setups`` (internal,
    one per request, from :func:`setups_from_reference`) replaces the
    port's own draws.
    """
    dev = compat.resolve_device(device)
    requests = list(requests)
    if not requests:
        raise ValueError("_fused_lanes: empty request list")
    if any(req.get("serving_params") for req in requests):
        raise NotImplementedError("serving mode is " + _NOT_PORTED.format(4))
    if engine not in ("compacted", "reference"):
        raise ValueError(f"unknown engine {engine!r}")
    if setups is not None and len(setups) != len(requests):
        raise ValueError("setups: one per request")
    chunk = max(1, int(chunk))
    n = int(n_packets)
    budget = n if claim_budget is None else int(claim_budget)
    budget = max(1, min(budget, n))
    s_pad = -(-budget // chunk) * chunk

    t_start = time.perf_counter()
    if dev.type == "cuda":
        doneprefix._launcher()  # build and load the kernel library
        torch.cuda.synchronize(dev)
    t_built = time.perf_counter()

    segs = []
    for i, req in enumerate(requests):
        pol = _resolve_policy(req["policy"])
        seeds = np.asarray(req["seeds"], dtype=np.uint32).reshape(-1)
        lanes = seeds.shape[0]
        lp = default_lane_params(**(req.get("lane_params") or {}))
        tp = default_traffic_params(**(req.get("traffic_params") or {}))
        fp = default_fault_params(**(req.get("fault_params") or {}))
        unknown = set(lp) - set(LaneParams._fields)
        unknown |= set(tp) - set(TrafficParams._fields)
        unknown |= set(fp) - set(FaultParams._fields)
        if unknown:
            raise ValueError(f"unknown sweep knobs: {sorted(unknown)}")
        params = _lane_tensors(lp, LaneParams, lanes, dev)
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
            )
        else:
            su = setups[i]
            want = (lanes, n_workers, n)
            if tuple(su.cumsvc.shape) != want or su.u.shape[1] < s_pad:
                raise ValueError(
                    f"setup {i}: cumsvc {tuple(su.cumsvc.shape)} (want {want}), "
                    f"{su.u.shape[1]} draws (want >= {s_pad})"
                )
        if engine == "compacted":
            st, done, claimed = _compacted_lanes(pol, max_batch, params, su, n, chunk)
        else:
            st, done, claimed = _reference_lanes(pol, max_batch, params, su)
        segs.append(_segment_outputs(st, done, claimed, su.arr, n, return_times))

    # exactly-once on the packed words: one multi-ring prefix launch for
    # every segment of the fused call
    words = torch.cat([o["words"] for o in segs], dim=0)
    prefix = kernel_ops.done_prefix_packed(
        words,
        torch.full((words.shape[0],), n, dtype=torch.int32, device=dev),
        n_bits=n,
        impl=prefix_impl,
    )
    results, at = [], 0
    for o in segs:
        lanes = o["p50"].shape[0]
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
