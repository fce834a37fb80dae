"""TCP flow scenario layer over a policy-driven forwarder (section 4.3.2).

End-to-end discrete-event simulation of:  senders --> access link -->
L3 forwarder (the device under test) --> receiver --> ACKs --> senders.
The forwarder is the unified DES worker plane (:mod:`repro_torch.core.des`):
k workers draining the queues of any registered ``RxPolicy``
(:mod:`repro_torch.core.policy`) — the COREC shared queue (batch claims,
natural cross-worker reordering), k RSS-hashed per-worker queues
(per-flow in-order, but no work conservation), the locked shared queue,
hybrid stealing, adaptive batching, ...  This layer owns only the TCP
endpoints and the access link; the event heap and worker lifecycle are
the core's.

TCP is CUBIC-flavoured NewReno with the two Linux-5.13 behaviours that
matter for reordering tolerance (the paper runs stock CUBIC on 5.13):

* an *adaptive reordering threshold*: fast retransmit fires at
  ``dup_acks >= reorder_thresh``; detection of a spurious retransmit
  (DSACK: receiver saw a duplicate segment) raises the threshold, exactly
  like Linux's tcp_reordering metric / RACK reo_wnd growth.
* *window undo* on spurious retransmit (Eifel-style): the multiplicative
  decrease is reverted, so only genuinely lost-looking gaps cost window.

The sender access link is explicitly serialized (``link_pps``): for the
single-huge-flow test the path is link-bottlenecked like the paper's
10 Gbps setup, so adding workers cannot speed the flow up — it can only
hurt via reordering, reproducing Table 5's percent-level FCT deltas.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .des import DesItem, EventLoop, WorkerPlane
from .faults import hash_u01
from .policy import make_policy

__all__ = ["TcpSimConfig", "FlowResult", "simulate_tcp"]


@dataclass
class TcpSimConfig:
    policy: str = "corec"  # any registered rx policy name
    n_workers: int = 4
    batch: int = 32
    service_mean: float = 1.0  # per-packet forwarding cost (us)
    service_jitter: float = 0.35  # lognormal sigma on per-packet service
    claim_overhead: float = 0.6  # per-batch claim cost (us)
    deschedule_prob: float = 2e-4  # per-batch chance a worker stalls
    deschedule_mean: float = 150.0  # stall length (us)
    prop_delay: float = 25.0  # one-way propagation (us)
    link_pps: float = 0.85  # sender link rate, packets/us (~10GbE @1500B)
    init_cwnd: int = 10
    cubic_beta: float = 0.7
    rwnd: int = 512  # receive-window cap (packets)
    init_reorder_thresh: int = 3
    max_reorder_thresh: int = 300  # Linux sysctl tcp_max_reordering
    rto: float = 5_000.0  # coarse retransmission timer (us)
    #: SACK-grade recovery (mirrors the lane engine's scoreboard):
    #: FACK-style multi-hole loss marking, one window cut per recovery
    #: episode, partial-ACK retransmit selection, RFC 6675 pipe.
    sack: bool = False
    #: receiver drops the FIRST arrival of every k-th segment (0 = off)
    loss_every: int = 0
    #: random drop probability per segment (0.0 = off); drop-once like
    #: ``loss_every``, scheduled by the counter-hash
    #: :func:`repro_torch.core.faults.hash_u01` on (seed, flow, seq block) —
    #: the lane engine reproduces the exact schedule from the lane seed
    loss_rate: float = 0.0
    #: mean loss-burst length in segments (1.0 = iid Bernoulli): whole
    #: ``loss_burst``-wide seq blocks share one draw, so losses cluster
    #: Gilbert-Elliott-style at unchanged marginal rate
    loss_burst: float = 1.0
    #: cap on packets actually sent per flow (elephant/mice mixes)
    pkt_budget: int = 1 << 30
    seed: int = 0
    policy_kwargs: dict = field(default_factory=dict)
    #: per-flow steering override (flow id -> queue), the indirection-
    #: table hook: parity tests feed the lane engine's 32-bit hash here so
    #: both planes pin flows to the same queues (see the tcptorch docstring).
    queue_hints: Optional[Dict[int, int]] = None


@dataclass
class FlowResult:
    flow_id: int
    n_packets: int
    fct: float  # flow completion time (us)
    retransmissions: int
    spurious: int
    t_start: float


@dataclass
class _Flow:
    fid: int
    n_packets: int
    t_start: float
    cwnd: float = 10.0
    ssthresh: float = float("inf")
    next_to_send: int = 0
    highest_acked: int = -1  # cumulative: all <= this are acked
    dup_acks: int = 0
    in_flight: int = 0
    retx: int = 0
    spurious: int = 0
    reorder_thresh: int = 3
    cwnd_before_cut: float = 0.0
    last_retx_seq: int = -1
    done: bool = False
    t_done: float = 0.0
    recv_buf: set = field(default_factory=set)
    recv_next: int = 0  # receiver's next expected seq
    retx_queue: deque = field(default_factory=deque)
    # SACK scoreboard (cfg.sack): holes awaiting retransmission /
    # already resent but not yet cumulatively acked, plus the recovery
    # episode marker (one window cut per episode)
    retx_pending: set = field(default_factory=set)
    retx_done: set = field(default_factory=set)
    in_rec: bool = False
    rec_pt: int = -1
    dropped_once: set = field(default_factory=set)


def simulate_tcp(
    flows: List[Tuple[int, int, float]],  # (flow_id, n_packets, t_start)
    cfg: TcpSimConfig,
) -> List[FlowResult]:
    rng = np.random.default_rng(cfg.seed)
    fl: Dict[int, _Flow] = {
        fid: _Flow(
            fid=fid,
            n_packets=min(n, cfg.pkt_budget),  # per-lane packet budget
            t_start=t0,
            cwnd=float(cfg.init_cwnd),
            reorder_thresh=cfg.init_reorder_thresh,
        )
        for fid, n, t0 in flows
    }

    # ---- forwarder (the unified DES worker plane) + link state ---------
    loop = EventLoop()
    link_free = [0.0]  # sender NIC serialization horizon
    spacing = 1.0 / cfg.link_pps

    def service_sample(item: DesItem) -> float:
        mu = np.log(cfg.service_mean) - cfg.service_jitter**2 / 2
        return float(rng.lognormal(mu, cfg.service_jitter))

    plane = WorkerPlane(
        loop,
        make_policy(cfg.policy, cfg.n_workers, cfg.batch, **cfg.policy_kwargs),
        cfg.n_workers,
        service_fn=service_sample,
        # forwarded packet -> receiver after propagation
        on_complete=lambda tt, item: loop.schedule(
            tt + cfg.prop_delay, "deliver", item.payload
        ),
        rng=rng,
        claim_overhead=cfg.claim_overhead,
        deschedule_prob=cfg.deschedule_prob,
        deschedule_mean=cfg.deschedule_mean,
    )

    # ---- sender ---------------------------------------------------------
    def try_send(f: _Flow, t: float) -> None:
        wnd = min(f.cwnd, float(cfg.rwnd))
        while (not f.done) and f.in_flight < int(wnd) and (
            f.retx_pending or f.retx_queue or f.next_to_send < f.n_packets
        ):
            if cfg.sack and f.retx_pending:
                # scoreboard drain: lowest hole first, then new data
                seq = min(f.retx_pending)
                f.retx_pending.discard(seq)
                f.retx_done.add(seq)
            elif f.retx_queue:
                seq = f.retx_queue.popleft()
            else:
                seq = f.next_to_send
                f.next_to_send += 1
            f.in_flight += 1
            depart = max(t, link_free[0]) + spacing  # NIC serialization
            link_free[0] = depart
            loop.schedule(depart + cfg.prop_delay, "arrive", (f.fid, seq))

    # ---- receiver ---------------------------------------------------------
    def deliver(t: float, data) -> None:
        fid, seq = data
        f = fl[fid]
        sched = bool(cfg.loss_every) and (seq + 1) % cfg.loss_every == 0
        if cfg.loss_rate > 0.0 and not sched:
            # random loss: counter-hash schedule shared with the lane
            # engine — compare through float32 so the drop decision is
            # bit-identical to the in-scan fp32 comparison
            blk = seq // max(int(cfg.loss_burst), 1)
            sched = np.float32(hash_u01(cfg.seed, fid, blk)) < np.float32(
                cfg.loss_rate
            )
        if sched and seq not in f.dropped_once:
            # loss: the first copy of a loss-scheduled segment is
            # dropped on the floor — no delivery, no ACK (mirrors the
            # lane engine's drop-once dwords bitmap)
            f.dropped_once.add(seq)
            return
        dup = seq < f.recv_next or seq in f.recv_buf  # DSACK condition
        if not dup:
            f.recv_buf.add(seq)
            while f.recv_next in f.recv_buf:
                f.recv_buf.discard(f.recv_next)
                f.recv_next += 1
        loop.schedule(t + cfg.prop_delay, "ack", (fid, f.recv_next - 1, dup))

    # ---- sender ACK processing -------------------------------------------
    def on_ack(t: float, data) -> None:
        fid, ackno, dsack = data
        f = fl[fid]
        if f.done:
            return
        if dsack:
            # Spurious retransmit: raise the reordering threshold
            # (tcp_reordering adaptation) and undo the window cut (Eifel).
            f.spurious += 1
            # Linux raises tcp_reordering to the observed displacement;
            # approximate with additive growth (RACK's reo_wnd steps too).
            f.reorder_thresh = min(f.reorder_thresh + 4, cfg.max_reorder_thresh)
            if f.cwnd_before_cut > f.cwnd:
                # Eifel-style undo of the rate cut, but the flow stays in
                # congestion avoidance (ssthresh keeps the cut value).
                f.cwnd = f.cwnd_before_cut
        if cfg.sack:
            _on_ack_sack(f, t, dsack)
            return
        if ackno > f.highest_acked:
            newly = ackno - f.highest_acked
            f.highest_acked = ackno
            f.in_flight = max(0, f.in_flight - newly)
            f.dup_acks = 0
            if f.cwnd < f.ssthresh:
                f.cwnd += newly  # slow start
            else:
                f.cwnd += newly / f.cwnd  # congestion avoidance
            if f.highest_acked >= f.n_packets - 1:
                f.done = True
                f.t_done = t
                return
        elif not dsack:
            f.dup_acks += 1
            if f.dup_acks >= f.reorder_thresh:  # fast retransmit
                missing = f.highest_acked + 1
                if missing < f.n_packets and missing != f.last_retx_seq:
                    f.retx_queue.append(missing)
                    f.retx += 1
                    f.last_retx_seq = missing
                    f.in_flight = max(0, f.in_flight - 1)
                    f.cwnd_before_cut = f.cwnd
                    f.ssthresh = max(2.0, f.cwnd * cfg.cubic_beta)
                    f.cwnd = f.ssthresh
                f.dup_acks = 0
        try_send(f, t)

    def _on_ack_sack(f: _Flow, t: float, dsack: bool) -> None:
        # SACK-grade recovery, semantically step-matched to the lane
        # engine's scoreboard batch (tcptorch._tcp_step, sack=True): the
        # sender reads the receiver's LIVE state (cumulative prefix +
        # out-of-order set), exactly as the lane engine reads the packed
        # receive bitmap when it consumes an ack batch.
        ackno = f.recv_next - 1
        advanced = ackno > f.highest_acked
        if advanced:
            newly = ackno - f.highest_acked
            f.highest_acked = ackno
            if not f.in_rec:  # no window growth during a recovery episode
                if f.cwnd < f.ssthresh:
                    f.cwnd += newly  # slow start
                else:
                    f.cwnd += newly / f.cwnd  # congestion avoidance
            if f.highest_acked >= f.n_packets - 1:
                f.done = True
                f.t_done = t
                return
        # scoreboard upkeep: drop marks at/below the cumulative prefix
        f.retx_pending = {s for s in f.retx_pending if s > ackno}
        f.retx_done = {s for s in f.retx_done if s > ackno}
        if advanced and f.in_rec and ackno >= f.rec_pt:
            # recovery episode complete: forget resent-but-unacked marks
            f.in_rec = False
            f.retx_done.clear()
        # FACK loss marking: every hole more than reorder_thresh below the
        # highest SACKed seq is presumed lost (multi-hole, one pass)
        high_sack = max(f.recv_buf) if f.recv_buf else ackno
        cut_hi = min(high_sack - f.reorder_thresh, f.n_packets - 1)
        marks = [
            h
            for h in range(ackno + 1, cut_hi + 1)
            if h not in f.recv_buf
            and h not in f.retx_pending
            and h not in f.retx_done
        ]
        if marks:
            f.retx_pending.update(marks)
            f.retx += len(marks)
            if not f.in_rec:  # one window cut per recovery episode
                f.in_rec = True
                f.rec_pt = f.next_to_send - 1
                f.cwnd_before_cut = f.cwnd
                f.ssthresh = max(2.0, f.cwnd * cfg.cubic_beta)
                f.cwnd = f.ssthresh
        if advanced and f.in_rec and ackno < f.rec_pt:
            # partial ACK: the next hole is known-lost, resend immediately
            fh = ackno + 1
            if fh < f.n_packets and fh not in f.retx_pending and fh not in f.retx_done:
                f.retx_pending.add(fh)
                f.retx += 1
        # RFC 6675 pipe: in-flight = sent, not SACKed, not marked lost
        f.in_flight = sum(
            1
            for s in range(ackno + 1, f.next_to_send)
            if s not in f.recv_buf and s not in f.retx_pending
        )
        try_send(f, t)

    # ---- event wiring + RTO safety ---------------------------------------
    hints = cfg.queue_hints or {}
    loop.on("start", lambda t, fid: try_send(fl[fid], t))
    loop.on(
        "arrive",
        lambda t, data: plane.enqueue(
            t,
            DesItem(flow=data[0], payload=data, queue_hint=hints.get(data[0])),
        ),
    )
    loop.on("deliver", deliver)
    loop.on("ack", on_ack)

    def rto_sweep(t: float) -> None:
        # RTO safety: if everything stalls (in-flight accounting drift can
        # strand a window), coarse timeout: reset and resend from the hole.
        for f in fl.values():
            if not f.done:
                f.in_flight = 0
                f.dup_acks = 0
                f.ssthresh = max(2.0, f.cwnd * cfg.cubic_beta)
                f.cwnd = float(cfg.init_cwnd)
                missing = f.highest_acked + 1
                if cfg.sack:
                    # timeout invalidates the resent-but-unacked marks and
                    # the episode; re-mark the first hole for resend
                    f.retx_done.clear()
                    f.in_rec = False
                    if missing < f.n_packets and missing not in f.retx_pending:
                        f.retx_pending.add(missing)
                        f.retx += 1
                elif missing < f.n_packets and missing not in f.retx_queue:
                    f.retx_queue.appendleft(missing)
                    f.retx += 1
                    f.last_retx_seq = missing
                try_send(f, t + cfg.rto)

    for f in fl.values():
        loop.schedule(f.t_start, "start", f.fid)
    loop.run(on_idle=rto_sweep)
    plane.finalize()  # raises StrandedRunError on silent slot-stranding

    return [
        FlowResult(
            flow_id=f.fid,
            n_packets=f.n_packets,
            fct=(f.t_done - f.t_start),
            retransmissions=f.retx,
            spurious=f.spurious,
            t_start=f.t_start,
        )
        for f in fl.values()
    ]
