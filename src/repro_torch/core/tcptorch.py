"""The TCP lane engine of the port: ``repro.core.tcpjax`` in PyTorch.

The closed loop of the reference -- senders -> access link ->
policy-driven forwarder -> receiver -> ACKs -> the window -- restated
over an explicit lane dimension.  One step retires one run of events
on every lane at once, the earliest of

* **send**: the flow whose window opened earliest puts a burst of up to
  ``send_burst`` segments (holes first, then new data) on the
  serialised access link and appends them to its steering queue's
  arrival log;
* **claim**: the batch claim of :mod:`repro_torch.core.torchplane` on
  those logs (``queue_heads``, ``rows_arrived``, ``steal_choice`` and
  the :class:`~repro_torch.core.torchplane.TorchPolicy` flags); the
  claimed transmission ids go into a packed claim bitmap;
* **ack**: delivery and ACK processing, per event under NewReno, or
  every ACK up to the next send decision in one masked pass under the
  SACK scoreboard (``tcp_params={"sack": True}``);
* **RTO**: when nothing else is pending and a flow is unfinished.

After the scan, the exactly-once check takes the claim bitmaps of every
lane of every policy segment and runs ``ops.done_prefix_packed`` once
(on a CUDA tensor the words route of ``csrc/done_prefix.cu``):
popcount == done prefix == transmissions on every lane.

Packed bitmaps (receiver, drop-once, claim, SACK scoreboard) are the
reference's uint32 words held in int64, masked to the low 32 bits:
``~`` is ``x ^ 0xFFFFFFFF`` and every shift result is masked.

Exact parity with the reference on its own draws
(:func:`tcp_setups_from_reference`) needs its floating-point order.
XLA on the CPU computes ``jnp.cumsum`` over a claim window in blocks of
16 (a sequential prefix inside each block plus the exclusive prefix of
the block totals, blocked the same way) and ``jnp.sum`` over more than
32 elements in blocks of 32 (the window padded by half the slack on
either side, a sequential sum inside each block, then over the block
totals); ``torchplane._xla_cumsum`` and ``torchplane._xla_sum`` write
those orders out, so they round the same on the CPU and on the card.

The step has no data-dependent host control flow: the only
device-to-host read is the chunk boundary's all-lanes-quiet check.
Draws come from each lane's own CPU ``torch.Generator``, as in
:mod:`~repro_torch.core.torchplane`, so ``shards=N`` (the lane axis
over the N ranks of a process group, :mod:`repro_torch.core.shard`)
leaves every lane's result as it was.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import compat
from ..kernels import doneprefix
from ..kernels import ops as kernel_ops
from ..kernels import ref as kref
from .shard import all_gather_lanes, shard_knobs, shard_seeds, shard_setup
from .torchplane import (
    FaultParams,
    LaneParams,
    _chunked_scan,
    _lane_tensors,
    _pick,
    _resolve_policy,
    _xla_cumsum,
    _xla_sum,
    default_fault_params,
    default_lane_params,
    hash_u01,
    queue_heads,
    rows_arrived,
    steal_choice,
)

__all__ = [
    "TcpParams",
    "TcpLaneResult",
    "default_tcp_params",
    "tcp_lane_defaults",
    "tcp_setups_from_reference",
    "run_tcp_lanes",
    "run_tcp_lanes_fused",
]

_M32 = kref.MASK32
_INF = math.inf
#: block width of the reference's hierarchical ACK-time min; the tack
#: array pads the transmission budget to whole blocks
_ABLK = 32


class TcpParams(NamedTuple):
    """Per-lane TCP and path knobs (each field a [lanes] float32 tensor),
    the fields of ``repro.core.tcpjax.TcpParams``."""

    service_mean: torch.Tensor  # per-packet forwarding cost
    service_jitter: torch.Tensor  # lognormal sigma on service
    prop_delay: torch.Tensor  # one-way propagation
    link_pps: torch.Tensor  # sender link rate (packets per unit time)
    init_cwnd: torch.Tensor
    cubic_beta: torch.Tensor  # multiplicative decrease
    rwnd: torch.Tensor  # receive-window cap (packets)
    init_reorder_thresh: torch.Tensor  # dup-ACK fast-retransmit threshold
    max_reorder_thresh: torch.Tensor  # tcp_max_reordering analogue
    rto: torch.Tensor  # coarse retransmission timer
    pkt_budget: torch.Tensor  # per-lane cap on packets per flow
    loss_every: torch.Tensor  # drop the 1st arrival of every k-th segment (0 = off)
    loss_rate: torch.Tensor  # random drop probability per segment (0.0 = off)
    loss_burst: torch.Tensor  # mean loss-burst length in segments (1.0 = Bernoulli)


def default_tcp_params(**kw) -> dict:
    d = dict(
        service_mean=1.0,
        service_jitter=0.35,
        prop_delay=25.0,
        link_pps=0.85,
        init_cwnd=10,
        cubic_beta=0.7,
        rwnd=512,
        init_reorder_thresh=3,
        max_reorder_thresh=300,
        rto=5_000.0,
        pkt_budget=1 << 30,  # effectively uncapped; exact in fp32
        loss_every=0,
        loss_rate=0.0,
        loss_burst=1.0,
    )
    d.update(kw)
    return d


def tcp_lane_defaults(**kw) -> dict:
    """Claim-knob defaults of the TCP plane (not the forwarder's)."""
    d = default_lane_params(
        claim_overhead=0.6, deschedule_prob=2e-4, deschedule_mean=150.0
    )
    d.update(kw)
    return d


class TcpLaneResult(NamedTuple):
    """Per-lane outputs of one TCP policy segment (the fields of
    ``repro.core.tcpjax.TcpLaneResult``; integers are int32)."""

    fct: torch.Tensor  # [lanes, F] flow completion time (inf if unfinished)
    done: torch.Tensor  # [lanes, F] flow finished within the step budget
    retransmissions: torch.Tensor  # [lanes, F]
    spurious: torch.Tensor  # [lanes, F] DSACK-detected spurious retransmits
    delivered: torch.Tensor  # [lanes, F] receiver's contiguous delivered prefix
    sends: torch.Tensor  # [lanes] transmissions put on the link
    batches: torch.Tensor  # [lanes] forwarder claims
    items: torch.Tensor  # [lanes] transmissions claimed
    deschedules: torch.Tensor  # [lanes]
    claimed_popcount: torch.Tensor  # [lanes] set bits in the claim bitmap
    claimed_prefix: torch.Tensor  # [lanes] done prefix of that bitmap


# ----------------------------------------------------------------------
# Packed-bit helpers, batched over every leading dim (words: int64 low 32)
# ----------------------------------------------------------------------
def _not32(x: torch.Tensor) -> torch.Tensor:
    """uint32 complement of int64-held words."""
    return x ^ _M32


def _bit(pos: torch.Tensor) -> torch.Tensor:
    """``1 << (pos & 31)`` as an int64 word."""
    return torch.bitwise_left_shift(torch.ones_like(pos), pos & 31)


def _trailing_ones(x: torch.Tensor) -> torch.Tensor:
    """Trailing-ones count of each word."""
    y = _not32(x)
    low = y & -y  # lowest set bit of ~x (0 when x is full)
    return torch.where(x == _M32, 32, kref.popcount32(low - 1))


def _recv_prefix(words: torch.Tensor, m_bits: int) -> torch.Tensor:
    """Contiguous received prefix of each packed row ([..., mw] -> [...]):
    the first word that is not full, and its trailing ones."""
    not_full = words != _M32
    idx = not_full.to(torch.uint8).argmax(dim=-1)  # first not-full word (0: none)
    w = words.gather(-1, idx[..., None]).squeeze(-1)
    bits = idx * 32 + _trailing_ones(w)
    bits = torch.where(not_full.any(dim=-1), bits, words.shape[-1] * 32)
    return bits.clamp(max=m_bits)


def _popcnt_rows(words: torch.Tensor) -> torch.Tensor:
    """Set bits per packed row ([..., mw] -> [...])."""
    return kref.popcount32(words).sum(dim=-1)


def _high_seq(words: torch.Tensor) -> torch.Tensor:
    """Highest set bit of each packed row (-1 when empty): the highest
    bit of the last non-zero word, i.e. the largest ``32 j + hb_j`` over
    the non-zero words."""
    w = words
    for s in (1, 2, 4, 8, 16):
        w = w | (w >> s)
    hb = kref.popcount32(w) - 1
    base = torch.arange(words.shape[-1], device=words.device) * 32
    return torch.where(words != 0, base + hb, -1).amax(dim=-1)


def _bit_range(lo: torch.Tensor, hi: torch.Tensor, mw: int) -> torch.Tensor:
    """Packed mask with bits ``lo..hi`` (inclusive) set, empty if hi < lo
    ([...] x2 -> [..., mw])."""
    base = torch.arange(mw, device=lo.device) * 32
    lo_rel = (lo[..., None] - base).clamp(0, 32)
    hi_rel = (hi[..., None] + 1 - base).clamp(0, 32)
    n = (hi_rel - lo_rel).clamp(0, 32)
    one = torch.ones_like(n)
    body = torch.where(n >= 32, _M32, torch.bitwise_left_shift(one, n) - 1)
    out = torch.bitwise_left_shift(body, lo_rel) & _M32
    return torch.where(n > 0, out, 0)


# ----------------------------------------------------------------------
# Lane setup: draws, state
# ----------------------------------------------------------------------
@dataclass
class _TcpSetup:
    """One policy segment's per-lane draws and derived constants."""

    svc_pad: torch.Tensor  # [L, tx_budget + 1] fp32 service times, 0 pad
    u: torch.Tensor  # [L, S] fp32 deschedule uniforms, one per step
    stalls: torch.Tensor  # [L, S] fp32 unit exponential stall lengths
    lseed: torch.Tensor  # [L] int64 lane seed (uint32 value), the loss hash key
    neff: torch.Tensor | None = None  # [L, F + 1] effective flow sizes, dump 0
    crash_w: torch.Tensor | None = None  # [L, W] fp32 crash time (+inf: never)
    slow_w: torch.Tensor | None = None  # [L, W] fp32 service multiplier


def _tcp_draws(tcp: TcpParams, seeds, tx_budget: int, n_steps: int) -> _TcpSetup:
    """Every lane's draws from its own CPU generator in a fixed order
    (lognormal service per transmission, a deschedule uniform and a unit
    exponential stall per step), so a lane's draws depend on its seed
    and parameters only."""
    dev = tcp.service_mean.device
    z, u, e = [], [], []
    for seed in seeds:
        g = torch.Generator().manual_seed(int(seed))
        z.append(torch.randn(tx_budget, generator=g))
        u.append(torch.rand(n_steps, generator=g))
        e.append(torch.empty(n_steps).exponential_(generator=g))
    sj = tcp.service_jitter[:, None]
    mu = torch.log(tcp.service_mean[:, None]) - sj**2 / 2
    svc = torch.exp(torch.stack(z).to(dev) * sj + mu)
    return _TcpSetup(
        svc_pad=torch.nn.functional.pad(svc, (0, 1)).contiguous(),
        u=torch.stack(u).to(dev),
        stalls=torch.stack(e).to(dev),
        lseed=torch.as_tensor(np.asarray(seeds, dtype=np.int64), device=dev),
    )


def tcp_setups_from_reference(consts: dict, device="cpu") -> _TcpSetup:
    """The reference's per-lane ``_tcp_setup`` draws (a dict of [lanes,
    ...] arrays ``svc_pad``, ``u``, ``stalls``, ``lseed``) as the port's
    tensors: this system's state, carried across."""
    dev = compat.resolve_device(device)

    def t(key, dtype):
        a = np.asarray(consts[key])
        if dtype == torch.int64:
            a = a.astype(np.int64)  # uint32 seeds
        return torch.tensor(a, dtype=dtype, device=dev).contiguous()

    f32 = torch.float32
    return _TcpSetup(
        svc_pad=t("svc_pad", f32),
        u=t("u", f32),
        stalls=t("stalls", f32),
        lseed=t("lseed", torch.int64).reshape(-1),
    )


def _tcp_state0(lanes, tcp, t_start, f_cnt, max_pkts, w_cnt, mb, tb, sack, sb) -> dict:
    """Initial closed-loop state on the lane axis.  Per-flow fields carry
    a dump slot F that masked updates land in, as in the reference.  The
    queue logs carry no dump row: a step that sends nothing writes its
    burst window back unchanged, so it may use any real row."""
    dev = tcp.init_cwnd.device
    mw = (max_pkts + 31) // 32  # receiver bitmap words per flow
    tw = (tb + 31) // 32  # claim bitmap words
    nbk = (tb + 31) // _ABLK
    f1 = f_cnt + 1
    i64, f32 = torch.int64, torch.float32

    def full(shape, val, dtype):
        return torch.full((lanes, *shape), val, dtype=dtype, device=dev)

    ts_pad = torch.cat([t_start, t_start.new_full((1,), _INF)])
    st = dict(
        cwnd=tcp.init_cwnd[:, None].expand(lanes, f1).clone(),
        ssthresh=full((f1,), _INF, f32),
        next_seq=full((f1,), 0, i64),
        high_ack=full((f1,), -1, i64),
        dup=full((f1,), 0, i64),
        infl=full((f1,), 0, i64),
        retx=full((f1,), 0, i64),
        spur=full((f1,), 0, i64),
        reo=tcp.init_reorder_thresh.to(i64)[:, None].expand(lanes, f1).clone(),
        cwnd_before=full((f1,), 0.0, f32),
        last_retx=full((f1,), -1, i64),
        pend=full((f1,), -1, i64),  # single-slot retransmit queue
        done=full((f1,), False, torch.bool),
        t_done=full((f1,), 0.0, f32),
        t_ready=ts_pad.expand(lanes, f1).clone(),
        # receiver: packed seen-bitmap per flow, and the drop-once bitmap
        rwords=full((f1, mw), 0, i64),
        dwords=full((f1, mw), 0, i64),
        # access link and transmission records (send_burst slack past
        # the budget; tack padded to whole blocks plus the dump slot)
        link_free=full((), 0.0, f32),
        nsend=full((), 0, i64),
        txf=full((tb + sb,), 0, i64),
        txs=full((tb + sb,), 0, i64),
        tack=full((nbk * _ABLK + 1,), _INF, f32),
        # forwarder: per-queue arrival logs and the batch-claim state
        qidx=full((w_cnt, tb + max(mb, sb)), tb, i64),
        qarr=full((w_cnt, tb + sb), _INF, f32),
        qapp=full((w_cnt,), 0, i64),
        qptr=full((w_cnt,), 0, i64),
        freet=full((w_cnt,), 0.0, f32),
        lockt=full((), 0.0, f32),
        words=full((tw + 1,), 0, i64),
        batches=full((), 0, i64),
        items=full((), 0, i64),
        deschs=full((), 0, i64),
        t_now=full((), 0.0, f32),
        quiet=full((), False, torch.bool),
    )
    if sack:
        # rtxp: holes awaiting retransmission; rtxd: resent, not yet
        # cumulatively acked; rec_pt: the recovery point
        st.update(
            rtxp=full((f1, mw), 0, i64),
            rtxd=full((f1, mw), 0, i64),
            in_rec=full((f1,), False, torch.bool),
            rec_pt=full((f1,), -1, i64),
        )
    return st


# ----------------------------------------------------------------------
# The batched-event step
# ----------------------------------------------------------------------
@dataclass
class _Static:
    """The shapes and index vectors a segment's steps share."""

    pol: object
    f_cnt: int
    max_pkts: int
    w_cnt: int
    mb: int
    tb: int
    sack: bool
    sb: int
    t_start: torch.Tensor  # [F] fp32 flow start times
    qid_flow: torch.Tensor  # [F] steering queue of each flow
    frng: torch.Tensor  # [F + 1]
    wrng: torch.Tensor  # [W]
    ii: torch.Tensor  # [sb]
    jj: torch.Tensor  # [mb]

    @property
    def mw(self) -> int:
        return (self.max_pkts + 31) // 32

    @property
    def tw(self) -> int:
        return (self.tb + 31) // 32

    @property
    def nbk(self) -> int:
        return (self.tb + 31) // _ABLK


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[l, idx[l], :]`` of a [L, n, m] tensor -> [L, m]."""
    return x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[2])).squeeze(1)


def _tcp_step(
    c: _Static, lp: LaneParams, tcp: TcpParams, su: _TcpSetup, st: dict, u, stall
):
    """One batched-event step on every lane: replaces ``st``'s entries.

    The lane-batched ``repro.core.tcpjax._tcp_step``, field for field.
    Each read of a pre-step value is taken before its field is replaced
    (the step never writes a tensor in place).  ``u``/``stall`` [L] are
    this step's draws.
    """
    pol, f_cnt, w_cnt, mb, tb, sb = c.pol, c.f_cnt, c.w_cnt, c.mb, c.tb, c.sb
    mw, tw, nbk = c.mw, c.tw, c.nbk
    lanes = u.shape[0]
    neff = su.neff
    spacing = 1.0 / tcp.link_pps
    beta = tcp.cubic_beta[:, None]
    max_reo = tcp.max_reorder_thresh.to(torch.int64)
    ii, frng = c.ii, c.frng

    # ---- candidate event times ------------------------------------
    wnd = torch.minimum(st["cwnd"], tcp.rwnd[:, None]).to(torch.int64)
    if c.sack:
        has_rtx = (st["rtxp"] != 0).any(dim=-1)
    else:
        has_rtx = st["pend"] >= 0
    can_send = (
        ~st["done"]
        & (st["infl"] < wnd)
        & (has_rtx | (st["next_seq"] < neff))
        & (st["nsend"] < tb)[:, None]
    )
    tsf = torch.where(can_send, st["t_ready"], _INF)
    tsf_min, f_sel = tsf.min(dim=1)  # ties: first index, as jnp.argmin
    t_send = torch.where(
        torch.isfinite(tsf_min), torch.maximum(tsf_min, st["link_free"]), _INF
    )

    heads = queue_heads(st["qarr"], st["qptr"])
    if pol.steals:
        arr_next = heads.amin(dim=1, keepdim=True)
    elif pol.shared:
        arr_next = heads[:, :1]
    else:
        arr_next = heads
    t_cand = torch.maximum(st["freet"], arr_next)
    if pol.uses_lock:
        t_cand = torch.maximum(t_cand, st["lockt"][:, None])
    # a worker whose next claim would land at/after its crash is dead
    t_cand = torch.where(t_cand >= su.crash_w, _INF, t_cand)
    t_claim, w_sel = t_cand.min(dim=1)

    # the reference's two-level ACK-time min (block mins, then the first
    # minimal block, then the first minimum inside it) is the flat first
    # minimum over the same blocks
    t_ack, j_sel = st["tack"][:, : nbk * _ABLK].min(dim=1)

    live = ~st["done"] & (neff > 0)
    any_live = live.any(dim=1)
    idle = ~(torch.isfinite(t_send) | torch.isfinite(t_claim) | torch.isfinite(t_ack))
    t_rto = torch.where(any_live & idle, st["t_now"], _INF)
    t_ev, ev = torch.stack([t_send, t_claim, t_ack, t_rto], dim=1).min(dim=1)
    act = torch.isfinite(t_ev)
    st["t_now"] = torch.where(act, t_ev, st["t_now"])
    ms = act & (ev == 0)
    mc = act & (ev == 1)
    ma = act & (ev == 2)
    mr = act & (ev == 3)
    # every flow finished and nothing in flight: the lane never changes again
    st["quiet"] = ~any_live & idle

    # ---- send: a window burst onto the link in one step -------------
    fd = torch.where(ms, f_sel, f_cnt)
    oh_fd = frng == fd[:, None]
    base = torch.where(ms, t_send, st["link_free"])
    ns_fd = _pick(st["next_seq"], fd)
    infl_fd = _pick(st["infl"], fd)
    space = (_pick(wnd, fd) - infl_fd).clamp(min=0)
    if c.sack:
        holes = kernel_ops.first_set_bits(_row(st["rtxp"], fd), sb).to(torch.int64)
        nh = (holes >= 0).sum(dim=1)
    else:
        pend_fd = _pick(st["pend"], fd)
        nh = (pend_fd >= 0).to(torch.int64)
        holes = torch.where(ii == 0, pend_fd[:, None], -1)
    fresh = (_pick(neff, fd) - ns_fd).clamp(min=0)
    room = tb - st["nsend"]
    n_take = torch.minimum(torch.minimum(space, nh + fresh), room.clamp(max=sb))
    n_take = torch.where(ms, n_take, 0)
    take = ii < n_take[:, None]
    n_rtx = torch.minimum(nh, n_take)
    is_rtx = ii < n_rtx[:, None]
    seqs = torch.where(is_rtx, holes, ns_fd[:, None] + ii - nh[:, None])
    st["next_seq"] = st["next_seq"] + torch.where(oh_fd, (n_take - n_rtx)[:, None], 0)
    st["infl"] = st["infl"] + torch.where(oh_fd, n_take[:, None], 0)
    if c.sack:
        # move the retransmitted holes rtxp -> rtxd: distinct bits, so an
        # add-scatter builds the delta
        wi_h = torch.where(is_rtx, holes >> 5, mw)
        dh = torch.zeros((lanes, mw + 1), dtype=torch.int64, device=u.device)
        dh.scatter_add_(1, wi_h, torch.where(is_rtx, _bit(holes), 0))
        dh_f = torch.where(oh_fd[:, :, None], dh[:, None, :mw], 0)
        st["rtxp"] = st["rtxp"] & _not32(dh_f)
        st["rtxd"] = st["rtxd"] | dh_f
    else:
        st["pend"] = torch.where(oh_fd & (n_rtx > 0)[:, None], -1, st["pend"])
    departs = base[:, None] + spacing[:, None] * (ii + 1).to(torch.float32)
    st["link_free"] = torch.where(
        ms, base + spacing * n_take.to(torch.float32), st["link_free"]
    )
    # the burst into the tx records and the steering queue's log: the
    # reference's dynamic slices as gathers and scatters at per-lane
    # offsets (nsend <= tx_budget and qapp <= tx_budget keep every window
    # inside its row)
    at0 = st["nsend"]
    tx_i = at0[:, None] + ii
    st["txf"] = st["txf"].scatter(
        1, tx_i, torch.where(take, fd[:, None], st["txf"].gather(1, tx_i))
    )
    st["txs"] = st["txs"].scatter(
        1, tx_i, torch.where(take, seqs, st["txs"].gather(1, tx_i))
    )
    st["nsend"] = at0 + n_take
    row = c.qid_flow[f_sel.clamp(max=f_cnt - 1)]
    pos = _pick(st["qapp"], row)
    m_i, m_a = st["qidx"].shape[2], st["qarr"].shape[2]
    qi = (row * m_i + pos)[:, None] + ii
    qa = (row * m_a + pos)[:, None] + ii
    qidx = st["qidx"].view(lanes, -1)
    qarr = st["qarr"].view(lanes, -1)
    qidx = qidx.scatter(1, qi, torch.where(take, tx_i, qidx.gather(1, qi)))
    qarr = qarr.scatter(
        1, qa, torch.where(take, departs + tcp.prop_delay[:, None], qarr.gather(1, qa))
    )
    st["qidx"] = qidx.view(st["qidx"].shape)
    st["qarr"] = qarr.view(st["qarr"].shape)
    st["qapp"] = st["qapp"] + torch.where(c.wrng == row[:, None], n_take[:, None], 0)

    # ---- claim: the batch claim on the dynamic logs -----------------
    t0 = torch.where(mc, t_claim, 0.0)
    if pol.steals:
        q, backlog_q = steal_choice(st["qarr"], st["qptr"], w_sel, t0)
        backlog = _pick(backlog_q, q)
    elif pol.shared:
        q = torch.zeros_like(w_sel)
        backlog = rows_arrived(st["qarr"], t0)[:, 0] - st["qptr"][:, 0]
    else:
        q = w_sel
        backlog = _pick(rows_arrived(st["qarr"], t0), q) - _pick(st["qptr"], q)
    ptr = _pick(st["qptr"], q)
    k = pol.next_batch(backlog, lp, w_cnt)
    k = torch.minimum(k.clamp(min=1), backlog.clamp(max=mb))
    k = torch.where(mc, k, 0)
    desch = mc & (u < lp.deschedule_prob)
    stall_t = torch.where(desch, stall * lp.deschedule_mean, 0.0)
    t1 = t0 + lp.claim_overhead + stall_t
    gi = (q * m_i + ptr)[:, None] + c.jj
    g = st["qidx"].view(lanes, -1).gather(1, gi)
    valid = c.jj < k[:, None]
    gj = torch.where(valid, g, tb)
    slow = _pick(su.slow_w, w_sel)
    sv = torch.where(valid, su.svc_pad.gather(1, gj), 0.0) * slow[:, None]
    comp = t1[:, None] + _xla_cumsum(sv)
    tack_v = torch.where(valid, comp + 2 * tcp.prop_delay[:, None], _INF)
    st["tack"] = st["tack"].scatter(1, gj, tack_v)  # duplicates: the dump, all inf
    t_end = t1 + _xla_sum(sv)
    st["freet"] = torch.where(
        (c.wrng == w_sel[:, None]) & mc[:, None], t_end[:, None], st["freet"]
    )
    if pol.uses_lock:
        st["lockt"] = torch.where(mc, t1, st["lockt"])
    st["qptr"] = st["qptr"] + torch.where(c.wrng == q[:, None], k[:, None], 0)
    widx = torch.where(valid, gj >> 5, tw)
    delta = torch.zeros((lanes, tw + 1), dtype=torch.int64, device=u.device)
    delta.scatter_add_(1, widx, torch.where(valid, _bit(gj), 0))
    st["words"] = st["words"] | delta
    st["batches"] = st["batches"] + mc
    st["items"] = st["items"] + k
    st["deschs"] = st["deschs"] + desch

    # ---- ack: delivery + ACK processing -----------------------------
    li = tcp.loss_every.to(torch.int64)
    lim = li.clamp(min=1)
    lb = tcp.loss_burst.to(torch.int64).clamp(min=1)
    if not c.sack:
        _ack_newreno(c, tcp, su, st, ma, t_ack, j_sel, li, lim, lb, max_reo, beta)
    else:
        _ack_sack(c, tcp, su, st, ma, t_send, t_ack, li, lim, lb, max_reo, beta)

    # ---- RTO sweep: everything stalled, resend from the hole --------
    mrf = mr[:, None] & live
    missing_r = st["high_ack"] + 1
    cond = mrf & (missing_r < neff)
    st["ssthresh"] = torch.where(
        mrf, torch.clamp(st["cwnd"] * beta, min=2.0), st["ssthresh"]
    )
    st["cwnd"] = torch.where(mrf, tcp.init_cwnd[:, None], st["cwnd"])
    st["infl"] = torch.where(mrf, 0, st["infl"])
    if c.sack:
        # a timeout voids the scoreboard: the resent marks are forgotten
        # and just the first hole is re-marked
        st["rtxd"] = torch.where(mrf[:, :, None], 0, st["rtxd"])
        st["in_rec"] = st["in_rec"] & ~mrf
        mr_wi = (missing_r >> 5).clamp(0, mw - 1)
        mr_bit = _bit(missing_r)
        cur_r = st["rtxp"].gather(2, mr_wi[:, :, None]).squeeze(2)
        fresh_mark = cond & ((cur_r & mr_bit) == 0)
        st["retx"] = st["retx"] + fresh_mark
        marked = cur_r | torch.where(fresh_mark, mr_bit, 0)
        st["rtxp"] = st["rtxp"].scatter(2, mr_wi[:, :, None], marked[:, :, None])
    else:
        st["dup"] = torch.where(mrf, 0, st["dup"])
        st["retx"] = st["retx"] + (cond & (st["pend"] != missing_r))
        st["pend"] = torch.where(cond, missing_r, st["pend"])
        st["last_retx"] = torch.where(cond, missing_r, st["last_retx"])
    st["t_ready"] = torch.where(
        mrf, (st["t_now"] + tcp.rto)[:, None], st["t_ready"]
    )


def _ack_newreno(c, tcp, su, st, ma, t_ack, j_sel, li, lim, lb, max_reo, beta):
    """The per-event ACK path: consume the single earliest ACK."""
    f_cnt, tb, mw = c.f_cnt, c.tb, c.mw
    lanes = ma.shape[0]
    beta = beta[:, 0]
    jad = torch.where(ma, j_sel, tb)
    fa = _pick(st["txf"], jad)
    sa = _pick(st["txs"], jad)
    st["tack"] = st["tack"].scatter(1, jad[:, None], _INF)  # consume
    fad = torch.where(ma, fa, f_cnt)
    oh = c.frng == fad[:, None]
    t_a = torch.where(ma, t_ack, 0.0)
    bsh = sa & 31
    bitv = _bit(sa)
    # the receiver drops the first arrival of every loss_every-th segment
    # once (dwords), or of a segment whose counter hash (lane seed, flow,
    # seq block) lands under loss_rate; a dropped segment sends no ACK
    sched = (li > 0) & ((sa + 1) % lim == 0)
    u_loss = hash_u01(su.lseed, fa, sa // lb)
    sched = sched | (u_loss < tcp.loss_rate)
    fw = (fad * mw + (sa >> 5))[:, None]
    dwords = st["dwords"].view(lanes, -1)
    dw = dwords.gather(1, fw).squeeze(1)
    drop = ma & sched & ((dw & bitv) == 0)
    dwords = dwords.scatter(1, fw, (dw | torch.where(drop, bitv, 0))[:, None])
    st["dwords"] = dwords.view(st["dwords"].shape)
    rwords = st["rwords"].view(lanes, -1)
    old_w = rwords.gather(1, fw).squeeze(1)
    dup_seg = ((old_w >> bsh) & 1) == 1  # DSACK: the receiver saw it before
    rwords = rwords.scatter(1, fw, (old_w | torch.where(drop, 0, bitv))[:, None])
    st["rwords"] = rwords.view(st["rwords"].shape)
    pref = _recv_prefix(_row(st["rwords"], fad), c.max_pkts)
    ackno = pref - 1  # cumulative ACK == received prefix - 1

    alive = ma & ~drop & ~_pick(st["done"], fad)
    # spurious retransmit: raise the reordering threshold + Eifel undo
    dsk = alive & dup_seg
    spur = _pick(st["spur"], fad) + dsk
    reo0 = _pick(st["reo"], fad)
    reo = torch.where(dsk, torch.minimum(reo0 + 4, max_reo), reo0)
    cwb = _pick(st["cwnd_before"], fad)
    cw0 = _pick(st["cwnd"], fad)
    cw = torch.where(dsk & (cwb > cw0), cwb, cw0)
    # cumulative advance: window growth + completion check
    ha = _pick(st["high_ack"], fad)
    adv = alive & (ackno > ha)
    newly = (ackno - ha).to(torch.float32)
    infl0 = _pick(st["infl"], fad)
    infl = torch.where(adv, (infl0 - (ackno - ha)).clamp(min=0), infl0)
    ss = _pick(st["ssthresh"], fad)
    growth = torch.where(cw < ss, newly, newly / cw)
    cw = torch.where(adv, cw + growth, cw)
    ha = torch.where(adv, ackno, ha)
    neff_a = _pick(su.neff, fad)
    done_now = adv & (ackno >= neff_a - 1)
    done = _pick(st["done"], fad) | done_now
    t_done = torch.where(done_now, t_a, _pick(st["t_done"], fad))
    # dup-ACK path: fast retransmit at the adaptive threshold
    dup0 = _pick(st["dup"], fad)
    dupinc = alive & ~adv & ~dup_seg
    dnew = dup0 + 1
    fire = dupinc & (dnew >= reo)
    missing = ha + 1
    last_retx = _pick(st["last_retx"], fad)
    pend = _pick(st["pend"], fad)
    do_rtx = fire & (missing < neff_a) & (missing != last_retx) & (pend < 0)
    pend = torch.where(do_rtx, missing, pend)
    retx = _pick(st["retx"], fad) + do_rtx
    last_retx = torch.where(do_rtx, missing, last_retx)
    infl = torch.where(do_rtx, (infl - 1).clamp(min=0), infl)
    ss_cut = torch.clamp(cw * beta, min=2.0)
    cwb = torch.where(do_rtx, cw, cwb)
    ss = torch.where(do_rtx, ss_cut, ss)
    cw = torch.where(do_rtx, ss_cut, cw)
    dup = torch.where(adv | fire, 0, torch.where(dupinc, dnew, dup0))
    # the window may have opened: the flow can send again at t_a
    t_ready = torch.where(alive & ~done_now, t_a, _pick(st["t_ready"], fad))
    for key, val in (
        ("spur", spur),
        ("reo", reo),
        ("cwnd", cw),
        ("cwnd_before", cwb),
        ("infl", infl),
        ("ssthresh", ss),
        ("high_ack", ha),
        ("done", done),
        ("t_done", t_done),
        ("dup", dup),
        ("pend", pend),
        ("retx", retx),
        ("last_retx", last_retx),
        ("t_ready", t_ready),
    ):
        st[key] = torch.where(oh, val[:, None], st[key])


def _ack_sack(c, tcp, su, st, ma, t_send, t_ack, li, lim, lb, max_reo, beta):
    """The batched SACK path: retire every ACK maturing before the next
    send decision in one masked pass (all updates order-free per flow)."""
    f_cnt, tb, mw = c.f_cnt, c.tb, c.mw
    lanes = ma.shape[0]
    f1, nbits = f_cnt + 1, mw * 32
    neff = su.neff
    t_barrier = torch.where(ma, torch.maximum(t_send, t_ack), -_INF)
    tack = st["tack"]
    m_all = (tack <= t_barrier[:, None]) & torch.isfinite(tack)
    m = m_all[:, :tb]
    ta_j = tack[:, :tb]
    fa_j = st["txf"][:, :tb]
    sa_j = st["txs"][:, :tb]
    fad_j = torch.where(m, fa_j, f_cnt)
    sa_c = sa_j.clamp(0, nbits - 1)
    bit_j = _bit(sa_c)
    # loss: among same-seq copies in one batch only the earliest undropped
    # arrival may drop (DES order); random loss ORs into the schedule
    sched_j = (li[:, None] > 0) & ((sa_j + 1) % lim[:, None] == 0)
    u_loss_j = hash_u01(su.lseed[:, None], fa_j, sa_j // lb[:, None])
    sched_j = sched_j | (u_loss_j < tcp.loss_rate[:, None])
    fw_j = fad_j * mw + (sa_c >> 5)
    seen_j = (st["dwords"].view(lanes, -1).gather(1, fw_j) & bit_j) != 0
    cand_j = m & sched_j & ~seen_j
    fs_j = fad_j * nbits + sa_c
    tmin_seq = torch.full((lanes, f1 * nbits), _INF, device=ta_j.device)
    tmin_seq.scatter_reduce_(
        1, fs_j, torch.where(cand_j, ta_j, _INF), "amin", include_self=True
    )
    drop_j = cand_j & (ta_j <= tmin_seq.gather(1, fs_j))
    deliv_j = m & ~drop_j
    # OR-scatters as counts: duplicate (flow, seq) pairs add, > 0 is set
    stage = torch.zeros((lanes, f1 * nbits), dtype=torch.int32, device=ta_j.device)
    stage.scatter_add_(1, fs_j, deliv_j.to(torch.int32))
    dstage = torch.zeros_like(stage).scatter_add_(1, fs_j, drop_j.to(torch.int32))

    def pack(counts):
        w = kernel_ops.pack_bits_u32((counts > 0).view(lanes, f1, nbits))
        return w.to(torch.int64) & _M32

    old_rw = st["rwords"]
    new_rw = old_rw | pack(stage)
    st["rwords"] = new_rw
    st["dwords"] = st["dwords"] | pack(dstage)
    st["tack"] = torch.where(m_all, _INF, tack)
    # per-flow batch aggregates
    arr_f = stage.view(lanes, f1, nbits).sum(dim=2)
    tmin_f = torch.full((lanes, f1), _INF, device=ta_j.device).scatter_reduce_(
        1, fad_j, torch.where(deliv_j, ta_j, _INF), "amin", include_self=True
    )
    tmax_f = torch.full((lanes, f1), -_INF, device=ta_j.device).scatter_reduce_(
        1, fad_j, torch.where(deliv_j, ta_j, -_INF), "amax", include_self=True
    )
    pref_f = _recv_prefix(new_rw, c.max_pkts)
    ackno_f = pref_f - 1
    alive_f = ~st["done"]  # pre-batch completion state
    # DSACK: every arrival that set no new bit is a duplicate
    dup_f = (arr_f - (_popcnt_rows(new_rw) - _popcnt_rows(old_rw))).clamp(min=0)
    dsk_f = alive_f & (dup_f > 0)
    st["spur"] = st["spur"] + torch.where(dsk_f, dup_f, 0)
    st["reo"] = torch.where(
        dsk_f, torch.minimum(st["reo"] + 4 * dup_f, max_reo[:, None]), st["reo"]
    )
    undo_f = dsk_f & (st["cwnd_before"] > st["cwnd"])
    st["cwnd"] = torch.where(undo_f, st["cwnd_before"], st["cwnd"])
    # cumulative advance (aggregated growth; no growth in recovery)
    adv_f = alive_f & (ackno_f > st["high_ack"])
    newly_f = (ackno_f - st["high_ack"]).to(torch.float32)
    grow_f = adv_f & ~st["in_rec"]
    growth = torch.where(st["cwnd"] < st["ssthresh"], newly_f, newly_f / st["cwnd"])
    st["cwnd"] = torch.where(grow_f, st["cwnd"] + growth, st["cwnd"])
    st["high_ack"] = torch.where(adv_f, ackno_f, st["high_ack"])
    done_now_f = adv_f & (ackno_f >= neff - 1)
    st["done"] = st["done"] | done_now_f
    st["t_done"] = torch.where(done_now_f, tmax_f, st["t_done"])
    # scoreboard upkeep: drop marks below the cumulative ack, then close
    # the recovery episode once the ack passes its point
    keep = _not32(_bit_range(torch.zeros_like(st["high_ack"]), st["high_ack"], mw))
    st["rtxp"] = st["rtxp"] & keep
    st["rtxd"] = st["rtxd"] & keep
    exit_f = adv_f & st["in_rec"] & (ackno_f >= st["rec_pt"])
    st["rtxd"] = torch.where(exit_f[:, :, None], 0, st["rtxd"])
    st["in_rec"] = st["in_rec"] & ~exit_f
    # FACK-style marking: a hole is lost once the highest SACKed seq runs
    # reorder_thresh past it; all such holes, one window cut per episode
    cut_hi = torch.minimum(_high_seq(new_rw) - st["reo"], neff - 1)
    lost_f = _bit_range(pref_f, cut_hi, mw)
    lost_f = lost_f & _not32(new_rw) & _not32(st["rtxp"]) & _not32(st["rtxd"])
    n_lost = _popcnt_rows(lost_f)
    mark_f = ma[:, None] & alive_f & ~st["done"] & (n_lost > 0)
    enter_f = mark_f & ~st["in_rec"]
    st["retx"] = st["retx"] + torch.where(mark_f, n_lost, 0)
    st["rtxp"] = torch.where(mark_f[:, :, None], st["rtxp"] | lost_f, st["rtxp"])
    cut = torch.clamp(st["cwnd"] * beta, min=2.0)
    st["cwnd_before"] = torch.where(enter_f, st["cwnd"], st["cwnd_before"])
    st["ssthresh"] = torch.where(enter_f, cut, st["ssthresh"])
    st["cwnd"] = torch.where(enter_f, cut, st["cwnd"])
    st["rec_pt"] = torch.where(enter_f, st["next_seq"] - 1, st["rec_pt"])
    st["in_rec"] = st["in_rec"] | enter_f
    # partial ACK inside recovery: retransmit the first hole now
    fh = pref_f
    part_f = (
        ma[:, None] & adv_f & st["in_rec"] & (ackno_f < st["rec_pt"]) & (fh < neff)
    )
    fh_wi = (fh >> 5).clamp(0, mw - 1)[:, :, None]
    fh_bit = _bit(fh)
    board = (st["rtxp"] | st["rtxd"]).gather(2, fh_wi).squeeze(2)
    pr_f = part_f & ((board & fh_bit) == 0)
    cur_w = st["rtxp"].gather(2, fh_wi).squeeze(2)
    st["rtxp"] = st["rtxp"].scatter(
        2, fh_wi, (cur_w | torch.where(pr_f, fh_bit, 0))[:, :, None]
    )
    st["retx"] = st["retx"] + pr_f
    # RFC 6675 pipe: sent above the cumulative ack, neither SACKed nor
    # marked lost (a resent hole counts via its cleared rtxp bit)
    region = _bit_range(pref_f, st["next_seq"] - 1, mw)
    pipe = _popcnt_rows(region & _not32(new_rw) & _not32(st["rtxp"]))
    st["infl"] = torch.where(ma[:, None], pipe, st["infl"])
    # the window may have opened at the earliest ack in the batch
    rdy_f = alive_f & ~st["done"] & torch.isfinite(tmin_f)
    st["t_ready"] = torch.where(rdy_f, tmin_f, st["t_ready"])


# ----------------------------------------------------------------------
# Outputs and the two engines
# ----------------------------------------------------------------------
def _tcp_outputs(st, su: _TcpSetup, t_start, f_cnt, max_pkts, tb) -> dict:
    tw = (tb + 31) // 32
    i32 = torch.int32
    done = st["done"][:, :f_cnt]
    fct = torch.where(done, st["t_done"][:, :f_cnt] - t_start, _INF)
    words = st["words"][:, :tw]
    pref = _recv_prefix(st["rwords"][:, :f_cnt], max_pkts)
    return dict(
        fct=fct,
        done=done,
        retransmissions=st["retx"][:, :f_cnt].to(i32),
        spurious=st["spur"][:, :f_cnt].to(i32),
        delivered=torch.minimum(pref, su.neff[:, :f_cnt]).to(i32),
        sends=st["nsend"].to(i32),
        batches=st["batches"].to(i32),
        items=st["items"].to(i32),
        deschedules=st["deschs"].to(i32),
        claimed_popcount=_popcnt_rows(words).to(i32),
        words=words,
    )


def _run_segment(c: _Static, lp, tcp, su: _TcpSetup, st: dict, engine: str, chunk):
    """Advance every lane of one segment: ``compacted`` in chunks of
    ``chunk`` steps with one host check of "every lane quiet" before each
    chunk (a quiet lane is a fixed point of the step), ``reference`` every
    step of the budget."""
    u_t = su.u.t().contiguous()
    stall_t = su.stalls.t().contiguous()
    steps = u_t.shape[0]

    def body(s):
        _tcp_step(c, lp, tcp, su, st, u_t[s], stall_t[s])

    if engine == "reference":
        for s in range(steps):
            body(s)
    else:
        _chunked_scan(body, steps, lambda: st["quiet"].all(), chunk)


def _check_static_knobs(tp: dict):
    """Pop ``sack`` and ``send_burst``, the Python-static knobs of a
    segment; returns them (``send_burst`` None when not given)."""
    sack = tp.pop("sack", False)
    if not isinstance(sack, (bool, int, np.bool_)) or isinstance(sack, float):
        raise ValueError("tcp_params['sack'] must be a scalar bool (static)")
    sb = tp.pop("send_burst", None)
    if sb is not None:
        if not isinstance(sb, int) or isinstance(sb, bool) or sb < 1:
            raise ValueError("tcp_params['send_burst'] must be a positive int (static)")
    return bool(sack), sb


def _segment(
    pol,
    seeds,
    lp: dict,
    tp: dict,
    fp: dict,
    sack: bool,
    n_arr,
    t_start,
    n_workers: int,
    max_batch: int,
    tb: int,
    s_pad: int,
    sb: int,
    dev,
    setup=None,
):
    """One policy segment ready to step: ``(static, lane params, tcp
    params, setup, state0)``.  ``setup`` (from
    :func:`tcp_setups_from_reference`) replaces the port's own draws."""
    lanes = len(seeds)
    f_cnt = len(n_arr)
    params = _lane_tensors(lp, LaneParams, lanes, dev)
    tcp = _lane_tensors(tp, TcpParams, lanes, dev)
    fparams = _lane_tensors(fp, FaultParams, lanes, dev)
    if setup is None:
        su = _tcp_draws(tcp, seeds, tb, s_pad)
    else:
        want = (lanes, tb + 1)
        if tuple(setup.svc_pad.shape) != want or setup.u.shape[1] < s_pad:
            raise ValueError(
                f"setup: svc_pad {tuple(setup.svc_pad.shape)} (want {want}), "
                f"{setup.u.shape[1]} draws (want >= {s_pad})"
            )
        su = _TcpSetup(
            setup.svc_pad, setup.u[:, :s_pad], setup.stalls[:, :s_pad], setup.lseed
        )
    # per-lane effective flow sizes: the packet budget lets one lane
    # carry an elephant/mice mix over the shared layout
    n_pad = torch.as_tensor(np.append(n_arr, 0), device=dev)
    pb = tcp.pkt_budget.to(torch.int64).clamp(min=0)
    su.neff = torch.minimum(n_pad[None, :], pb[:, None])
    # per-worker fault axes: crash horizon and service slowdown
    widx = torch.arange(n_workers, dtype=torch.float32, device=dev)
    su.crash_w = torch.where(
        widx == fparams.crash_worker[:, None], fparams.crash_t[:, None], _INF
    )
    su.slow_w = torch.where(
        widx == fparams.straggler_worker[:, None], fparams.straggler[:, None], 1.0
    )
    ts = torch.as_tensor(t_start, device=dev)
    c = _Static(
        pol=pol,
        f_cnt=f_cnt,
        max_pkts=int(n_arr.max()),
        w_cnt=n_workers,
        mb=max_batch,
        tb=tb,
        sack=sack,
        sb=sb,
        t_start=ts,
        qid_flow=pol.select_queue(torch.arange(f_cnt, device=dev), n_workers),
        frng=torch.arange(f_cnt + 1, device=dev),
        wrng=torch.arange(n_workers, device=dev),
        ii=torch.arange(sb, device=dev),
        jj=torch.arange(max_batch, device=dev),
    )
    st = _tcp_state0(
        lanes, tcp, ts, f_cnt, c.max_pkts, n_workers, max_batch, tb, sack, sb
    )
    return c, params, tcp, su, st


def run_tcp_lanes_fused(
    requests,
    *,
    n_pkts=256,
    t_start=None,
    n_workers: int = 4,
    max_batch: int = 64,
    tx_budget: int | None = None,
    n_steps: int | None = None,
    engine: str = "compacted",
    chunk: int = 64,
    shards: int | str = 1,
    prefix_impl: str = "auto",
    timings: dict | None = None,
    device=None,
    setups=None,
):
    """Simulate every TCP lane of every request; one
    :class:`TcpLaneResult` each, in order.

    ``requests`` are dicts ``{"policy", "seeds", "lane_params",
    "tcp_params", "fault_params"}``, one lane segment each, sharing the
    flow layout (``n_pkts``: an int or per-flow counts; ``t_start``:
    per-flow start times, default 0) and the budgets: ``tx_budget``
    transmissions (default 9/8 of the packet total + 32) and ``n_steps``
    events (default ``3 * tx_budget + flows + 64``), rounded up to a
    multiple of ``chunk``.  Flows that do not finish report
    ``done=False`` and an infinite ``fct``.  ``tcp_params`` may carry the
    static knobs ``sack`` (a bool) and ``send_burst`` (an int, equal
    across requests; default 32).  Runs on the CUDA device unless
    ``device="cpu"``; ``timings`` receives ``compile_s`` (kernel build
    and load) and ``run_s`` (the sweep, between two device
    synchronisations).  ``setups`` (internal, one per request, from
    :func:`tcp_setups_from_reference`) replaces the port's own draws.
    ``shards`` splits the lane axis over the ranks of the default process
    group as :func:`repro_torch.core.torchplane._fused_lanes` does; the
    words route then checks the gathered words of every lane on every
    rank.
    """
    if engine not in ("compacted", "reference"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = compat.resolve_device(device)
    n_shards = compat.resolve_shards(shards)
    rank = dist.get_rank() if n_shards > 1 else 0
    requests = list(requests)
    if not requests:
        raise ValueError("run_tcp_lanes_fused: empty request list")
    if setups is not None and len(setups) != len(requests):
        raise ValueError("setups: one per request")
    n_arr = np.atleast_1d(np.asarray(n_pkts, dtype=np.int64))
    f_cnt = int(n_arr.shape[0])
    max_pkts = int(n_arr.max())
    total = int(n_arr.sum())
    if t_start is None:
        t_start = np.zeros(f_cnt, dtype=np.float32)
    t_start = np.asarray(t_start, dtype=np.float32)
    if t_start.shape != (f_cnt,):
        raise ValueError(f"t_start shape {t_start.shape} != ({f_cnt},)")
    tb = total + total // 8 + 32 if tx_budget is None else int(tx_budget)
    if n_steps is None:
        n_steps = 3 * tb + f_cnt + 64
    chunk = max(1, int(chunk))
    s_pad = -(-int(n_steps) // chunk) * chunk

    segs, sb_seen = [], set()
    for req in requests:
        seeds = np.asarray(req["seeds"], dtype=np.uint32).reshape(-1)
        lp = tcp_lane_defaults(**(req.get("lane_params") or {}))
        tp = default_tcp_params(**(req.get("tcp_params") or {}))
        sack, sb = _check_static_knobs(tp)
        if sb is not None:
            sb_seen.add(sb)
        # crash-between-claims + straggler only: claims here never crash
        # mid-batch, so ``lease`` is accepted and has nothing to reclaim
        fp = default_fault_params(**(req.get("fault_params") or {}))
        unknown = set(lp) - set(LaneParams._fields)
        unknown |= set(tp) - set(TcpParams._fields)
        unknown |= set(fp) - set(FaultParams._fields)
        if unknown:
            raise ValueError(f"unknown sweep knobs: {sorted(unknown)}")
        lanes = len(seeds)
        if n_shards > 1:
            lp, tp, fp = (shard_knobs(d, lanes, n_shards, rank) for d in (lp, tp, fp))
            seeds = shard_seeds(seeds, n_shards, rank)
        segs.append((_resolve_policy(req["policy"]), seeds, lp, tp, fp, sack, lanes))
    if len(sb_seen) > 1:
        raise ValueError(
            f"send_burst must agree across fused requests, got {sorted(sb_seen)}"
        )
    sb = sb_seen.pop() if sb_seen else 32

    t_begin = time.perf_counter()
    if dev.type == "cuda":
        doneprefix._launcher()  # build and load the kernel library
        torch.cuda.synchronize(dev)
    t_built = time.perf_counter()

    outs = []
    for i, (pol, seeds, lp, tp, fp, sack, whole) in enumerate(segs):
        setup = None if setups is None else setups[i]
        if setup is not None and n_shards > 1:
            setup = shard_setup(setup, whole, n_shards, rank)
        c, params, tcp, su, st = _segment(
            pol, seeds, lp, tp, fp, sack, n_arr, t_start, n_workers, max_batch,
            tb, s_pad, sb, dev, setup,
        )
        _run_segment(c, params, tcp, su, st, engine, chunk)
        outs.append(_tcp_outputs(st, su, c.t_start, c.f_cnt, c.max_pkts, tb))
    if n_shards > 1:
        # every rank's lanes in rank order, the padding dropped
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_gather = time.perf_counter()
        outs = [all_gather_lanes(o, n_shards, seg[6]) for o, seg in zip(outs, segs)]
        if timings is not None:
            timings["gather_s"] = time.perf_counter() - t_gather

    # exactly-once on the claim bitmaps: every transmission put on the
    # link was claimed by exactly one batch (popcount == prefix == sends),
    # one launch for every lane of every segment
    words = torch.cat([o["words"] for o in outs])
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    sends = torch.cat([o["sends"] for o in outs])
    prefix = kernel_ops.done_prefix_packed(words, sends, n_bits=tb, impl=prefix_impl)
    results, at = [], 0
    for o in outs:
        lanes = o["sends"].shape[0]
        o["claimed_prefix"] = prefix[at : at + lanes]
        results.append(TcpLaneResult(**{f: o[f] for f in TcpLaneResult._fields}))
        at += lanes
    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["compile_s"] = t_built - t_begin
        timings["run_s"] = time.perf_counter() - t_built
    return results


def run_tcp_lanes(
    policy: str,
    seeds,
    n_pkts=256,
    t_start=None,
    lane_params: dict | None = None,
    tcp_params: dict | None = None,
    fault_params: dict | None = None,
    **kw,
) -> TcpLaneResult:
    """One policy's TCP lanes: a single-segment
    :func:`run_tcp_lanes_fused` (see there for the budgets, ``engine``,
    ``chunk`` and ``device``)."""
    return run_tcp_lanes_fused(
        [
            dict(
                policy=policy,
                seeds=seeds,
                lane_params=lane_params,
                tcp_params=tcp_params,
                fault_params=fault_params,
            )
        ],
        n_pkts=n_pkts,
        t_start=t_start,
        **kw,
    )[0]
