"""RFC 4737 packet reordering metrics (paper section 4.3).

Implements the metrics the paper reports:

* Type-P-Reordered-Ratio: fraction of packets that arrive with a sequence
  number smaller than one already seen (the 'NextExp' definition, RFC 4737
  section 4.1-4.2).
* Reordering distance / 'max distance' (Table 4): for each reordered
  packet, how many positions later than its in-order slot it arrived
  (RFC 4737 section 4.4 byte/packet offset, packet flavour).
* Reordering extent (section 4.3): lateness relative to the highest
  sequence number seen.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence

import numpy as np

__all__ = ["ReorderReport", "measure_reordering", "per_flow_reordering"]


@dataclass
class ReorderReport:
    n: int
    n_reordered: int
    max_distance: int
    max_extent: int
    distances: List[int]

    @property
    def ratio(self) -> float:
        return self.n_reordered / self.n if self.n else 0.0

    @property
    def pct(self) -> float:
        return 100.0 * self.ratio


def measure_reordering(arrival_seq: Sequence[int]) -> ReorderReport:
    """RFC 4737 over a stream of sequence numbers in arrival order.

    A packet is reordered iff its sequence number is < NextExp, where
    NextExp is 1 + the largest sequence number seen so far.  Extent of a
    reordered packet = (arrival position of the earliest not-yet-arrived
    larger seqno) - simplified to the standard 'lateness in positions'
    computation below.
    """
    next_exp = 0
    n_reordered = 0
    max_extent = 0
    distances: List[int] = []
    # position at which each seqno arrived, for distance computation
    seq = list(arrival_seq)
    n = len(seq)
    arrived_pos = {}
    for pos, s in enumerate(seq):
        arrived_pos[s] = pos
        if s >= next_exp:
            next_exp = s + 1
        else:
            n_reordered += 1
            # extent: how many packets with larger seqno arrived before it
            # (scan back until we find one smaller — RFC 4737 sec 4.3.2)
            extent = 0
            for back in range(pos - 1, -1, -1):
                if seq[back] > s:
                    extent = pos - back
                else:
                    break
            max_extent = max(max_extent, extent)
    # Reordering distance (Table 4 'max distance'): displacement between
    # in-order rank and arrival position.
    order = np.argsort(np.asarray(seq), kind="stable")
    # rank[i] = arrival position of the i-th smallest seqno
    for rank_in_order, pos in enumerate(order):
        d = int(pos) - rank_in_order
        if d > 0 and seq[pos] < max(seq[: pos + 1]):
            distances.append(d)
    return ReorderReport(
        n=n,
        n_reordered=n_reordered,
        max_distance=max(distances) if distances else 0,
        max_extent=max_extent,
        distances=distances,
    )


def per_flow_reordering(
    arrival_order: Iterable[tuple],
) -> dict:
    """Reordering measured *within each flow* (how TCP perceives it).

    ``arrival_order`` yields (flow_id, seqno_within_flow) in global arrival
    order.  Returns {flow_id: ReorderReport} plus an '__all__' aggregate in
    which every packet counts once.
    """
    flows: dict = {}
    for fid, s in arrival_order:
        flows.setdefault(fid, []).append(s)
    reports = {fid: measure_reordering(seqs) for fid, seqs in flows.items()}
    tot = sum(r.n for r in reports.values())
    reord = sum(r.n_reordered for r in reports.values())
    maxd = max((r.max_distance for r in reports.values()), default=0)
    reports["__all__"] = ReorderReport(
        n=tot,
        n_reordered=reord,
        max_distance=maxd,
        max_extent=max((r.max_extent for r in reports.values()), default=0),
        distances=[],
    )
    return reports
