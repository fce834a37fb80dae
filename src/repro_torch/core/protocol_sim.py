"""Deterministic interleaving simulator for the COREC protocol.

Property-based testing of a concurrent algorithm with real threads is
non-deterministic; instead this module re-expresses the exact protocol of
``ring.CorecRing`` as *stepped* coroutines that yield control after every
shared-memory access.  A hypothesis-generated schedule (sequence of actor
ids) then drives an arbitrary interleaving, and invariants are checked
after every single step.  This mirrors how non-blocking algorithms are
model-checked; any safety violation found here is a real bug in the
protocol logic (the atomic ops themselves are executed atomically by
construction — one step at a time).

Keep the step bodies in sync with ring.py; tests/test_ring_properties.py
asserts behavioural equivalence on sequential schedules.

Both of ring.py's data planes are modelled: ``producer``/``consumer`` step
the per-item reference path (one shared access per descriptor), while
``producer_packed``/``consumer_packed`` step the word-packed fast path —
each DD-word snapshot, word-span RMW, fenced batch restamp, and the
head-clamped claim scan is one atomic step, exactly the granularity the
packed CorecRing gets from AtomicBitmap/AtomicU64Array.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Generator, List, Optional, Sequence

__all__ = [
    "SimState",
    "consumer",
    "consumer_packed",
    "producer",
    "producer_packed",
    "run_schedule",
    "ScheduleResult",
]

_WORD = 64


class SimState:
    """Plain-int replica of CorecRing state (steps are atomic by fiat)."""

    def __init__(self, size: int):
        assert size > 0 and size & (size - 1) == 0 and size % _WORD == 0
        self.size = size
        self.mask = size - 1
        self.cells: List[Optional[int]] = [None] * size
        self.seq = list(range(size))
        self.head = 0
        self.published = 0  # slots whose DD stamp is visible (head lags
        # by one micro-step inside produce; single producer => benign)
        self.claim_head = 0
        self.done = [0] * (size // _WORD)
        self.dd = [0] * (size // _WORD)  # packed-plane DD bitmap
        self.tail = 0
        self.tail_lock_owner: Optional[int] = None
        # how far `published` may run ahead of `head`: 1 for the per-item
        # producer (DD stamp then head), up to the burst size for the
        # packed producer (whole burst published before the one doorbell)
        self.max_publish_lag = 1
        # audit trails
        self.claims: List[tuple] = []  # (wid, start, end, payloads)
        self.delivered: List[int] = []
        self.released_upto = 0
        self.produced_payloads: List[int] = []


# ----------------------------------------------------------------------
# actors: generators yielding a label after each atomic shared access
# ----------------------------------------------------------------------
def producer(st: SimState, payloads: Sequence[int]) -> Generator[str, None, None]:
    """Single producer (the NIC): fills slots while it has credit."""
    i = 0
    while i < len(payloads):
        head = st.head
        yield "p:load_head"
        tail = st.tail
        yield "p:load_tail"
        if head - tail >= st.size:
            yield "p:full"
            continue
        idx = head & st.mask
        if st.seq[idx] != head:
            yield "p:slot_busy"
            continue
        st.cells[idx] = payloads[i]
        yield "p:write_cell"
        st.seq[idx] = head + 1  # DD publish
        st.published = head + 1
        st.produced_payloads.append(payloads[i])  # visible from this step
        yield "p:publish_dd"
        st.head = head + 1
        yield "p:advance_head"
        i += 1


def consumer(
    st: SimState, wid: int, max_batch: int = 4, rounds: int = 1 << 30
) -> Generator[str, None, None]:
    """claim -> copy -> complete -> try_release, stepped (Listing 2)."""
    for _ in range(rounds):
        # ---- claim -----------------------------------------------------
        while True:
            start = st.claim_head
            yield f"c{wid}:load_claim_head"
            n = 0
            while n < max_batch:
                t = start + n
                ready = st.seq[t & st.mask] == t + 1
                yield f"c{wid}:dd_scan"
                if not ready:
                    break
                n += 1
            if n == 0:
                yield f"c{wid}:empty"
                break
            # CAS
            ok = st.claim_head == start
            if ok:
                st.claim_head = start + n
            yield f"c{wid}:cas_{'win' if ok else 'fail'}"
            if ok:
                # ---- copy out (exclusive ownership) ---------------------
                payloads = []
                for t in range(start, start + n):
                    idx = t & st.mask
                    payloads.append(st.cells[idx])
                    st.cells[idx] = None
                    yield f"c{wid}:copy"
                st.claims.append((wid, start, start + n, payloads))
                st.delivered.extend(payloads)
                # ---- complete: set READ_DONE bits ----------------------
                t = start
                while t < start + n:
                    word = (t & st.mask) // _WORD
                    bit0 = (t & st.mask) % _WORD
                    span = min(start + n - t, _WORD - bit0)
                    st.done[word] |= ((1 << span) - 1) << bit0
                    yield f"c{wid}:done_or"
                    t += span
                break
        # ---- try_release ------------------------------------------------
        if st.tail_lock_owner is None:
            st.tail_lock_owner = wid
            yield f"c{wid}:trylock_win"
            tail = st.tail
            limit = st.claim_head
            yield f"c{wid}:release_load"
            t = tail
            while t < limit:
                idx = t & st.mask
                if not (st.done[idx // _WORD] >> (idx % _WORD)) & 1:
                    break
                t += 1
                yield f"c{wid}:release_scan"
            for u in range(tail, t):
                idx = u & st.mask
                st.done[idx // _WORD] &= ~(1 << (idx % _WORD))
                st.seq[idx] = u + st.size
                yield f"c{wid}:recycle"
            if t != tail:
                st.tail = t
                st.released_upto = t
            yield f"c{wid}:store_tail"
            st.tail_lock_owner = None
            yield f"c{wid}:unlock"
        else:
            yield f"c{wid}:trylock_fail"


# ----------------------------------------------------------------------
# word-packed actors (ring.py's packed=True plane, stepped)
# ----------------------------------------------------------------------
def _word_run(words, size: int, start: int, limit: int):
    """Stepped trailing-ones scan over a packed bitmap: yields after every
    word snapshot (the one atomic load), finally yields ('run', n)."""
    run = 0
    pos = start % size
    while run < limit:
        b = pos % _WORD
        word = words[pos // _WORD]
        yield "word_load"
        span = min(_WORD - b, limit - run, size - pos)
        window = (word >> b) & ((1 << span) - 1)
        gaps = ~window & ((1 << span) - 1)
        if gaps:
            run += (gaps & -gaps).bit_length() - 1
            break
        run += span
        pos = (pos + span) % size
    yield ("run", run)


def _word_spans(size: int, start: int, n: int):
    pos = start % size
    while n > 0:
        b = pos % _WORD
        span = min(_WORD - b, n, size - pos)
        yield pos // _WORD, ((1 << span) - 1) << b
        pos = (pos + span) % size
        n -= span


def producer_packed(
    st: SimState, payloads: Sequence[int], burst: int = 16
) -> Generator[str, None, None]:
    """Batched producer: burst of cell writes, one fenced seq restamp, one
    DD word publish per word span, ONE head doorbell per burst."""
    st.max_publish_lag = max(st.max_publish_lag, burst)
    i = 0
    while i < len(payloads):
        head = st.head
        yield "P:load_head"
        tail = st.tail
        yield "P:load_tail"
        n = min(burst, len(payloads) - i, st.size - (head - tail))
        if n <= 0:
            yield "P:full"
            continue
        for k in range(n):
            st.cells[(head + k) & st.mask] = payloads[i + k]
        yield "P:write_cells"  # plain stores into producer-owned slots
        for k in range(n):
            st.seq[(head + k) & st.mask] = head + k + 1
        st.published = head + n  # visible to any plane from this fence on
        st.produced_payloads.extend(payloads[i : i + n])
        yield "P:stamp_seq_batch"
        for w, bits in _word_spans(st.size, head & st.mask, n):
            st.dd[w] |= bits
            yield "P:publish_dd_word"
        st.head = head + n
        yield "P:doorbell"
        i += n


def consumer_packed(
    st: SimState, wid: int, max_batch: int = 4, rounds: int = 1 << 30
) -> Generator[str, None, None]:
    """Word-packed claim -> copy -> complete -> try_release (ring.py's
    packed plane): the DD scan is one load per word, the claim is clamped
    at the loaded head (epoch safety), and the release clears/recycles
    whole word spans."""
    for _ in range(rounds):
        # ---- claim (word scan, head-clamped) ---------------------------
        while True:
            start = st.claim_head
            yield f"C{wid}:load_claim_head"
            head = st.head
            yield f"C{wid}:load_head"
            want = min(max_batch, head - start)
            if want <= 0:
                yield f"C{wid}:empty"
                break
            n = 0
            for step in _word_run(st.dd, st.size, start & st.mask, want):
                if isinstance(step, tuple):
                    n = step[1]
                else:
                    yield f"C{wid}:dd_word"
            if n == 0:
                yield f"C{wid}:stale_scan"
                continue
            ok = st.claim_head == start
            if ok:
                st.claim_head = start + n
            yield f"C{wid}:cas_{'win' if ok else 'fail'}"
            if not ok:
                continue
            # ---- copy out (exclusive ownership, plain memory) ----------
            payloads = []
            for t in range(start, start + n):
                idx = t & st.mask
                payloads.append(st.cells[idx])
                st.cells[idx] = None
            yield f"C{wid}:copy_batch"
            st.claims.append((wid, start, start + n, payloads))
            st.delivered.extend(payloads)
            # ---- complete: READ_DONE word spans ------------------------
            for w, bits in _word_spans(st.size, start & st.mask, n):
                st.done[w] |= bits
                yield f"C{wid}:done_or"
            break
        # ---- try_release (word-packed) ---------------------------------
        if st.tail_lock_owner is None:
            st.tail_lock_owner = wid
            yield f"C{wid}:trylock_win"
            tail = st.tail
            limit = st.claim_head
            yield f"C{wid}:release_load"
            freed = 0
            for step in _word_run(st.done, st.size, tail & st.mask, limit - tail):
                if isinstance(step, tuple):
                    freed = step[1]
                else:
                    yield f"C{wid}:done_word"
            if freed:
                for w, bits in _word_spans(st.size, tail & st.mask, freed):
                    st.done[w] &= ~bits
                    yield f"C{wid}:clear_done_word"
                    st.dd[w] &= ~bits
                    yield f"C{wid}:clear_dd_word"
                for u in range(tail, tail + freed):
                    st.seq[u & st.mask] = u + st.size
                yield f"C{wid}:restamp_seq_batch"
                st.tail = tail + freed
                st.released_upto = st.tail
                yield f"C{wid}:store_tail"
            st.tail_lock_owner = None
            yield f"C{wid}:unlock"
        else:
            yield f"C{wid}:trylock_fail"


@dataclass
class ScheduleResult:
    steps: int
    trace: List[str] = field(default_factory=list)


def check_invariants(st: SimState) -> None:
    """Safety invariants of the protocol — asserted after *every* step."""
    # ordering of the cursors.  claim_head is bounded by *published* DD
    # stamps, not by the producer's head (which advances one micro-step
    # after the publish — the store-buffer analogue the paper discusses).
    assert st.tail <= st.claim_head, "tail overran claim_head"
    assert st.claim_head <= st.published, "claimed an unpublished ticket"
    assert (
        st.head <= st.published <= st.head + st.max_publish_lag
    ), "publish/head drift"
    assert st.published - st.tail <= st.size, "producer overran credit"
    # claims are disjoint and within [0, claim_head)
    ivs = sorted((s, e) for _, s, e, _ in st.claims)
    for (s1, e1), (s2, e2) in zip(ivs, ivs[1:]):
        assert e1 <= s2, f"overlapping claims {(s1, e1)} {(s2, e2)}"
    for s, e in ivs:
        assert e <= st.claim_head, "claim beyond claim_head"
    # no payload delivered twice / invented
    assert len(st.delivered) == len(set(st.delivered)), "duplicate delivery"
    assert set(st.delivered) <= set(st.produced_payloads), "phantom delivery"
    # tail only covers completed-and-released tickets: every ticket < tail
    # must belong to some claim
    covered = set()
    for _, s, e, _ in st.claims:
        covered.update(range(s, e))
    for t in range(st.tail):
        assert t in covered, f"released ticket {t} never claimed"


def run_schedule(
    st: SimState,
    actors: Sequence[Generator[str, None, None]],
    schedule: Sequence[int],
    invariant_every_step: bool = True,
) -> ScheduleResult:
    """Drive actors by the schedule; dead actors' turns are skipped."""
    live = list(actors)
    trace: List[str] = []
    steps = 0
    for pick in schedule:
        g = live[pick % len(live)]
        if g is None:
            continue
        try:
            label = next(g)
            trace.append(label)
            steps += 1
        except StopIteration:
            live[pick % len(live)] = None
        if invariant_every_step:
            check_invariants(st)
    return ScheduleResult(steps=steps, trace=trace)
