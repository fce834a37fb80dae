"""Atomic RMW primitives — the CPython analogue of the paper's gcc builtins.

COREC coordinates threads exclusively through Read-Modify-Write machine
instructions (``__sync_bool_compare_and_swap`` / ``__atomic`` builtins,
paper section 3.5).  CPython exposes no CAS on plain ints, so each atomic
variable here carries a private micro-mutex that makes every RMW a single
indivisible step.  The emulation is faithful at the *algorithm* level:

* every critical section is an O(1) single-word update (never held across
  work, never nested),
* a failed CAS costs O(1) and leaves shared state untouched,
* all updates are immediately globally visible (the mutex doubles as the
  store-buffer flush the paper gets from LOCK-prefixed instructions).

The non-blocking properties COREC derives from RMW instructions therefore
hold for every data structure built on top of this module, and are
property-tested in ``tests/test_ring_properties.py``.
"""

from __future__ import annotations

import threading

__all__ = [
    "AtomicU64",
    "AtomicU64Array",
    "AtomicBitmap",
    "AtomicWord",
    "AtomicLease",
    "TryLock",
]

_WORD_BITS = 64
_WORD_MASK = (1 << _WORD_BITS) - 1


class AtomicU64:
    """64-bit atomic counter with load / store / CAS / fetch_add.

    Matches the paper's choice of an ever-growing transaction ID
    (section 3.4.3): 64-bit tickets make ABA wraparound physically
    unreachable (2**64 increments).
    """

    __slots__ = ("_lock", "_value")

    def __init__(self, value: int = 0):
        self._lock = threading.Lock()
        self._value = value & 0xFFFFFFFFFFFFFFFF

    def load(self) -> int:
        # A 64-bit aligned load is atomic on x86; the mutex additionally
        # gives us the acquire fence of ``__atomic_load``.
        with self._lock:
            return self._value

    def store(self, value: int) -> None:
        with self._lock:
            self._value = value & 0xFFFFFFFFFFFFFFFF

    def compare_and_swap(self, expected: int, new: int) -> bool:
        """``__sync_bool_compare_and_swap``: True iff the swap happened."""
        with self._lock:
            if self._value != expected:
                return False
            self._value = new & 0xFFFFFFFFFFFFFFFF
            return True

    def fetch_add(self, delta: int) -> int:
        with self._lock:
            old = self._value
            self._value = (old + delta) & 0xFFFFFFFFFFFFFFFF
            return old

    def fetch_or(self, bits: int) -> int:
        with self._lock:
            old = self._value
            self._value = old | bits
            return old

    def fetch_and(self, bits: int) -> int:
        with self._lock:
            old = self._value
            self._value = old & bits
            return old


# A bitmask word is just a u64 used for its bit operations.
AtomicWord = AtomicU64


class AtomicU64Array:
    """A fixed array of 64-bit cells sharing ONE lock, with batched stores.

    Models a cacheline-resident array written with plain stores plus a
    single release fence at the end (how a real driver restamps a span of
    descriptors): ``store_many`` publishes a whole batch of cells as one
    fenced step, so it is counted as ONE atomic operation by callers that
    track RMW cost, versus one per cell on the per-item path.
    """

    __slots__ = ("_lock", "_values")

    def __init__(self, values):
        self._lock = threading.Lock()
        self._values = [int(v) & _WORD_MASK for v in values]

    def __len__(self) -> int:
        return len(self._values)

    def load(self, i: int) -> int:
        with self._lock:
            return self._values[i]

    def store(self, i: int, value: int) -> None:
        with self._lock:
            self._values[i] = value & _WORD_MASK

    def store_many(self, pairs) -> None:
        """Publish many (index, value) cells under one fence."""
        with self._lock:
            v = self._values
            for i, x in pairs:
                v[i] = x & _WORD_MASK


class AtomicBitmap:
    """``nbits`` flag bits packed into AtomicU64 words (the DD/READ_DONE
    cacheline of a descriptor ring).

    All range operations wrap modulo ``nbits`` (ring addressing) and touch
    each underlying word at most twice, so the RMW cost of an n-slot span
    is O(n/64) instead of O(n).  Every method that touches shared words
    returns (or includes) the number of atomic word operations it issued,
    so data structures built on top can report honest per-item op counts.
    """

    __slots__ = ("nbits", "_words")

    def __init__(self, nbits: int):
        if nbits <= 0 or nbits & (nbits - 1):
            raise ValueError("bitmap size must be a power of two")
        self.nbits = nbits
        self._words = [AtomicU64(0) for _ in range(max(1, nbits // _WORD_BITS))]

    # -- per-bit (the per-item reference path) --------------------------
    def test(self, bit: int) -> bool:
        bit %= self.nbits
        return bool(self._words[bit // _WORD_BITS].load() >> (bit % _WORD_BITS) & 1)

    def set_bit(self, bit: int) -> None:
        bit %= self.nbits
        self._words[bit // _WORD_BITS].fetch_or(1 << (bit % _WORD_BITS))

    def clear_bit(self, bit: int) -> None:
        bit %= self.nbits
        self._words[bit // _WORD_BITS].fetch_and(
            ~(1 << (bit % _WORD_BITS)) & _WORD_MASK
        )

    # -- word-packed range ops (the fast path) --------------------------
    def _spans(self, start: int, n: int):
        """Yield (word, bits) covering ``n`` bits from ``start`` mod nbits."""
        pos = start % self.nbits
        while n > 0:
            w, b = pos // _WORD_BITS, pos % _WORD_BITS
            span = min(_WORD_BITS - b, n, self.nbits - pos)
            yield w, ((1 << span) - 1) << b
            pos = (pos + span) % self.nbits
            n -= span

    def set_range(self, start: int, n: int) -> int:
        """OR-in ``n`` bits from ``start``; returns atomic ops issued."""
        ops = 0
        for w, bits in self._spans(start, n):
            self._words[w].fetch_or(bits)
            ops += 1
        return ops

    def clear_range(self, start: int, n: int) -> int:
        """Clear ``n`` bits from ``start``; returns atomic ops issued."""
        ops = 0
        for w, bits in self._spans(start, n):
            self._words[w].fetch_and(~bits & _WORD_MASK)
            ops += 1
        return ops

    def run_of_ones(self, start: int, limit: int):
        """(run, ops): length of the contiguous set-bit run from ``start``
        (mod nbits), capped at ``limit``, via trailing-ones popcount on
        word snapshots — one load per 64 slots instead of one per slot."""
        limit = min(limit, self.nbits)
        if limit <= 0:
            return 0, 0
        run = 0
        ops = 0
        pos = start % self.nbits
        while run < limit:
            w, b = pos // _WORD_BITS, pos % _WORD_BITS
            word = self._words[w].load()
            ops += 1
            span = min(_WORD_BITS - b, limit - run, self.nbits - pos)
            window = (word >> b) & ((1 << span) - 1)
            gaps = ~window & ((1 << span) - 1)
            if gaps:
                run += (gaps & -gaps).bit_length() - 1
                break
            run += span
            pos = (pos + span) % self.nbits
        return run, ops


class AtomicLease:
    """One claim's ownership word for lease-based reclamation.

    A batch claim publishes an AtomicLease in state HELD.  Exactly one
    of two CAS transitions wins:

    * the claim owner's ``try_complete()`` (HELD -> DONE) on the normal
      completion path, or
    * a helper's ``try_reclaim()`` (HELD -> RECLAIMED) after the lease
      deadline expires.

    Both are single-word ``__sync_bool_compare_and_swap`` analogues, so
    the race between a slow-but-alive owner and an impatient helper
    resolves without blocking either: the loser's CAS simply fails and
    it drops its copy of the batch (owner loses -> its deliveries were
    already made and become the duplicate prefix; helper loses -> no
    reclaim happened and exactly-once is preserved).
    """

    HELD = 1
    DONE = 2
    RECLAIMED = 3

    __slots__ = ("_word",)

    def __init__(self):
        self._word = AtomicU64(self.HELD)

    def state(self) -> int:
        return self._word.load()

    def try_complete(self) -> bool:
        """Owner's completion CAS; False iff a helper already reclaimed."""
        return self._word.compare_and_swap(self.HELD, self.DONE)

    def try_reclaim(self) -> bool:
        """Helper's reclamation CAS; False iff completed or already taken."""
        return self._word.compare_and_swap(self.HELD, self.RECLAIMED)


class TryLock:
    """The paper's TAIL-release trylock (Listing 2 line 35).

    ``try_acquire`` never blocks: a thread that loses simply skips the
    release duty — "even if the trylock() call fails there are no negative
    consequences for the thread in terms of waiting or delay".
    """

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        return self._lock.acquire(blocking=False)

    def release(self) -> None:
        self._lock.release()
