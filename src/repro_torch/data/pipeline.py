"""Host data pipeline: COREC prefetch ring between producers and feeders
(the port's own copy of ``repro.data.pipeline``, over its own
``core/ring.py``; the batch draw is the reference's, number for number).

The training input pipeline is the second place the paper's single-queue
discipline pays off: producer threads materialise microbatches into ONE
shared ring; any idle device feeder claims the next batch (work
conserving — a slow producer or a hiccuping feeder never stalls its
peers).  The *contiguous release* rule is what makes the stream position
checkpointable: TAIL is exactly the number of microbatches durably
consumed, so restart resumes at a well-defined offset regardless of how
claims interleaved (the same transparency argument as the NIC's credit
scheme).

``SyntheticLMSource`` is deterministic per (seed, index): after restart,
batch k is bit-identical — property-tested in tests/test_torch_data.py.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..core.ring import CorecRing

__all__ = ["SyntheticLMSource", "CorecDataPipeline", "make_batches"]


class SyntheticLMSource:
    """Deterministic synthetic LM batches: tokens[i] derived from a
    counter-based RNG so any index is recomputable (resumable stream)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ index)
        toks = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1),
                            dtype=np.int32)
        return {
            "index": index,
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }


def make_batches(source: SyntheticLMSource, start: int, n: int) -> Iterator[dict]:
    for i in range(start, start + n):
        yield source.batch_at(i)


class CorecDataPipeline:
    """Producer threads -> CorecRing -> feeder ``next_batch()`` calls.

    ``position()`` returns the contiguous-release TAIL: the checkpointable
    stream offset.  ``restore(pos)`` restarts production at that offset.
    """

    def __init__(self, source: SyntheticLMSource, ring_size: int = 64,
                 n_producers: int = 2, start_index: int = 0):
        self.source = source
        self.ring = CorecRing(ring_size)
        self.n_producers = n_producers
        self._next_index = start_index
        self._index_lock = threading.Lock()
        self._base = start_index
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # producer side -----------------------------------------------------
    def _producer_loop(self):
        while not self._stop.is_set():
            with self._index_lock:
                idx = self._next_index
                self._next_index += 1
            batch = self.source.batch_at(idx)
            while not self._stop.is_set():
                # slot for batch idx is (idx - base): single logical
                # producer stream — offer in order via ticket spin
                if self.ring.head + self._base == idx and self.ring.produce(batch):
                    break
                time.sleep(0.0005)

    def start(self):
        for _ in range(self.n_producers):
            t = threading.Thread(target=self._producer_loop, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)

    # feeder side ---------------------------------------------------------
    def next_batch(self, worker: int = 0, timeout: float = 10.0) -> Optional[dict]:
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            claim = self.ring.claim(max_batch=1)
            if claim is not None:
                self.ring.complete(claim)
                self.ring.try_release()
                return claim.payloads[0]
            time.sleep(0.0005)
        return None

    def position(self) -> int:
        """Checkpointable stream offset (contiguous-release TAIL)."""
        return self._base + self.ring.tail

    @classmethod
    def restore(cls, source: SyntheticLMSource, position: int, **kw):
        return cls(source, start_index=position, **kw)
