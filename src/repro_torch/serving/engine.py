"""Continuous-batching inference engine with a COREC ingestion queue:
the port of ``repro.serving.engine``.

Dataflow (the paper's Rx pipeline, serving edition):

  frontend --submit--> scheduler (COREC shared ring | RSS per-worker rings)
      --claim (CAS)--> ingestion workers: prefill the prompt, stage the
      per-request cache --> decode loop: inserts staged requests into free
      decode slots, steps ALL active slots in one batched ``decode_step``,
      retires finished sequences.

Decode slots form ``n_lanes`` rings with the paper's producer-credit
semantics: each lane has an admission cursor ``head`` and a ``tail``
that advances only over the *contiguous* prefix of finished slots.
All lanes' releasable prefixes come from ONE launch of the batched
done-prefix kernel (``kernels/csrc/done_prefix_batch.cu``), so slot
recycling costs one launch whatever the lane count.
``contiguous_release=False`` gives the free-list alternative.

Fields and methods follow the reference one for one.  The differences:
the engine takes ``device`` (the card unless the caller names the CPU)
and a ``torch.Generator`` in place of a JAX key; it builds every CUDA
kernel in its constructor, before any thread starts; prefill (worker
threads) and decode (the engine thread) run under
``torch.inference_mode()`` on each thread's current stream, the
default stream, so a staged cache is complete before the engine thread
copies it in; ``_insert`` writes the slot axis by name (1 for k/v, 0
for lengths) where the reference guesses it from shapes; and
``decode_steps``/``prefills`` count the model calls.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..compat import resolve_device
from ..config import ArchConfig
from ..kernels import _build, ops
from ..models.api import build_model
from .request import Request, RequestResult
from .scheduler import make_scheduler

__all__ = ["EngineConfig", "InferenceEngine"]

#: the slot (batch) axis of each cache leaf of the dense decoder
_SLOT_AXIS = {"k": 1, "v": 1, "lengths": 0}


@dataclass
class EngineConfig:
    n_slots: int = 8  # decode slots (total, across all lanes)
    max_seq: int = 64  # cache capacity per slot
    n_workers: int = 2  # ingestion (prefill) workers
    policy: str = "corec"  # 'corec' | 'rss'
    claim_batch: int = 4
    eos_token: int = 1
    contiguous_release: bool = True  # paper's TAIL rule for slot reuse
    greedy: bool = True
    n_lanes: int = 1  # decode slot rings; released in ONE batched kernel


class InferenceEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        ecfg: EngineConfig,
        params=None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.model = build_model(cfg)
        if self.device.type == "cuda":
            # every kernel built and loaded before a worker thread exists
            for name in _build.build():
                _build.load(name)
        self.params = (
            params
            if params is not None
            else self.model.init(generator=generator, device=self.device)
        )
        self._run_params = self.model.prepare(self.params)
        self.sched = make_scheduler(ecfg.policy, ecfg.n_workers)
        B, S = ecfg.n_slots, ecfg.max_seq
        with torch.inference_mode():
            self.cache = self.model.init_cache(B, S, self.device)

        # slot ring bookkeeping (host side): R lanes of B/R slots each;
        # global slot id = lane * lane_slots + offset
        if B % ecfg.n_lanes:
            raise ValueError("n_slots must be divisible by n_lanes")
        self.n_lanes = ecfg.n_lanes
        self.lane_slots = B // ecfg.n_lanes
        self.slot_req: List[Optional[RequestResult]] = [None] * B
        self.slot_budget = np.zeros(B, np.int32)
        # READ_DONE bits for admitted slots, one row per lane
        self.done_mask = np.zeros((self.n_lanes, self.lane_slots), bool)
        self.lane_head = np.zeros(self.n_lanes, np.int64)  # admission cursors
        self.lane_tail = np.zeros(self.n_lanes, np.int64)  # release cursors
        self._staged: List = []
        self._staged_lock = threading.Lock()
        self._stop = threading.Event()
        self.results: List[RequestResult] = []
        self.release_events: List[int] = []  # run lengths (diagnostics)
        self.decode_steps = 0  # batched decode_step calls (diagnostics)
        self.prefills = 0  # prefill calls (diagnostics)
        self._count_lock = threading.Lock()

    def _prefill(self, params, batch):
        return self.model.prefill(params, batch, max_seq=self.ecfg.max_seq)

    def _decode(self, params, cache, tokens):
        return self.model.decode_step(params, cache, tokens)

    # ------------------------------------------------------------------
    # ingestion worker: claim -> prefill -> stage
    # ------------------------------------------------------------------
    def _make_batch(self, req: Request):
        tokens = torch.tensor(req.prompt, dtype=torch.int32, device=self.device)
        return {"tokens": tokens[None, :]}

    def _worker_loop(self, wid: int):
        with torch.inference_mode():  # thread-local: enter it per thread
            while not self._stop.is_set():
                claim = self.sched.claim(wid, self.ecfg.claim_batch)
                if claim is None:
                    time.sleep(0.0005)
                    continue
                for req in claim.payloads:
                    if req is None:
                        continue
                    cache1, logits = self._prefill(
                        self._run_params, self._make_batch(req)
                    )
                    with self._count_lock:
                        self.prefills += 1
                    first = int(torch.argmax(logits[0])) if self.ecfg.greedy else 0
                    rr = RequestResult(
                        rid=req.rid,
                        tokens=[first],
                        t_arrival=req.t_arrival,
                        t_first_token=time.perf_counter(),
                        worker=wid,
                    )
                    with self._staged_lock:
                        self._staged.append((cache1, rr, req.max_new_tokens))
                self.sched.complete(wid, claim)

    # ------------------------------------------------------------------
    # slot ring: release (TAIL advance) + admit (HEAD advance)
    # ------------------------------------------------------------------
    @property
    def head(self) -> int:
        """Total admissions across lanes (monotonic)."""
        return int(self.lane_head.sum())

    @property
    def tail(self) -> int:
        """Total releases across lanes (monotonic)."""
        return int(self.lane_tail.sum())

    def _release(self):
        """Advance every lane's tail over its contiguous done prefix
        (paper line 37-41) -- ONE batched kernel launch for all R lanes."""
        if not self.ecfg.contiguous_release:
            return  # free-list mode: no tail semantics
        n = self.lane_slots
        in_flight = self.lane_head - self.lane_tail
        if not in_flight.any():
            return
        dev = self.device
        runs = ops.done_prefix_batch(
            torch.as_tensor(self.done_mask, device=dev),
            torch.as_tensor((self.lane_tail % n).astype(np.int32), device=dev),
            torch.as_tensor(in_flight.astype(np.int32), device=dev),
            impl="auto",
        ).tolist()
        for r in range(self.n_lanes):
            run = int(runs[r])
            if run:
                for i in range(run):
                    self.done_mask[r, (self.lane_tail[r] + i) % n] = False
                self.lane_tail[r] += run
                self.release_events.append(run)

    def _capacity_slots(self) -> List[int]:
        if self.ecfg.contiguous_release:
            self._release()
            n = self.lane_slots
            slots = []
            lane_free = n - (self.lane_head - self.lane_tail)
            # round-robin over lanes so admissions spread the straggler risk
            for i in range(n):
                for r in range(self.n_lanes):
                    if i < lane_free[r]:
                        slots.append(r * n + int((self.lane_head[r] + i) % n))
            return slots
        return [i for i in range(self.ecfg.n_slots) if self.slot_req[i] is None]

    def _insert(self, slot: int, cache1, rr: RequestResult, budget: int):
        for name, ax in _SLOT_AXIS.items():
            self.cache[name].select(ax, slot).copy_(cache1[name].select(ax, 0))
        self.slot_req[slot] = rr
        self.slot_budget[slot] = budget
        lane, off = slot // self.lane_slots, slot % self.lane_slots
        self.done_mask[lane, off] = False
        if self.ecfg.contiguous_release:
            self.lane_head[lane] += 1

    # ------------------------------------------------------------------
    def run(
        self,
        requests: List[Request],
        rate: Optional[float] = None,
        timeout: float = 180.0,
    ) -> List[RequestResult]:
        """Open loop: submit at ``rate`` req/s (None = all at once)."""
        with torch.inference_mode():
            return self._run(requests, rate, timeout)

    def _run(self, requests, rate, timeout):
        threads = [
            threading.Thread(target=self._worker_loop, args=(w,), daemon=True)
            for w in range(self.ecfg.n_workers)
        ]
        for t in threads:
            t.start()

        def producer():
            interval = 1.0 / rate if rate else 0.0
            if interval:
                for req in requests:
                    req.t_arrival = time.perf_counter()
                    while not self.sched.submit(req):
                        time.sleep(0.0005)
                    time.sleep(interval)
            else:
                # burst mode: one descriptor burst + doorbell per chunk via
                # the schedulers' batch surface (prefix-retry on full ring)
                i = 0
                stamped = 0  # t_arrival once, at FIRST offer: admission
                # stalls must stay inside the measured request latency
                while i < len(requests):
                    chunk = requests[i : i + 64]
                    if i + len(chunk) > stamped:
                        now = time.perf_counter()
                        for req in requests[stamped : i + len(chunk)]:
                            req.t_arrival = now
                        stamped = i + len(chunk)
                    took = self.sched.submit_batch(chunk)
                    i += took
                    if took == 0:
                        time.sleep(0.0005)

        prod = threading.Thread(target=producer, daemon=True)
        prod.start()

        n_total = len(requests)
        deadline = time.perf_counter() + timeout
        while len(self.results) < n_total and time.perf_counter() < deadline:
            # 1) admit staged requests into released slots
            slots = self._capacity_slots()
            for slot in slots:
                with self._staged_lock:
                    item = self._staged.pop(0) if self._staged else None
                if item is None:
                    break
                self._insert(slot, *item)
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            if not active:
                time.sleep(0.001)
                continue
            # 2) one batched decode step over all slots
            last = torch.tensor(
                [r.tokens[-1] if r else 0 for r in self.slot_req],
                dtype=torch.int32,
                device=self.device,
            )[:, None]
            self.cache, logits = self._decode(self._run_params, self.cache, last)
            self.decode_steps += 1
            nxt = torch.argmax(logits, -1).tolist()  # one sync per step
            now = time.perf_counter()
            # 3) retire finished sequences (set READ_DONE bits)
            for i in active:
                rr = self.slot_req[i]
                rr.tokens.append(int(nxt[i]))
                self.slot_budget[i] -= 1
                if int(nxt[i]) == self.ecfg.eos_token or self.slot_budget[i] <= 0:
                    rr.t_done = now
                    self.results.append(rr)
                    self.slot_req[i] = None
                    self.done_mask[i // self.lane_slots, i % self.lane_slots] = True
        self._stop.set()
        self._release()  # hand back the trailing done-prefix (drain)
        for t in threads:
            t.join(timeout=2.0)
        return list(self.results)
