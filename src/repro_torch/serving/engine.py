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
recycling costs one launch whatever the lane count.  On a CUDA device
the ring state (READ_DONE mask, start and limit words, the runs) lives
in pinned host memory that the host writes through numpy views and the
kernel reads and writes in place (``done_prefix_batch_mapped``), on a
stream of the engine's own: no copy, and the wait for the runs covers
that launch alone, not the prefills queued on the default stream.  On
the CPU the plain version runs on the same arrays.
``contiguous_release=False`` gives the free-list alternative.

Fields and methods follow the reference one for one.  The differences:
the engine takes ``device`` (the card unless the caller names the CPU)
and a ``torch.Generator`` in place of a JAX key; it builds every CUDA
kernel in its constructor, before any thread starts; prefill (worker
threads) and decode (the engine thread) run under
``torch.inference_mode()`` on each thread's current stream, the
default stream, so a staged cache is complete before the engine thread
copies it in; ``_insert`` writes each cache leaf's slot axis, the one
its ``cache_specs`` names ``"batch"``, where the reference guesses it
from shapes; ``decode_steps``/``prefills`` count the model calls; an idle
ingestion worker naps longer after each empty claim (``_IDLE_NAP_S``),
where the reference's polls every half millisecond; and
while a profiler records, the engine's phases are spans
(:mod:`repro_torch.tracing`): ``claim`` (a worker's non-empty claim:
``worker``, ``items``, ``rids``), ``prefill`` (``rid``, ``tokens``),
and per decode step ``step`` (``step``, ``active``, ``held``) over
``release`` (``runs``, ``held``: done slots still behind an unfinished
one), ``admit`` (``slots``, ``rids``, ``wait_ns`` since each prefill
ended), ``upload``, ``decode`` (``step``), ``readback`` and ``retire``
(``finished``).  The ``prefill`` and ``decode`` spans sit inside the
hooks ``_prefill`` and ``_decode``, so a subclass that wraps a hook
wraps them too; so that a ``step`` holds its release, an iteration of
``_run`` with nothing active or staged releases and waits, and one
that steps runs ``_step``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import tracing
from ..compat import resolve_device
from ..config import ArchConfig
from ..kernels import _build, ops
from ..kernels.doneprefix import done_prefix_batch_mapped
from ..models.api import build_model, frontend_inputs
from ..models.layers import cdtype
from .request import Request, RequestResult
from .scheduler import make_scheduler

__all__ = ["EngineConfig", "InferenceEngine"]

#: an idle ingestion worker's naps between empty claims: from the
#: shortest, doubled after each empty claim up to the longest, back to the
#: shortest once a claim brings requests.  A worker woken every half millisecond takes
#: the interpreter lock from the decode thread at each of its ops: two
#: such workers made a 32-slot granite-4.0-h-small decode step take 105
#: ms against 65 ms alone on an H100 host; at the longest nap a request
#: that finds every worker idle waits at most that long to be claimed.
_IDLE_NAP_S = (0.0005, 0.008)

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
        #: the slot axis of each cache leaf: its logical "batch" axis
        self._slot_axis = {
            name: spec.axes.index("batch")
            for name, spec in self.model.cache_specs(B, S).items()
        }

        # slot ring bookkeeping (host side): R lanes of B/R slots each;
        # global slot id = lane * lane_slots + offset
        if B % ecfg.n_lanes:
            raise ValueError("n_slots must be divisible by n_lanes")
        self.n_lanes = ecfg.n_lanes
        self.lane_slots = B // ecfg.n_lanes
        self.slot_req: List[Optional[RequestResult]] = [None] * B
        self.slot_budget = np.zeros(B, np.int32)
        # READ_DONE bits for admitted slots, one row per lane
        R, n = self.n_lanes, self.lane_slots
        if self.device.type == "cuda":
            # the TAIL advance's state, pinned: the host writes it through
            # numpy views, the kernel reads it in place (see _release)
            def pinned(shape, dtype):
                return torch.zeros(shape, dtype=dtype, pin_memory=True)

            self._ring = (
                pinned((R, n), torch.bool),  # done mask
                pinned(R, torch.int32),  # start: tail % n
                pinned(R, torch.int32),  # limit: in flight
                pinned(R, torch.int32),  # runs
            )
            self.done_mask, self._start, self._limit, self._runs = (
                t.numpy() for t in self._ring
            )
            self._release_stream = torch.cuda.Stream(self.device)
            self._release_done = torch.cuda.Event()
        else:
            self.done_mask = np.zeros((R, n), bool)
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
        self._worker_state = threading.local()  # the rid a worker prefills

    def _prefill(self, params, batch):
        rid = getattr(self._worker_state, "rid", None)
        with tracing.span("prefill", rid=rid, tokens=batch["tokens"].shape[1]):
            return self.model.prefill(params, batch, max_seq=self.ecfg.max_seq)

    def _decode(self, params, cache, tokens):
        with tracing.span("decode", step=self.decode_steps):
            return self.model.decode_step(params, cache, tokens)

    # ------------------------------------------------------------------
    # ingestion worker: claim -> prefill -> stage
    # ------------------------------------------------------------------
    def _make_batch(self, req: Request):
        """The prompt, and the stubbed frontends' inputs as the reference
        engine gives them: zero image embeddings (VLM) and zero audio
        frames (Whisper), in the compute dtype."""
        tokens = torch.tensor(req.prompt, dtype=torch.int32, device=self.device)
        batch = {"tokens": tokens[None, :]}
        dt = cdtype(self.cfg)
        for key, shape in frontend_inputs(self.cfg).items():
            batch[key] = torch.zeros((1, *shape), dtype=dt, device=self.device)
        return batch

    def _worker_loop(self, wid: int):
        shortest, longest = _IDLE_NAP_S
        nap = shortest
        with torch.inference_mode():  # thread-local: enter it per thread
            while not self._stop.is_set():
                claim = self.sched.claim(wid, self.ecfg.claim_batch)
                if claim is None:
                    time.sleep(nap)
                    nap = min(2 * nap, longest)
                    continue
                nap = shortest
                with tracing.span("claim", worker=wid) as sp:
                    if sp:
                        rids = [r.rid for r in claim.payloads if r is not None]
                        sp.set(items=len(rids), rids=rids)
                    for req in claim.payloads:
                        if req is None:
                            continue
                        self._worker_state.rid = req.rid
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
        (paper line 37-41) -- ONE batched kernel launch for all R lanes:
        on a CUDA device over the pinned ring state in place, on the
        engine's stream, waiting on an event of that launch alone."""
        with tracing.span("release") as sp:
            first = len(self.release_events)
            self._advance_tails()
            if sp:
                sp.set(runs=self.release_events[first:], held=self._held())

    def _held(self) -> int:
        """Finished slots not yet released: each lies behind an
        unfinished one in its lane (none in free-list mode)."""
        if not self.ecfg.contiguous_release:
            return 0
        return int(self.done_mask.sum())

    def _advance_tails(self):
        if not self.ecfg.contiguous_release:
            return  # free-list mode: no tail semantics
        n = self.lane_slots
        in_flight = self.lane_head - self.lane_tail
        if not in_flight.any():
            return
        if self.device.type == "cuda":
            self._start[:] = self.lane_tail % n
            self._limit[:] = in_flight
            done_prefix_batch_mapped(*self._ring, self._release_stream)
            self._release_done.record(self._release_stream)
            self._release_done.synchronize()
            runs = self._runs.copy()
        else:
            runs = ops.done_prefix_batch(
                torch.as_tensor(self.done_mask),
                torch.as_tensor((self.lane_tail % n).astype(np.int32)),
                torch.as_tensor(in_flight.astype(np.int32)),
                impl="auto",
            ).numpy()
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
        for name, ax in self._slot_axis.items():
            self.cache[name].select(ax, slot).copy_(cache1[name].select(ax, 0))
        self.slot_req[slot] = rr
        self.slot_budget[slot] = budget
        lane, off = slot // self.lane_slots, slot % self.lane_slots
        self.done_mask[lane, off] = False
        if self.ecfg.contiguous_release:
            self.lane_head[lane] += 1

    def _step(self) -> None:
        """One iteration that steps: admit staged requests into released
        slots, one batched decode step over all slots, retire finished
        sequences.  The caller makes sure a slot is active or a request
        staged, so one is active once the admission ran (every slot is
        free when none is active)."""
        with tracing.span("step", step=self.decode_steps) as st:
            # 1) admit staged requests into released slots
            slots = self._capacity_slots()
            held = self._held() if st else 0  # behind an unfinished slot
            with tracing.span("admit") as sp:
                n = 0
                for slot in slots:
                    with self._staged_lock:
                        item = self._staged.pop(0) if self._staged else None
                    if item is None:
                        break
                    self._insert(slot, *item)
                    n += 1
                if sp:
                    now = time.perf_counter()
                    got = [self.slot_req[s] for s in slots[:n]]
                    sp.set(slots=slots[:n], rids=[r.rid for r in got],
                           wait_ns=[int(1e9 * (now - r.t_first_token)) for r in got])
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            # 2) one batched decode step over all slots
            with tracing.span("upload"):
                last = torch.tensor(
                    [r.tokens[-1] if r else 0 for r in self.slot_req],
                    dtype=torch.int32,
                    device=self.device,
                )[:, None]
            self.cache, logits = self._decode(self._run_params, self.cache, last)
            self.decode_steps += 1
            with tracing.span("readback"):
                nxt = torch.argmax(logits, -1).tolist()  # one sync per step
            now = time.perf_counter()
            # 3) retire finished sequences (set READ_DONE bits)
            with tracing.span("retire") as sp:
                finished = 0
                for i in active:
                    rr = self.slot_req[i]
                    rr.tokens.append(int(nxt[i]))
                    self.slot_budget[i] -= 1
                    if int(nxt[i]) == self.ecfg.eos_token or self.slot_budget[i] <= 0:
                        rr.t_done = now
                        self.results.append(rr)
                        self.slot_req[i] = None
                        self.done_mask[i // self.lane_slots, i % self.lane_slots] = True
                        finished += 1
                if sp:
                    sp.set(finished=finished)
            if st:
                st.set(active=len(active), held=held)

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
            if not self._staged and all(r is None for r in self.slot_req):
                # nothing to admit or step: hand back what finished, wait
                self._release()
                time.sleep(0.001)
                continue
            self._step()
        self._stop.set()
        self._release()  # hand back the trailing done-prefix (drain)
        for t in threads:
            t.join(timeout=2.0)
        return list(self.results)
