"""The serving driver: the port's ``InferenceEngine.run`` fed by the
benchmark's traffic, timed from each request's due time.

The engine (``repro_torch.serving.engine``) is the system under test:
its COREC scheduler, prefill workers, batched decode loop and TAIL slot
release run unchanged.  ``BenchEngine`` only wraps the engine's own
hooks to record spans: ``_make_batch`` (a worker has claimed the
request: its prefill starts), ``_prefill`` and ``_decode`` (each call's
host span, with ``record_function`` ranges for the trace), and lets one
engine serve several ``run`` calls (warm-up, window, drain).

``run`` is handed a request sequence whose iteration releases each
request when it is due: on the open loop's schedule, or, in a closed
loop, when the client's previous request was answered.  The engine
stamps ``t_arrival`` when it submits; this module keeps the due times
and reports how late submission ran.

Phases: weights from the seed on the device, the engine, a warm-up run
over the cell's largest and smallest prompts (set-up ends here, at the
first timed request's due time), the window (plus, with ``trace``, a
traced stretch of the same traffic after it), the drain, and once the
program's state is freed the configuration's reference
(``bench.spec.load_reference``) over a sample of the answers.
The engine serves on a thread of its own; the process's main thread
starts and stops the profiler.

The record (what the metric readers take):

- ``setup_s``, ``window`` (perf_counter bounds), ``seconds``, ``cfg``
- ``requests``: per request ``rid, due, submit, prefill_start,
  first_token, done, prompt_len, new_tokens, n_tokens, in_window``
  (None where it never happened)
- ``steps``: per decode step ``(t_start, active)``, ``active`` a byte
  per slot, 1 where it holds a request; with trace ``step_keys``: per
  step the keys each slot's attention read
- ``trace``: :func:`bench.trace.reduce_events` of the traced stretch
- ``late``: submission minus due time over the window's requests
"""

from __future__ import annotations

import contextlib
import gc
import heapq
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, InferenceEngine, Request

from bench import spec
from bench import traffic as tr
from bench.reference.judge import gap_stats
from bench.trace import Tracer
from bench.weights import make_params, rules_of

__all__ = ["run", "compared", "BenchEngine"]

#: what the engine's producer sleeps between submissions: the harness paces
_RATE = 1e9
#: the first due time lies this far past the call, so the engine's
#: threads are up when it comes
_LEAD_S = 0.05
#: traffic beyond the traced stretches (a second one if the first came
#: back without kernels), so that it is loaded to its end
_TAIL_MARGIN_S = 1.0


class _Log:
    """Spans the engine hooks record; lists appended under the GIL."""

    def __init__(self, trace: bool, n_slots: int, device):
        self.trace = trace
        self.prefill_start: dict = {}
        self.steps: list = []
        self.keys = None
        if trace and device.type == "cuda":
            shape = (1 << 16, n_slots)
            self.keys = torch.zeros(shape, dtype=torch.int32, pin_memory=True)

    def span(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


class _Announced(list):
    """The engine's results list, waking whoever waits on ``cond`` at
    each answer appended."""

    def __init__(self, cond: threading.Condition):
        super().__init__()
        self.cond = cond

    def append(self, item):
        with self.cond:
            super().append(item)
            self.cond.notify_all()


class BenchEngine(InferenceEngine):
    """The port's engine with the harness's spans on its hooks."""

    def __init__(self, *args, log: _Log, **kw):
        self.log = log
        self._local = threading.local()
        self.answered = threading.Condition()
        super().__init__(*args, **kw)

    def run(self, requests, rate=None, timeout=180.0):
        """One more ``run`` of the same engine: its stop flag cleared,
        its results those of this call, each answer announced on
        :attr:`answered` (a closed loop's clients wait on it)."""
        self._stop.clear()
        self.results = _Announced(self.answered)
        return super().run(requests, rate, timeout)

    def _make_batch(self, req):
        self._local.rid = req.rid
        self.log.prefill_start[req.rid] = time.perf_counter()
        return super()._make_batch(req)

    def _prefill(self, params, batch):
        rid, S = self._local.rid, batch["tokens"].shape[1]
        with self.log.span(f"bench.prefill:{rid}:{S}"):
            return super()._prefill(params, batch)

    def _decode(self, params, cache, tokens):
        i = len(self.log.steps)
        active = bytes(r is not None for r in self.slot_req)
        keys = self.log.keys
        if keys is not None and i < keys.shape[0]:
            keys[i].copy_(cache["lengths"], non_blocking=True)
        self.log.steps.append((time.perf_counter(), active))
        with self.log.span(f"bench.decode:{i}"):
            return super()._decode(params, cache, tokens)


class _OpenFeed:
    """Requests released at their due times (perf_counter seconds)."""

    def __init__(self, items):
        self.items = items  # [(due, Request)]

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for due, req in self.items:
            time.sleep(max(0.0, due - time.perf_counter()))
            yield req


class _ClosedFeed:
    """``clients`` callers: each one's next request is due when its last
    one is answered, until ``stop``.  The callers wait on the engine's
    answers (no polling); the engine's ``run`` is ended by its timeout,
    so the length only has to exceed what it serves."""

    def __init__(self, engine, stream, start: float, stop: float, make):
        self.engine, self.stop, self.make = engine, stop, make
        self.heap = [(start + d, c) for c, d in enumerate(stream.first_dues())]
        heapq.heapify(self.heap)
        self.client: dict = {}  # rid -> client
        self.seen = 0

    def __len__(self):
        return 1 << 40

    def _poll(self):
        res = self.engine.results
        for rr in res[self.seen :]:
            c = self.client.get(rr.rid)
            if c is not None and rr.t_done < self.stop:
                heapq.heappush(self.heap, (rr.t_done, c))
        self.seen = len(res)

    def __iter__(self):
        cond = self.engine.answered
        while True:
            with cond:
                self._poll()
                now = time.perf_counter()
                if now >= self.stop:
                    return
                if not self.heap or self.heap[0][0] > now:
                    wake = self.heap[0][0] if self.heap else self.stop
                    cond.wait(max(0.0, min(wake, self.stop) - now))
                    continue
            due, c = heapq.heappop(self.heap)
            req = self.make(due)
            self.client[req.rid] = c
            yield req


class _Drain:
    """Nothing to submit: wait for ``n`` answers."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(())


class _Thread:
    """``fn()`` on a thread of its own; :meth:`join` returns its result
    or raises its exception."""

    def __init__(self, fn):
        self._out = {}
        self._t = threading.Thread(target=self._run, args=(fn,), daemon=True)
        self._t.start()

    def _run(self, fn):
        try:
            self._out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 -- handed to join()
            self._out["error"] = e

    def join(self):
        self._t.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float = None) -> dict:
    """One run of a serving cell; returns the record."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cfg_d = config["config"]
    cfg = ArchConfig(**cfg_d)
    ecfg = EngineConfig(**cell["engine"])
    traffic = cell["traffic"]
    tail = cell["trace_s"] if trace else 0.0

    reference = spec.load_reference(config)
    params = make_params(
        build_model(cfg), seed, dev, getattr(torch, cfg.dtype), rules_of(reference)
    )
    log = _Log(trace, ecfg.n_slots, dev)
    eng = BenchEngine(cfg, ecfg, params=params, device=dev, log=log)

    rid = iter(range(1 << 62))
    reqs: dict = {}  # rid -> [Request, due]

    def request(p: tr.Planned, due: float) -> Request:
        r = Request(next(rid), p.prompt, p.new_tokens - 1, session=p.session)
        reqs[r.rid] = [r, due]
        return r

    # warm-up: the cell's largest and smallest prompts through the engine
    wrng = np.random.default_rng([int(seed), 99])
    warm = [
        request(tr.Planned(0.0, wrng.integers(0, cfg.vocab, n).tolist(), 2, 0), 0.0)
        for n in cell["warmup_prompts"]
    ]
    done = eng.run(_OpenFeed([(0.0, r) for r in warm]), rate=_RATE, timeout=600.0)
    if len(done) < len(warm):
        raise RuntimeError("the warm-up requests were not all answered")
    reqs.clear()
    log.prefill_start.clear()
    log.steps.clear()

    tracer = Tracer() if tail and dev.type == "cuda" else None
    if tracer:
        tracer.warm()
    drain = cell["drain_s"]
    extra = 2 * tail + _TAIL_MARGIN_S if tail else 0.0
    if traffic["loop"] == "open":
        plan = tr.open_plan(traffic, seed, seconds, cfg.vocab)
        if extra:
            plan += [
                tr.Planned(p.due + seconds, p.prompt, p.new_tokens, p.session)
                for p in tr.open_plan(traffic, seed, extra, cfg.vocab, stream=1)
            ]
        t0 = time.perf_counter() + _LEAD_S
        items = [(t0 + p.due, request(p, t0 + p.due)) for p in plan]

        def serve():
            timeout = seconds + extra + drain
            return eng.run(_OpenFeed(items), rate=_RATE, timeout=timeout)
    else:
        stream = tr.ClosedStream(traffic, seed, cfg.vocab)
        ramp = time.perf_counter() + _LEAD_S
        t0 = ramp + traffic["ramp_s"]
        stop = t0 + seconds + extra

        def serve():
            make = lambda due: request(stream.next(), due)  # noqa: E731
            feed = _ClosedFeed(eng, stream, ramp, stop, make)
            out = eng.run(feed, rate=_RATE, timeout=stop - time.perf_counter())
            left = len(reqs) - len(out)
            if left:
                out += eng.run(_Drain(left), rate=_RATE, timeout=drain)
            return out

    worker = _Thread(serve)
    try:
        trace_out = _traced(tracer, t0 + seconds, tail) if tracer else None
    finally:
        results = worker.join()
    t1 = t0 + seconds
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    record = {
        "setup_s": t0 - t_start,
        "window": (t0, t1),
        "seconds": seconds,
        "cfg": cfg_d,
        "trace": trace_out,
        "memory_peak_bytes": peak,
    }
    record.update(_tally(eng, log, reqs, results, t0, t1))
    ring = {"head_minus_tail": eng.head - eng.tail, "backlog": eng.sched.backlog()}

    # the program's state goes before the reference runs
    del eng, results
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    record.update(_judge(cell, cfg_d, reference, params, record, reqs, seed, ring))
    return record


def _traced(tracer, start: float, seconds: float) -> dict:
    """The reduced trace of the stretch from ``start``.  A stretch that
    comes back without a kernel while the engine runs (one of 12 traced
    runs on an H100) is traced once more, on the stretch after it; a
    second one without a kernel ends the run, so that a broken trace is
    never reported as the device's idle time."""
    out = tracer.trace(start, seconds)
    if not out["kernels"]:
        n = out["device_events"]
        print(f"trace: no kernel among {n} device events; tracing the next stretch",
              file=sys.stderr)
        out = tracer.trace(time.perf_counter(), seconds)
    if not out["kernels"]:
        n = out["device_events"]
        raise RuntimeError(f"two traced stretches without a kernel ({n} device events)")
    return out


def _tally(eng, log: _Log, reqs: dict, results: list, t0: float, t1: float) -> dict:
    by_rid: dict = {}
    dupes = 0
    for rr in results:
        dupes += rr.rid in by_rid
        by_rid[rr.rid] = rr
    rows = []
    for rid, (req, due) in sorted(reqs.items()):
        rr = by_rid.get(rid)
        rows.append({
            "rid": rid,
            "due": due,
            "submit": req.t_arrival,
            "prefill_start": log.prefill_start.get(rid),
            "first_token": rr.t_first_token if rr else None,
            "done": rr.t_done if rr else None,
            "prompt_len": len(req.prompt),
            "new_tokens": req.max_new_tokens + 1,
            "n_tokens": len(rr.tokens) if rr else 0,
            "in_window": t0 <= due < t1,
            "tokens": rr.tokens if rr else None,
        })
    late = [r["submit"] - r["due"] for r in rows if r["in_window"]]
    out = {
        "requests": rows,
        "duplicates": dupes,
        "steps": list(log.steps),
        "late": {
            "p50_s": float(np.percentile(late, 50)) if late else None,
            "p99_s": float(np.percentile(late, 99)) if late else None,
            "max_s": max(late) if late else None,
            "n": len(late),
        },
    }
    if log.keys is not None:
        n = min(len(log.steps), log.keys.shape[0])
        S = eng.ecfg.max_seq
        out["step_keys"] = (log.keys[:n] + 1).clamp(max=S).tolist()
    return out


def compared(stats: dict) -> dict:
    """The numbers a cell's ``check.limits`` may name, from
    :func:`gap_stats`: the widest gap and the gaps' 90th percentile."""
    return {"logit_gap": stats.get("widest"), "logit_gap_p90": stats.get("p90")}


def _judge(cell, cfg_d, reference, params, record, reqs, seed, ring) -> dict:
    """``correct`` and the numbers compared, each beside its limit, the
    sample judged by the configuration's ``reference`` (the sample stays
    in ``record["sample"]``)."""
    rows = record["requests"]
    due = [r for r in rows if r["in_window"]]
    failed = sum(r["n_tokens"] != r["new_tokens"] for r in due)
    unanswered = sum(r["n_tokens"] != r["new_tokens"] for r in rows)
    done = [r for r in due if r["n_tokens"] == r["new_tokens"]]
    checks = {
        "unanswered": {"value": unanswered, "limit": 0},
        "duplicates": {"value": record["duplicates"], "limit": 0},
        "ring_head_minus_tail": {"value": ring["head_minus_tail"], "limit": 0},
        "ring_backlog": {"value": ring["backlog"], "limit": 0},
    }
    limits = cell["check"]["limits"]
    n = min(cell["check"]["sample"], len(done))
    g = {}
    judged = {"tokens": 0}
    if n:
        longest = max(done, key=lambda r: r["prompt_len"] + r["n_tokens"])
        rest = [r for r in done if r is not longest]
        rng = np.random.default_rng([int(seed), 7])
        pick = rng.choice(len(rest), n - 1, replace=False)
        sample = [longest] + [rest[i] for i in sorted(pick)]
        t = time.perf_counter()
        pairs = [(reqs[r["rid"]][0].prompt, r["tokens"]) for r in sample]
        g = gap_stats(reference, params, cfg_d, pairs)
        judged = dict(g, seconds=time.perf_counter() - t)
        record["sample"] = [(reqs[r["rid"]][0].prompt, r["tokens"]) for r in sample]
    numbers = compared(g)
    for name, limit in limits.items():
        checks[name] = {"value": numbers[name], "limit": limit}
    correct = bool(due) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()
    )
    return {"correct": correct, "attempted": len(due), "failed": failed,
            "checks": checks, "judged": judged}
