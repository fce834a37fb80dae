"""The port's own spans (``repro_torch.tracing``) on the tiny grok engine
on the CPU, and ``RingStats`` counting exactly under threads.

* With no profiler recording, an engine run records nothing and never
  constructs a ``record_function``.
* Under an all-thread ``torch.profiler`` started on the main thread
  while the engine serves on another, the span tree: one ``step`` per
  decode step over its ``release``, ``admit``, ``upload``, ``decode``,
  ``readback`` and ``retire``; per layer an ``attn`` and a ``moe`` span
  in each ``decode``, each ``moe`` over ``moe.route``, ``moe.experts``
  and ``moe.combine``; one ``prefill`` per request, inside the ``claim``
  that took it, and one ``admit`` naming it; no layer or MoE span in a
  prefill; and the profiler holding the ranges of the engine's phases
  alone (the layer and MoE spans are buffered without one).
* A training forward under a profiler records no span.
* A scripted finish order on 4 slots, slot 0 last: the ``held`` slots
  counted by hand on each step.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, tracing
from repro_torch.core import CorecRing
from repro_torch.serving import EngineConfig, InferenceEngine, Request
from repro_torch.serving.request import RequestResult

STEP_PHASES = ("release", "upload", "decode", "readback", "retire")


@pytest.fixture(autouse=True)
def _empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _engine(n_slots: int = 4, n_workers: int = 2) -> InferenceEngine:
    cfg = configs.get_tiny("grok-1-314b")
    ecfg = EngineConfig(n_slots=n_slots, max_seq=24, n_workers=n_workers, eos_token=-1)
    gen = torch.Generator().manual_seed(17)
    return InferenceEngine(cfg, ecfg, generator=gen, device="cpu")


def _requests(n: int, new_tokens: int = 3) -> list:
    rng = np.random.default_rng(18)
    return [
        Request(rid=i, prompt=list(map(int, rng.integers(2, 500, 4 + i % 3))),
                max_new_tokens=new_tokens, session=i % 3)
        for i in range(n)
    ]


def _profiled(fn):
    """``fn()`` on a thread of its own while an all-thread CPU profiler,
    started on this thread, records; returns (fn's result, profiler)."""
    out = {}
    worker = threading.Thread(target=lambda: out.update(value=fn()), daemon=True)
    cfg = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg) as prof:
        worker.start()
        worker.join(timeout=300)
    assert not worker.is_alive(), "the engine did not finish"
    return out["value"], prof


def _children(spans) -> dict:
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def _inside(child, parent) -> bool:
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_nothing_recorded_and_no_range_entered_without_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    class Counting(real):
        def __init__(self, *args, **kw):
            made.append(args)
            super().__init__(*args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    assert not torch.autograd.profiler._is_profiler_enabled
    eng = _engine()
    res = eng.run(_requests(6), timeout=120)
    assert len(res) == 6 and eng.decode_steps > 0
    assert tracing.spans() == [] and tracing.dropped() == 0
    assert made == []
    assert not tracing.span("step", step=0)  # the shared no-op is false


def test_span_tree_of_an_engine_run_under_an_all_thread_profiler():
    eng = _engine()
    reqs = _requests(6)
    res, prof = _profiled(lambda: eng.run(reqs, timeout=120))
    assert sorted(r.rid for r in res) == list(range(6))
    spans = tracing.spans()
    assert spans and all(s.end_ns is not None for s in spans)
    assert tracing.dropped() == 0
    kids = _children(spans)
    n_layers = eng.cfg.n_layers

    steps = [s for s in spans if s.name == "step"]
    assert [s.fields["step"] for s in steps] == list(range(eng.decode_steps))
    for st in steps:
        inner = kids.get(st.id, [])
        names = [c.name for c in inner]
        for phase in STEP_PHASES:
            assert names.count(phase) == 1, (st, names)
        assert names.count("admit") == 1
        assert all(c.tid == st.tid and _inside(c, st) for c in inner)
        assert 1 <= st.fields["active"] <= 4 and st.fields["held"] >= 0
        (dec,) = [c for c in inner if c.name == "decode"]
        assert dec.fields["step"] == st.fields["step"]
        layers = kids.get(dec.id, [])
        for name in ("attn", "moe"):
            got = sorted(c.fields["layer"] for c in layers if c.name == name)
            assert got == list(range(n_layers)), (name, got)
        assert all(_inside(c, dec) for c in layers)
        for moe in (c for c in layers if c.name == "moe"):
            parts = [c.name for c in kids.get(moe.id, [])]
            assert parts == ["moe.route", "moe.experts", "moe.combine"]

    by_id = {s.id: s for s in spans}
    inner = ("attn", "moe", "moe.route", "moe.experts", "moe.combine")
    for s in (s for s in spans if s.name in inner):
        assert not s.ranged and by_id[s.parent].name in ("decode", "moe"), s
    assert all(s.ranged for s in spans if s.name not in inner)
    prefills = [s for s in spans if s.name == "prefill"]
    assert sorted(s.fields["rid"] for s in prefills) == list(range(6))
    for s in prefills:
        claim = by_id[s.parent]
        assert claim.name == "claim" and s.fields["rid"] in claim.fields["rids"]
        assert s.fields["tokens"] == len(reqs[s.fields["rid"]].prompt)
    claimed = [r for s in spans if s.name == "claim" for r in s.fields["rids"]]
    admitted = [r for s in spans if s.name == "admit" for r in s.fields["rids"]]
    assert sorted(claimed) == sorted(admitted) == list(range(6))
    for s in (s for s in spans if s.name == "claim"):
        assert s.fields["items"] == len(s.fields["rids"]) > 0
    for s in (s for s in spans if s.name == "admit"):
        assert len(s.fields["wait_ns"]) == len(s.fields["rids"])
        assert all(w >= 0 for w in s.fields["wait_ns"])
    finished = sum(s.fields["finished"] for s in spans if s.name == "retire")
    assert finished == 6

    ranges = {e.name for e in prof.events() if e.name.startswith("repro.")}
    assert ranges == {tracing.range_name(s) for s in spans if s.ranged}
    assert {r.split(":")[0] for r in ranges} == {
        "repro.claim", "repro.prefill", "repro.step", "repro.release",
        "repro.admit", "repro.upload", "repro.decode", "repro.readback",
        "repro.retire",
    }


def test_a_training_forward_records_no_span():
    eng = _engine()
    tokens = torch.randint(2, 500, (2, 8), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens, "labels": tokens}
    (loss, _), _ = _profiled(lambda: eng.model.loss(eng.params, batch))
    assert torch.isfinite(loss)
    assert tracing.spans() == []


class _Drain:
    """Nothing to submit: the run ends at ``n`` answers."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(())


def test_held_slots_of_a_scripted_finish_order():
    """Slots 0-3 admitted at once with budgets 4, 1, 2, 3: slot 0
    finishes last, so each step's release finds one more finished slot
    held behind it (0, 1, 2, 3) and the drain releases all four."""
    eng = _engine(n_workers=1)
    with torch.inference_mode():
        for rid, budget in enumerate((4, 1, 2, 3)):
            req = _requests(4)[rid]
            cache1, logits = eng._prefill(eng._run_params, eng._make_batch(req))
            rr = RequestResult(rid=rid, tokens=[int(torch.argmax(logits[0]))],
                               t_arrival=time.perf_counter(),
                               t_first_token=time.perf_counter(), worker=0)
            eng._staged.append((cache1, rr, budget))
    res, _ = _profiled(lambda: eng.run(_Drain(4), rate=1e9, timeout=60))
    assert [r.rid for r in res] == [1, 2, 3, 0]
    spans = tracing.spans()
    kids = _children(spans)
    steps = [s for s in spans if s.name == "step"]
    assert [s.fields["held"] for s in steps] == [0, 1, 2, 3]
    assert [s.fields["active"] for s in steps] == [4, 3, 2, 1]
    released = [
        [c for c in kids[s.id] if c.name == "release"][0].fields for s in steps
    ]
    assert released == [{"runs": [], "held": h} for h in (0, 1, 2, 3)]
    (drain,) = [s for s in spans if s.name == "release" and s.parent is None]
    assert drain.fields == {"runs": [4], "held": 0}
    assert eng.head == eng.tail == 4


# ---------------------------------------------------------------- RingStats


def test_ring_stats_exact_under_a_producer_and_four_claimers():
    """20,000 items through a 1,024-slot ring, one producer and four
    claiming threads, with the interpreter switching threads every
    microsecond: every counter adds up exactly, over the ring and in
    each thread's own shard. The threads share one 30 s deadline and
    stop at it."""
    total, ring = 20_000, CorecRing(1024)
    deadline = time.monotonic() + 30.0
    stop = threading.Event()
    taken = [0]
    lock = threading.Lock()
    claims = [0] * 4
    items = [0] * 4
    shards = [None] * 5

    def produce():
        sent = 0
        while sent < total and not stop.is_set():
            n = ring.produce_batch(range(sent, min(sent + 64, total)))
            sent += n
            if not n:
                time.sleep(0)
        shards[4] = ring.stats.shard()

    def consume(w):
        while not stop.is_set():
            with lock:
                if taken[0] >= total:
                    break
            c = ring.claim(8)
            if c is None:
                # An empty poll helps release, as a worker's does: the
                # last completions' release may have lost the trylock.
                ring.try_release()
                time.sleep(0)
                continue
            claims[w] += 1
            items[w] += len(c)
            with lock:
                taken[0] += len(c)
            ring.complete(c)
            ring.try_release()
        shards[w] = ring.stats.shard()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=produce, daemon=True)] + [
            threading.Thread(target=consume, args=(w,), daemon=True) for w in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in threads)
    finally:
        stop.set()
        sys.setswitchinterval(old)
    while ring.tail < total:
        assert ring.try_release() > 0
    s = ring.stats.snapshot()
    assert s["produced"] == s["claimed_items"] == s["released_items"] == total
    assert s["claims"] == sum(claims) == ring.stats.claims
    assert s["atomic_ops"] > 0 and list(s) == list(ring.stats.snapshot())
    assert shards[4].produced == total
    assert [(c.claims, c.claimed_items) for c in shards[:4]] == list(zip(claims, items))


def test_ring_stats_keep_counts_whose_increment_spans_a_thread_switch():
    """``atomic_ops += self._done.set_range(...)`` reads the count before
    the call and stores it after. Here every thread reads, then waits at
    a barrier until all 8 have read before any of them stores: one
    shared counter keeps about one update a round (of 8 x 500, about
    500), while each thread's own shard keeps every one. The threads
    share one 30 s deadline; at it the barrier breaks and they stop."""
    ring, n, rounds = CorecRing(64), 8, 500
    deadline = time.monotonic() + 30.0
    barrier = threading.Barrier(n)

    def word_ops():
        barrier.wait()  # a thread switch between every read and its store
        return 1

    def count():
        try:
            for _ in range(rounds):
                ring.stats.shard().atomic_ops += word_ops()
        except threading.BrokenBarrierError:
            return

    threads = [threading.Thread(target=count, daemon=True) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    barrier.abort()
    assert not any(t.is_alive() for t in threads)
    assert ring.stats.atomic_ops == n * rounds
    assert ring.stats.snapshot()["atomic_ops"] == n * rounds
