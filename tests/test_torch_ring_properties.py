"""The port's protocol model against its ring, the reference and kernel 2.

``repro_torch.core.protocol_sim`` re-expresses the port's ``CorecRing``
protocol (per-item and word-packed planes) as stepped coroutines that
yield after every shared access.  Here:

* hypothesis schedules drive both planes with the safety invariants
  checked after every step, and every schedule steps the port's model
  and the reference's in lockstep: the same step labels, the same
  deliveries and cursors;
* the port's real ring agrees with the model on a sequential schedule,
  and its packed plane is observationally equivalent to its per-item
  plane (sequential schedules, and threads);
* the packed TAIL scan the model steps (``_word_run``) equals the
  batched done-prefix (``ops.done_prefix_batch``) on the unpacked masks,
  on ``chip_smoke.py`` phase 18d's rows: the plain version here, the
  CUDA kernel under the ``cuda`` marker.
"""

from __future__ import annotations

import importlib.util
import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import protocol_sim as rsim
from repro_torch.core import protocol_sim as sim
from repro_torch.core.ring import CorecRing
from repro_torch.kernels import ops
from repro_torch.kernels.doneprefix import done_prefix_batch_cuda

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()


def _lockstep(packed: bool, schedule, n_payloads, max_batch, burst=16, size=64):
    """Step the port's model and the reference's on one schedule (the
    invariants are checked inside ``run_schedule`` after every step) and
    return both traces: step labels, deliveries, cursors."""
    traces = []
    for mod in (sim, rsim):
        state = mod.SimState(size)
        if packed:
            actors = [mod.producer_packed(state, list(range(n_payloads)), burst=burst)]
            actors += [
                mod.consumer_packed(state, w, max_batch=max_batch, rounds=1000)
                for w in range(3)
            ]
        else:
            actors = [mod.producer(state, list(range(n_payloads)))]
            actors += [
                mod.consumer(state, w, max_batch=max_batch, rounds=1000)
                for w in range(3)
            ]
        res = mod.run_schedule(state, actors, schedule)
        traces.append(
            (res.steps, res.trace, list(state.delivered), state.head,
             state.claim_head, state.tail)
        )
    return traces


@settings(max_examples=60, deadline=None)
@given(
    schedule=st.lists(st.integers(0, 3), min_size=50, max_size=600),
    n_payloads=st.integers(1, 100),
    max_batch=st.integers(1, 8),
)
def test_interleavings_preserve_invariants_and_equal_reference(
    schedule, n_payloads, max_batch
):
    port, ref = _lockstep(False, schedule, n_payloads, max_batch)
    assert port == ref


@settings(max_examples=60, deadline=None)
@given(
    schedule=st.lists(st.integers(0, 3), min_size=50, max_size=600),
    n_payloads=st.integers(1, 100),
    max_batch=st.integers(1, 8),
    burst=st.integers(1, 64),
)
def test_packed_interleavings_preserve_invariants_and_equal_reference(
    schedule, n_payloads, max_batch, burst
):
    port, ref = _lockstep(True, schedule, n_payloads, max_batch, burst)
    assert port == ref


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_long_fair_schedules_drain(seed, packed):
    rnd = random.Random(seed)
    n = 120
    schedule = [rnd.randrange(5) for _ in range(15_000)]
    state = sim.SimState(64)
    if packed:
        actors = [sim.producer_packed(state, list(range(n)), burst=16)]
        actors += [sim.consumer_packed(state, w, 4, 10_000) for w in range(4)]
    else:
        actors = [sim.producer(state, list(range(n)))]
        actors += [sim.consumer(state, w, 4, 10_000) for w in range(4)]
    sim.run_schedule(state, actors, schedule)
    assert sorted(state.delivered) == sorted(state.produced_payloads) == list(range(n))


# ---------------------------------------------------------------------
# The model against the port's real ring
# ---------------------------------------------------------------------
def test_sequential_consumer_matches_real_ring():
    ring = CorecRing(64)
    state = sim.SimState(64)
    for i in range(40):
        assert ring.produce(i)
    for _ in sim.producer(state, list(range(40))):
        pass
    got = []
    while (c := ring.claim(max_batch=7)) is not None:
        ring.complete(c)
        ring.try_release()
        got.extend(c.payloads)
    for _ in sim.consumer(state, 0, max_batch=7, rounds=100):
        pass
    assert got == state.delivered == list(range(40))
    assert ring.tail == state.tail == 40


def _drive_sequential(ring: CorecRing, ops_):
    """Apply a deterministic op sequence; return the observable trace."""
    trace, held = [], []
    for op, arg in ops_:
        if op == "produce":
            trace.append(("produce", ring.produce_batch(list(arg))))
        elif op == "claim":
            c = ring.claim(max_batch=arg)
            trace.append(("claim", None if c is None else (c.start, c.end, c.payloads)))
            if c is not None:
                held.append(c)
        elif op == "complete" and held:
            c = held.pop(arg % len(held))
            ring.complete(c)
            trace.append(("complete", (c.start, c.end)))
        elif op == "release":
            trace.append(("release", ring.try_release()))
        trace.append(("cursors", ring.head, ring.claim_head, ring.tail))
    for c in held:
        ring.complete(c)
    while (c := ring.claim(max_batch=8)) is not None:
        ring.complete(c)
        trace.append(("drain", c.start, c.end, list(c.payloads)))
    while ring.try_release():
        pass
    trace.append(("final", ring.head, ring.claim_head, ring.tail))
    return trace


@pytest.mark.parametrize("size", [8, 64, 128])
@pytest.mark.parametrize("seed", range(5))
def test_packed_observationally_equivalent_sequential(seed, size):
    rnd = random.Random(seed)
    ops_, nxt = [], 0
    for _ in range(rnd.randrange(5, 60)):
        k = rnd.randrange(4)
        if k == 0:
            n = rnd.randrange(1, 2 * size)
            ops_.append(("produce", range(nxt, nxt + n)))
            nxt += n
        elif k == 1:
            ops_.append(("claim", rnd.randrange(1, size + 1)))
        elif k == 2:
            ops_.append(("complete", rnd.randrange(8)))
        else:
            ops_.append(("release", None))
    assert _drive_sequential(CorecRing(size, packed=True), ops_) == _drive_sequential(
        CorecRing(size, packed=False), ops_
    )


@pytest.mark.parametrize("packed", [True, False])
def test_threaded_exactly_once_disjoint_covering_claims(packed):
    ring = CorecRing(128, packed=packed)
    n = 4000
    delivered, intervals = [], []
    lock, stop = threading.Lock(), threading.Event()

    def worker():
        while not stop.is_set():
            c = ring.claim(max_batch=16)
            if c is None:
                ring.try_release()
                continue
            ring.complete(c)
            ring.try_release()
            with lock:
                delivered.extend(c.payloads)
                intervals.append((c.start, c.end))

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    i = 0
    while i < n:
        i += ring.produce_batch(list(range(i, min(i + 37, n))))
    deadline = time.time() + 30
    while time.time() < deadline:
        with lock:
            if len(delivered) == n:
                break
        time.sleep(0.001)
    stop.set()
    for t in threads:
        t.join(timeout=2)
    while ring.try_release():
        pass
    assert sorted(delivered) == list(range(n))
    ivs = sorted(intervals)
    assert ivs[0][0] == 0 and ivs[-1][1] == n
    assert all(e1 == s2 for (_, e1), (s2, _) in zip(ivs, ivs[1:]))
    assert ring.tail == ring.head == n and ring.epoch() == n // 128


# ---------------------------------------------------------------------
# The packed TAIL scan against the batched done-prefix (kernel 2)
# ---------------------------------------------------------------------
def _word_run_case(size: int, dev):
    masks, st_, lim, want = CHIP.word_run_rows(size, np.random.default_rng(size))
    got = ops.done_prefix_batch(
        torch.from_numpy(masks).to(dev),
        torch.from_numpy(st_).to(dev),
        torch.from_numpy(lim).to(dev),
    )
    return got.cpu().numpy(), want, lim


@pytest.mark.parametrize("size", [64, 100, 128, 320, 1000])
def test_word_run_equals_done_prefix_batch_plain(size):
    got, want, lim = _word_run_case(size, "cpu")
    np.testing.assert_array_equal(got, want)
    # the rows reach every limit class: 0, partial runs and the full ring
    assert (lim == 0).any() and (lim == size).any() and (want == size).any()
    assert ((want > 0) & (want < lim)).any()


def test_word_run_rows_cover_every_word_edge():
    masks, st_, _, _ = CHIP.word_run_rows(256, np.random.default_rng(0))
    edges = {(64 * k + d) % 256 for k in range(4) for d in (-1, 0, 1)}
    assert set(st_.tolist()) == edges and masks.shape[1] == 256


@pytest.mark.cuda
@pytest.mark.parametrize("size", CHIP.WORD_RUN_SIZES)
def test_cuda_word_run_equals_done_prefix_batch_kernel(size):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batched done-prefix kernel")
    before = done_prefix_batch_cuda.launches
    got, want, _ = _word_run_case(size, torch.device("cuda"))
    assert done_prefix_batch_cuda.launches == before + 1
    np.testing.assert_array_equal(got, want)
