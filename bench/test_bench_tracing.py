"""The readers of the program's own spans (``repro_torch.tracing``) on a
hand-made span list: each gives its hand-computed value, leaves out the
steps that started before the window and the step the profiler cut
short, and gives None with no steps or without the program's spans."""

from __future__ import annotations

import sys

import pytest

import repro_torch
from bench.spec import BENCH, load_module
from repro_torch import tracing

MS = 1_000_000  # ns
T0 = 10_000 * MS  # the window's start, perf_counter ns


def _read(name: str, record: dict):
    return load_module(BENCH / "metrics" / f"{name}.py").read(record)


class _Tree:
    """Spans laid out one after another on one thread: ``add`` opens a
    span of ``ms`` host milliseconds under ``parent`` at ``at`` ns."""

    def __init__(self):
        self.spans = []
        self.ids = iter(range(1, 1 << 20))

    def add(self, name, at, ms, parent=None, **fields):
        s = tracing.Span(next(self.ids), name, fields, 1, parent and parent.id,
                         at, at + round(ms * MS))
        self.spans.append(s)
        return s

    def step(self, i, at, release, admit, upload, decode, moe, readback, retire):
        """A step of the given phase ms (``moe``: each layer's moe span,
        inside ``decode``); ``retire`` None leaves it out, as when the
        profiler stops inside the step."""
        phases = release + admit + upload + decode + readback + (retire or 0)
        st = self.add("step", at, phases + 0.01, step=i)
        t = at
        for name, ms in (("release", release), ("admit", admit), ("upload", upload)):
            self.add(name, t, ms, st)
            t += round(ms * MS)
        dec = self.add("decode", t, decode, st, step=i)
        u = t
        for layer, m in enumerate(moe):
            self.add("attn", u, 0.5, dec, layer=layer)
            u += MS // 2
            mo = self.add("moe", u, m, dec, layer=layer)
            for part in ("moe.route", "moe.experts", "moe.combine"):
                self.add(part, u, m / 4, mo)
            u += round(m * MS)
        t += round(decode * MS)
        self.add("readback", t, readback, st)
        t += round(readback * MS)
        if retire is not None:
            self.add("retire", t, retire, st, finished=0)
        return st


def _spans():
    tr = _Tree()
    # before the window: counted nowhere
    tr.step(0, T0 - 500 * MS, 9, 9, 9, 90, (50,), 9, 9)
    tr.add("claim", T0 - 10 * MS, 5, worker=0, items=1, rids=[3])
    tr.step(1, T0, 1, 0.2, 0.1, 30, (10, 10), 4, 0.3)
    tr.step(2, T0 + 100 * MS, 2, 0.4, 0.3, 40, (10, 15), 6, 0.5)
    # the profiler stopped inside this one: no retire, counted nowhere
    tr.step(3, T0 + 200 * MS, 5, 5, 5, 100, (60,), 5, None)
    return tr.spans


EXPECTED = {
    "decode_enqueue_ms": (30 + 40) / 2,
    "moe_enqueue_ms": (20 + 25) / 2,
    "decode_sync_ms": (4 + 6) / 2,
    "release_ms": (1 + 2) / 2,
    "loop_host_ms": ((0.2 + 0.1 + 0.3) + (0.4 + 0.3 + 0.5)) / 2,
}
#: with the window opening after step 1: step 2 alone
LATER = {
    "decode_enqueue_ms": 40,
    "moe_enqueue_ms": 25,
    "decode_sync_ms": 6,
    "release_ms": 2,
    "loop_host_ms": 0.4 + 0.3 + 0.5,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_hand_counts(monkeypatch, name):
    spans = _spans()
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    record = {"window": (T0 / 1e9, T0 / 1e9 + 51)}
    assert _read(name, record) == pytest.approx(EXPECTED[name], rel=1e-12)
    later = {"window": ((T0 + 50 * MS) / 1e9, T0 / 1e9 + 51)}
    assert _read(name, later) == pytest.approx(LATER[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_none_without_steps(monkeypatch, name):
    record = {"window": (T0 / 1e9, T0 / 1e9 + 51)}
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert _read(name, record) is None
    spans = _spans()
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    assert _read(name, {"window": ((T0 + 300 * MS) / 1e9, T0 / 1e9 + 51)}) is None
    # a program without its own spans (the import fails): nothing, no error
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert _read(name, record) is None
