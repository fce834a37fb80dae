"""The device trace of a run: ``torch.profiler`` over a window, reduced
to what the per-layer metrics read.

Every thread is traced (``profile_all_threads``): the harness's spans
are ``record_function`` ranges named ``bench.<kind>:<id>...`` on the
thread that calls into the engine.  A device operation belongs to the
span open on the thread that launched it, at the time it launched it:
the CUDA runtime call (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
``cudaMemcpyAsync``...) carries the device operation's correlation id
and the launching thread's id.

The reduction keeps, per span, the device seconds of each operation by
its short name; over the window, the seconds in which some device
operation ran (``busy_s``), the operations that took most time, and
the idle gaps summed by what the host threads were inside at the time.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

__all__ = ["Tracer", "reduce_events", "short_name", "SPAN_PREFIX"]

SPAN_PREFIX = "bench."
_RUNTIME = re.compile(r"^cu[A-Z]|^cuda[A-Z]")


def short_name(name: str) -> str:
    """A device operation's name without return type, template
    arguments, parameters and anonymous namespace."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void ", "", s)
    cut = min((i for i in (s.find("<"), s.find("(")) if i > 0), default=len(s))
    return s[:cut].strip()


class Tracer:
    """``torch.profiler`` over every thread, started and stopped by the
    thread that made it (the profiler's client registers on that thread
    and its callbacks must run there: the process's main thread, while
    the engine runs on another).  :meth:`warm` once in set-up takes the
    profiler's own start-up out of the traced stretch."""

    def __init__(self):
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._make = lambda: profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(profile_all_threads=True),
        )

    def warm(self):
        prof = self._make()
        prof.start()
        self._torch.cuda.synchronize()
        prof.stop()

    def trace(self, start: float, seconds: float) -> dict:
        """Sleep until ``start`` (``time.perf_counter``), trace for
        ``seconds``, and return the reduced trace."""
        time.sleep(max(0.0, start - time.perf_counter()))
        prof = self._make()
        prof.start()
        t0 = time.time_ns()
        time.sleep(seconds)
        self._torch.cuda.synchronize()
        t1 = time.time_ns()
        prof.stop()
        return reduce_events(_rows(prof.profiler.kineto_results.events()), t0, t1)


def _rows(events):
    """Kineto events as plain tuples: (kind, name, start_ns, dur_ns,
    correlation, os_tid); kind is "device", "runtime" or "span"."""
    out = []
    for e in events:
        name = e.name()
        on_device = "CUDA" in str(e.device_type())
        span = e.is_user_annotation()
        if on_device:
            if span:
                continue  # the GPU-side copy of a host span
            kind = "device"
        elif span and name.startswith(SPAN_PREFIX):
            kind = "span"
        elif _RUNTIME.match(name):
            kind = "runtime"
        else:
            continue
        start, dur = e.start_ns(), e.duration_ns()
        out.append((kind, name, start, dur, e.correlation_id(), e.device_resource_id()))
    return out


def _union_s(intervals, lo: int, hi: int) -> float:
    busy, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy / 1e9


def reduce_events(rows, t0: int, t1: int) -> dict:
    """The reduction of :func:`_rows` over the window ``[t0, t1]`` ns."""
    launch = {c: (tid, s) for k, _, s, _, c, tid in rows if k == "runtime"}
    spans = defaultdict(list)  # os tid -> [(start, end, name)]
    for k, name, s, d, _, tid in rows:
        if k == "span":
            spans[tid].append((s, s + d, name))
    for v in spans.values():
        v.sort()

    starts = {tid: [a for a, _, _ in v] for tid, v in spans.items()}

    def owner(corr):
        tid, s = launch.get(corr, (None, None))
        i = bisect.bisect_right(starts.get(tid, ()), s) - 1
        if i >= 0 and spans[tid][i][1] >= s:
            return spans[tid][i][2]
        return None

    per_span = defaultdict(lambda: defaultdict(float))
    ops = defaultdict(float)
    intervals = []
    kernels = 0
    for k, name, s, d, c, _ in rows:
        if k != "device":
            continue
        e = s + d
        if e <= t0 or s >= t1:
            continue
        kernels += not name.startswith(("Memcpy", "Memset"))
        short = short_name(name)
        ops[short] += d / 1e9
        intervals.append((s, e))
        span = owner(c)
        if span is not None:
            per_span[span][short] += d / 1e9
    return {
        "window_s": (t1 - t0) / 1e9,
        "kernels": kernels,
        "device_events": sum(k == "device" for k, *_ in rows),
        "busy_s": _union_s(intervals, t0, t1),
        "spans": {k: dict(v) for k, v in per_span.items()},
        "complete": _complete_spans(spans, t0, t1),
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": _idle_gaps(intervals, spans, t0, t1),
    }


def _complete_spans(spans, t0: int, t1: int) -> list:
    """The spans that opened and closed inside the window."""
    return sorted(n for v in spans.values() for a, b, n in v if a >= t0 and b <= t1)


def _merged(intervals) -> tuple:
    """A union of intervals as sorted (starts, ends)."""
    starts, ends = [], []
    for a, b in sorted(intervals):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def _idle_gaps(intervals, spans, t0: int, t1: int) -> list:
    """Device idle seconds, summed by the kinds of span ("prefill",
    "decode"...) that host threads were inside at each gap's middle."""
    by_kind = defaultdict(list)
    for v in spans.values():
        for a, b, n in v:
            by_kind[n[len(SPAN_PREFIX) :].split(":")[0]].append((a, b))
    unions = {k: _merged(v) for k, v in by_kind.items()}

    def inside(u, t):
        i = bisect.bisect_right(u[0], t) - 1
        return i >= 0 and u[1][i] >= t

    out = defaultdict(float)
    end = t0
    for s, e in sorted(intervals) + [(t1, t1)]:
        s = min(s, t1)
        if s > end:
            mid = (s + end) // 2
            kinds = sorted(k for k, u in unions.items() if inside(u, mid))
            label = "+".join(kinds) if kinds else "outside engine calls"
            label += " (host)"
            out[label] += (s - end) / 1e9
        end = max(end, min(e, t1))
    return sorted(out.items(), key=lambda kv: -kv[1])[:10]
