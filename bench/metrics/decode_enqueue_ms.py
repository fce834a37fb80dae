"""Host milliseconds a decode step spends enqueuing its model step: the
program's ``decode`` span (``repro_torch.tracing``; ``decode_step``
returns once every kernel is enqueued), averaged over the whole steps
that started in the window.

The program records its spans only while a profiler records, so a
traced run (``--trace 1``) gives the number and an untraced one, or a
program without its own spans, gives none.  :func:`step_ms` is what
the readers of the other spans share."""

from __future__ import annotations


def _spans() -> list:
    try:
        from repro_torch import tracing
    except ImportError:  # a program without its own spans
        return []
    return tracing.spans()


def step_ms(record, names):
    """The host ms of the spans named in ``names`` beneath each ``step``
    span (at any depth), averaged over the whole steps (those that reach
    their ``retire``) that started at or after the window's start; None
    where there are no such steps or no such spans."""
    t0_ns = record["window"][0] * 1e9
    spans = [s for s in _spans() if s.end_ns is not None]
    by_id = {s.id: s for s in spans}
    steps = {s.id for s in spans if s.name == "step" and s.start_ns >= t0_ns}
    whole = {s.parent for s in spans if s.name == "retire" and s.parent in steps}
    if not whole:
        return None

    def step_of(s):
        while s is not None and s.id not in whole:
            s = by_id.get(s.parent)
        return s

    total, found = 0, False
    for s in spans:
        if s.name in names and step_of(s) is not None:
            total += s.end_ns - s.start_ns
            found = True
    return total / 1e6 / len(whole) if found else None


def read(record):
    return step_ms(record, {"decode"})
