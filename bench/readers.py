"""What the metric readers share: the window's requests and decode
steps, percentiles, and the traced spans of each kind."""

from __future__ import annotations

import numpy as np

__all__ = ["in_window", "p95", "window_steps", "traced_spans", "share"]


def in_window(record: dict) -> list:
    """The requests due in the window."""
    return [r for r in record["requests"] if r["in_window"]]


def p95(values):
    """The 95th percentile (linear), or None over no values or where a
    value is missing: a request that never reached the point counts as
    missing every limit."""
    if not values or any(v is None for v in values):
        return None
    return float(np.percentile(values, 95))


def window_steps(record: dict) -> list:
    """The decode steps started in the window, with their index."""
    t0, t1 = record["window"]
    return [(i, t, a) for i, (t, a) in enumerate(record["steps"]) if t0 <= t < t1]


def traced_spans(record: dict, kind: str) -> list:
    """``(fields, device seconds by operation)`` of every ``kind`` span
    (``prefill``, ``decode``) that opened and closed inside the trace;
    ``fields`` are the span name's parts after the kind."""
    tr = record.get("trace")
    if not tr:
        return []
    out = []
    for name in tr["complete"]:
        parts = name.split(":")
        if parts[0] == f"bench.{kind}":
            out.append((parts[1:], tr["spans"].get(name, {})))
    return out


def share(part: float, whole: float):
    """``part / whole`` in percent, or None over nothing measured."""
    return 100.0 * part / whole if whole > 0 else None
