"""The port's own spans: what the serving path is doing, recorded only
while a ``torch.profiler`` session records somewhere in the process.

``span(name, **fields)`` is a context manager.  While no profiler
records it returns one shared no-op object and does nothing else (not
even constructing a ``record_function``, whose entry alone costs
microseconds).  While one records it

* appends a :class:`Span` to a bounded in-memory buffer (name, fields,
  thread, parent span from the thread's own stack, start and end on
  ``time.perf_counter_ns``: the clock of the engine's request stamps),
  counting the spans it had to drop once the buffer is full;
* opens a ``torch.profiler.record_function`` range named
  ``repro.<name>[:<id>...]`` (the ids: the values of whichever of
  ``worker``, ``rid``, ``step``, ``layer`` are among the fields), so
  that every device operation launched inside carries it on the trace's
  own timeline.

``inner_span(name, **fields)`` is the same span without the profiler
range: for the spans inside a phase, a decode step's layers and MoE
blocks, some thirty a step, whose ranges would cost the profiled
program more than the work they time.  Such a span lies on the trace's
timeline through its enclosing phase, which is in both the buffer and
the trace.  ``no_span`` takes the same arguments and never records,
for a call site that records only on some paths.

The check is the process-wide ``torch.autograd.profiler``
``_is_profiler_enabled`` flag, read by the two alone: a profiler
started on one thread (``profile_all_threads``) records the others,
where the C-level check is thread-local and reads false.

Counts live as fields on the span at the boundary where the work
happens; spans of one request share its ``rid``.  A caller that builds
a field only for the trace tests the span first: the no-op is false.

The buffer is one per process, as the profiler it follows is.  Where
the serving path opens which span: ``PERF.md``, section 3.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = [
    "ID_FIELDS",
    "MAX_SPANS",
    "Span",
    "clear",
    "dropped",
    "inner_span",
    "no_span",
    "range_name",
    "span",
    "spans",
]

#: the buffer's bound: ~40 spans a decode step of six layers, so a traced
#: stretch of minutes fits; past it spans are counted as dropped, not kept
MAX_SPANS = 1 << 17
#: fields whose values name the profiler range, in this order
ID_FIELDS = ("worker", "rid", "step", "layer")


class Span:
    """One recorded span, and while it is open its context manager.
    ``end_ns`` is None until it closes; ``parent`` is the id of the span
    open on the same thread when it opened (None at the top); ``ranged``
    whether it opens a profiler range (:func:`span`) or not
    (:func:`inner_span`)."""

    __slots__ = (
        "id", "name", "fields", "tid", "parent", "start_ns", "end_ns", "ranged",
        "_range",
    )

    def __init__(self, id: int, name: str, fields: dict, tid: int = 0,
                 parent: Optional[int] = None, start_ns: int = 0,
                 end_ns: Optional[int] = None, ranged: bool = True):
        self.id = id
        self.name = name
        self.fields = fields
        self.tid = tid
        self.parent = parent
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.ranged = ranged
        self._range = None

    def __repr__(self) -> str:
        return (
            f"Span({self.id}, {self.name!r}, {self.fields!r}, tid={self.tid}, "
            f"parent={self.parent}, start_ns={self.start_ns}, end_ns={self.end_ns})"
        )

    def set(self, **fields) -> None:
        """Add fields known only once the work inside has run."""
        self.fields.update(fields)

    def __enter__(self) -> "Span":
        stack = _thread_stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if self.ranged:
            self._range = torch.profiler.record_function(range_name(self))
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _thread_stack().pop()
        return False


def range_name(s: Span) -> str:
    """The profiler range of a span: ``repro.<name>[:<id>...]``."""
    ids = "".join(f":{s.fields[k]}" for k in ID_FIELDS if k in s.fields)
    return f"repro.{s.name}{ids}"


class _Off:
    """The span while nothing records: enters, exits, is false."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **fields) -> None:
        pass


_OFF = _Off()
_buffer: List[Span] = []
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()  # guards the drop count
_state = {"dropped": 0}


def _thread_stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, **fields):
    """A span of ``name`` with ``fields``: a :class:`Span` to enter
    while a ``torch.profiler`` session records in this process, else
    the shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _open(name, fields, True)


def inner_span(name: str, **fields):
    """As :func:`span`, buffered without a profiler range."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _open(name, fields, False)


def no_span(name: str, **fields):
    """The shared no-op, whatever records."""
    return _OFF


def _open(name: str, fields: dict, ranged: bool):
    if len(_buffer) >= MAX_SPANS:
        with _lock:
            _state["dropped"] += 1
        return _OFF
    s = Span(next(_ids), name, fields, threading.get_native_id(), ranged=ranged)
    _buffer.append(s)
    return s


def spans() -> List[Span]:
    """The recorded spans in the order they opened (a copy)."""
    return list(_buffer)


def clear() -> None:
    """Empty the buffer and its drop count."""
    with _lock:
        _buffer.clear()
        _state["dropped"] = 0


def dropped() -> int:
    """Spans not kept since the last :func:`clear`: the buffer was full."""
    return _state["dropped"]
