"""Failure detection + checkpoint/restart orchestration (the port's own
copy of ``repro.runtime.fault``).

At fleet scale the failure story is: heartbeats -> detector marks a host
dead -> the run controller re-forms the mesh from survivors (elastic.py)
-> state restores from the last committed checkpoint (checkpoint/ckpt.py
reshards automatically) -> the data pipeline resumes at its released TAIL
position.  ``SimCluster`` exercises the whole path with threads standing
in for hosts (tests/test_runtime.py); on a real fleet the heartbeat
transport is the only piece that changes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

__all__ = ["HeartbeatTable", "FailureDetector", "SimCluster"]


class HeartbeatTable:
    def __init__(self):
        self._beats: Dict[int, float] = {}
        self._lock = threading.Lock()

    def beat(self, host: int, t: Optional[float] = None):
        with self._lock:
            self._beats[host] = t if t is not None else time.monotonic()

    def last(self, host: int) -> Optional[float]:
        with self._lock:
            return self._beats.get(host)

    def hosts(self) -> List[int]:
        with self._lock:
            return sorted(self._beats)


class FailureDetector:
    """Deadline-based: a host missing ``timeout`` seconds of beats is dead."""

    def __init__(self, table: HeartbeatTable, timeout: float = 1.0):
        self.table = table
        self.timeout = timeout
        self.declared_dead: Set[int] = set()

    def check(self, now: Optional[float] = None) -> Set[int]:
        now = now if now is not None else time.monotonic()
        dead = set()
        for h in self.table.hosts():
            if h in self.declared_dead:
                continue
            last = self.table.last(h)
            if last is not None and now - last > self.timeout:
                dead.add(h)
        self.declared_dead |= dead
        return dead

    def alive(self) -> List[int]:
        return [h for h in self.table.hosts() if h not in self.declared_dead]


@dataclass
class SimCluster:
    """Thread-per-host harness for fault-path tests.

    Each 'host' runs ``work_fn(host_id, step)`` in a loop and beats; the
    controller detects failures, rebuilds the roster and invokes
    ``on_refit(survivors)`` — the same control flow a real multi-host
    launcher runs (with jax.distributed + real heartbeat transport).
    """

    n_hosts: int
    work_fn: Callable[[int, int], None]
    heartbeat_every: float = 0.02
    detect_timeout: float = 0.2
    table: HeartbeatTable = field(default_factory=HeartbeatTable)
    _killed: Set[int] = field(default_factory=set)
    _stop: threading.Event = field(default_factory=threading.Event)
    refits: List[List[int]] = field(default_factory=list)

    def _host_loop(self, host: int):
        step = 0
        while not self._stop.is_set():
            if host in self._killed:
                return  # crash: stop beating
            self.work_fn(host, step)
            self.table.beat(host)
            step += 1
            time.sleep(self.heartbeat_every)

    def kill(self, host: int):
        self._killed.add(host)

    def run(self, duration: float, on_refit: Callable[[List[int]], None]):
        threads = [
            threading.Thread(target=self._host_loop, args=(h,), daemon=True)
            for h in range(self.n_hosts)
        ]
        for h in range(self.n_hosts):
            self.table.beat(h)
        for t in threads:
            t.start()
        det = FailureDetector(self.table, self.detect_timeout)
        t_end = time.monotonic() + duration
        while time.monotonic() < t_end:
            dead = det.check()
            if dead:
                survivors = det.alive()
                self.refits.append(survivors)
                on_refit(survivors)
            time.sleep(self.heartbeat_every)
        self._stop.set()
        for t in threads:
            t.join(timeout=1.0)
        return det
