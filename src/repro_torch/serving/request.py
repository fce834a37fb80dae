"""Serving request/result types."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

__all__ = ["Request", "RequestResult"]


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    session: int = 0  # flow identity (RSS hashes this; COREC ignores it)
    t_arrival: float = field(default_factory=time.perf_counter)


@dataclass
class RequestResult:
    rid: int
    tokens: List[int]
    t_arrival: float
    t_first_token: float = 0.0
    t_done: float = 0.0
    worker: int = -1

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrival

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival
