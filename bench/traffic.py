"""The one traffic generator: a cell's ``traffic`` parameters and a seed
in, requests out.  The seed draws everything: the arrival gaps, the
prompt lengths and their order, each prompt's token ids and its
session (and, elsewhere, the weights).

Gaps and lengths are stratified: the stream is cut into blocks of
``strata`` requests, and each block takes one draw from each of the
``strata`` equal-probability slices of the distribution, in an order
drawn from the seed.  So every seed offers the same amount of work per
block, and what the seed changes is where in a block the short gaps and
the long prompts fall.  In a queueing model of the qwen2 cell
(two servers, service proportional to the prompt, 15% noise, 286
requests at 0.6 to 0.8 utilisation), ``ttft_p95_s`` spread 5-7% (IQR
over median) across seeds with blocks of 8, against 20-40% where the
whole window's quantiles were reshuffled per seed and 7-15% with one
schedule for every seed.

Parameters (a workload file's ``traffic``):

- ``loop``: ``"open"`` (arrivals on a schedule, whatever the system
  does) or ``"closed"`` (``clients`` callers, each sending its next
  request when its last one is answered);
- ``strata``: requests per block of the stratified draws;
- ``rate_per_s`` (open): Poisson-like arrivals with a fixed count:
  ``round(rate seconds)`` stratified exponential gaps, scaled to fill
  the window;
- ``clients``, ``ramp_s`` (closed): client c sends its first request at
  ``c ramp_s / clients``; the window opens when the ramp ends;
- ``prompt``: ``{"dist": "loguniform" | "uniform", "min", "max"}``
  tokens, stratified; token ids uniform over the configuration's
  vocabulary;
- ``new_tokens``: the tokens each request is served;
- ``sessions`` (optional): ``{"dist": "zipf", "exponent", "ids"}``,
  the flow id a request carries (RSS pins flows; COREC ignores them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

__all__ = ["Planned", "open_plan", "ClosedStream", "prompt_lengths", "stratified"]


@dataclass
class Planned:
    due: float  # seconds after the window opens (open loop)
    prompt: List[int]
    new_tokens: int
    session: int


def _rng(seed: int, stream: int, part: int) -> np.random.Generator:
    """Stream ``stream`` of the seed; ``part`` keeps the gaps, the
    lengths and the tokens apart, so that none shifts another."""
    return np.random.default_rng([int(seed), stream, part])


def stratified(n: int, strata: int, rng: np.random.Generator) -> np.ndarray:
    """n uniforms in [0, 1): blocks of ``strata``, each holding one draw
    from each slice ``[k/strata, (k+1)/strata)``, in a drawn order."""
    blocks = -(-n // strata)
    u = (np.arange(strata) + rng.random((blocks, strata))) / strata
    return rng.permuted(u, axis=1).ravel()[:n]


def prompt_lengths(spec: dict, u: np.ndarray) -> np.ndarray:
    """Prompt lengths at the distribution's quantiles ``u``."""
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "loguniform":
        x = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    elif spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError("unknown prompt dist " + repr(spec["dist"]))
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def _sessions(spec, n: int, rng: np.random.Generator) -> np.ndarray:
    if not spec:
        return np.zeros(n, np.int64)
    if spec["dist"] != "zipf":
        raise ValueError("unknown session dist " + repr(spec["dist"]))
    k = np.arange(1, spec["ids"] + 1, dtype=np.float64)
    p = k ** -spec["exponent"]
    return rng.choice(spec["ids"], size=n, p=p / p.sum())


def open_plan(
    traffic: dict, seed: int, seconds: float, vocab: int, stream: int = 0
) -> List[Planned]:
    """The open loop's requests due in ``[0, seconds)``: ``round(rate
    seconds)`` of them, the first at 0, drawn from ``stream`` of the
    seed (a window and what follows it take streams of their own)."""
    n = max(1, round(traffic["rate_per_s"] * seconds))
    k = traffic["strata"]
    gaps = -np.log1p(-stratified(n, k, _rng(seed, stream, 0)))
    gaps *= seconds / gaps.sum()
    due = np.cumsum(gaps) - gaps
    lens = prompt_lengths(traffic["prompt"], stratified(n, k, _rng(seed, stream, 1)))
    rng = _rng(seed, stream, 2)
    sess = _sessions(traffic.get("sessions"), n, rng)
    return [
        Planned(float(due[i]), rng.integers(0, vocab, int(lens[i])).tolist(),
                traffic["new_tokens"], int(sess[i]))
        for i in range(n)
    ]


class ClosedStream:
    """The closed loop's requests in the order they are sent, their
    lengths stratified in blocks of ``strata``."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.traffic, self.vocab = traffic, vocab
        self.lengths = _rng(seed, 1, 1)  # apart from every open plan's stream
        self.rng = _rng(seed, 1, 2)
        self._lens: list = []

    def first_dues(self) -> np.ndarray:
        """Seconds after the ramp starts at which each client sends first."""
        C = self.traffic["clients"]
        return np.arange(C) * (self.traffic["ramp_s"] / C)

    def next(self) -> Planned:
        if not self._lens:
            k = self.traffic["strata"]
            u = stratified(k, k, self.lengths)
            self._lens = prompt_lengths(self.traffic["prompt"], u)[::-1].tolist()
        n = self._lens.pop()
        sess = int(_sessions(self.traffic.get("sessions"), 1, self.rng)[0])
        return Planned(0.0, self.rng.integers(0, self.vocab, n).tolist(),
                       self.traffic["new_tokens"], sess)
