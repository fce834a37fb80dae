"""Traffic generators: the MoonGen/Trex stand-ins (paper section 4).

Produces the workloads the paper evaluates with:

* constant-rate / Poisson UDP streams of fixed packet size (Fig 7),
* a MAWI-like real-trace mix: empirical trimodal packet-size distribution
  and bursty (lognormal inter-arrival) timing (Table 4),
* TCP-style flow arrivals: F parallel flows of a given payload size
  decomposed into MSS-sized packets (Table 5, Figs 8-10).

All times are in seconds of *simulated* time; the threaded benchmarks
rescale to wall-clock microseconds, the DES benchmarks consume them as-is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

__all__ = [
    "Packet",
    "udp_stream",
    "mawi_mix",
    "flow_packets",
    "FlowSpec",
    "diurnal_times",
    "heavy_tail_service",
]

MSS = 1460  # bytes of TCP payload per full-size packet


@dataclass
class Packet:
    seqno: int  # global sequence number (generation order)
    flow: int
    flow_seq: int  # sequence within the flow
    size: int  # bytes on the wire
    t_arrival: float  # generation timestamp (simulated seconds)


def udp_stream(
    n: int,
    rate_pps: float,
    size: int = 64,
    poisson: bool = True,
    seed: int = 0,
    n_flows: int = 1,
) -> List[Packet]:
    """Sequenced UDP packets at a target rate (Fig 7's 100k-packet test)."""
    rng = np.random.default_rng(seed)
    if poisson:
        gaps = rng.exponential(1.0 / rate_pps, size=n)
    else:
        gaps = np.full(n, 1.0 / rate_pps)
    t = np.cumsum(gaps)
    flows = rng.integers(0, n_flows, size=n) if n_flows > 1 else np.zeros(n, int)
    flow_seq = {}
    out = []
    for i in range(n):
        f = int(flows[i])
        s = flow_seq.get(f, 0)
        flow_seq[f] = s + 1
        out.append(
            Packet(seqno=i, flow=f, flow_seq=s, size=size, t_arrival=float(t[i]))
        )
    return out


# Empirical MAWI-flavoured packet-size mixture: strong modes at 40-64B
# (ACKs/SYNs), ~576B (legacy MTU) and 1500B (full), plus a uniform body.
_MAWI_SIZES = np.array([40, 64, 120, 576, 1420, 1500])
_MAWI_WEIGHTS = np.array([0.28, 0.12, 0.08, 0.10, 0.12, 0.30])


def mawi_mix(
    n: int,
    mean_rate_pps: float,
    seed: int = 0,
    n_flows: int = 2048,
    burstiness: float = 0.9,
) -> List[Packet]:
    """Real-trace-like mix: trimodal sizes, lognormal (bursty) gaps, many
    concurrent flows with Zipf-ian popularity (a few elephants, many mice).
    """
    rng = np.random.default_rng(seed)
    sizes = rng.choice(_MAWI_SIZES, size=n, p=_MAWI_WEIGHTS / _MAWI_WEIGHTS.sum())
    sigma = burstiness
    mu = np.log(1.0 / mean_rate_pps) - sigma**2 / 2
    gaps = rng.lognormal(mu, sigma, size=n)
    t = np.cumsum(gaps)
    # Zipf flow popularity
    zipf_w = 1.0 / np.arange(1, n_flows + 1) ** 1.1
    zipf_w /= zipf_w.sum()
    flows = rng.choice(n_flows, size=n, p=zipf_w)
    flow_seq: dict = {}
    out = []
    for i in range(n):
        f = int(flows[i])
        s = flow_seq.get(f, 0)
        flow_seq[f] = s + 1
        out.append(
            Packet(
                seqno=i,
                flow=f,
                flow_seq=s,
                size=int(sizes[i]),
                t_arrival=float(t[i]),
            )
        )
    return out


def diurnal_times(
    n: int,
    mean_rate_pps: float,
    amp: float = 0.6,
    period: float = 50.0,
    seed: int = 0,
    rng=None,
) -> np.ndarray:
    """Nonhomogeneous-Poisson arrival times, lambda(t) = rate(1 + amp sin wt).

    Time-rescaling: draw a unit-rate process, invert the cumulative
    intensity Lambda(t) = rate*(t + amp/w*(1 - cos wt)) by damped Newton
    (lambda >= rate*(1 - amp) > 0 bounds the derivative away from 0).
    The numpy mirror of the lane engine's "diurnal" workload — same
    intensity, same inversion — used by the DES serving scenario
    (:mod:`repro_torch.core.servingtorch`) for distributional parity.
    """
    rng = np.random.default_rng(seed) if rng is None else rng
    s = np.cumsum(rng.exponential(size=n))
    amp = float(np.clip(amp, 0.0, 0.95))
    w = 2.0 * np.pi / period
    lam_min = mean_rate_pps * (1.0 - amp)
    t = s / mean_rate_pps
    for _ in range(12):
        big = mean_rate_pps * (t + amp / w * (1.0 - np.cos(w * t)))
        lam = mean_rate_pps * (1.0 + amp * np.sin(w * t))
        t = np.maximum(t - (big - s) / np.maximum(lam, lam_min), 0.0)
    return np.maximum.accumulate(t)


def heavy_tail_service(
    n: int, mean: float, alpha: float = 1.8, seed: int = 0, rng=None
) -> np.ndarray:
    """Heavy-tailed per-request service times (user session sizes).

    Pareto with tail index ``alpha > 1`` via inverse-CDF ``u^(-1/alpha)``
    on a uniform clipped at 1e-4 (~p99.99 truncation), scaled so the
    truncated mean is ``mean`` — matching the lane engine's "HT" service
    kind draw for draw in distribution.
    """
    rng = np.random.default_rng(seed) if rng is None else rng
    u = np.maximum(rng.uniform(size=n), 1e-4)
    return mean * (alpha - 1.0) / alpha * u ** (-1.0 / alpha)


@dataclass
class FlowSpec:
    flow_id: int
    payload_bytes: int
    t_start: float = 0.0

    @property
    def n_packets(self) -> int:
        return max(1, -(-self.payload_bytes // MSS))


def flow_packets(spec: FlowSpec, window: int = 64) -> List[Packet]:
    """All data packets of one flow (used by the TCP model, which releases
    them window-by-window; timestamps are assigned by the sender there)."""
    return [
        Packet(
            seqno=-1,
            flow=spec.flow_id,
            flow_seq=i,
            size=min(MSS, spec.payload_bytes - i * MSS) + 40,
            t_arrival=spec.t_start,
        )
        for i in range(spec.n_packets)
    ]
