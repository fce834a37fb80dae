"""The port's TCP lane engine on its own draws against the DES plane.

The counterpart of ``test_tcpjax.py::test_distributional_parity_with_des_plane``
for ``repro_torch``: torch draws differ from ``jax.random``, so parity
is distributional.  Twelve flows of 50 packets starting 4 apart, six
seeds, all five policies in one fused port call; the DES plane
(``repro.core.tcp``, three seeds, steered by the lane engine's 32-bit
hash through ``queue_hints``) pools its FCTs the same way.  Pooled FCT
p50 and p99 per policy within ``test_tcpjax.py``'s tolerances.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.policy import jax_policies  # noqa: E402
from repro.core.tcp import TcpSimConfig, simulate_tcp  # noqa: E402

from repro_torch.core import SweepRequest, run_sweep  # noqa: E402
from repro_torch.core.torchplane import rss_hash32  # noqa: E402

POLICIES = jax_policies()
N_WORKERS = 4
N_FLOWS, NPK = 12, 50
P50_RTOL = 0.15
P99_RTOL = 0.35


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The lane tensors are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _port_sweep():
    return run_sweep(
        SweepRequest(
            scenario="tcp",
            seeds=np.arange(6),
            n_packets=np.full(N_FLOWS, NPK),
            t_start=np.arange(N_FLOWS) * 4.0,
            n_workers=N_WORKERS,
        ),
        device="cpu",
    )


def _des_fcts(name: str) -> np.ndarray:
    flows = [(i, NPK, 4.0 * i) for i in range(N_FLOWS)]
    hints = {
        i: int(h) for i, h in enumerate(rss_hash32(np.arange(N_FLOWS), N_WORKERS))
    }
    out = []
    for seed in range(3):
        cfg = TcpSimConfig(
            policy=name, n_workers=N_WORKERS, seed=seed, queue_hints=hints
        )
        out += [r.fct for r in simulate_tcp(flows, cfg)]
    return np.asarray(out)


@pytest.mark.parametrize("name", POLICIES)
def test_distributional_parity_with_des_plane(name):
    res = _port_sweep()[name]
    assert bool(res.done.all())
    sends = res.sends
    assert bool((res.claimed_popcount == sends).all())
    assert bool((res.claimed_prefix == sends).all())
    j = res.fct.numpy().ravel()
    d = _des_fcts(name)
    for q, rtol in ((50, P50_RTOL), (99, P99_RTOL)):
        got, want = np.percentile(j, q), np.percentile(d, q)
        assert got == pytest.approx(want, rel=rtol), (name, q, got, want)
