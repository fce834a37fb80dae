"""The open-loop serving scenario on the port's lane engine.

The counterpart of ``repro.core.servingjax.sweep_serving_jax``: one
serving configuration per (knob, seed) lane, every lane advanced by the
claim-compacted engine in one call, with SLO attainment, offered, shed
and the overload plane's accounting computed on the device -- see
:class:`~repro_torch.core.torchplane.ServingParams` and
:class:`~repro_torch.core.torchplane.OverloadConfig` for the knobs.
Multi-policy serving sweeps go through :func:`repro_torch.core.run_sweep`
(``scenario="serving"``).  The reference's discrete-event half of
``servingjax.py`` is not part of the port.
"""

from __future__ import annotations

from .sweep import ARRIVAL_WORKLOADS
from .torchplane import _fused_lanes

__all__ = ["sweep_serving_torch"]


def sweep_serving_torch(
    policy: str,
    seeds,
    capacity: int = 2000,
    arrival: str = "poisson",
    lane_params: dict | None = None,
    traffic_params: dict | None = None,
    serving_params: dict | None = None,
    fault_params: dict | None = None,
    n_workers: int = 4,
    max_batch: int = 64,
    device=None,
    **kw,
):
    """One policy's serving lanes; returns their
    :class:`~repro_torch.core.torchplane.LaneResult`.

    ``capacity`` is each lane's generation capacity (the engine's
    ``n_packets``); the per-lane ``horizon`` decides how much of it is
    offered.  Sessions are heavy-tailed (service kind ``HT``).  Runs on
    the CUDA device unless ``device="cpu"`` is passed; ``kw`` passes on
    to the engine (``return_times``, ``engine``, ``chunk``, ...).
    """
    return _fused_lanes(
        [
            dict(
                policy=policy,
                seeds=seeds,
                lane_params=lane_params,
                traffic_params=traffic_params,
                fault_params=fault_params,
                serving_params=serving_params or {},
            )
        ],
        workload=ARRIVAL_WORKLOADS[arrival],
        service="HT",
        serving=True,
        n_packets=capacity,
        n_workers=n_workers,
        max_batch=max_batch,
        device=device,
        **kw,
    )[0]
