"""The port's lane engine and sweep API.

Build a :class:`SweepRequest` and call :func:`run_sweep`; it runs on
the CUDA device unless ``device="cpu"`` is passed.
"""

from .policy import (
    make_torch_policy,
    overload_defaults,
    serving_defaults,
    torch_policies,
)
from .servingtorch import sweep_serving_torch
from .sweep import SweepRequest, SweepResult, run_sweep
from .tcptorch import TcpLaneResult, run_tcp_lanes, run_tcp_lanes_fused
from .torchplane import LaneResult, lane_grid

__all__ = [
    "SweepRequest",
    "SweepResult",
    "run_sweep",
    "torch_policies",
    "make_torch_policy",
    "serving_defaults",
    "overload_defaults",
    "sweep_serving_torch",
    "LaneResult",
    "lane_grid",
    "TcpLaneResult",
    "run_tcp_lanes",
    "run_tcp_lanes_fused",
]
