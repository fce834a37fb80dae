"""The port's lane engine and sweep API.

Build a :class:`SweepRequest` and call :func:`run_sweep`; it runs on
the CUDA device unless ``device="cpu"`` is passed.
"""

from .policy import make_torch_policy, torch_policies
from .sweep import SweepRequest, SweepResult, run_sweep
from .torchplane import LaneResult, lane_grid

__all__ = [
    "SweepRequest",
    "SweepResult",
    "run_sweep",
    "torch_policies",
    "make_torch_policy",
    "LaneResult",
    "lane_grid",
]
