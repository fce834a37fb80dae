"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller names the CPU.
There is no silent fallback: asking for the default device on a host
without CUDA raises, so a measurement can never quietly come from the
CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); ``"cpu"``
    only when the caller says so, as the CPU tests do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "present; pass device='cpu' to run the plain versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
