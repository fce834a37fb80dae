"""Device resolution and the lane axis' process group for the port's
entry points.

Every entry point runs on the card unless the caller names the CPU.
There is no silent fallback: asking for the default device on a host
without CUDA raises, so a measurement can never quietly come from the
CPU.

The lane-axis entry points (``make_mesh``, ``device_count``,
``lane_mesh``) are the counterparts of the reference's
``repro.compat``.  The reference partitions the lane axis over the
local devices of one process; the port partitions it over the ranks of
a ``torch.distributed`` process group (SPMD: one process per shard),
so ``device_count`` is the world size of the default group, or 1 when
no group is set up.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

__all__ = [
    "resolve_device",
    "make_mesh",
    "device_count",
    "lane_mesh",
    "resolve_shards",
]


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


def device_count() -> int:
    """The ranks the lane axis can be split over: the world size of the
    default process group, or 1 when none is set up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the default
    process group (whose world size must be the product of ``shape``),
    on ``device``'s type (default: the card)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    return init_device_mesh(
        dev.type, tuple(int(s) for s in shape), mesh_dim_names=tuple(axis_names)
    )


def lane_mesh(n_shards: int, device=None):
    """A 1-D ``("lanes",)`` mesh over ``n_shards`` ranks: the axis the
    sweep engines (``core/torchplane.py``, ``core/tcptorch.py``) split."""
    return make_mesh((n_shards,), ("lanes",), device)


def resolve_shards(shards) -> int:
    """``shards`` as a count: ``"auto"`` (or None) is :func:`device_count`.
    A count above 1 needs an initialised default process group of exactly
    that many ranks, each of which makes the same call (SPMD); nothing
    falls back to running the shards one after another."""
    n = device_count() if shards in ("auto", None) else max(1, int(shards))
    if n > 1:
        have = dist.get_world_size() if dist.is_initialized() else None
        if have != n:
            raise RuntimeError(
                f"shards={n} splits the lane axis over {n} ranks of a "
                f"torch.distributed process group, and "
                + ("none is initialised" if have is None else f"the group has {have}")
                + f": start {n} processes, call torch.distributed."
                f"init_process_group(backend, init_method='tcp://localhost:<port>', "
                f"rank=r, world_size={n}) in each (repro_torch.distributed."
                f"run_ranks does this), then make the same call on every rank"
            )
    return n
