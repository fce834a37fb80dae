"""Production mesh construction: the port of ``repro.launch.mesh``.

Functions (never module-level constants), so importing this module
starts no process group.

A ``DeviceMesh`` needs a process group of its size.  On a cluster that
is the default group; in one process with no cluster,
:func:`fake_process_group` starts torch's ``fake`` backend, whose ranks
exist only as a world size and whose collectives do nothing: the
port's counterpart of the reference's forced host devices.  Meshes made
that way give partition specs, placements and local shard shapes of a
256- or 512-device mesh, and place no data.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from .. import compat
from ..sharding import AbstractMesh

__all__ = [
    "production_mesh_shape",
    "fake_process_group",
    "make_production_mesh",
    "make_local_mesh",
]


def production_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 ``("data", "model")`` single-pod (256 chips) or 2x16x16
    ``("pod", "data", "model")`` two-pod (512 chips), as names and sizes."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def fake_process_group(world_size: int) -> None:
    """Start the default process group as ``world_size`` ranks of torch's
    ``fake`` backend in this one process (this process is rank 0).  The
    backend lives in ``torch.testing._internal``; this is the one place
    the port imports it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh as a ``DeviceMesh``.  Over the default process
    group when it is initialised (a cluster of 256 or 512 ranks, on
    ``device``'s type, default the card); with no group, over a
    :func:`fake_process_group` of that size started here, on the CPU
    (shapes and placements only: nothing is placed)."""
    from torch.distributed.device_mesh import init_device_mesh

    am = production_mesh_shape(multi_pod=multi_pod)
    if not dist.is_initialized():
        fake_process_group(math.prod(am.axis_sizes))
        return init_device_mesh("cpu", am.axis_sizes, mesh_dim_names=am.axis_names)
    return compat.make_mesh(am.axis_sizes, am.axis_names, device)


def make_local_mesh(device=None):
    """Every rank of the default process group as a ``(data, model)``
    mesh of ``(world, 1)``, on ``device`` (default: the card).  With no
    group, a one-rank group is started here (``gloo`` on the CPU,
    ``nccl`` on the card)."""
    dev = compat.resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return compat.make_mesh((compat.device_count(), 1), ("data", "model"), dev)
