"""The lane axis split over the ranks of a process group: the port of the
reference's ``shard_map`` over ``("lanes",)`` (``jaxplane.py:1506-1510``,
``tcpjax.py:1049-1053``).

As in the reference, each policy segment is padded on its own to a
multiple of the shard count by repeating its last lane
(``jaxplane.py:1591-1599``), and rank r holds the r-th contiguous slice
of every padded segment.  The budgets (``s_pad``, the slot count, the
claim budget) are fixed before the split, so they do not depend on the
rank.  After the scans, every rank gathers every segment's per-lane
outputs in rank order, which is the reference's lane order, drops the
padding and runs the exactly-once check on the whole.

Each lane draws from its own generator, so a lane's results do not
depend on which rank runs it; the reference's draws (``setups=``) are
padded and split the same way as the lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "shard_slice",
    "shard_seeds",
    "shard_knobs",
    "shard_setup",
    "all_gather_lanes",
]


def shard_slice(lanes: int, n_shards: int, rank: int) -> tuple:
    """``(lo, hi)``: rank ``rank``'s lanes of a segment of ``lanes``
    padded to a multiple of ``n_shards``, as indices into the padded
    segment."""
    per = -(-lanes // n_shards)
    return rank * per, (rank + 1) * per


def _pad_take(a, lanes: int, n_shards: int, rank: int):
    """Rows ``lo:hi`` of ``a`` (lane axis 0) padded with its last row."""
    lo, hi = shard_slice(lanes, n_shards, rank)
    idx = np.minimum(np.arange(lo, hi), lanes - 1)
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)].contiguous()
    return np.asarray(a)[idx]


def shard_knobs(knobs: dict, lanes: int, n_shards: int, rank: int) -> dict:
    """A knob dict with every ``[lanes]`` array cut to the rank's lanes;
    scalars (broadcast to every lane, and the static knobs) pass as they
    are."""
    out = {}
    for k, v in knobs.items():
        a = np.asarray(v)
        out[k] = _pad_take(a, lanes, n_shards, rank) if a.shape == (lanes,) else v
    return out


def shard_seeds(seeds, n_shards: int, rank: int) -> np.ndarray:
    """The rank's lane seeds of a segment (padding repeats the last)."""
    seeds = np.asarray(seeds)
    return _pad_take(seeds, len(seeds), n_shards, rank)


def shard_setup(setup, lanes: int, n_shards: int, rank: int):
    """A setup dataclass (``_LaneSetup`` / ``_TcpSetup``) with every
    tensor field cut to the rank's lanes on its axis 0."""
    return dataclasses.replace(
        setup,
        **{
            f.name: _pad_take(getattr(setup, f.name), lanes, n_shards, rank)
            for f in dataclasses.fields(setup)
            if isinstance(getattr(setup, f.name), torch.Tensor)
        },
    )


def all_gather_lanes(fields: Dict[str, torch.Tensor], n_shards: int, lanes: int):
    """Every rank's ``fields`` (tensors sharing a lane axis 0 of the
    rank's length) gathered in rank order and cut to the segment's first
    ``lanes`` lanes (the padding dropped).  The fields travel as one byte
    buffer per rank, so the gather is one collective per segment and
    every value arrives bit for bit.  Under ``gloo``, which gathers host
    memory only, the buffer goes through the host."""
    names = list(fields)
    local = next(iter(fields.values())).shape[0]
    dev = next(iter(fields.values())).device
    parts, layout = [], []
    for k in names:
        t = fields[k].contiguous()
        b = t.view(torch.uint8).reshape(local, -1) if t.numel() else (
            torch.empty((local, 0), dtype=torch.uint8, device=dev)
        )
        parts.append(b)
        layout.append((k, t.dtype, tuple(t.shape[1:]), b.shape[1]))
    buf = torch.cat(parts, dim=1)
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        buf = buf.cpu()
    got = [torch.empty_like(buf) for _ in range(n_shards)]
    dist.all_gather(got, buf)
    whole = torch.cat(got)[:lanes].to(dev)
    out, at = {}, 0
    for k, dtype, rest, width in layout:
        col = whole[:, at : at + width].contiguous()
        out[k] = col.view(dtype).reshape((lanes,) + rest)
        at += width
    return out
