"""AdamW with decoupled weight decay, global-norm clipping and fp32 state:
the port of ``repro.optim.adamw``, formula for formula.

The state mirrors the parameter tree (nested dicts of tensors); the
update is functional and returns new tensors, the learning rate arriving
as a 0-d fp32 tensor so that one step function serves the whole
schedule.  ``torch.optim.AdamW`` orders and rounds the same update
differently (its bias corrections, its ``eps`` placement, the decay
applied before the step), so the reference's arithmetic is written out:

  g     <- g * min(1, clip / max(|g|, 1e-9))     (fp32, |g| the global norm)
  m     <- b1 m + (1 - b1) g
  v     <- b2 v + (1 - b2) g^2
  u     =  -lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)
  p     <- (p + u) in p's dtype

The parameter trees are nested dicts.  Each leaf's new moments and
update are computed together, so one leaf's temporaries are freed
before the next leaf's are made.

The same update runs on DTensor trees (a sharded train step): the
moments and updates keep each parameter's placements, each leaf's
arithmetic runs on its local shard (elementwise, so the values are the
one-device formula's), and the step count is a replicated 0-d DTensor.
The global norm is each rank's sum of squares over the shards it owns
(a shard replicated over a mesh dim counts on that dim's first
coordinate only), all-reduced once as a ``Partial`` sum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..sharding import is_dtensor
from ..tree import tree_leaves, tree_map

__all__ = ["AdamW", "OptState", "apply_updates", "global_norm"]


class OptState(NamedTuple):
    m: Any  # fp32 first moments, the parameters' tree
    v: Any  # fp32 second moments
    step: torch.Tensor  # 0-d int32: updates taken


def global_norm(tree) -> torch.Tensor:
    """sqrt of the Python sum, leaf by leaf in sorted-key order, of each
    leaf's fp32 sum of squares (the reference's ``global_norm``).  Over
    DTensor leaves, the same sum taken over every shard once, as one
    all-reduced ``Partial`` sum: a plain 0-d tensor on every rank."""
    leaves = tree_leaves(tree)
    if leaves and is_dtensor(leaves[0]):
        return torch.sqrt(_sharded_sum_sq(leaves))
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def _sharded_sum_sq(leaves) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial

    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    total = torch.zeros((), device=leaves[0].to_local().device)
    for x in leaves:
        # a shard replicated over a mesh dim is counted on its first coordinate
        if not any(p.is_replicate() and c for p, c in zip(x.placements, coord)):
            total = total + torch.sum(torch.square(x.to_local().float()))
    return DTensor.from_local(
        total, mesh, [Partial()] * mesh.ndim, run_check=False
    ).full_tensor()


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def apply_updates(params, updates):
    """``(p + u)`` cast back to each parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> OptState:
        """Zero fp32 moments on each parameter's device; step 0."""

        def zeros(p):
            if is_dtensor(p):  # the parameter's placements
                return torch.zeros_like(p, dtype=torch.float32)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        first = tree_leaves(params)[0]
        step = torch.zeros((), dtype=torch.int32, device=_local(first).device)
        if is_dtensor(first):
            from torch.distributed.tensor import DTensor, Replicate

            mesh = first.device_mesh
            step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim)
        return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params), step=step)

    def update(
        self, grads, state: OptState, params, lr: torch.Tensor
    ) -> Tuple[Any, OptState]:
        """-> (updates, new state); ``lr`` a 0-d fp32 tensor (or a float).
        Over DTensor trees the step count and ``lr`` may be replicated 0-d
        DTensors; each leaf's update runs on its local shard."""
        step = state.step + 1
        scale = None
        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** _local(step).float()
        bc2 = 1 - b2 ** _local(step).float()
        lr = _local(lr)

        def leaf(g, m, v, p):
            if is_dtensor(p):
                from torch.distributed.tensor import DTensor

                out = leaf(*(_local(t) for t in (g, m, v, p)))
                return tuple(
                    DTensor.from_local(t, p.device_mesh, p.placements, run_check=False,
                                       shape=p.shape, stride=p.stride())
                    for t in out
                )
            g = g.float() if scale is None else g.float() * scale
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mhat = m / bc1
            vhat = v / bc2
            u = -lr * (
                mhat / (torch.sqrt(vhat) + self.eps)
                + self.weight_decay * p.float()
            )
            return u, m, v

        def walk(g, m, v, p):  # -> (updates, m, v), each of the params' tree
            if not isinstance(g, dict):
                return leaf(g, m, v, p)
            parts = {k: walk(g[k], m[k], v[k], p[k]) for k in g}
            return tuple({k: parts[k][i] for k in parts} for i in range(3))

        updates, m, v = walk(grads, state.m, state.v, params)
        return updates, OptState(m=m, v=v, step=step)
