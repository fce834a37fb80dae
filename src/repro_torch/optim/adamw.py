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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamW", "OptState", "apply_updates", "global_norm"]


class OptState(NamedTuple):
    m: Any  # fp32 first moments, the parameters' tree
    v: Any  # fp32 second moments
    step: torch.Tensor  # 0-d int32: updates taken


def global_norm(tree) -> torch.Tensor:
    """sqrt of the Python sum, leaf by leaf in sorted-key order, of each
    leaf's fp32 sum of squares (the reference's ``global_norm``)."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


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
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        dev = tree_leaves(params)[0].device
        return OptState(
            m=tree_map(zeros, params),
            v=tree_map(zeros, params),
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def update(
        self, grads, state: OptState, params, lr: torch.Tensor
    ) -> Tuple[Any, OptState]:
        """-> (updates, new state); ``lr`` a 0-d fp32 tensor (or a float)."""
        step = state.step + 1
        scale = None
        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def leaf(g, m, v, p):
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
