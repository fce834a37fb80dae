"""Parameter specification trees, with torch dtypes.

Models declare their parameters as nested dicts of ``ParamSpec`` leaves
(shape + logical axis names + initialiser), as ``repro.models.spec``
does; :func:`init_params` materialises them, :func:`abstract_params`
gives their stand-ins on the ``meta`` device (shapes and dtypes, nothing
allocated), and ``repro_torch.sharding`` resolves the logical axis names
into partition specs over a mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

__all__ = ["ParamSpec", "init_params", "abstract_params", "spec_map", "tree_leaves"]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | constant
    scale: Optional[float] = None  # stddev (normal) or value (constant)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ")


def spec_map(fn: Callable[[ParamSpec], Any], specs):
    """Apply ``fn`` to every leaf of a nested dict of specs."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: spec_map(fn, v) for k, v in specs.items()}


def tree_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict in sorted key order -- the
    order in which ``jax.tree_util`` flattens a dict."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += tree_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def _leaf_init(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "constant":
        return torch.full(spec.shape, spec.scale, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        # fan-in scaled unless an explicit stddev is given
        if spec.scale is not None:
            std = spec.scale
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(
            spec.shape, generator=generator, dtype=torch.float32, device=device
        )
        return (x.mul_(std)).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def abstract_params(specs):
    """Every leaf as a tensor on the ``meta`` device: the spec's shape and
    dtype, no storage (the reference's ``ShapeDtypeStruct`` stand-ins)."""
    return spec_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def init_params(specs, generator: torch.Generator, device):
    """Materialise real parameters on ``device``: the reference's
    initialisers (``repro.models.spec._leaf_init``), drawn from
    ``generator`` leaf after leaf in sorted key order.  The draws are
    torch's, not ``jax.random``'s: the distributions agree, the numbers
    do not (the tests carry the reference's numbers across instead)."""
    if isinstance(specs, ParamSpec):
        return _leaf_init(specs, generator, device)
    return {k: init_params(specs[k], generator, device) for k in sorted(specs)}
