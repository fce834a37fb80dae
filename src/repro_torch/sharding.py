"""Logical-axis sharding rules (MaxText-style) for the production mesh:
the port of ``repro.sharding``.

One place decides how every logical tensor dimension maps onto mesh
axes; models only speak logical names (``models/spec.py``).  The
resolution is config-aware, as the reference's:

* ``heads``/``kv_heads`` shard over ``model`` only when the head count
  divides the model-axis size (``attn_tp``); otherwise attention weights
  stay replicated on ``model`` and TP applies to MLP + vocab only.
* ``experts`` shards over ``model`` (expert parallelism) only with
  ``expert_parallel=True``; otherwise ``expert_mlp`` takes the TP role.
* ``embed`` (weight d_model dims) shards over ``data`` (ZeRO-3/FSDP).
* ``batch`` shards over ``("pod", "data")``; ``cache_seq`` (the KV
  cache's sequence dim) over ``model``.

A mesh is either a ``torch.distributed`` ``DeviceMesh`` or an
:class:`AbstractMesh` (axis names and sizes, no process group): the
rules and their partition specs need only the names and sizes, so they
resolve for a 256- or 512-device mesh in a process that has none.
:meth:`LogicalRules.sharding` gives DTensor placements, which need a
``DeviceMesh`` to place a tensor (``launch/mesh.py`` makes one, under
torch's ``fake`` backend when there is no cluster).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .config import ArchConfig
from .models.spec import spec_map

__all__ = [
    "AbstractMesh",
    "NamedSharding",
    "LogicalRules",
    "abstract_mesh",
    "make_rules",
    "resolve_axes",
    "tree_shardings",
    "activation_sharding",
    "batch_spec",
    "constrain",
]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape alone: ``axis_sizes`` by ``axis_names`` (the
    reference's ``jax.sharding.AbstractMesh``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(mesh) -> AbstractMesh:
    """The names and sizes of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(int(s) for s in mesh.shape), tuple(mesh.mesh_dim_names))


def _shard_placements(spec, names: Tuple[str, ...]):
    """DTensor placements over mesh dims ``names`` for a partition spec:
    tensor dim d sharded over mesh axes (a, b, ...) is ``Shard(d)`` on
    each of them, and DTensor splits in mesh-dim order (so
    ``("pod", "data")`` is pod major, as XLA splits it)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        for a in (part,) if isinstance(part, str) else (part or ()):
            out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A partition spec over a mesh: ``spec`` (the reference's
    ``PartitionSpec`` as a tuple of mesh-axis names, a name, a tuple of
    names or None per tensor dim) and its DTensor ``placements``."""

    mesh: object
    spec: Tuple

    @property
    def placements(self):
        return _shard_placements(self.spec, abstract_mesh(self.mesh).axis_names)

    def shard_shape(self, shape, coordinate=None) -> Tuple[int, ...]:
        """The local shape of a ``shape`` tensor on the device at
        ``coordinate`` (default: this rank's on a ``DeviceMesh``, the
        first device's on an :class:`AbstractMesh`), split as DTensor
        splits: ``torch.chunk`` sizes, so an uneven dim leaves the last
        shards short (XLA pads instead)."""
        am = abstract_mesh(self.mesh)
        if coordinate is None:
            coordinate = getattr(self.mesh, "get_coordinate", lambda: None)()
        coordinate = coordinate or (0,) * len(am.axis_names)
        out = list(shape)
        for dim_idx, p in enumerate(self.placements):
            d = getattr(p, "dim", None)
            if d is None:
                continue
            k, c = am.axis_sizes[dim_idx], coordinate[dim_idx]
            per = -(-out[d] // k)
            out[d] = max(0, min(per, out[d] - c * per))
        return tuple(out)

    def distribute(self, tensor: torch.Tensor):
        """``tensor`` as a DTensor placed by this sharding (needs a
        ``DeviceMesh``)."""
        from torch.distributed.tensor import distribute_tensor

        if isinstance(self.mesh, AbstractMesh):
            raise TypeError("an AbstractMesh places nothing; build a DeviceMesh")
        return distribute_tensor(tensor, self.mesh, list(self.placements))


class LogicalRules:
    def __init__(self, table: Dict[str, Optional[Tuple[str, ...]]], mesh):
        self.table = table
        self.mesh = mesh

    def pspec(self, axes: Tuple[Optional[str], ...]) -> Tuple:
        names = abstract_mesh(self.mesh).axis_names
        parts = []
        used = set()
        for ax in axes:
            m = self.table.get(ax) if ax is not None else None
            if m is None:
                parts.append(None)
                continue
            m = tuple(a for a in m if a in names and a not in used)
            used.update(m)
            parts.append(m if len(m) != 1 else m[0])
        # trim trailing Nones for cleanliness
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def sharding(self, axes: Tuple[Optional[str], ...]) -> NamedSharding:
        return NamedSharding(self.mesh, self.pspec(axes))


def _axis_size(mesh, name: str) -> int:
    return abstract_mesh(mesh).shape.get(name, 1)


def make_rules(cfg: ArchConfig, mesh) -> LogicalRules:
    model = _axis_size(mesh, "model")
    attn_tp = cfg.attn_tp
    if attn_tp is None:
        attn_tp = cfg.n_heads % model == 0 and cfg.n_heads >= model
    # expert parallelism off unless the config asks for it, as in the
    # reference (group-local dispatch + expert-FFN TP)
    ep = bool(cfg.expert_parallel)

    table: Dict[str, Optional[Tuple[str, ...]]] = {
        "batch": ("pod", "data"),
        "embed": ("data",),
        "mlp": ("model",),
        "vocab": ("model",),
        "heads": ("model",) if attn_tp else None,
        "kv_heads": ("model",)
        if (attn_tp and cfg.n_kv_heads % model == 0 and cfg.n_kv_heads >= model)
        else None,
        "experts": ("model",) if ep else None,
        "expert_mlp": None if ep else ("model",),
        "cache_seq": ("model",) if cfg.seq_shard_cache else None,
        "cache_heads": None,  # resolved below
        "seq": None,  # activation sequence dim (train): stays unsharded
        "enc_seq": None,
        "ssm_heads": ("model",)
        if (
            cfg.ssm_state > 0
            and (cfg.ssm_expand * cfg.d_model // max(cfg.ssm_head_dim, 1)) % model
            == 0
        )
        else None,
        "ssm_inner": ("model",),
        "rwkv_heads": ("model",)
        if (cfg.rwkv and (cfg.d_model // 64) % model == 0)
        else None,
    }
    # KV-cache head sharding: only if kv heads divide model AND the cache
    # is not already sharded on seq (no double use of one axis)
    if (
        not cfg.seq_shard_cache
        and cfg.n_kv_heads % model == 0
        and cfg.n_kv_heads >= model
    ):
        table["cache_heads"] = ("model",)
    return LogicalRules(table, mesh)


def resolve_axes(rules: LogicalRules, axes) -> Tuple:
    return rules.pspec(tuple(axes))


def tree_shardings(rules: LogicalRules, specs):
    """ParamSpec tree -> NamedSharding tree."""
    return spec_map(lambda s: rules.sharding(s.axes), specs)


def activation_sharding(rules: LogicalRules, *axes) -> NamedSharding:
    return rules.sharding(tuple(axes))


def batch_spec(rules: LogicalRules) -> Tuple:
    return rules.pspec(("batch", "seq"))


def constrain(rules: Optional[LogicalRules], x, *axes):
    """``x`` laid out by the logical ``axes`` (the reference's
    ``with_sharding_constraint``): a DTensor is redistributed to the
    rules' placements; without rules, or for a plain tensor (local to
    one device, nothing to lay out), ``x`` itself."""
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sh = rules.sharding(tuple(axes))
    return x.redistribute(sh.mesh, list(sh.placements))
