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

The models take the rules as ``rules`` (None: one device, every helper
below the identity or the plain cast) and lay out weights and
activations the reference's two ways: :func:`use_weight` casts a
weight and drops its ``embed`` (FSDP) sharding at the point of use,
an all-gather over ``data`` whose backward is DTensor's reduce-scatter
back onto the parameter's placement; :func:`constrain` pins an
activation (the reference's ``with_sharding_constraint``).  Work that
is local to a shard -- attention over a (batch, head) shard, the norms
over rows, the scans, the MoE dispatch within its token group -- runs
under :func:`local`, ``local_map`` over the rules' placements, on plain
tensors.  Plain tensors that meet DTensors elsewhere (RoPE tables,
``arange`` iotas, the zero states) are lifted one way only: every
sharded entry point runs under :func:`sharded_region`, which is
``implicit_replication()``, so a plain tensor counts as replicated on
the rules' mesh.

A mesh is either a ``torch.distributed`` ``DeviceMesh`` or an
:class:`AbstractMesh` (axis names and sizes, no process group): the
rules and their partition specs need only the names and sizes, so they
resolve for a 256- or 512-device mesh in a process that has none.
:meth:`LogicalRules.sharding` gives DTensor placements, which need a
``DeviceMesh`` to place a tensor (``launch/mesh.py`` makes one, under
torch's ``fake`` backend when there is no cluster).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

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
    "use_weight",
    "local",
    "sharded_region",
    "serving_region",
    "shard_offset",
    "mesh_dims",
    "is_dtensor",
    "sharded_zeros",
    "from_local",
    "local_device",
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


def _shard_placements(spec, mesh: AbstractMesh):
    """DTensor placements over ``mesh``'s dims for a partition spec:
    tensor dim d sharded over mesh axes (a, b, ...) is ``Shard(d)`` on
    each of them, and DTensor splits in mesh-dim order (so
    ``("pod", "data")`` is pod major, as XLA splits it).  On an axis of
    size 1 a part is ``Replicate()``: the one shard is the whole dim,
    and DTensor refuses to reshape a dim it holds as sharded, even over
    one device (a ``(world, 1)`` mesh's every TP weight)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.axis_names
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        for a in (part,) if isinstance(part, str) else (part or ()):
            i = names.index(a)
            if mesh.axis_sizes[i] > 1:
                out[i] = Shard(d)
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
        return _shard_placements(self.spec, abstract_mesh(self.mesh))

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


def use_weight(rules: Optional[LogicalRules], w, axes, dt: torch.dtype):
    """The reference's ``use_weight`` (``layers.py:70-79``): ``w`` cast to
    ``dt``, then laid out by the logical ``axes`` -- the weight's axes
    with ``embed`` dropped, so the FSDP shard over ``data`` is gathered
    at the matmul (in ``dt``, after the cast) and TP axes stay.  Without
    rules, the cast alone."""
    return constrain(rules, w.to(dt), *axes)


def _placements(rules: LogicalRules, axes):
    # a list: local_map reads a tuple of placements as one per output
    return None if axes is None else list(rules.sharding(tuple(axes)).placements)


def local(rules: Optional[LogicalRules], fn: Callable, out_axes, in_axes) -> Callable:
    """``fn`` on each rank's local shards (``local_map``): every tensor
    argument redistributed to the rules' placements of its entry of
    ``in_axes`` (None: a non-tensor argument), the outputs declared by
    ``out_axes``: one axes tuple for a single output, a list of them
    (None for a non-tensor) for a tuple of outputs.  ``fn`` must be right on any shard of those axes;
    the gradients flow back on the inputs' placements.  Without rules,
    ``fn`` itself."""
    if rules is None:
        return fn
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import Partial

    if isinstance(out_axes, list):
        out = tuple(_placements(rules, a) for a in out_axes)
    else:
        out = _placements(rules, out_axes)
    ins = [_placements(rules, a) for a in in_axes]
    # an input replicated over a mesh dim that another input shards over
    # meets a different shard on each rank there: its gradient is a
    # Partial sum over that dim
    split = [any(p is not None and p[i].is_shard() for p in ins)
             for i in range(rules.mesh.ndim)]
    grads = tuple(
        None if p is None else [
            Partial() if split[i] and q.is_replicate() else q for i, q in enumerate(p)
        ]
        for p in ins
    )
    return local_map(
        fn,
        out_placements=out,
        in_placements=tuple(ins),
        in_grad_placements=grads,
        device_mesh=rules.mesh,
        redistribute_inputs=True,
    )


_REGION = threading.local()


@contextlib.contextmanager
def sharded_region(rules: Optional[LogicalRules]):
    """The context a sharded entry point runs in: with rules,
    ``implicit_replication()`` (a plain tensor meeting a DTensor counts
    as replicated on its mesh); without, nothing.  Regions nest: only
    the outermost enters and leaves ``implicit_replication``, which
    resets its flag on exit, so a step's region also covers the
    backward of a loss that opened its own."""
    depth = getattr(_REGION, "depth", 0)
    if rules is None or depth:
        _REGION.depth = depth + (rules is not None)
        try:
            yield
        finally:
            _REGION.depth = depth
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _REGION.depth = 1
    try:
        with implicit_replication():
            yield
    finally:
        _REGION.depth = 0


@contextlib.contextmanager
def serving_region(rules: Optional[LogicalRules]):
    """What a prefill or decode step runs in (inside its
    ``inference_mode``): with rules, :func:`sharded_region` under
    ``no_grad`` with inference mode off, since DTensor's views of an
    inference tensor fail; without, nothing."""
    if rules is None:
        yield
        return
    with torch.inference_mode(False), torch.no_grad(), sharded_region(rules):
        yield


def mesh_dims(rules: LogicalRules, axis: Optional[str]) -> list:
    """The dims (indices) of the rules' ``DeviceMesh`` of size above 1 that
    logical ``axis`` shards over."""
    part = rules.pspec((axis,))
    part = part[0] if part else ()
    names = rules.mesh.mesh_dim_names
    return [
        names.index(a)
        for a in ((part,) if isinstance(part, str) else part or ())
        if rules.mesh.size(names.index(a)) > 1
    ]


def shard_offset(rules: LogicalRules, axis: Optional[str], size: int) -> int:
    """Where this rank's shard of a ``size``-long dim laid out by logical
    ``axis`` starts (0 when it is not sharded), split as DTensor splits
    (``torch.chunk``, in mesh-dim order)."""
    sh = rules.sharding((axis,))
    am = abstract_mesh(sh.mesh)
    coord = sh.mesh.get_coordinate() if hasattr(sh.mesh, "get_coordinate") else None
    coord = coord or (0,) * len(am.axis_names)
    start = 0
    for i, p in enumerate(sh.placements):
        if getattr(p, "dim", None) is None:
            continue
        per = -(-size // am.axis_sizes[i])
        start += min(per * coord[i], size)
        size = max(0, min(per, size - per * coord[i]))
    return start


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a sharded run's tensor)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def sharded_zeros(rules: Optional[LogicalRules], shape, axes, dtype, device):
    """Zeros of ``shape``: without rules a tensor on ``device``; with
    rules a DTensor laid out by the logical ``axes``, made from this
    rank's zero shard on ``device`` (so on ``meta`` nothing is
    allocated)."""
    if rules is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    sh = rules.sharding(tuple(axes))
    local_t = torch.zeros(sh.shard_shape(shape), dtype=dtype, device=device)
    return from_local(local_t, sh, shape)


def from_local(local_t: torch.Tensor, sh: NamedSharding, shape):
    """The DTensor of global ``shape`` placed by ``sh`` whose shard on
    this rank is ``local_t`` (contiguous strides; no collective)."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(
        local_t, sh.mesh, list(sh.placements), run_check=False,
        shape=shape, stride=tuple(reversed(stride)),
    )


def local_device(t: torch.Tensor) -> torch.device:
    """Where ``t``'s data lives: a DTensor's local shard's device (``meta``
    in a dry run, where the mesh says ``cpu``)."""
    return t.to_local().device if is_dtensor(t) else t.device
