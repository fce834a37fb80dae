"""The weights both sides are judged on: drawn from the seed on the
device, in the types they are served in, in one draw per dtype.

The tree has the port's layout (``model.abstract_params()``: keys and
shapes), and the values are the benchmark's own rule, not the port's
initialiser: every matrix normal at ``1/sqrt(fan_in)`` of its input
axes, so that each block keeps the scale of its input and the logits
come out near unit spread (the token table at ``1/sqrt(d_model)``, which
also serves as a tied output head); the QKV biases at 0.1;
the norm weights ``1 + 0.1 N(0, 1)``, so that a norm that drops its
weight shows.  Norm weights and the MoE router are fp32 (the port reads
them as stored), everything else bf16 (the compute dtype), so the
port's ``prepare`` casts nothing and both sides read the same bits.

Those are the shared rules (:data:`RULES`), which cover the dense and
MoE decoders.  A configuration's reference module may declare
``WEIGHT_RULES`` for the leaves its family adds, in the same four
tables: ``fan_in`` (leaf name -> input axes, counted from the end),
``std`` (leaf name -> a fixed std), ``offset`` (leaf name -> a value
added after scaling, for leaves such as ``D``, ``A_log`` or ``dt_bias``
whose useful values are not centred on 0) and ``fp32`` (path suffixes
of leaves kept in fp32).  :func:`rules_of` merges them over the shared
ones; a leaf that no rule covers raises ``KeyError`` naming it.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_params", "leaf_paths", "rules_of", "FP32_LEAVES", "RULES"]

#: leaves kept in fp32: the norms' weights and the router
FP32_LEAVES = ("ln1/w", "ln2/w", "final_norm/w", "router")

#: per leaf name: the axes, counted from the end, that a matrix reads
_FAN_IN = {
    "wq": (-3,),
    "wk": (-3,),
    "wv": (-3,),
    "wo": (-3, -2),
    "w1": (-2,),
    "w3": (-2,),
    "w2": (-2,),
    "router": (-2,),
    "out": (-2,),
    "tok": (-1,),
}
_STD = {"bq": 0.1, "bk": 0.1, "bv": 0.1}

#: the shared rules, in the form a reference's ``WEIGHT_RULES`` takes
RULES = {"fan_in": _FAN_IN, "std": _STD, "offset": {}, "fp32": FP32_LEAVES}


def rules_of(reference=None) -> dict:
    """The shared rules with ``reference.WEIGHT_RULES`` (if it declares
    any) merged over them: a leaf name that the reference gives a
    fan-in or a std takes that rule alone; its offsets and fp32 leaves
    join the shared ones."""
    extra = getattr(reference, "WEIGHT_RULES", None) or {}
    unknown = set(extra) - set(RULES)
    if unknown:
        raise KeyError(f"unknown weight rule tables {sorted(unknown)}")
    named = set(extra.get("fan_in", {})) | set(extra.get("std", {}))
    out = {}
    for table in ("fan_in", "std"):
        kept = {k: v for k, v in RULES[table].items() if k not in named}
        out[table] = {**kept, **extra.get(table, {})}
    out["offset"] = {**RULES["offset"], **extra.get("offset", {})}
    out["fp32"] = FP32_LEAVES + tuple(extra.get("fp32", ()))
    return out


def leaf_paths(tree, prefix: str = ""):
    """``(path, leaf)`` of a nested dict in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += leaf_paths(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def _is_fp32(path: str, fp32) -> bool:
    return any(path == p or path.endswith("/" + p) for p in fp32)


def _std(path: str, shape, rules: dict) -> float:
    name = path.rsplit("/", 1)[-1]
    if name in rules["std"]:
        return rules["std"][name]
    axes = rules["fan_in"].get(name)
    if axes is None:
        raise KeyError(f"no weight rule for leaf {path!r}")
    return 1.0 / math.sqrt(math.prod(shape[a] for a in axes))


def make_params(
    model, seed: int, device, dtype=torch.bfloat16, rules: dict = None
) -> dict:
    """The parameter tree of ``model`` drawn from ``seed`` on ``device``
    by ``rules`` (:func:`rules_of`; the shared ones where None): one
    ``randn`` over every bf16 leaf and one over every fp32 leaf, then
    each leaf's slice scaled in place."""
    rules = RULES if rules is None else rules
    leaves = leaf_paths(model.abstract_params())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for fp32 in (False, True):
        group = [(p, a) for p, a in leaves if _is_fp32(p, rules["fp32"]) == fp32]
        dt = torch.float32 if fp32 else dtype
        flat = torch.randn(
            sum(_padded(a.numel()) for _, a in group),
            generator=gen,
            dtype=dt,
            device=device,
        )
        off = 0
        for path, a in group:
            n = a.numel()
            leaf = flat[off : off + n].view(a.shape)
            off += _padded(n)
            if path.endswith("/w") and fp32:  # a norm's weight
                leaf.mul_(0.1).add_(1.0)
            else:
                leaf.mul_(_std(path, a.shape, rules))
                shift = rules["offset"].get(path.rsplit("/", 1)[-1])
                if shift is not None:
                    leaf.add_(shift)
            out[path] = leaf
    return _nest(out)


def _padded(n: int) -> int:
    """``n`` rounded up to 128 elements: every leaf starts 256-byte
    aligned, as a leaf of its own allocation would."""
    return -(-n // 128) * 128


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree
