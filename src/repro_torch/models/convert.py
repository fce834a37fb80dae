"""Carry the reference's parameters across: ``repro`` pytree -> port tree.

The tests build a model with the JAX package's ``DecoderLM(cfg).init``,
hand its parameters over as numpy arrays, and compare the two models on
the same inputs.  The card run uses the port's own ``init`` instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compat import resolve_device
from ..config import ArchConfig
from .api import build_model
from .spec import tree_leaves

__all__ = ["params_from_reference"]


def params_from_reference(cfg: ArchConfig, params_np, device=None):
    """The reference's ``init(rng)`` tree (nested dicts of numpy-convertible
    leaves, layers stacked ``[L, ...]``) as the port's parameters on
    ``device`` (default: the card), leaf for leaf, in each spec's dtype.
    Raises on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)
    specs = dict(tree_leaves(build_model(cfg).param_specs()))
    given = dict(tree_leaves(params_np))
    missing = sorted(set(specs) - set(given))
    extra = sorted(set(given) - set(specs))
    if missing or extra:
        raise KeyError(f"{cfg.name}: missing leaves {missing}, extra leaves {extra}")
    out: dict = {}
    for path, spec in specs.items():
        leaf = np.array(given[path], dtype=np.float32)  # a writable copy
        if leaf.shape != spec.shape:
            raise ValueError(
                f"{cfg.name}: leaf {path} has shape {leaf.shape}, the model "
                f"wants {spec.shape}"
            )
        node = out
        *parents, name = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = torch.from_numpy(leaf).to(device=dev, dtype=spec.dtype)
    return out
