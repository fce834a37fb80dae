"""What the port's model families share: stacked layer specs, the
``init``/``prepare``/``init_cache`` half of their API, and the label
log-probabilities their losses take.

Parameters travel as an argument (a nested dict of tensors, the
reference's pytree), so one model object serves fp32 masters and
prepared trees alike; the model itself holds only the config.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..compat import resolve_device
from ..config import ArchConfig
from ..sharding import is_dtensor, sharded_zeros
from .layers import cdtype, label_logprobs, unembed
from .spec import ParamSpec, abstract_params, init_params, spec_map

__all__ = ["LMBase"]


#: the matmuls without batch dims, whose outputs "dots" keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _stack(n: int, specs):
    """Prepend a layer dim to every leaf of a spec tree."""
    return spec_map(
        lambda s: ParamSpec((n,) + s.shape, (None,) + s.axes, s.init, s.scale, s.dtype),
        specs,
    )


def _unstack(tree, n: int):
    """A stacked ``[L, ...]`` tree -> L per-layer trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if is_dtensor(tree):  # DTensor's unbind fails on inference tensors
        return [tree[i] for i in range(n)]
    return torch.unbind(tree, 0)


class LMBase(nn.Module):
    """Subclasses define ``param_specs()``, ``cache_specs(batch, seq)``
    and ``FP32_KEYS``."""

    #: the subtrees and leaves, by key, that decode reads as stored fp32
    #: (the reference casts them to fp32, or not at all, at use)
    FP32_KEYS: Tuple[str, ...] = ()

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        """fp32 master parameters on ``device`` (default: the card), drawn
        from ``generator`` (default: seed 0 on that device)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return init_params(self.param_specs(), generator, dev)

    def abstract_params(self):
        """The parameter tree on the ``meta`` device: shapes and dtypes,
        nothing allocated."""
        return abstract_params(self.param_specs())

    def prepare(self, params):
        """The tree to run: every floating leaf outside ``FP32_KEYS`` cast
        to the compute dtype once (the values the reference's cast at
        each use gives); the leaves under ``FP32_KEYS`` as stored, as
        decode reads them.  Prefill still rounds those per call, as the
        reference's ``cast_tree`` does."""
        dt = cdtype(self.cfg)

        def go(tree, keep=False):
            if isinstance(tree, dict):
                return {k: go(v, keep or k in self.FP32_KEYS) for k, v in tree.items()}
            return tree if keep or not tree.is_floating_point() else tree.to(dt)

        return go(params)

    def _remat(self, fn, *args):
        """One layer ``fn(*args)``, honouring ``cfg.remat`` as the
        reference's ``_remat`` does (``transformer.py:54-60``): under grad
        mode with ``remat`` on, policy ``"full"`` runs the layer under
        ``torch.utils.checkpoint`` (its activations recomputed in the
        backward, not kept), and ``"dots"`` (jax's
        ``checkpoint_dots_with_no_batch_dims``) does so selectively: the
        outputs of the un-batched matmuls (``aten.mm``, ``aten.addmm``,
        which every projection of a ``[B, S, d]`` activation by a 2-D
        weight becomes) are kept and the rest is recomputed.
        ``"none"``, ``remat`` off, or no grad mode runs it plainly."""
        cfg = self.cfg
        if not (torch.is_grad_enabled() and cfg.remat) or cfg.remat_policy == "none":
            return fn(*args)
        if cfg.remat_policy == "dots":
            return checkpoint(fn, *args, use_reentrant=False, context_fn=_dots_context)
        if cfg.remat_policy != "full":
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        return checkpoint(fn, *args, use_reentrant=False)

    def _label_logprobs(self, params, x, labels, rules=None):
        """(logsumexp, label logit) of the fp32 logits of the hidden
        states ``x`` [B, S, d] at ``labels`` [B, S], the reference's
        ``unembed(...).astype(float32)`` then ``label_logprobs``."""
        logits = unembed(params["embed"], x, self.cfg, rules).float()
        return label_logprobs(logits, labels, self.cfg.vocab, rules)

    def _mean_ce(self, params, x, labels, rules=None):
        """The unmasked mean cross-entropy, as (ce, {"ce": ce}): the loss
        of the families without a z-loss or aux term (RWKV6, Zamba2,
        Whisper)."""
        lse, ll = self._label_logprobs(params, x, labels, rules)
        ce = (lse - ll).mean()
        return ce, {"ce": ce}

    def init_cache(self, batch_size: int, seq_len: int, device, rules=None):
        """An empty cache of :meth:`cache_specs` on ``device``; with rules,
        DTensors laid out by the specs' axes, each rank's zeros on
        ``device``."""
        return spec_map(
            lambda s: sharded_zeros(rules, s.shape, s.axes, s.dtype, device),
            self.cache_specs(batch_size, seq_len),
        )
