"""The train, prefill and serve steps, on one device or sharded over a
``DeviceMesh``: the port of ``repro.launch.steps``.

``build_steps`` wires a model and the optimizer into three callables:

* ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
  as the reference's ``steps.py:94-130``: the loss and its gradient with
  respect to every parameter leaf (``value_and_grad`` of ``model.loss``);
  with ``microbatches > 1`` the batch split on its leading axis, the
  gradients summed in fp32 over the microbatches and divided by their
  count, the loss averaged and the metrics replaced by ``{"ce": loss}``;
  then the learning rate from ``lr_fn`` at the optimizer's step count
  *before* this update (so step 1 under a warm-up has lr 0),
  ``optimizer.update`` and ``apply_updates``.  The metrics gain ``loss``
  and ``lr``.  Functional: new parameter and state trees come back, the
  caller's are left as they were.
* ``prefill_step`` and ``serve_step``: the model's ``prefill`` and
  ``decode_step``, under inference mode.

Training runs the plain routes: every kernel refuses an input that
requires a gradient (``kernels._build.refuse_grad``), so a configuration
must name them (``attention_impl="xla"``).

With a ``mesh`` (a ``DeviceMesh`` or a ``sharding.AbstractMesh``) the
bundle also carries the reference's shardings (``steps.py:71-91``): the
train rules and the serve rules (the weights replicated over ``data``
when their bf16 bytes over the model axis stay under 8 GB), the
parameter, optimizer-state, batch and cache shardings, and
``abstract_state()`` (parameters and AdamW state on the ``meta``
device).

With a ``DeviceMesh`` the steps run sharded, the counterpart of the
reference's ``jax.jit(in_shardings=..., out_shardings=...)``
(``dryrun.py:145-174``): the state arrives as DTensors on the bundle's
shardings (:func:`place_state`), each step places a batch (plain
tensors, global) by ``batch_sharding``, runs the model with the rules
(prefill: ``rules``; serve: ``serve_rules``, as the reference's do),
and the train step redistributes the gradients to the parameters'
placements before AdamW, so parameters and state come back on
``param_shardings`` and ``opt_shardings`` and the caches on
``cache_shardings``.  The metrics come back as plain tensors, equal on
every rank.  With microbatches, each rank splits its own batch shard,
so microbatch i holds rows i of every rank's shard; the summed
gradients are the same up to the order of the sum.  Setting a rules
table's ``batch`` to None (the dry-run's B = 1) replicates the batch of
every later call.  :func:`gather_state` brings a sharded tree back whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..compat import resolve_device
from ..config import ArchConfig
from ..models.api import build_model
from ..models.spec import abstract_params
from ..optim import AdamW, OptState, apply_updates
from ..sharding import (
    AbstractMesh,
    LogicalRules,
    abstract_mesh,
    is_dtensor,
    make_rules,
    sharded_region,
    tree_shardings,
)
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["StepBundle", "build_steps", "value_and_grad", "place_state",
           "gather_state", "place"]


@dataclass
class StepBundle:
    model: Any
    optimizer: AdamW
    train_step: Callable
    prefill_step: Callable
    serve_step: Callable
    device: torch.device
    # the reference's sharding fields: None when built without a mesh
    rules: Optional[LogicalRules] = None
    serve_rules: Optional[LogicalRules] = None
    param_shardings: Any = None
    serve_param_shardings: Any = None
    opt_shardings: Any = None
    batch_sharding: Optional[Callable] = None  # batch tree -> shardings tree
    cache_shardings: Optional[Callable] = None  # (batch, seq) -> shardings

    def abstract_state(self):
        """(parameters, AdamW state) on the ``meta`` device: the shapes and
        dtypes the train step carries, nothing allocated."""
        params = abstract_params(self.model.param_specs())
        step = torch.empty((), dtype=torch.int32, device="meta")
        return params, OptState(m=params, v=params, step=step)


def _batch_shardings(rules: LogicalRules, batch_specs) -> Any:
    def leaf(s):
        if s.dim() >= 3:  # modality embeddings [B, T, d]
            return rules.sharding(("batch", None, None))
        if s.dim() == 2:
            return rules.sharding(("batch", "seq"))
        return rules.sharding(("batch",))

    return tree_map(leaf, batch_specs)


def value_and_grad(model, params, batch, rules=None):
    """(loss, metrics, grads) of ``model.loss(params, batch, rules)``: the
    grads a tree of ``params``' structure, zeros for a leaf the loss does
    not read (as ``jax.grad`` gives), the loss and metrics detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    # the backward too: a remat layer's recompute meets the plain tables again
    with torch.enable_grad(), sharded_region(rules):
        loss, metrics = model.loss(tree_unflatten(params, leaves), batch, rules)
        grads = torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True
        )
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def place(tensor, sharding):
    """A plain tensor (the same on every rank) as a DTensor placed by
    ``sharding``; a DTensor redistributed to it."""
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(tensor):
        return tensor.redistribute(sharding.mesh, list(sharding.placements))
    return distribute_tensor(tensor, sharding.mesh, list(sharding.placements))


def place_state(bundle: "StepBundle", params, opt: Optional[OptState] = None,
                serve: bool = False):
    """A one-device state distributed over the bundle's mesh: parameters
    on ``param_shardings`` (``serve_param_shardings`` with ``serve``)
    and, when given, the AdamW state on ``opt_shardings``.  Returns
    ``params`` or ``(params, opt)``."""
    sh = bundle.serve_param_shardings if serve else bundle.param_shardings
    params = tree_map(place, params, sh)
    if opt is None:
        return params
    o = bundle.opt_shardings
    return params, OptState(
        m=tree_map(place, opt.m, o.m), v=tree_map(place, opt.v, o.v),
        step=place(opt.step, o.step),
    )


def gather_state(tree):
    """Every DTensor leaf of ``tree`` (dicts, tuples, an ``OptState``)
    brought back whole with ``full_tensor()`` (a collective: every rank
    calls it); plain leaves as they are."""
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


def build_steps(
    cfg: ArchConfig,
    lr_fn: Optional[Callable] = None,
    optimizer: Optional[AdamW] = None,
    microbatches: int = 1,
    device=None,
    mesh=None,
    serve_replicate_weights: Optional[bool] = None,
) -> StepBundle:
    """The steps of ``cfg`` on ``device`` (default: the card).  ``lr_fn``
    maps the 0-d int32 step count to a 0-d fp32 learning rate (default a
    constant 3e-4); ``optimizer`` defaults to ``AdamW()``.  ``mesh``
    fills the sharding fields, and a ``DeviceMesh`` makes the steps run
    sharded over it; ``serve_replicate_weights`` (default: decided from
    the weights' size) picks the serve rules' ``embed``."""
    dev = resolve_device(device)
    model = build_model(cfg)
    optimizer = optimizer or AdamW()
    shardings = {} if mesh is None else _shardings(cfg, model, mesh,
                                                   serve_replicate_weights)
    sharded = mesh is not None and not isinstance(mesh, AbstractMesh)
    # the rules the models run with: None on one device
    rules = shardings["rules"] if sharded else None
    serve_rules = shardings["serve_rules"] if sharded else None
    if lr_fn is None:

        def lr_fn(step):
            return torch.tensor(3e-4, dtype=torch.float32, device=dev)

    def to_device(batch, rules=None):
        if not sharded:
            return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        batch = {k: v if is_dtensor(v) else torch.as_tensor(v, device=dev)
                 for k, v in batch.items()}
        return tree_map(place, batch, _batch_shardings(rules, batch))

    def split(v, i):
        """Microbatch i of a batch leaf: rows i of its split on the
        leading axis (of each rank's shard, when sharded)."""
        if not is_dtensor(v):
            return v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])[i]
        from torch.distributed.tensor import DTensor

        loc = v.to_local()
        loc = loc.reshape((microbatches, loc.shape[0] // microbatches) + loc.shape[1:])[i]
        return DTensor.from_local(loc, v.device_mesh, v.placements, run_check=False)

    def train_step(params, opt_state, batch):
        batch = to_device(batch, rules)
        if microbatches > 1:
            grads = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32)
                if is_dtensor(p)
                else torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                params,
            )
            loss_sum = 0.0
            for i in range(microbatches):
                part = {k: split(v, i) for k, v in batch.items()}
                loss, _, g = value_and_grad(model, params, part, rules)
                g = _to_params(g, params)
                tree_map(lambda a, b: a.add_(b.float()), grads, g)
                loss_sum = loss_sum + loss
                del g
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss_sum / microbatches
            metrics = {"ce": loss}
        else:
            loss, metrics, grads = value_and_grad(model, params, batch, rules)
            grads = _to_params(grads, params)
        lr = lr_fn(opt_state.step)
        updates, new_opt = optimizer.update(grads, opt_state, params, lr)
        del grads
        new_params = apply_updates(params, updates)
        metrics = dict(metrics, loss=loss, lr=lr)
        if sharded:
            metrics = {k: v.full_tensor() if is_dtensor(v) else v
                       for k, v in metrics.items()}
        return new_params, new_opt, metrics

    def prefill_step(params, batch, max_seq: Optional[int] = None):
        return model.prefill(params, to_device(batch, rules), rules, max_seq=max_seq)

    def serve_step(params, cache, tokens):
        if sharded:
            tokens = to_device({"tokens": tokens}, serve_rules)["tokens"]
        return model.decode_step(params, cache, tokens, serve_rules)

    return StepBundle(
        model=model,
        optimizer=optimizer,
        train_step=train_step,
        prefill_step=prefill_step,
        serve_step=serve_step,
        device=dev,
        **shardings,
    )


def _to_params(grads, params):
    """Each DTensor gradient on its parameter's placements (the reference's
    out-shardings): a ``Partial`` sum is reduce-scattered or all-reduced
    there."""
    return tree_map(
        lambda g, p: g.redistribute(p.device_mesh, p.placements) if is_dtensor(g) else g,
        grads, params,
    )


def _shardings(cfg: ArchConfig, model, mesh, serve_replicate_weights) -> dict:
    """The reference's sharding fields of the bundle (``steps.py:71-91``)."""
    rules = make_rules(cfg, mesh)
    param_specs = model.param_specs()
    param_sh = tree_shardings(rules, param_specs)
    # inference sharding != training sharding: a decode step amortizes
    # ZeRO-3 weight gathers over one token, so when the bf16 weights fit
    # with model-axis sharding alone they are replicated over 'data'
    model_ax = abstract_mesh(mesh).shape.get("model", 1)
    if serve_replicate_weights is None:
        serve_replicate_weights = (cfg.n_params() * 2 / model_ax) < 8e9
    serve_rules = make_rules(cfg, mesh)
    if serve_replicate_weights:
        serve_rules.table["embed"] = None

    def cache_shardings(batch_size: int, seq_len: int):
        return tree_shardings(serve_rules, model.cache_specs(batch_size, seq_len))

    return dict(
        rules=rules,
        serve_rules=serve_rules,
        param_shardings=param_sh,
        serve_param_shardings=tree_shardings(serve_rules, param_specs),
        opt_shardings=OptState(m=param_sh, v=param_sh, step=rules.sharding(())),
        batch_sharding=lambda specs: _batch_shardings(rules, specs),
        cache_shardings=cache_shardings,
    )
