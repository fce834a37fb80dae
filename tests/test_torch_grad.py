"""Every family's gradient against ``jax.grad`` of the reference's loss,
and the grad guard of the port's kernels.

The reference's ``build_model(cfg).init(PRNGKey(s))`` parameters cross
over through ``params_from_reference`` with every attention's wq/wk/wv at
fan-in d (``test_torch_loss._fan_in_d``: the reference initialiser takes
the fan-in from the head count, which makes attention all but a hard max
and amplifies XLA's compiled rounding); the same numpy-seeded batch goes
through ``jax.jit(jax.grad(loss))`` and through ``torch.autograd`` of the
port's ``loss`` on the plain routes (``launch.steps.value_and_grad``).

Tolerances:

* fp32, all ten tiny archs with the config's ``remat`` (the reference's
  layers under ``jax.checkpoint``, the port's under
  ``torch.utils.checkpoint``): every leaf within ``2e-5`` of the largest
  magnitude of that leaf's reference gradient.
* bf16: ``tests/test_torch_grad_bf16.py``.
* The MoE router's gradient through the aux loss alone, at ``1e-6`` of
  its magnitude: the aux loss itself agrees to ``1e-6``, not bit for bit
  (the fp32 router matmul, ``exp`` and mean round apart by an ulp).
* RWKV6's chunked WKV form can overflow in ``exp(-la)`` (Queue C): the
  port is held only where the reference's gradient is finite, and the
  count of non-finite reference elements is printed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from test_torch_loss import _batch, _fan_in_d, _np_tree  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models.api import build_model, frontend_inputs  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import moe_block, moe_groups, moe_route  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

FP32_GRAD = 2e-5
AUX_GRAD = 1e-6


#: the ten tiny configurations, then the MoE at the reference's default
#: capacity factor, where assignments drop
FP32_CASES = {name: (name, {}) for name in configs.ALL_ARCHS}
FP32_CASES["moonshot-cf1.25"] = ("moonshot-v1-16b-a3b", {"capacity_factor": 1.25})


def _grads(name: str, over: dict, seed: int = 1):
    """(reference gradient leaves as [(path, np.ndarray)], the port's
    gradient leaves as np.ndarray, both in jax's leaf order)."""
    jcfg = jconfigs.get_tiny(name).replace(**over)
    tcfg = configs.get_tiny(name).replace(**over)
    params = _fan_in_d(_np_tree(jbuild_model(jcfg).init(jax.random.PRNGKey(seed))))
    batch = _batch(tcfg, seed + 1, "some")
    jmodel = jbuild_model(jcfg)
    jg = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))(params, batch)
    ref = [
        (jax.tree_util.keystr(path), np.asarray(g, np.float32))
        for path, g in jax.tree_util.tree_leaves_with_path(jg)
    ]
    tparams = params_from_reference(tcfg, params, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, tg = value_and_grad(build_model(tcfg), tparams, tbatch)
    port = [g.float().numpy() for g in tree_leaves(tg)]
    assert len(port) == len(ref)
    for (path, a), b in zip(ref, port):
        assert a.shape == b.shape, path
    return ref, port


@pytest.mark.parametrize("case", sorted(FP32_CASES))
def test_fp32_gradients_match_reference(case):
    name, over = FP32_CASES[case]
    ref, port = _grads(name, over)
    nonfinite = 0
    for (path, a), b in zip(ref, port):
        fin = np.isfinite(a)
        nonfinite += int((~fin).sum())
        assert np.isfinite(b[fin]).all(), path
        scale = float(np.abs(a[fin]).max(initial=0.0))
        err = float(np.abs(a - b)[fin].max(initial=0.0))
        assert err <= FP32_GRAD * max(scale, 1e-6), (path, err, scale)
    if name == "rwkv6-3b":
        print(f"{name}: {nonfinite} non-finite reference gradient elements")
    else:
        assert nonfinite == 0
    # every leaf gets a gradient (all parameters feed the loss)
    assert all(float(np.abs(b).max()) > 0 for b in port)


@pytest.mark.parametrize("cf", [None, 1.25])
@pytest.mark.parametrize("name", ["grok-1-314b", "moonshot-v1-16b-a3b"])
def test_moe_router_gradient_of_aux_loss(name, cf):
    """The aux loss's gradient reaches the router only through the
    softmax (the top-k indices and the counts carry none); at the
    reference's default capacity factor some assignments drop."""
    over = {} if cf is None else {"capacity_factor": cf}
    jcfg = jconfigs.get_tiny(name).replace(**over)
    tcfg = configs.get_tiny(name).replace(**over)
    params = _fan_in_d(_np_tree(jbuild_model(jcfg).init(jax.random.PRNGKey(1))))
    tokens = _batch(tcfg, 2)["tokens"]
    jmodel = jbuild_model(jcfg)
    jg = jax.jit(jax.grad(lambda p: jmodel.forward(p, tokens)[2]))(params)
    want = np.asarray(jg["layers"]["moe"]["router"])
    tparams = params_from_reference(tcfg, params, device="cpu")
    router = tparams["layers"]["moe"]["router"].requires_grad_(True)
    aux = build_model(tcfg).forward(tparams, torch.from_numpy(tokens))[2]
    (got,) = torch.autograd.grad(aux, router)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= AUX_GRAD * float(np.abs(want).max())


def test_moe_dropped_assignments_carry_no_gradient():
    """A dropped assignment goes to the spare buffer row, which no expert
    reads and which combines as 0: a token whose every assignment drops
    gets exactly zero gradient through the block's output (its gates are
    masked too), and a token with a kept one gets a gradient."""
    cfg = configs.get_tiny("moonshot-v1-16b-a3b").replace(capacity_factor=0.3)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, cfg.d_model, generator=g).requires_grad_(True)
    y, _ = moe_block(lp, x, cfg)
    (gx,) = torch.autograd.grad(y.square().sum(), x)
    G = moe_groups(x.shape[0] * x.shape[1], cfg.moe_group_size)
    plan = moe_route(lp["router"], x.detach().reshape(G, -1, cfg.d_model), cfg)
    dropped = ~plan.keep.reshape(G, -1, cfg.top_k).any(-1).reshape(-1)
    gx = gx.reshape(-1, cfg.d_model)
    assert 0 < int(dropped.sum()) < dropped.numel()
    assert float(gx[dropped].abs().max()) == 0.0
    assert bool((gx[~dropped].abs().sum(-1) > 0).all())


# ----------------------------------------------------------------------
# the grad guard
# ----------------------------------------------------------------------
def _op_calls():
    """Each floating-input op of ``kernels.ops`` as f(impl, *grad inputs)."""
    g = torch.Generator().manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=g)

    q, kv = rn(1, 4, 2, 8), rn(1, 4, 1, 8)
    lengths = torch.tensor([3], dtype=torch.int32)
    r = rn(1, 8, 2, 4)
    w = torch.sigmoid(rn(1, 8, 2, 4))
    x, dt, A = rn(1, 8, 2, 4), torch.rand(1, 8, 2, generator=g), -torch.rand(2)
    Bm, Cm, D = rn(1, 8, 1, 4), rn(1, 8, 1, 4), rn(2)
    return {
        "attention": (lambda impl, q: ops.attention(q, kv, kv, impl=impl), q),
        "decode_attention": (
            lambda impl, q: ops.decode_attention(q[:, 0], kv, kv, lengths, impl=impl),
            q,
        ),
        "rmsnorm": (lambda impl, x: ops.rmsnorm(x, torch.ones(8), impl=impl), q),
        "add_rmsnorm": (
            lambda impl, d: ops.add_rmsnorm(q, d, torch.ones(8), impl=impl),
            q.clone(),
        ),
        "rwkv6": (lambda impl, r: ops.rwkv6(r, r, r, w, rn(2, 4), impl=impl), r),
        "ssd": (lambda impl, x: ops.ssd(x, dt, A, Bm, Cm, D, impl=impl), x),
    }


@pytest.mark.parametrize("op", sorted(_op_calls()))
def test_kernel_route_refuses_input_that_requires_grad(op):
    """``impl="cuda"`` with an input that requires a gradient raises the
    grad error before the device check, on the CPU; without grad mode the
    same call reaches the device check; ``"auto"`` on the CPU and
    ``"plain"`` run the plain version, whose output has a ``grad_fn``."""
    fn, arg = _op_calls()[op]
    arg = arg.requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        fn("cuda", arg)
    with torch.no_grad(), pytest.raises(ValueError, match="needs a CUDA tensor"):
        fn("cuda", arg)
    for impl in ("auto", "plain"):
        out = fn(impl, arg)
        out = out[0] if isinstance(out, tuple) else out
        assert out.grad_fn is not None
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        fn("cuda", arg.detach())


def test_done_prefix_ops_are_not_guarded():
    """Integer and bool inputs need no gradient: under grad mode the
    done-prefix ops reach the device check as before."""
    done = torch.ones(1, 8, dtype=torch.bool)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.done_prefix_batch(done, z, z + 4, impl="cuda")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.claim_check(done, 4, impl="cuda")


def test_model_on_kernel_route_refuses_training():
    """A config that insists on the kernels (``attention_impl="pallas"``)
    raises the grad error in ``loss`` under grad mode, never trains on the
    plain version in silence; under ``no_grad`` it reaches the device
    check instead."""
    cfg = configs.get_tiny("qwen2-1.5b").replace(attention_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(_batch(cfg, 0)["tokens"])
    with pytest.raises(RuntimeError, match="has no backward"):
        value_and_grad(model, params, {"tokens": tokens, "labels": tokens})
    with torch.no_grad(), pytest.raises(ValueError, match="needs a CUDA tensor"):
        model.loss(params, {"tokens": tokens, "labels": tokens})


@pytest.mark.parametrize(
    "name", ["qwen2-1.5b", "rwkv6-3b", "zamba2-1.2b", "whisper-large-v3"]
)
def test_loss_has_grad_serving_keeps_inference_mode(name):
    """``loss`` builds a graph when a parameter requires a gradient;
    ``prefill`` and ``decode_step`` still run under inference mode."""
    cfg = configs.get_tiny(name)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4, "none").items()}
    params["final_norm"]["w"].requires_grad_(True)
    total, _ = model.loss(params, batch)
    assert total.requires_grad and not total.is_inference()
    p = model.prepare(params)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    cache, logits = model.prefill(p, pre, max_seq=12)
    assert logits.is_inference() and cache["lengths"].is_inference()
    cache, logits = model.decode_step(p, cache, batch["tokens"][:, :1])
    assert logits.is_inference() and not logits.requires_grad
    assert set(frontend_inputs(cfg)) <= set(batch)


def _count_layer_calls(model, attr):
    calls = []
    inner = getattr(model, attr)

    def counted(*args):
        calls.append(1)
        return inner(*args)

    setattr(model, attr, counted)
    return calls


@pytest.mark.parametrize(
    "name,attr",
    [
        ("qwen2-1.5b", "_self_layer"),
        ("rwkv6-3b", "_layer"),
        ("zamba2-1.2b", "_mamba_block"),
        ("whisper-large-v3", "_dec_layer"),
    ],
)
def test_remat_full_recomputes_layers_with_equal_gradients(name, attr):
    """``remat=True`` with policy ``"full"`` runs each layer under
    ``torch.utils.checkpoint``: the backward runs the layer again, and
    the gradients equal those of ``"none"`` exactly."""
    grads, calls = {}, {}
    for policy in ("full", "none"):
        cfg = configs.get_tiny(name).replace(remat=True, remat_policy=policy)
        model = build_model(cfg)
        counter = _count_layer_calls(model, attr)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 5, "none").items()}
        _, _, g = value_and_grad(model, params, batch)
        grads[policy], calls[policy] = tree_leaves(g), len(counter)
    assert calls["full"] == 2 * calls["none"] > 0
    for a, b in zip(grads["full"], grads["none"]):
        assert torch.equal(a, b)


def test_remat_dots_policy_is_not_ported():
    """The remat policy "dots" (jax's ``checkpoint_dots_with_no_batch_dims``)
    runs under grad mode with the gradients of "full", bit for bit, and
    without grad mode recomputes nothing; ``tests/test_torch_runtime.py``
    holds it against the reference per family."""
    grads = {}
    for policy in ("dots", "full"):
        cfg = configs.get_tiny("qwen2-1.5b").replace(remat_policy=policy)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.from_numpy(_batch(cfg, 0)["tokens"])
        batch = {"tokens": tokens, "labels": tokens}
        grads[policy] = tree_leaves(value_and_grad(model, params, batch)[2])
        with torch.no_grad():  # no backward, nothing to recompute
            model.loss(params, batch)
    for a, b in zip(grads["dots"], grads["full"]):
        assert torch.equal(a, b)
