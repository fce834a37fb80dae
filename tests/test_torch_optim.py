"""AdamW and the schedules against the JAX package's, and mirrors of
``tests/test_optim.py``'s optimizer tests.

The port writes the reference's formulas out (``optim/adamw.py``), so
the same gradients give the same parameters, moments and step count up to
the rounding of fp32 ``pow``/``sqrt`` in XLA and in PyTorch:
``rtol=atol=1e-6``.  The schedules compute in fp32 as the reference's
do: ``1e-6`` relative (``cos`` rounds apart by an ulp at a few steps).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import optim as joptim  # noqa: E402

from repro_torch.optim import (  # noqa: E402
    AdamW,
    OptState,
    apply_updates,
    cosine_schedule,
    global_norm,
    wsd_schedule,
)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(rng, scale=1.0):
    return {
        "w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
        "b": {"z": (scale * rng.standard_normal(7)).astype(np.float32)},
        "s": np.float32(scale * rng.standard_normal()),
    }


def _torch(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize(
    "opts",
    [
        {},
        {"clip_norm": None},
        {"weight_decay": 0.0},
        {"b2": 0.999, "eps": 1e-6},
    ],
    ids=["default", "no-clip", "no-decay", "b2-eps"],
)
def test_adamw_matches_reference(opts):
    """Six steps under a cosine schedule with warm-up, gradients large
    enough that the clip acts (except where switched off)."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt, topt = joptim.AdamW(**opts), AdamW(**opts)
    jp, tp = params, _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    jlr, tlr = joptim.cosine_schedule(1e-2, 2, 6), cosine_schedule(1e-2, 2, 6)
    for _ in range(6):
        g = _tree(rng, scale=3.0)
        ju, js = jopt.update(g, js, jp, jlr(js.step))
        tu, ts = topt.update(_torch(g), ts, tp, tlr(ts.step))
        jp, tp = joptim.apply_updates(jp, ju), apply_updates(tp, tu)
    assert isinstance(ts, OptState) and ts.step.dtype == torch.int32
    assert int(ts.step) == int(js.step) == 6
    for want, got in [(jp, tp), (js.m, ts.m), (js.v, ts.v)]:
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_warmup_step_one_leaves_params_unchanged():
    """The lr comes from the step count before the update: 0 at step 1
    under a warm-up, so every leaf keeps its bits (the moments move)."""
    rng = np.random.default_rng(1)
    tp = _torch(_tree(rng))
    opt = AdamW()
    state = opt.init(tp)
    lr = cosine_schedule(1.0, 3, 9)(state.step)
    u, state = opt.update(_torch(_tree(rng)), state, tp, lr)
    p1 = apply_updates(tp, u)
    for a, b in zip(tree_leaves(tp), tree_leaves(p1)):
        assert torch.equal(a, b)
    assert int(state.step) == 1 and float(global_norm(state.m)) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_apply_updates_match_reference(dtype):
    rng = np.random.default_rng(2)
    tree = _tree(rng, scale=2.0)
    want = float(joptim.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    np.testing.assert_allclose(float(global_norm(_torch(tree))), want, rtol=1e-6)
    params = {"p": rng.standard_normal(9).astype(np.float32)}
    upd = {"p": (1e-3 * rng.standard_normal(9)).astype(np.float32)}
    jp = {"p": jnp.asarray(params["p"], dtype)}
    tp = {"p": torch.tensor(params["p"]).to(getattr(torch, dtype))}
    got = apply_updates(tp, _torch(upd))["p"]
    want = joptim.apply_updates(jp, {"p": jnp.asarray(upd["p"])})["p"]
    assert got.dtype == tp["p"].dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize(
    "name,args",
    [
        ("cosine", (1.0, 10, 100)),
        ("cosine", (3e-4, 0, 50, 0.0)),
        ("cosine", (1e-3, 2, 8)),
        ("wsd", (1.0, 10, 50, 20)),
        ("wsd", (3e-4, 10, 4, 2)),
        ("wsd", (1e-2, 0, 5, 0, 0.1)),
    ],
)
def test_schedules_match_reference(name, args):
    jfn = {"cosine": joptim.cosine_schedule, "wsd": joptim.wsd_schedule}[name](*args)
    tfn = {"cosine": cosine_schedule, "wsd": wsd_schedule}[name](*args)
    steps = list(range(0, 131, 3))
    got = [tfn(s) for s in steps]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    want = [float(jfn(s)) for s in steps]
    np.testing.assert_allclose([float(g) for g in got], want, rtol=1e-6, atol=0)
    # a 0-d int32 step tensor, as the optimizer's state carries it
    s = torch.tensor(7, dtype=torch.int32)
    np.testing.assert_allclose(float(tfn(s)), float(jfn(jnp.int32(7))), rtol=1e-6)


# ----------------------------------------------------------------------
# mirrors of tests/test_optim.py
# ----------------------------------------------------------------------
def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    opt = AdamW(weight_decay=0.0)
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2)

    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), w)
        upd, state = opt.update({"w": g}, state, params, torch.tensor(0.05))
        params = apply_updates(params, upd)
    assert float(loss(params)) < 1e-3


def test_grad_clipping():
    opt = AdamW(clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    huge = {"w": torch.full((3,), 1e6)}
    upd, state = opt.update(huge, state, params, torch.tensor(1.0))
    # post-clip the step magnitude is bounded by lr * O(1)
    assert float(upd["w"].abs().max()) < 2.0


def test_schedules_shapes():
    cos = cosine_schedule(1.0, warmup=10, total=100)
    assert float(cos(0)) == 0.0
    assert abs(float(cos(10)) - 1.0) < 1e-6
    assert float(cos(100)) < float(cos(50))
    wsd = wsd_schedule(1.0, warmup=10, stable=50, decay=20)
    assert abs(float(wsd(30)) - 1.0) < 1e-6  # stable phase
    assert float(wsd(75)) < 0.7  # decaying


def test_global_norm():
    t = {"a": torch.ones(4), "b": torch.ones(9)}
    assert abs(float(global_norm(t)) - np.sqrt(13.0)) < 1e-6
