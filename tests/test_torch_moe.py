"""The port's MoE block and MoE decoders vs the JAX package's.

The same numpy-seeded inputs go through the reference's ``moe_block``
(under ``jax.jit``) and the port's, and the tiny grok and moonshot
``DecoderLM``s run prefill and decode in both packages on the
reference's parameters, carried across by ``params_from_reference``.

* The routing is compared exactly: every (group, expert, slot, token)
  assignment, dropped or kept, and which are kept, read off the
  reference's own dispatch (its vmapped ``dispatch_one`` is recorded
  while it traces).  These fix the top-k counts the aux loss weighs;
  the aux loss itself is held at ``rtol=1e-6`` (a few ulps): its fp32
  router logits, softmax and token mean each round differently in XLA
  and PyTorch on the CPU (a matmul's summation order, ``exp``, a
  reduction's order), by an ulp here and there.  The output is held at
  fp32 ``rtol=atol=2e-5``, bf16 at ``2e-2`` (``tests/test_kernels.py``'s),
  the caches with ``atol`` scaled by their largest magnitude, as
  ``test_torch_model.py`` does.
* The tiny configs' capacity factors (2.5 and 3.0, at least E / k) drop
  nothing; the default 1.25 drops, and the tests that run it assert
  that drops occurred.
* A decode step routes its B slots as one group, so at capacity 1.25 a
  slot's token changes what the other slots' assignments keep: both
  packages show it, identically.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.spec import tree_leaves  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine, Request  # noqa: E402
from test_torch_model import (  # noqa: E402
    BF16,
    FP32,
    _compare,
    _inputs,
    _reference_params,
    _run_port,
    _run_reference,
)

MOE = ("grok-1-314b", "moonshot-v1-16b-a3b")
#: the reference's default capacity factor: drops at every size tested
DEFAULT_CF = 1.25


def _cfgs(name: str, **over):
    jcfg, tcfg = jconfigs.get_tiny(name), configs.get_tiny(name)
    return jcfg.replace(**over), tcfg.replace(**over)


def _moe_params(cfg, seed: int, router_scale: float = 0.3):
    """One MoE block's leaves at unit-variance activations' scale; the
    router wide enough that the top-k choices are well separated."""
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff

    def draw(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        "router": draw((d, E), router_scale),
        "w1": draw((E, d, ff), d**-0.5),
        "w3": draw((E, d, ff), d**-0.5),
        "w2": draw((E, ff, d), ff**-0.5),
    }


class _RecordDispatch:
    """Stands in for the ``jax`` module inside ``repro.models.layers``
    while its ``moe_block`` traces, delegating everything, and records
    the arguments of the vmapped ``dispatch_one``: the group's tokens,
    each sorted assignment's expert (``E`` for a drop), its slot and its
    token."""

    def __init__(self):
        self.args = None

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        mapped = jax.vmap(fn, *a, **kw)
        if fn.__name__ != "dispatch_one":
            return mapped

        def record(*args):
            self.args = args
            return mapped(*args)

        return record


def _table(rows, keep):
    """Assignment rows sorted, beside the kept ones sorted."""
    order = np.lexsort(rows.T[::-1])
    kept = rows[keep]
    return rows[order], kept[np.lexsort(kept.T[::-1])]


def _reference_moe(monkeypatch, jcfg, p, x):
    """(y, aux, assignments, kept assignments) of the reference's
    ``moe_block`` under ``jax.jit``, as sorted (group, expert, slot,
    token) rows.  Its dispatch marks a drop with expert ``E``; in the
    sorted order each expert's run starts at slot 0, which is kept, and
    a dropped assignment takes the expert of its run."""
    rec = _RecordDispatch()
    monkeypatch.setattr(jlayers, "jax", rec)

    def fn(p, x):
        y, aux = jlayers.moe_block(p, x, jcfg)
        _, e_slot, pos, tok = rec.args
        return y, aux, e_slot, pos, tok

    y, aux, e_slot, pos, tok = (np.asarray(a) for a in jax.jit(fn)(p, x))
    monkeypatch.undo()
    expert = np.stack(
        [e[np.flatnonzero(q == 0)][np.cumsum(q == 0) - 1] for e, q in zip(e_slot, pos)]
    )
    keep = e_slot < jcfg.n_experts
    np.testing.assert_array_equal(expert[keep], e_slot[keep])
    g = np.broadcast_to(np.arange(e_slot.shape[0])[:, None], e_slot.shape)
    rows = np.stack([g, expert, pos, tok], -1)
    return (y, aux) + _table(rows.reshape(-1, 4), keep.reshape(-1))


def _port_moe(tcfg, p, x):
    """(y, aux, assignments, kept assignments) of the port's
    ``moe_block`` and the plan of its ``moe_route``, in the reference's
    row format."""
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    y, aux = layers.moe_block(tp, tx, tcfg)
    B, S, d = x.shape
    G = layers.moe_groups(B * S, tcfg.moe_group_size)
    plan = layers.moe_route(tp["router"], tx.reshape(G, -1, d), tcfg)
    g = torch.arange(G)[:, None].expand_as(plan.idx)
    tok = torch.arange(plan.idx.shape[1]).expand_as(plan.idx) // tcfg.top_k
    rows = torch.stack([g, plan.idx, plan.slot, tok], -1).reshape(-1, 4).numpy()
    return (y.numpy(), aux.numpy()) + _table(rows, plan.keep.reshape(-1).numpy())


def _check_moe(monkeypatch, jcfg, tcfg, p, x):
    """Port == reference; returns the number of dropped assignments."""
    jy, jaux, jrows, jkept = _reference_moe(monkeypatch, jcfg, p, x)
    ty, taux, trows, tkept = _port_moe(tcfg, p, x)
    assert len(trows) == x.shape[0] * x.shape[1] * tcfg.top_k
    np.testing.assert_array_equal(trows, jrows)
    np.testing.assert_array_equal(tkept, jkept)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ty, jy, **FP32)
    return len(trows) - len(tkept)


@pytest.mark.parametrize("capacity", ["tiny", "default"])
@pytest.mark.parametrize("name", MOE)
def test_moe_block_matches_reference(monkeypatch, name, capacity):
    """Tokens with a shared component, as a residual stream carries one:
    the router's load is uneven, so the default capacity drops."""
    over = {} if capacity == "tiny" else {"capacity_factor": DEFAULT_CF}
    jcfg, tcfg = _cfgs(name, **over)
    p = _moe_params(tcfg, seed=1)
    rng = np.random.default_rng(2)
    shared = 2 * rng.standard_normal(tcfg.d_model)
    x = rng.standard_normal((2, 12, tcfg.d_model)) + shared
    drops = _check_moe(monkeypatch, jcfg, tcfg, p, x.astype(np.float32))
    if capacity == "tiny":
        assert drops == 0  # cf >= E / k
    else:
        assert drops > 0


@pytest.mark.parametrize("name", MOE)
def test_moe_block_several_groups_matches_reference(monkeypatch, name):
    """T = 18 tokens, groups of 4: 18 // 4 = 4 groups, lowered to 3 (the
    first count that divides T), each with its own capacity cut."""
    jcfg, tcfg = _cfgs(name, capacity_factor=DEFAULT_CF, moe_group_size=4)
    assert layers.moe_groups(18, 4) == 3
    p = _moe_params(tcfg, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 9, tcfg.d_model))
    assert _check_moe(monkeypatch, jcfg, tcfg, p, x.astype(np.float32)) > 0


@pytest.mark.parametrize("k", [1, 2, 3, 6])
def test_top_k_ties_equal_lax_top_k(k):
    """Values on a coarse grid, so that most rows hold ties: the same
    values and indices as ``lax.top_k`` (ties lowest index first)."""
    rng = np.random.default_rng(k)
    x = (rng.integers(0, 4, (64, 16)) / 4).astype(np.float32)
    want_v, want_i = jax.lax.top_k(x, k)
    got_v, got_i = layers.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("name", MOE)
def test_moe_block_tied_router_logits_match_reference(monkeypatch, name):
    """Router columns in equal pairs: every token's logits tie exactly
    (one dot product per column, the same in both), so the top-k
    choices hinge on the tie order."""
    jcfg, tcfg = _cfgs(name, capacity_factor=DEFAULT_CF)
    p = _moe_params(tcfg, seed=5)
    E = tcfg.n_experts
    p["router"][:, 1::2] = p["router"][:, 0 : E - 1 : 2]
    x = np.random.default_rng(6).standard_normal((2, 8, tcfg.d_model))
    x = x.astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x @ p["router"]), -1)
    assert torch.equal(probs[..., 0::2], probs[..., 1::2])
    _check_moe(monkeypatch, jcfg, tcfg, p, x)


# ----------------------------------------------------------------------
# the MoE decoders
# ----------------------------------------------------------------------
CASES = [(n, c) for n in MOE for c in ("tiny", "default")]


def _model_cfgs(name, capacity, **over):
    if capacity == "default":
        over["capacity_factor"] = DEFAULT_CF
    return _cfgs(name, **over)


@pytest.mark.parametrize("name,capacity", CASES)
def test_forward_matches_reference(name, capacity):
    """The hidden states, the K/V of every layer and the summed aux."""
    jcfg, tcfg = _model_cfgs(name, capacity)
    params = _reference_params(jcfg, 7)
    tokens, _ = _inputs(tcfg, seed=8)
    jmodel = jbuild_model(jcfg)
    jx, jcaches, jaux = jax.jit(lambda p, t: jmodel.forward(p, t, collect_kv=True))(
        params, tokens
    )
    model = build_model(tcfg)
    tparams = model.prepare(params_from_reference(tcfg, params, device="cpu"))
    x, caches, aux = model.forward(tparams, torch.from_numpy(tokens), collect_kv=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **FP32)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **FP32)
    assert float(aux) > 0
    for k in ("k", "v"):
        want = np.asarray(jcaches[k])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(
            caches[k].numpy(), want, rtol=FP32["rtol"], atol=FP32["atol"] * scale
        )


@pytest.mark.parametrize("name,capacity", CASES)
def test_prefill_and_decode_match_reference_fp32(name, capacity):
    jcfg, tcfg = _model_cfgs(name, capacity)
    params = _reference_params(jcfg, 9)
    tokens, steps = _inputs(tcfg, seed=10)
    ref = _run_reference(jcfg, params, tokens, None, steps, 12)
    port = _run_port(tcfg, params, tokens, None, steps, 12)
    _compare(ref, port, FP32)


@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_match_reference_bf16(name):
    jcfg, tcfg = _cfgs(name, dtype="bfloat16")
    params = _reference_params(jcfg, 11)
    tokens, steps = _inputs(tcfg, seed=12)
    ref = _run_reference(jcfg, params, tokens, None, steps, 10)
    port = _run_port(tcfg, params, tokens, None, steps, 10)
    _compare(ref, port, BF16)


def _wide_router(params_np, seed: int):
    """The router drawn at unit scale, so that a bf16 rounding of it
    shows in decode: at the reference's 0.02 it moves the logits by
    ~1e-5, which the bf16 gates and residual stream then hide."""
    out = jax.tree_util.tree_map(lambda a: a, params_np)
    moe = out["layers"]["moe"]
    moe["router"] = np.random.default_rng(seed).standard_normal(
        moe["router"].shape
    ).astype(np.float32)
    return out


def _rounded_router(params_np):
    out = jax.tree_util.tree_map(lambda a: a, params_np)
    moe = out["layers"]["moe"]
    moe["router"] = np.asarray(
        jax.numpy.asarray(moe["router"]).astype("bfloat16"), np.float32
    )
    return out


@pytest.mark.parametrize("name", MOE)
def test_bf16_router_cast_points_match_reference(name):
    """Both packages: prefill is unchanged, bit for bit, when the router
    is rounded to bf16 beforehand (``cast_tree`` rounds it, then the
    block upcasts it to fp32); decode is not (it routes with the fp32
    router as stored)."""
    jcfg, tcfg = _cfgs(name, dtype="bfloat16")
    params = _wide_router(_reference_params(jcfg, 13), seed=20)
    rounded = _rounded_router(params)
    assert not np.array_equal(
        rounded["layers"]["moe"]["router"], params["layers"]["moe"]["router"]
    )
    tokens, steps = _inputs(tcfg, seed=14, batch=8, n_steps=1)
    for run, cfg in ((_run_reference, jcfg), (_run_port, tcfg)):
        a = run(cfg, params, tokens, None, steps, 8)
        b = run(cfg, rounded, tokens, None, steps, 8)
        np.testing.assert_array_equal(a[0][1], b[0][1])  # prefill logits
        np.testing.assert_array_equal(a[0][0]["k"], b[0][0]["k"])
        assert not np.array_equal(a[1][1], b[1][1]), run.__name__  # decode


def test_decode_couples_slots_like_reference():
    """Four slots decode as one group of 4 tokens.  At capacity 1.25
    each expert keeps 1 of them (``int(4 * 3 / 8 * 1.25)``), so changing
    slot 0's token changes the other slots' logits, in the reference and
    in the port alike; at the tiny config's drop-free capacity it does
    not (to fp32 rounding)."""
    tokens, steps = _inputs(configs.get_tiny(MOE[1]), seed=15, batch=4, n_steps=1)
    other = steps[0].copy()
    other[0, 0] = (other[0, 0] + 1) % 512
    diffs = {}
    for capacity in ("tiny", "default"):
        jcfg, tcfg = _model_cfgs(MOE[1], capacity)
        params = _reference_params(jcfg, 16)
        out = {}
        for which, step in (("a", steps), ("b", [other])):
            ref = _run_reference(jcfg, params, tokens, None, step, 8)
            port = _run_port(tcfg, params, tokens, None, step, 8)
            _compare(ref, port, FP32)
            out[which] = (ref[1][1], port[1][1])
        for i, pkg in enumerate(("reference", "port")):
            a, b = out["a"][i][1:], out["b"][i][1:]  # slots 1-3
            diffs[capacity, pkg] = float(np.abs(a - b).max())
    assert diffs["default", "reference"] > 1e-3
    assert diffs["default", "port"] > 1e-3
    assert diffs["tiny", "reference"] < 1e-5
    assert diffs["tiny", "port"] < 1e-5


@pytest.mark.parametrize("name", MOE)
def test_engine_answers_every_request(name):
    """The tiny MoE at capacity 1.25 behind the port's engine on the
    CPU, under both policies: every request answered with its tokens,
    the first token (its own B = 1 prefill) the same under both, and the
    decode steps' drop counts on the model's ``moe_stats``."""
    cfg = configs.get_tiny(name).replace(capacity_factor=DEFAULT_CF)
    first = {}
    for policy in ("corec", "rss"):
        eng = InferenceEngine(
            cfg,
            EngineConfig(
                n_slots=4, max_seq=24, n_workers=2, policy=policy, eos_token=-1
            ),
            generator=torch.Generator().manual_seed(17),
            device="cpu",
        )
        stats = {k: torch.zeros((), dtype=torch.int64) for k in ("kept", "assigned")}
        eng.model.moe_stats = stats
        rng = np.random.default_rng(18)
        reqs = [
            Request(
                rid=i,
                prompt=list(map(int, rng.integers(2, 500, 5 + i % 4))),
                max_new_tokens=4,
                session=i % 3,
            )
            for i in range(8)
        ]
        res = eng.run(reqs, timeout=120)
        assert sorted(r.rid for r in res) == list(range(8))
        assert all(len(r.tokens) == 5 for r in res)
        assert eng.head == eng.tail == 8
        first[policy] = {r.rid: r.tokens[0] for r in res}
        assigned = eng.decode_steps * 4 * cfg.n_layers * cfg.top_k
        assert int(stats["assigned"]) == assigned
        assert 0 < int(stats["kept"]) < assigned
    assert first["corec"] == first["rss"]


# ----------------------------------------------------------------------
# parameters, specs and the decode step's bytes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", MOE)
def test_params_from_reference_carries_moe_leaves(name):
    """The reference's moe/{router,w1,w3,w2} leaves cross over unchanged,
    from the specs alone (no MoE code in convert.py)."""
    jcfg, tcfg = _cfgs(name)
    params = _reference_params(jcfg, 19)
    got = dict(tree_leaves(params_from_reference(tcfg, params, device="cpu")))
    want = dict(tree_leaves(params))
    moe = [p for p in want if "/moe/" in p]
    assert sorted(p.rsplit("/", 1)[1] for p in moe) == ["router", "w1", "w2", "w3"]
    assert sorted(got) == sorted(want)
    for path in moe:
        np.testing.assert_array_equal(got[path].numpy(), want[path])


@pytest.mark.parametrize("name", configs.ALL_ARCHS)
def test_every_arch_builds_with_the_reference_specs(name):
    """Every one of the ten configurations builds (the MoE ones too) and
    declares the reference's leaves, shapes and initialisers."""
    tcfg, jcfg = configs.get_tiny(name), jconfigs.get_tiny(name)

    def flat(specs):
        out = {}
        for path, s in tree_leaves(specs):
            out[path] = (tuple(s.shape), tuple(s.axes), s.init, s.scale)
        return out

    want = flat(jbuild_model(jcfg).param_specs())
    assert flat(build_model(tcfg).param_specs()) == want


def test_router_is_kept_in_fp32_by_prepare():
    cfg = configs.get_tiny(MOE[1]).replace(dtype="bfloat16")
    model = build_model(cfg)
    params = model.prepare(model.init(generator=torch.Generator(), device="cpu"))
    moe = params["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert {moe[k].dtype for k in ("w1", "w2", "w3")} == {torch.bfloat16}


#: (weight bytes, state and cache bytes) of one decode step at 16 slots
#: and 384 positions, at the served depths (moonshot 16 layers, grok 2).
#: Every expert's w1/w3/w2 in bf16 (the capacity dispatch runs every
#: expert, routed to or not), the router in fp32 (4 d E), the norms in
#: fp32, the untied output table whole, the token table in the 16 rows
#: gathered; K/V over 384 of 512 positions and the lengths read and
#: written.  moonshot: 16 (2 * 2048 * 4 + 4 * 2048 * 16 * 128 * 2 + 2048 *
#: 64 * 4 + 3 * 64 * 2048 * 1408 * 2) + 2048 * 163840 * 2 + 16 * 2048 * 2
#: + 2048 * 4; grok likewise with 48/8 heads and 8 experts of 32,768.
MOE_DECODE_BYTES = {
    "moonshot-v1-16b-a3b": (18_933_424_128, 805_306_496),
    "grok-1-314b": (21_290_999_808, 50_331_776),
}


@pytest.mark.parametrize("name", sorted(MOE_DECODE_BYTES))
def test_decode_step_bytes_count_every_expert(name):
    from test_torch_whisper import _chip_smoke

    assert _chip_smoke().decode_step_bytes(name, 384) == MOE_DECODE_BYTES[name]
