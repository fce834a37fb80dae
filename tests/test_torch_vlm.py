"""The port's VLM period/group stack (llama-3.2-vision's cross-attention
groups) vs the JAX package's ``DecoderLM``, on the same parameters.

The reference's ``DecoderLM(cfg).init(PRNGKey(s))`` parameters cross
over as numpy arrays through ``params_from_reference``;
``forward(collect_kv=True)`` (the 6-D self K/V ``[G, P-1, B, S, Hkv,
dh]`` and the cross K/V ``[G, B, n_image_tokens, Hkv, dh]``), prefill
and 4 decode steps run in both packages (the reference under
``jax.jit`` on its plain XLA routes, the port on its plain versions) on
``llama-vision-tiny`` (2 groups of one self-attention layer and one
cross layer, 16 image tokens) with seeded numpy ``image_embeds``.  fp32
at ``rtol=atol=2e-5``, bf16 at ``2e-2``; for the caches ``atol`` scales
with the tensor's largest magnitude, lengths exactly.  The norm weights
are drawn away from 1 so that their two cast points show.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402

NAME = "llama-3.2-vision-90b"
FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CACHE = ("k", "v", "cross_k", "cross_v")


def _cfgs(**over):
    jcfg, tcfg = jconfigs.get_tiny(NAME), configs.get_tiny(NAME)
    return jcfg.replace(**over), tcfg.replace(**over)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _norm_nodes(params):
    g = params["groups"]
    nodes = [g[part][ln] for part in ("self", "cross") for ln in ("ln1", "ln2")]
    return nodes + [params["final_norm"]]


def _reference_params(jcfg, seed: int):
    """The reference's init with the norm weights drawn away from 1."""
    params = _np_tree(JDecoderLM(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for node in _norm_nodes(params):
        node["w"] = (1 + 0.3 * rng.standard_normal(node["w"].shape)).astype(np.float32)
    return params


def _inputs(cfg, seed: int, batch: int = 2, prompt: int = 6, n_steps: int = 4):
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.n_image_tokens, cfg.d_model)
    image = rng.standard_normal(shape).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (batch, prompt)).astype(np.int32)
    steps = [
        rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32) for _ in range(n_steps)
    ]
    return image, tokens, steps


def _run_reference(jcfg, params, image, tokens, lengths, steps, max_seq):
    model = JDecoderLM(jcfg)
    prefill = jax.jit(
        lambda p, t, m: model.prefill(
            p, {"tokens": t, "image_embeds": m}, max_seq=max_seq
        )
    )
    decode = jax.jit(model.decode_step)
    cache, logits = prefill(params, tokens, image)
    if lengths is not None:
        cache = dict(cache, lengths=np.asarray(lengths, np.int32))
    outs = [(_np_tree(cache), np.asarray(logits, np.float32))]
    for tok in steps:
        cache, logits = decode(params, cache, tok)
        outs.append((_np_tree(cache), np.asarray(logits, np.float32)))
    return outs


def _port(tcfg, params):
    model = build_model(tcfg)
    assert isinstance(model, DecoderLM) and model.period == tcfg.cross_attn_every
    return model, model.prepare(params_from_reference(tcfg, params, device="cpu"))


def _run_port(tcfg, params, image, tokens, lengths, steps, max_seq):
    model, p = _port(tcfg, params)
    batch = {
        "tokens": torch.from_numpy(tokens),
        "image_embeds": torch.from_numpy(image),
    }
    cache, logits = model.prefill(p, batch, max_seq=max_seq)
    if lengths is not None:
        cache = dict(cache, lengths=torch.tensor(lengths, dtype=torch.int32))

    def snap(cache, logits):
        c = {k: v.float().numpy().copy() for k, v in cache.items()}
        return c, logits.float().numpy()

    outs = [snap(cache, logits)]
    for tok in steps:
        cache, logits = model.decode_step(p, cache, torch.from_numpy(tok))
        outs.append(snap(cache, logits))
    return outs


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"], atol=tol["atol"] * scale, err_msg=what
    )


def _compare(ref, port, tol):
    assert len(ref) == len(port)
    for i, ((rc, rl), (pc, pl)) in enumerate(zip(ref, port)):
        np.testing.assert_allclose(pl, rl, err_msg=f"logits, step {i}", **tol)
        assert sorted(pc) == sorted(rc)
        np.testing.assert_array_equal(pc["lengths"], rc["lengths"])
        for k in CACHE:
            _close(pc[k], rc[k], tol, f"{k}, step {i}")


def test_params_from_reference_carries_every_leaf():
    """The groups/{self,cross} tree, leaf for leaf, values unchanged."""
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 0)
    got = params_from_reference(tcfg, params, device="cpu")
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert sorted(map(str, flat)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(flat[path].numpy(), leaf)
    assert got["groups"]["self"]["attn"]["wq"].shape[:2] == (2, 1)  # [G, P-1]


def test_forward_collect_kv_matches_reference():
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 1)
    image, tokens, _ = _inputs(tcfg, seed=2)
    jmodel = JDecoderLM(jcfg)
    jx, jcaches, _ = jax.jit(
        lambda p, t, m: jmodel.forward(p, t, image_embeds=m, collect_kv=True)
    )(params, tokens, image)
    model, p = _port(tcfg, params)
    x, caches, aux = model.forward(
        p, torch.from_numpy(tokens), torch.from_numpy(image), collect_kv=True
    )
    assert float(aux) == 0.0 and sorted(caches) == sorted(CACHE)
    _close(x.numpy(), jx, FP32, "hidden")
    for k in CACHE:
        _close(caches[k].numpy(), jcaches[k], FP32, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    params = _reference_params(jcfg, 3)
    image, tokens, steps = _inputs(tcfg, seed=4)
    ref = _run_reference(jcfg, params, image, tokens, None, steps, 12)
    port = _run_port(tcfg, params, image, tokens, None, steps, 12)
    _compare(ref, port, FP32 if dtype == "float32" else BF16)


def test_decode_past_max_seq_clamps_like_reference():
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 5)
    image, tokens, steps = _inputs(tcfg, seed=6, batch=3, prompt=5, n_steps=3)
    lengths = [5, 7, 8]
    ref = _run_reference(jcfg, params, image, tokens, lengths, steps, 8)
    port = _run_port(tcfg, params, image, tokens, lengths, steps, 8)
    _compare(ref, port, FP32)
    assert list(port[-1][0]["lengths"]) == [8, 10, 11]


def _rounded_norms(params_np):
    out = jax.tree_util.tree_map(lambda a: a, params_np)
    for node in _norm_nodes(out):
        w16 = jax.numpy.asarray(node["w"]).astype("bfloat16")
        node["w"] = np.asarray(w16, np.float32)
    return out


def test_bf16_norm_weight_cast_points_match_reference():
    """Both packages: prefill is unchanged, bit for bit, when every norm
    weight (the cross layers' included) is rounded to bf16 beforehand;
    decode is not (it reads them as stored fp32)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    params = _reference_params(jcfg, 7)
    rounded = _rounded_norms(params)
    image, tokens, steps = _inputs(tcfg, seed=8, n_steps=1)
    for run, cfg in ((_run_reference, jcfg), (_run_port, tcfg)):
        a = run(cfg, params, image, tokens, None, steps, 8)
        b = run(cfg, rounded, image, tokens, None, steps, 8)
        np.testing.assert_array_equal(a[0][1], b[0][1])  # prefill logits
        for k in CACHE:
            np.testing.assert_array_equal(a[0][0][k], b[0][0][k])
        assert not np.array_equal(a[1][1], b[1][1]), run.__name__  # decode


def test_engine_slot_axis_of_the_vlm_caches():
    """The engine writes a staged request into each cache leaf's slot
    axis, the one its cache_specs names "batch": axis 2 of the 6-D self
    K/V, axis 1 of the cross K/V.  One insert lands in that slot of
    every leaf and nowhere else."""
    _, tcfg = _cfgs()
    eng = InferenceEngine(
        tcfg,
        EngineConfig(n_slots=4, max_seq=8, n_workers=1),
        generator=torch.Generator().manual_seed(0),
        device="cpu",
    )
    assert eng._slot_axis == {"k": 2, "v": 2, "cross_k": 1, "cross_v": 1, "lengths": 0}
    image, tokens, _ = _inputs(tcfg, seed=9, batch=1)
    batch = {
        "tokens": torch.from_numpy(tokens),
        "image_embeds": torch.from_numpy(image),
    }
    with torch.inference_mode():  # as the engine thread runs it
        cache1, _ = eng.model.prefill(eng._run_params, batch, max_seq=8)
        eng._insert(2, cache1, None, 3)
    for name, ax in eng._slot_axis.items():
        got = eng.cache[name]
        assert torch.equal(got.select(ax, 2), cache1[name].select(ax, 0)), name
        rest = torch.cat([got.select(ax, i).flatten() for i in (0, 1, 3)])
        assert not rest.any(), name
    assert eng.cache["k"][1, 0, 2, 5].any() and not eng.cache["k"][1, 0, 2, 6].any()
