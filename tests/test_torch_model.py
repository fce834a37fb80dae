"""The port's dense decoder vs the JAX package's, on the same parameters.

The reference's ``DecoderLM(cfg).init(PRNGKey(s))`` parameters cross
over as numpy arrays through ``params_from_reference``; prefill and
three decode steps run in both packages (the reference under
``jax.jit``, its kernels on their plain XLA route as on any CPU host),
and the logits, the whole KV cache and the lengths must agree: fp32 at
``rtol=atol=2e-5``, bf16 at ``2e-2`` (the tolerances of
``tests/test_kernels.py``).  For the cache, whose entries reach ~30
(the reference's initialiser takes fan-in ``Hkv`` for ``wk``/``wv``,
1 for qwen2's tiny config), ``atol`` scales with the tensor's largest
magnitude: the two frameworks sum the projections in different orders,
and fp32 rounding error is relative to the terms summed, not to each
small result.  Lengths agree exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.config import ArchConfig  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.config import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

#: tests/test_serving.py's TINY engine config (GQA 4 over 2, no bias)
SERVING_TINY = dict(
    name="t",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    attention_impl="xla",
    dtype="float32",
)
CASES = {
    "qwen2-tiny": ("qwen2-1.5b", {}),  # GQA 3 over 1 + QKV bias
    "minicpm-tiny": ("minicpm-2b", {}),  # MHA, depth_scale, tied embeddings
    "serving-tiny": (None, SERVING_TINY),
}
FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _cfgs(case: str, **over):
    name, kw = CASES[case]
    if name is None:
        jcfg, tcfg = ArchConfig(**kw), TArchConfig(**kw)
    else:
        jcfg, tcfg = jconfigs.get_tiny(name), configs.get_tiny(name)
    return jcfg.replace(**over), tcfg.replace(**over)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_norms(params_np, seed: int):
    """Norm weights away from 1, so a bf16 rounding of them shows."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(lambda a: a, params_np)
    for node in (out["layers"]["ln1"], out["layers"]["ln2"], out["final_norm"]):
        node["w"] = (1 + 0.3 * rng.standard_normal(node["w"].shape)).astype(
            np.float32
        )
    return out


@functools.lru_cache(maxsize=None)
def _reference_fns(jcfg, max_seq: int):
    model = JDecoderLM(jcfg)
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, max_seq=max_seq))
    decode = jax.jit(model.decode_step)
    return model, prefill, decode


def _run_reference(jcfg, params_np, tokens, lengths, steps, max_seq):
    _, prefill, decode = _reference_fns(jcfg, max_seq)
    cache, logits = prefill(params_np, tokens)
    if lengths is not None:
        cache = dict(cache, lengths=np.asarray(lengths, np.int32))
    outs = [(_np_tree(cache), np.asarray(logits, np.float32))]
    for tok in steps:
        cache, logits = decode(params_np, cache, tok)
        outs.append((_np_tree(cache), np.asarray(logits, np.float32)))
    return outs


def _run_port(tcfg, params_np, tokens, lengths, steps, max_seq):
    model = build_model(tcfg)
    params = model.prepare(params_from_reference(tcfg, params_np, device="cpu"))
    cache, logits = model.prefill(
        params, {"tokens": torch.from_numpy(tokens)}, max_seq=max_seq
    )
    if lengths is not None:
        cache = dict(cache, lengths=torch.tensor(lengths, dtype=torch.int32))

    def snap(cache, logits):
        c = {k: v.float().numpy().copy() for k, v in cache.items() if k != "lengths"}
        c["lengths"] = cache["lengths"].numpy().copy()
        return c, logits.float().numpy()

    outs = [snap(cache, logits)]
    for tok in steps:
        cache, logits = model.decode_step(params, cache, torch.from_numpy(tok))
        outs.append(snap(cache, logits))
    return outs


def _inputs(tcfg, seed: int, batch: int = 2, prompt: int = 6, n_steps: int = 3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tcfg.vocab, (batch, prompt)).astype(np.int32)
    steps = [
        rng.integers(0, tcfg.vocab, (batch, 1)).astype(np.int32) for _ in range(n_steps)
    ]
    return tokens, steps


def _compare(ref, port, tol):
    assert len(ref) == len(port)
    for i, ((rc, rl), (pc, pl)) in enumerate(zip(ref, port)):
        np.testing.assert_allclose(pl, rl, err_msg=f"logits, step {i}", **tol)
        np.testing.assert_array_equal(pc["lengths"], rc["lengths"])
        for k in ("k", "v"):
            want = np.asarray(rc[k], np.float32)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(
                pc[k],
                want,
                rtol=tol["rtol"],
                atol=tol["atol"] * scale,
                err_msg=f"{k}, step {i}",
            )


def _reference_params(jcfg, seed: int):
    return _np_tree(JDecoderLM(jcfg).init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_reference_fp32(case):
    jcfg, tcfg = _cfgs(case)
    params = _random_norms(_reference_params(jcfg, 1), seed=2)
    tokens, steps = _inputs(tcfg, seed=3)
    max_seq = 12
    ref = _run_reference(jcfg, params, tokens, None, steps, max_seq)
    port = _run_port(tcfg, params, tokens, None, steps, max_seq)
    _compare(ref, port, FP32)


def test_prefill_and_decode_match_reference_bf16():
    """bf16 compute over fp32 masters, random norm weights: prefill rounds
    the norm weights to bf16 (the reference's cast_tree), decode passes
    them as stored, matmul weights are cast at use."""
    jcfg, tcfg = _cfgs("qwen2-tiny", dtype="bfloat16")
    params = _random_norms(_reference_params(jcfg, 4), seed=5)
    tokens, steps = _inputs(tcfg, seed=6)
    ref = _run_reference(jcfg, params, tokens, None, steps, 10)
    port = _run_port(tcfg, params, tokens, None, steps, 10)
    _compare(ref, port, BF16)


def _rounded_norms(params_np):
    out = jax.tree_util.tree_map(lambda a: a, params_np)
    for node in (out["layers"]["ln1"], out["layers"]["ln2"], out["final_norm"]):
        w16 = jax.numpy.asarray(node["w"]).astype("bfloat16")
        node["w"] = np.asarray(w16, np.float32)
    return out


def test_bf16_norm_weight_cast_points_match_reference():
    """Both packages: prefill is unchanged, bit for bit, when the norm
    weights are rounded to bf16 beforehand (it rounds them itself); decode
    is not (it uses the fp32 masters)."""
    jcfg, tcfg = _cfgs("qwen2-tiny", dtype="bfloat16")
    params = _random_norms(_reference_params(jcfg, 7), seed=8)
    rounded = _rounded_norms(params)
    tokens, steps = _inputs(tcfg, seed=9, n_steps=1)
    for run, cfg in ((_run_reference, jcfg), (_run_port, tcfg)):
        a = run(cfg, params, tokens, None, steps, 8)
        b = run(cfg, rounded, tokens, None, steps, 8)
        np.testing.assert_array_equal(a[0][1], b[0][1])  # prefill logits
        np.testing.assert_array_equal(a[0][0]["k"], b[0][0]["k"])
        assert not np.array_equal(a[1][1], b[1][1]), run.__name__  # decode


def test_decode_past_max_seq_clamps_like_reference():
    """One slot's length passes the cache: the reference's
    dynamic_update_slice clamps the write to the last position; the port
    must do the same (and attend over the whole cache)."""
    jcfg, tcfg = _cfgs("qwen2-tiny")
    params = _reference_params(jcfg, 10)
    tokens, steps = _inputs(tcfg, seed=11, batch=3, prompt=5, n_steps=3)
    max_seq = 8
    lengths = [5, 7, 8]  # slot 2 is full; slot 1 fills after one step
    ref = _run_reference(jcfg, params, tokens, lengths, steps, max_seq)
    port = _run_port(tcfg, params, tokens, lengths, steps, max_seq)
    _compare(ref, port, FP32)
    assert list(port[-1][0]["lengths"]) == [8, 10, 11]


def test_params_from_reference_rejects_missing_extra_and_misshapen_leaves():
    jcfg, tcfg = _cfgs("serving-tiny")
    params = _reference_params(jcfg, 0)
    params_from_reference(tcfg, params, device="cpu")  # the whole tree: fine
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["layers"]["attn"]["wq"]
    with pytest.raises(KeyError, match="missing leaves"):
        params_from_reference(tcfg, missing, device="cpu")
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["layers"]["attn"]["bq"] = np.zeros((2, 4, 16), np.float32)
    with pytest.raises(KeyError, match="extra leaves"):
        params_from_reference(tcfg, extra, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["final_norm"]["w"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(tcfg, bad, device="cpu")


@pytest.mark.parametrize(
    "name,item",
    [
        ("moonshot-v1-16b-a3b", "item 10"),  # MoE
        ("grok-1-314b", "item 10"),  # MoE
        ("llama-3.2-vision-90b", "item 11"),  # VLM cross-attention
        ("rwkv6-3b", "item 2"),
        ("zamba2-1.2b", "item 3"),
        ("whisper-large-v3", "item 3"),
    ],
)
def test_unported_families_raise_naming_roadmap_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        build_model(configs.get_tiny(name))


def test_configs_are_copies_of_the_reference():
    assert configs.ALL_ARCHS == jconfigs.ALL_ARCHS
    for name in configs.ALL_ARCHS:
        for get in ("get", "get_tiny"):
            t, j = getattr(configs, get)(name), getattr(jconfigs, get)(name)
            assert t.__dict__ == j.__dict__, name
            assert t.n_params() == j.n_params()
            assert t.vocab_padded() == j.vocab_padded()


def test_init_draws_the_reference_distributions():
    """The port's own init: the reference's leaves, shapes and scales
    (its numbers are torch's, so only the statistics can agree)."""
    cfg = configs.get_tiny("qwen2-1.5b").replace(d_model=96, d_ff=192)
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(generator=g, device="cpu")
    jparams = _reference_params(ArchConfig(**cfg.__dict__), 0)
    t = dict(_leaves(params))
    j = dict(_leaves(jparams))
    assert sorted(t) == sorted(j)
    for path in t:
        a, b = t[path].numpy(), np.asarray(j[path])
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, path
        if b.std() == 0:
            np.testing.assert_array_equal(a, b)  # zeros / ones
        else:
            assert a.std() == pytest.approx(b.std(), rel=0.1), path


def _leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)])
def test_rope_matches_reference(pos_shape):
    from repro.models.layers import rope as jrope
    from repro_torch.models.layers import rope

    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 600, pos_shape).astype(np.int32)
    want = np.asarray(jrope(x, pos, 1e6))
    got = rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def test_forward_collect_kv_matches_reference():
    jcfg, tcfg = _cfgs("qwen2-tiny")
    params = _random_norms(_reference_params(jcfg, 13), seed=14)
    tokens, _ = _inputs(tcfg, seed=15)
    jmodel = JDecoderLM(jcfg)
    jfwd = jax.jit(lambda p, t: jmodel.forward(p, t, collect_kv=True))
    jx, jcaches, _ = jfwd(params, tokens)
    model = build_model(tcfg)
    tparams = model.prepare(params_from_reference(tcfg, params, device="cpu"))
    x, caches, aux = model.forward(tparams, torch.from_numpy(tokens), collect_kv=True)
    assert float(aux) == 0.0
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **FP32)
    for k in ("k", "v"):
        want = np.asarray(jcaches[k])
        assert caches[k].shape == want.shape
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(
            caches[k].numpy(), want, rtol=FP32["rtol"], atol=FP32["atol"] * scale
        )
