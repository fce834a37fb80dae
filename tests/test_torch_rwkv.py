"""The port's RWKV6 model and its engine vs the JAX package's.

The reference's ``Rwkv6LM(cfg).init(PRNGKey(s))`` parameters cross over
as numpy arrays through ``params_from_reference``; prefill and 4 decode
steps run in both packages (the reference under ``jax.jit``, its WKV on
the chunked jnp route as on any CPU host; the port on its plain
versions) on ``rwkv6-tiny``.  The logits and the whole cache (WKV
states, both token-shift vectors, lengths) must agree: fp32 at
``2e-5``, bf16 at ``2e-2``, the tolerances of ``tests/test_kernels.py``;
for cache tensors ``atol`` scales with the tensor's largest magnitude
(the WKV state reaches ~14, and fp32 rounding error is relative to the
terms summed), lengths exactly.  The engine test wants the reference
engine's tokens per rid.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models.rwkv import Rwkv6LM as JRwkv6LM  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.rwkv import Rwkv6LM  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine, Request  # noqa: E402

NAME = "rwkv6-3b"
FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
#: the leaves decode reads as stored fp32 (the reference's cast-at-use)
DECODE_FP32 = ("u", "w_base", "w_lora_b", "gn_w", "gn_b")


def _cfgs(**over):
    jcfg, tcfg = jconfigs.get_tiny(NAME), configs.get_tiny(NAME)
    return jcfg.replace(**over), tcfg.replace(**over)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference_params(jcfg, seed: int):
    """The reference's init, with the zero/constant mixing and norm
    leaves drawn at random so that every leaf (and its rounding) shows."""
    params = _np_tree(JRwkv6LM(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tm, cm = params["layers"]["tm"], params["layers"]["cm"]
    for node, key, scale in (
        (tm, "mu_x", 0.3),
        (tm, "mu", 0.3),
        (tm, "gn_b", 0.1),
        (cm, "mu_k", 0.3),
        (cm, "mu_r", 0.3),
    ):
        node[key] = (scale * rng.standard_normal(node[key].shape)).astype(np.float32)
    for node in (tm["ln"], cm["ln"], tm, params["final_norm"]):
        key = "gn_w" if node is tm else "w"
        node[key] = (1 + 0.3 * rng.standard_normal(node[key].shape)).astype(np.float32)
    return params


def _inputs(cfg, seed: int, batch: int = 2, prompt: int = 11, n_steps: int = 4):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, prompt)).astype(np.int32)
    steps = [
        rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32) for _ in range(n_steps)
    ]
    return tokens, steps


def _run_reference(jcfg, params, tokens, steps):
    model = JRwkv6LM(jcfg)
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}))
    decode = jax.jit(model.decode_step)
    cache, logits = prefill(params, tokens)
    outs = [(_np_tree(cache), np.asarray(logits, np.float32))]
    for tok in steps:
        cache, logits = decode(params, cache, tok)
        outs.append((_np_tree(cache), np.asarray(logits, np.float32)))
    return outs


def _run_port(tcfg, params, tokens, steps):
    model = build_model(tcfg)
    assert isinstance(model, Rwkv6LM)
    p = model.prepare(params_from_reference(tcfg, params, device="cpu"))
    cache, logits = model.prefill(p, {"tokens": torch.from_numpy(tokens)})

    def snap(cache, logits):
        c = {k: v.float().numpy().copy() for k, v in cache.items()}
        return c, logits.float().numpy()

    outs = [snap(cache, logits)]
    for tok in steps:
        cache, logits = model.decode_step(p, cache, torch.from_numpy(tok))
        outs.append(snap(cache, logits))
    return outs


def _compare(ref, port, tol):
    assert len(ref) == len(port)
    for i, ((rc, rl), (pc, pl)) in enumerate(zip(ref, port)):
        np.testing.assert_allclose(pl, rl, err_msg=f"logits, step {i}", **tol)
        assert sorted(pc) == sorted(rc)
        np.testing.assert_array_equal(pc["lengths"], rc["lengths"])
        for k in ("wkv", "tm_last", "cm_last"):
            want = np.asarray(rc[k], np.float32)
            assert pc[k].shape == want.shape, k
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(
                pc[k],
                want,
                rtol=tol["rtol"],
                atol=tol["atol"] * scale,
                err_msg=f"{k}, step {i}",
            )


@pytest.mark.parametrize("dtype,tol", [("float32", FP32), ("bfloat16", BF16)])
def test_prefill_and_decode_match_reference(dtype, tol):
    jcfg, tcfg = _cfgs(dtype=dtype)
    params = _reference_params(jcfg, 1)
    tokens, steps = _inputs(tcfg, seed=2)
    ref = _run_reference(jcfg, params, tokens, steps)
    _compare(ref, _run_port(tcfg, params, tokens, steps), tol)


def test_padded_prompt_and_single_token_match_reference():
    """A prompt that is not a multiple of the chunk (8), and one token."""
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 3)
    for prompt in (13, 1):
        tokens, steps = _inputs(tcfg, seed=prompt, batch=1, prompt=prompt, n_steps=1)
        ref = _run_reference(jcfg, params, tokens, steps)
        _compare(ref, _run_port(tcfg, params, tokens, steps), FP32)


def _rounded(params_np):
    """The leaves decode reads in fp32, rounded to bf16 beforehand."""
    out = jax.tree_util.tree_map(lambda a: a, params_np)
    tm = out["layers"]["tm"]
    nodes = [(tm, k) for k in DECODE_FP32]
    nodes += [(tm["ln"], "w"), (out["layers"]["cm"]["ln"], "w")]
    nodes += [(out["final_norm"], "w")]
    for node, key in nodes:
        w16 = jax.numpy.asarray(node[key]).astype("bfloat16")
        node[key] = np.asarray(w16, np.float32)
    return out


def test_bf16_cast_points_match_reference():
    """Both packages: prefill is unchanged, bit for bit, when u, w_base,
    w_lora_b, the GroupNorm affine and the norm weights are rounded to
    bf16 beforehand (prefill rounds every leaf itself); decode is not (it
    reads them as stored fp32)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    params = _reference_params(jcfg, 4)
    rounded = _rounded(params)
    tokens, steps = _inputs(tcfg, seed=5, n_steps=1)
    for run, cfg in ((_run_reference, jcfg), (_run_port, tcfg)):
        a = run(cfg, params, tokens, steps)
        b = run(cfg, rounded, tokens, steps)
        np.testing.assert_array_equal(a[0][1], b[0][1])  # prefill logits
        np.testing.assert_array_equal(a[0][0]["wkv"], b[0][0]["wkv"])
        assert not np.array_equal(a[1][1], b[1][1]), run.__name__  # decode


def test_forward_collect_state_equals_prefill_cache():
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 6)
    tokens, _ = _inputs(tcfg, seed=7)
    model = build_model(tcfg)
    p = model.prepare(params_from_reference(tcfg, params, device="cpu"))
    x, states = model.forward(p, torch.from_numpy(tokens), collect_state=True)
    wkv, tm_last, cm_last = states
    jx, (jwkv, jtm, jcm) = JRwkv6LM(jcfg).forward(params, tokens, collect_state=True)
    for got, want in ((x, jx), (wkv, jwkv), (tm_last, jtm), (cm_last, jcm)):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * scale)


def _requests(n, cls, seed=13, new_tokens=4, prompt_len=6, sessions=4):
    rng = np.random.default_rng(seed)
    return [
        cls(
            rid=i,
            prompt=list(map(int, rng.integers(2, 200, prompt_len))),
            max_new_tokens=new_tokens,
            session=int(rng.integers(0, sessions)),
        )
        for i in range(n)
    ]


ENGINE = dict(n_slots=4, max_seq=24, n_workers=2, eos_token=-1, n_lanes=2)


@pytest.fixture(scope="module")
def reference_run():
    """One reference engine run (its prefill and decode jits dominate)."""
    jcfg, _ = _cfgs()
    eng = JInferenceEngine(jcfg, JEngineConfig(**ENGINE), rng=jax.random.PRNGKey(5))
    res = eng.run(_requests(8, JRequest), timeout=120)
    return _np_tree(eng.params), {r.rid: r.tokens for r in res}, (eng.head, eng.tail)


@pytest.mark.parametrize("policy", ["corec", "rss"])
def test_port_engine_tokens_equal_reference_engine(reference_run, policy):
    params, want, (head, tail) = reference_run
    assert head == tail == 8
    _, tcfg = _cfgs()
    eng = InferenceEngine(
        tcfg,
        EngineConfig(policy=policy, **ENGINE),
        params=params_from_reference(tcfg, params, device="cpu"),
        device="cpu",
    )
    res = eng.run(_requests(8, Request), timeout=120)
    assert {r.rid: r.tokens for r in res} == want
    assert eng.head == eng.tail == 8
    assert sum(eng.release_events) == 8
