"""The port's Zamba2 hybrid and its engine vs the JAX package's.

The reference's ``ZambaLM(cfg).init(PRNGKey(s))`` parameters cross over
as numpy arrays through ``params_from_reference``; prefill and 4 decode
steps run in both packages (the reference under ``jax.jit``, its SSD
and attention on their jnp routes as on any CPU host; the port on its
plain versions) on ``zamba2-tiny`` (2 groups of 2 Mamba layers, each
ended by the shared block, and 1 extra layer).  The logits and the
whole cache (SSM states, conv windows, the shared block's K/V, lengths)
must agree: fp32 at ``2e-5``, bf16 at ``2e-2``; for cache tensors
``atol`` scales with the tensor's largest magnitude, lengths exactly.

The reference initialiser takes the fan-in of the shared block's
``wq``/``wk``/``wv`` ``[2d, H, dh]`` from the head count, so q and k
come out ~6x too large and attention is all but a hard max, which
amplifies rounding differences: in bf16 a 1-ulp difference in one conv
output moves the second group's K by 10%, and in fp32 the last layer's
conv window ends ~5e-5 apart.  The model comparisons therefore draw
those three weights with fan-in 2d (the reference's weights rescaled
by sqrt(H / 2d)); the engine test runs the reference engine's own
initialiser and wants its tokens per rid.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models.zamba import ZambaLM as JZambaLM  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.zamba import ZambaLM  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine, Request  # noqa: E402

NAME = "zamba2-1.2b"
FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
#: the Mamba leaves decode reads as stored fp32 (the reference's cast-at-use)
DECODE_FP32 = ("A_log", "D", "dt_bias", "gn_w")
CACHE = ("ssm_g", "conv_g", "attn_k", "attn_v", "ssm_x", "conv_x")


def _cfgs(**over):
    jcfg, tcfg = jconfigs.get_tiny(NAME), configs.get_tiny(NAME)
    return jcfg.replace(**over), tcfg.replace(**over)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mamba_nodes(params):
    return [params["mamba_g"], params["mamba_x"]]


def _reference_params(jcfg, seed: int):
    """The reference's init, with the constant SSM leaves, the conv bias
    and the norm weights drawn at random so that every leaf (and its
    rounding) shows, and the shared block's wq/wk/wv at fan-in 2d."""
    params = _np_tree(JZambaLM(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def draw(node, key, loc, scale):
        shape = node[key].shape
        node[key] = (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    for node in _mamba_nodes(params):
        draw(node, "A_log", 0.0, 0.5)
        draw(node, "D", 1.0, 0.3)
        draw(node, "dt_bias", -1.0, 0.3)
        draw(node, "gn_w", 1.0, 0.3)
        draw(node, "conv_b", 0.0, 0.1)
        draw(node["ln"], "w", 1.0, 0.3)
    for node in (params["shared"]["ln1"], params["shared"]["ln2"]):
        draw(node, "w", 1.0, 0.3)
    draw(params["final_norm"], "w", 1.0, 0.3)
    sh = params["shared"]
    for key in ("wq", "wk", "wv"):
        d2, h = sh[key].shape[:2]
        sh[key] = (sh[key] * np.sqrt(h / d2)).astype(np.float32)
    return params


def _inputs(cfg, seed: int, batch: int = 2, prompt: int = 11, n_steps: int = 4):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, prompt)).astype(np.int32)
    steps = [
        rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32) for _ in range(n_steps)
    ]
    return tokens, steps


def _run_reference(jcfg, params, tokens, lengths, steps, max_seq):
    model = JZambaLM(jcfg)
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, max_seq=max_seq))
    decode = jax.jit(model.decode_step)
    cache, logits = prefill(params, tokens)
    if lengths is not None:
        cache = dict(cache, lengths=np.asarray(lengths, np.int32))
    outs = [(_np_tree(cache), np.asarray(logits, np.float32))]
    for tok in steps:
        cache, logits = decode(params, cache, tok)
        outs.append((_np_tree(cache), np.asarray(logits, np.float32)))
    return outs


def _run_port(tcfg, params, tokens, lengths, steps, max_seq):
    model = build_model(tcfg)
    assert isinstance(model, ZambaLM)
    p = model.prepare(params_from_reference(tcfg, params, device="cpu"))
    batch = {"tokens": torch.from_numpy(tokens)}
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


def _compare(ref, port, tol):
    assert len(ref) == len(port)
    for i, ((rc, rl), (pc, pl)) in enumerate(zip(ref, port)):
        np.testing.assert_allclose(pl, rl, err_msg=f"logits, step {i}", **tol)
        assert sorted(pc) == sorted(rc)
        np.testing.assert_array_equal(pc["lengths"], rc["lengths"])
        for k in CACHE:
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


def test_prefill_and_decode_match_reference_fp32():
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 1)
    tokens, steps = _inputs(tcfg, seed=2)
    ref = _run_reference(jcfg, params, tokens, None, steps, 16)
    _compare(ref, _run_port(tcfg, params, tokens, None, steps, 16), FP32)


def test_prefill_and_decode_match_reference_bf16():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    params = _reference_params(jcfg, 3)
    tokens, steps = _inputs(tcfg, seed=4)
    ref = _run_reference(jcfg, params, tokens, None, steps, 16)
    _compare(ref, _run_port(tcfg, params, tokens, None, steps, 16), BF16)


def test_padded_prompt_and_single_token_match_reference():
    """A prompt that is not a multiple of the chunk (8), and one token
    (shorter than the conv window)."""
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 5)
    for prompt in (13, 1):
        tokens, steps = _inputs(tcfg, seed=prompt, batch=1, prompt=prompt, n_steps=1)
        ref = _run_reference(jcfg, params, tokens, None, steps, 16)
        _compare(ref, _run_port(tcfg, params, tokens, None, steps, 16), FP32)


def test_decode_past_max_seq_clamps_like_reference():
    """One slot's length passes the shared block's cache: the write
    clamps to the last position, as dynamic_update_slice does."""
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 6)
    tokens, steps = _inputs(tcfg, seed=7, batch=3, prompt=5, n_steps=3)
    lengths = [5, 7, 8]
    ref = _run_reference(jcfg, params, tokens, lengths, steps, 8)
    port = _run_port(tcfg, params, tokens, lengths, steps, 8)
    _compare(ref, port, FP32)
    assert list(port[-1][0]["lengths"]) == [8, 10, 11]


def _rounded(params_np):
    """The leaves decode reads in fp32, rounded to bf16 beforehand."""
    out = jax.tree_util.tree_map(lambda a: a, params_np)
    nodes = [(n, k) for n in _mamba_nodes(out) for k in DECODE_FP32]
    nodes += [(n["ln"], "w") for n in _mamba_nodes(out)]
    nodes += [(out["shared"]["ln1"], "w"), (out["shared"]["ln2"], "w")]
    nodes += [(out["final_norm"], "w")]
    for node, key in nodes:
        w16 = jax.numpy.asarray(node[key]).astype("bfloat16")
        node[key] = np.asarray(w16, np.float32)
    return out


def test_bf16_cast_points_match_reference():
    """Both packages: prefill is unchanged, bit for bit, when A_log, D,
    dt_bias, the gated-norm weight and the norm weights are rounded to
    bf16 beforehand (prefill rounds every leaf itself); decode is not (it
    reads them as stored fp32)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    params = _reference_params(jcfg, 8)
    rounded = _rounded(params)
    tokens, steps = _inputs(tcfg, seed=9, n_steps=1)
    for run, cfg in ((_run_reference, jcfg), (_run_port, tcfg)):
        a = run(cfg, params, tokens, None, steps, 12)
        b = run(cfg, rounded, tokens, None, steps, 12)
        np.testing.assert_array_equal(a[0][1], b[0][1])  # prefill logits
        np.testing.assert_array_equal(a[0][0]["ssm_g"], b[0][0]["ssm_g"])
        assert not np.array_equal(a[1][1], b[1][1]), run.__name__  # decode


def test_forward_collect_state_matches_reference():
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 10)
    tokens, _ = _inputs(tcfg, seed=11)
    model = build_model(tcfg)
    p = model.prepare(params_from_reference(tcfg, params, device="cpu"))
    x, ys, ys_x = model.forward(p, torch.from_numpy(tokens), collect_state=True)
    jx, jys, jys_x = JZambaLM(jcfg).forward(params, tokens, collect_state=True)
    for got, want in zip((x, *ys, *ys_x), (jx, *jys, *jys_x)):
        want = np.asarray(want)
        assert got.shape == want.shape
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * scale)
    assert model.forward(p, torch.from_numpy(tokens))[1:] == (None, None)


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
