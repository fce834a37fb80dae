"""The port's Whisper encoder-decoder vs the JAX package's, on the same
parameters.

The reference's ``EncDecLM(cfg).init(PRNGKey(s))`` parameters cross over
as numpy arrays through ``params_from_reference``; the encoder, the
forward caches (self and cross K/V), prefill and 4 decode steps run in
both packages (the reference under ``jax.jit``, its attention on the
plain XLA route as on any CPU host; the port on its plain versions) on
``whisper-tiny`` (2 + 2 layers, 12 frames) with seeded numpy
``audio_embeds``.  fp32 at ``rtol=atol=2e-5``, bf16 at ``2e-2``; for the
caches ``atol`` scales with the tensor's largest magnitude (the
reference initialiser takes the fan-in of ``wk``/``wv`` from the head
count, so K/V reach tens), lengths exactly.

The LayerNorm weights and biases are drawn away from 1 and 0 so that
their two cast points show: prefill rounds them to the compute dtype
(the reference's ``cast_tree``), decode reads them as stored (fp32).

The reference initialiser takes the fan-in of ``wq``/``wk``/``wv``
``[d, H, dh]`` from the head count, so q and k come out sqrt(d / H) = 4x
too large here and attention is all but a hard max, which amplifies
rounding differences: under ``jax.jit`` XLA keeps a compiled layer's
bf16 intermediates in fp32 (excess precision), and the reference's own
compiled and op-by-op runs then differ by more than ``2e-2`` in bf16 and
``2e-5`` in fp32 (by 1e-4 on logits of 0.6).  As in
``test_torch_zamba.py``, the comparisons under ``jax.jit`` draw those
weights at fan-in d (the reference's weights scaled by sqrt(H / d)); at
the reference's own initialiser the port is held against the reference
run op by op (eager, layers unrolled, no remat), where the two round at
the same points: bf16 within ``2e-2``, the encoder bit for bit.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models.layers import apply_norm as japply_norm  # noqa: E402
from repro.models.whisper import EncDecLM as JEncDecLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import apply_norm  # noqa: E402
from repro_torch.models.whisper import EncDecLM  # noqa: E402

NAME = "whisper-large-v3"
FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CACHE = ("k", "v", "cross_k", "cross_v")
LN_KEYS = ("ln1", "ln2", "ln3")
ROOT = Path(__file__).resolve().parents[1]


def _cfgs(**over):
    jcfg, tcfg = jconfigs.get_tiny(NAME), configs.get_tiny(NAME)
    return jcfg.replace(**over), tcfg.replace(**over)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ln_nodes(params):
    return [params["dec_layers"][k] for k in LN_KEYS] + [
        params["enc_layers"]["ln1"],
        params["enc_layers"]["ln2"],
        params["enc_norm"],
        params["final_norm"],
    ]


def _reference_params(jcfg, seed: int, fan_in_d: bool = True):
    """The reference's init with every LayerNorm weight and bias drawn
    at random, so that each leaf (and its rounding) shows, and (unless
    ``fan_in_d`` is False) every attention's wq/wk/wv at fan-in d."""
    params = _np_tree(JEncDecLM(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for node in _ln_nodes(params):
        node["w"] = (1 + 0.3 * rng.standard_normal(node["w"].shape)).astype(np.float32)
        node["b"] = (0.2 * rng.standard_normal(node["b"].shape)).astype(np.float32)
    if fan_in_d:
        attns = [params["enc_layers"]["attn"]]
        attns += [params["dec_layers"][k] for k in ("self_attn", "cross_attn")]
        for attn in attns:
            for key in ("wq", "wk", "wv"):
                d, h = attn[key].shape[1:3]
                attn[key] = (attn[key] * np.sqrt(h / d)).astype(np.float32)
    return params


def _inputs(cfg, seed: int, batch: int = 2, prompt: int = 6, n_steps: int = 4):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((batch, cfg.enc_len, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (batch, prompt)).astype(np.int32)
    steps = [
        rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32) for _ in range(n_steps)
    ]
    return audio, tokens, steps


def _run_reference(jcfg, params, audio, tokens, lengths, steps, max_seq):
    model = JEncDecLM(jcfg)
    prefill = jax.jit(
        lambda p, t, a: model.prefill(
            p, {"tokens": t, "audio_embeds": a}, max_seq=max_seq
        )
    )
    decode = jax.jit(model.decode_step)
    cache, logits = prefill(params, tokens, audio)
    if lengths is not None:
        cache = dict(cache, lengths=np.asarray(lengths, np.int32))
    outs = [(_np_tree(cache), np.asarray(logits, np.float32))]
    for tok in steps:
        cache, logits = decode(params, cache, tok)
        outs.append((_np_tree(cache), np.asarray(logits, np.float32)))
    return outs


def _port(tcfg, params):
    model = build_model(tcfg)
    assert isinstance(model, EncDecLM)
    return model, model.prepare(params_from_reference(tcfg, params, device="cpu"))


def _run_port(tcfg, params, audio, tokens, lengths, steps, max_seq):
    model, p = _port(tcfg, params)
    batch = {
        "tokens": torch.from_numpy(tokens),
        "audio_embeds": torch.from_numpy(audio),
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
    """The whole tree, leaf for leaf, values and shapes unchanged."""
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 0)
    got = params_from_reference(tcfg, params, device="cpu")
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert sorted(map(str, flat)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(flat[path].numpy(), leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype, wdtype):
    """apply_norm's LayerNorm branch on x in each dtype, with the weight
    and bias in each (fp32 as decode reads them, bf16 as prefill does)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    x = (3 + 2 * rng.standard_normal((2, 5, tcfg.d_model))).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(tcfg.d_model)).astype(np.float32)
    b = (0.2 * rng.standard_normal(tcfg.d_model)).astype(np.float32)
    jnp = jax.numpy
    jp = {"w": jnp.asarray(w).astype(wdtype), "b": jnp.asarray(b).astype(wdtype)}
    want = japply_norm(jp, jnp.asarray(x).astype(dtype), jcfg)
    tdt = getattr(torch, dtype)
    tp = {"w": torch.from_numpy(w).to(getattr(torch, wdtype)),
          "b": torch.from_numpy(b).to(getattr(torch, wdtype))}
    got = apply_norm(tp, torch.from_numpy(x).to(tdt), tcfg)
    assert got.dtype == tdt
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol
    )


def test_encode_matches_reference():
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 1)
    audio, _, _ = _inputs(tcfg, seed=2)
    want = jax.jit(JEncDecLM(jcfg).encode)(params, audio)
    model, p = _port(tcfg, params)
    got = model.encode(p, torch.from_numpy(audio))
    _close(got.numpy(), want, FP32, "encoder output")


def test_forward_collect_kv_matches_reference():
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 4)
    audio, tokens, _ = _inputs(tcfg, seed=5)
    jmodel = JEncDecLM(jcfg)
    jx, jys = jax.jit(lambda p, t, a: jmodel.forward(p, t, a, collect_kv=True))(
        params, tokens, audio
    )
    model, p = _port(tcfg, params)
    t, a = torch.from_numpy(tokens), torch.from_numpy(audio)
    x, ys = model.forward(p, t, a, collect_kv=True)
    _close(x.numpy(), jx, FP32, "hidden")
    for k, got, want in zip(CACHE, ys, jys):
        _close(got.numpy(), want, FP32, k)
    assert model.forward(p, t, a)[1] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill (encoder, self and cross caches, last logits) and 4 decode
    steps; bf16 compute over fp32 masters."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    params = _reference_params(jcfg, 6)
    audio, tokens, steps = _inputs(tcfg, seed=7)
    ref = _run_reference(jcfg, params, audio, tokens, None, steps, 12)
    port = _run_port(tcfg, params, audio, tokens, None, steps, 12)
    _compare(ref, port, FP32 if dtype == "float32" else BF16)


def _run_reference_op_by_op(jcfg, params, audio, tokens, steps, max_seq):
    """The reference's prefill and decode steps run eagerly, the layer
    loops unrolled and without remat: each op rounds as written."""
    model = JEncDecLM(jcfg.replace(use_scan=False, remat=False))
    batch = {"tokens": tokens, "audio_embeds": audio}
    cache, logits = model.prefill(params, batch, max_seq=max_seq)
    outs = [(_np_tree(cache), np.asarray(logits, np.float32))]
    for tok in steps:
        cache, logits = model.decode_step(params, cache, tok)
        outs.append((_np_tree(cache), np.asarray(logits, np.float32)))
    return outs


def test_bf16_matches_reference_op_by_op_at_its_initialiser():
    """The reference's own initialiser (head-count fan-in, chaotic): the
    port's encoder equals the reference's run op by op bit for bit, and
    prefill and 4 decode steps agree within the bf16 tolerance."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    params = _reference_params(jcfg, 12, fan_in_d=False)
    audio, tokens, steps = _inputs(tcfg, seed=13)
    eager = JEncDecLM(jcfg.replace(use_scan=False, remat=False))
    jp = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a, "bfloat16"), params)
    want = np.asarray(eager.encode(jp, audio).astype("float32"))
    model, p = _port(tcfg, params)
    p16 = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16), p)
    got = model.encode(p16, torch.from_numpy(audio))
    np.testing.assert_array_equal(got.float().numpy(), want)
    ref = _run_reference_op_by_op(jcfg, params, audio, tokens, steps, 12)
    port = _run_port(tcfg, params, audio, tokens, None, steps, 12)
    _compare(ref, port, BF16)


def test_decode_past_max_seq_clamps_like_reference():
    """One slot's length passes the self cache: the write clamps to the
    last position, as dynamic_update_slice does; the cross cache is read
    over its full length whatever the self length."""
    jcfg, tcfg = _cfgs()
    params = _reference_params(jcfg, 8)
    audio, tokens, steps = _inputs(tcfg, seed=9, batch=3, prompt=5, n_steps=3)
    lengths = [5, 7, 8]
    ref = _run_reference(jcfg, params, audio, tokens, lengths, steps, 8)
    port = _run_port(tcfg, params, audio, tokens, lengths, steps, 8)
    _compare(ref, port, FP32)
    assert list(port[-1][0]["lengths"]) == [8, 10, 11]


def _rounded_lns(params_np):
    out = jax.tree_util.tree_map(lambda a: a, params_np)
    for node in _ln_nodes(out):
        for key in ("w", "b"):
            w16 = jax.numpy.asarray(node[key]).astype("bfloat16")
            node[key] = np.asarray(w16, np.float32)
    return out


def test_bf16_layernorm_cast_points_match_reference():
    """Both packages: prefill is unchanged, bit for bit, when every
    LayerNorm weight and bias is rounded to bf16 beforehand (it rounds
    them itself); decode is not (it reads the decoder's as stored fp32)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    params = _reference_params(jcfg, 10)
    rounded = _rounded_lns(params)
    audio, tokens, steps = _inputs(tcfg, seed=11, n_steps=1)
    for run, cfg in ((_run_reference, jcfg), (_run_port, tcfg)):
        a = run(cfg, params, audio, tokens, None, steps, 8)
        b = run(cfg, rounded, audio, tokens, None, steps, 8)
        np.testing.assert_array_equal(a[0][1], b[0][1])  # prefill logits
        for k in CACHE:
            np.testing.assert_array_equal(a[0][0][k], b[0][0][k])
        assert not np.array_equal(a[1][1], b[1][1]), run.__name__  # decode


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _without(tree, drop, path=""):
    """``tree`` without the leaves whose path ``drop`` matches."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        sub = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            v = _without(v, drop, sub)
            if v:
                out[k] = v
        elif not drop.search(sub):
            out[k] = v
    return out


@pytest.mark.parametrize("name", [NAME, "llama-3.2-vision-90b"])
def test_decode_reads_no_prefill_only_leaf(name):
    """decode_step runs, with the same logits, on a tree without the
    leaves chip_smoke.py's decode_step_bytes leaves out of the decode
    step's bytes (the encoder, the cross-attention's K/V projections):
    the bound counts no leaf that decode does not read."""
    smoke = _chip_smoke()
    cfg = configs.get_tiny(name)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.prepare(model.init(generator=gen, device="cpu"))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32))
    batch = smoke.model_batch(cfg, tokens, "cpu", torch.Generator().manual_seed(2))
    cache, _ = model.prefill(params, batch, max_seq=8)
    step = tokens[:, :1]
    _, want = model.decode_step(params, {k: v.clone() for k, v in cache.items()}, step)
    slim = _without(params, smoke.PREFILL_ONLY)
    n_all = sum(1 for _ in jax.tree_util.tree_leaves(params))
    n_slim = sum(1 for _ in jax.tree_util.tree_leaves(slim))
    assert n_slim < n_all
    _, got = model.decode_step(slim, cache, step)
    assert torch.equal(got, want)


#: (weight bytes, state and cache bytes) of one decode step at 16 slots
#: and 384 positions: the three earlier paths' figures as PERF.md gives
#: them; Whisper's token table read whole (tied, 51,968 padded rows),
#: its cross caches once, no encoder or cross K/V weight; the VLM's
#: cross caches once, no cross K/V weight
DECODE_BYTES = {
    "qwen2-1.5b": (3_088_046_080, 176_160_896),
    "rwkv6-3b": (5_875_394_560, 681_574_528),
    "zamba2-1.2b": (2_316_881_920, 1_607_876_736),
    NAME: (1_602_037_760, 4_938_793_088),
    "llama-3.2-vision-90b": (19_147_948_032, 411_041_920),
}


@pytest.mark.parametrize("name", sorted(DECODE_BYTES))
def test_decode_step_bytes(name):
    """From the specs alone, at the served configuration (the VLM at the
    card phase's depth cut, two groups of five layers)."""
    assert _chip_smoke().decode_step_bytes(name, 384) == DECODE_BYTES[name]
