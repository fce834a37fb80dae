"""granite-4.0-h-small, the port's Mamba-2 / attention pattern hybrid
(``models/granite.py``), on the CPU at its tiny size in fp32, against the
benchmark's plain reference (``bench/reference/granite_hybrid.py``: a
sequential scan, attention in query blocks, the MoE without capacity)
on weights drawn by the benchmark's rules; the full configuration's
pattern, parameter count and cache; the SSD plain route at state width
128; ``moe_capacity`` at 72 experts top-10; the decode step's spans.
No JAX: the JAX package has no such family.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench.reference import granite_hybrid as ref
from bench.weights import leaf_paths, make_params, rules_of
from repro_torch import configs, tracing
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.models.granite import GraniteHybridLM
from repro_torch.models.layers import moe_capacity

NAME = "granite-4.0-h-small"
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]

#: fp32 on both sides: the port's chunked scan (8-token chunks, decays
#: from cumulative sums) and the reference's sequential one, the conv's
#: and the MoE's sums, round apart by ~1e-8 of logits whose spread is
#: 2.6e-3 (the benchmark's token table, /4); 2e-7 leaves 20x of room and
#: lies four orders below what a swapped gate order moves (9e-3)
TOL = dict(rtol=1e-5, atol=2e-7)


def _tiny(**over):
    return configs.get_tiny(NAME).replace(**over)


def _params(cfg, seed: int):
    return make_params(build_model(cfg), seed, CPU, torch.float32, rules_of(ref))


def _tokens(cfg, shape, seed: int):
    return torch.randint(0, cfg.vocab, shape, generator=torch.Generator().manual_seed(seed))


def _served(model, params, toks, prompt: int):
    """Prefill of ``toks[:, :prompt]``, then a decode step per further
    token: the logits after each position from ``prompt - 1`` on."""
    with torch.inference_mode():
        cache, lg = model.prefill(params, {"tokens": toks[:, :prompt]}, max_seq=32)
        out = [lg]
        for t in range(prompt, toks.shape[1]):
            cache, lg = model.decode_step(params, cache, toks[:, t : t + 1])
            out.append(lg)
    return torch.stack(out, 1), cache


def _reference(params, cfg, toks, prompt: int):
    d = dataclasses.asdict(cfg)
    return torch.stack([ref.logits(params, d, row.tolist(), prompt - 1) for row in toks])


@pytest.mark.parametrize("seed", [11, 2**31 + 3])
def test_prefill_then_decode_equals_the_reference(seed):
    """A 20-token prefill and 10 decode steps through the cache, 2
    sequences: each position's logits the reference's full forward's."""
    cfg = _tiny()
    params = _params(cfg, seed)
    toks = _tokens(cfg, (2, 30), seed)
    got, cache = _served(build_model(cfg), params, toks, 20)
    want = _reference(params, cfg, toks[:, :-1], 20)
    torch.testing.assert_close(got[:, :-1], want, **TOL)
    assert cache["lengths"].tolist() == [30, 30]
    assert want.std() > 1e-3  # logits that carry a signal, 5,000 x atol


def test_norm_then_gate_order_fails_the_comparison():
    """zamba2's gated norm (normalise, then gate) in granite's place: the
    comparison that the right order passes fails, by far."""
    cfg = _tiny()
    params = _params(cfg, 11)
    toks = _tokens(cfg, (2, 30), 11)
    got, _ = _served(build_model(cfg.replace(mamba_gate_first=False)), params, toks, 20)
    want = _reference(params, cfg, toks[:, :-1], 20)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got[:, :-1], want, **TOL)
    assert (got[:, :-1] - want).abs().max() > 1e3 * TOL["atol"]


def test_a_slot_decodes_alone():
    """Slot 0's logits and cache rows, through a prefill and 4 decode
    steps, do not change when the other slots' tokens change: the MoE
    routes the step's slots as one group but drops nothing."""
    cfg = _tiny()
    model, params = build_model(cfg), _params(cfg, 5)
    a = _tokens(cfg, (4, 14), 1)
    b = _tokens(cfg, (4, 14), 2)
    b[0] = a[0]
    la, ca = _served(model, params, a, 10)
    lb, cb = _served(model, params, b, 10)
    assert not torch.equal(la[1:], lb[1:])
    torch.testing.assert_close(la[0], lb[0], rtol=0, atol=1e-6)
    for k in ("ssm", "conv", "k", "v"):
        torch.testing.assert_close(ca[k][:, 0], cb[k][:, 0], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_replayed_decode_step_equals_the_eager_one_on_the_card():
    """On a card ``decode_step`` replays a CUDA graph of itself: over 6
    steps, one slot's length rewritten in place between two of them (as
    the engine's ``_insert`` writes a slot), its logits and cache equal
    the eager step's bit for bit, and each step's logits stay as
    returned while later steps run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # widths the kernels take: d_head 32, P 64 and granite's N 128
    cfg = _tiny(d_model=128, ssm_head_dim=64, ssm_state=128)
    dev = torch.device("cuda")
    params = make_params(build_model(cfg), 5, dev, torch.float32, rules_of(ref))
    toks = _tokens(cfg, (4, 16), 5).to(dev, torch.int32)
    out = {}
    for replay in (False, True):
        model = build_model(cfg)
        step = model.decode_step if replay else model._step
        with torch.inference_mode():
            cache, _ = model.prefill(params, {"tokens": toks[:, :10]}, max_seq=32)
            logits = []
            for t in range(10, 16):
                if t == 13:
                    cache["lengths"][2] = 4
                cache, lg = step(params, cache, toks[:, t : t + 1])
                logits.append(lg)
        assert (model._graph is not None) == replay
        out[replay] = torch.stack(logits), cache
    (want, eager), (got, replayed) = out[False], out[True]
    assert torch.equal(got, want)
    for name in eager:
        assert torch.equal(replayed[name], eager[name]), name


def test_full_configuration_pattern_count_and_cache():
    cfg = configs.get(NAME)
    assert NAME in configs.PORT_ARCHS and NAME not in configs.ALL_ARCHS
    model = build_model(cfg)
    assert isinstance(model, GraniteHybridLM)
    published = json.loads((ROOT / "bench" / "configs" / f"{NAME}.json").read_text())
    kinds = [k for k, *_ in model._walk(model.abstract_params())]
    assert kinds == ["attn" if t == "attention" else t for t in published["layer_types"]]
    # 36 x 800,941,696 (Mamba) + 4 x 740,597,760 (attention) + the tied
    # table 411,041,792 + the final norm 4,096, every norm counted
    leaves = sum(t.numel() for _, t in leaf_paths(model.abstract_params()))
    assert cfg.n_params() == leaves == 32_207_337_984
    assert cfg.n_active_params() == 8_803_121_664  # top-10 of 72, the shared one
    specs = model.cache_specs(32, 1280)
    assert specs["ssm"].shape == (36, 32, 128, 64, 128)
    assert specs["ssm"].dtype == torch.float32
    assert specs["conv"].shape == (36, 32, 3, 8448)
    assert specs["k"].shape == specs["v"].shape == (4, 32, 1280, 8, 128)
    assert all(s.axes[s.axes.index("batch")] == "batch" for s in specs.values())
    ssm_slot = 36 * 128 * 64 * 128 * 4
    assert ssm_slot == 150_994_944  # 151.0 MB of fp32 state a slot


def test_ssd_plain_route_at_state_width_128_equals_a_sequential_recurrence():
    """``ops.ssd``'s plain route (64-token chunks) at P = 64, N = 128 over
    a ragged 150 tokens against ``S_t = exp(A dt_t) S + dt_t x_t B_t^T``,
    ``y_t = S_t C_t + D x_t`` token by token, from a given state."""
    g = torch.Generator().manual_seed(3)
    B, T, H, P, N = 2, 150, 4, 64, 128
    x = 0.5 * torch.randn(B, T, H, P, generator=g)
    dt = 0.2 * torch.nn.functional.softplus(torch.randn(B, T, H, generator=g))
    A = -torch.exp(0.3 * torch.randn(H, generator=g))
    Bm = 0.5 * torch.randn(B, T, 1, N, generator=g)
    Cm = 0.5 * torch.randn(B, T, 1, N, generator=g)
    D = torch.randn(H, generator=g)
    s0 = 0.3 * torch.randn(B, H, P, N, generator=g)
    y, s = ops.ssd(x, dt, A, Bm, Cm, D, s0, chunk=64, impl="plain")
    S, ys = s0.clone(), []
    for t in range(T):
        decay = torch.exp(A * dt[:, t])[..., None, None]
        S = decay * S + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, :, None, :]
        ys.append(S @ Cm[:, t, 0, :, None][:, None] + (D[:, None] * x[:, t])[..., None])
    torch.testing.assert_close(y, torch.stack(ys, 1)[..., 0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, S, rtol=1e-5, atol=1e-5)


def _capacity(Tg: int, E: int, k: int, cf: float) -> int:
    """The capacity formula the JAX package keeps."""
    return max(1, int(Tg * k / E * cf))


def test_moe_capacity_drops_nothing_where_cf_k_covers_the_experts():
    g = configs.get(NAME)
    sizes = range(1, 8193)
    lifted = [T for T in sizes if _capacity(T, 72, 10, 7.2) < T]
    assert len(lifted) == 183 and lifted[:3] == [61, 122, 235]
    assert all(moe_capacity(T, g) == max(_capacity(T, 72, 10, 7.2), T) for T in sizes)
    # where cf k >= E already gave Tg or more, nothing changes
    grok = configs.get("grok-1-314b").replace(capacity_factor=4.0)  # the bench's
    for cfg in (grok, configs.get_tiny("grok-1-314b"),
                configs.get_tiny("moonshot-v1-16b-a3b"), configs.get_tiny(NAME)):
        assert cfg.capacity_factor * cfg.top_k >= cfg.n_experts, cfg.name
        E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
        assert all(moe_capacity(T, cfg) == max(_capacity(T, E, k, cf), T) for T in sizes)
        if cfg.name != _tiny().name:
            assert all(moe_capacity(T, cfg) == _capacity(T, E, k, cf) for T in sizes)
    # and below it, the formula as it was
    low = configs.get_tiny("grok-1-314b").replace(capacity_factor=1.25)
    assert all(moe_capacity(T, low) == _capacity(T, 4, 2, 1.25) for T in sizes)


def test_decode_step_spans_under_a_profiler():
    """A decode step's inner spans: ``mamba`` or ``attn`` then ``moe`` a
    layer, in layer order, each ``moe`` holding the routed block's three
    and ``moe.shared``; none without a profiler."""
    cfg = _tiny()
    model, params = build_model(cfg), _params(cfg, 7)
    toks = _tokens(cfg, (2, 6), 7)
    with torch.inference_mode():
        cache, _ = model.prefill(params, {"tokens": toks[:, :5]}, max_seq=8)
    tracing.clear()
    try:
        with torch.inference_mode():
            model.decode_step(params, cache, toks[:, 5:])
        assert tracing.spans() == []
        with profile(activities=[ProfilerActivity.CPU]):
            with torch.inference_mode():
                model.decode_step(params, cache, toks[:, 5:])
        spans = tracing.spans()
    finally:
        tracing.clear()
    top = [(s.name, s.fields["layer"]) for s in spans if s.name in ("mamba", "attn", "moe")]
    want = []
    for n in range(cfg.n_layers):
        want += [("attn" if n in cfg.attn_layer_ids else "mamba", n), ("moe", n)]
    assert top == want
    for moe in (s for s in spans if s.name == "moe"):
        parts = [s.name for s in spans if s.parent == moe.id]
        assert parts == ["moe.route", "moe.experts", "moe.combine", "moe.shared"]
    assert not any(s.ranged for s in spans)
