"""The pattern hybrid's per-layer metrics on hand-made records, each
against a hand count: ``ssd_decode_roofline`` (the one-token SSD kernel
over its bytes), ``decode_mfu.hybrid`` (a whole decode step's bytes at
granite-4.0-h-small's sizes), ``mamba_enqueue_ms`` (the program's
``mamba`` spans) and ``decode_attention_roofline.hybrid`` (the decode
attention kernel over its attention layers alone); each gives None on an untraced record and on a
configuration without Mamba-2 layers."""

from __future__ import annotations

import json

import pytest

from bench import cost_hybrid
from bench.spec import BENCH, load_module
from repro_torch import tracing

MS = 1_000_000  # ns
T0 = 10_000 * MS  # the window's start, perf_counter ns
HBM = 3.35e12

#: the tiny pattern hybrid: d 64, inner 128 = 8 heads of P 16, N 24
TINY = {"n_layers": 4, "attn_layer_ids": [2], "d_model": 64, "n_heads": 4,
        "n_kv_heads": 2, "d_head": None, "d_ff": 32, "shared_ff": 48,
        "n_experts": 8, "top_k": 3, "vocab": 512, "ssm_state": 24,
        "ssm_expand": 2, "ssm_head_dim": 16}


def _read(name: str, record: dict):
    return load_module(BENCH / "metrics" / f"{name}.py").read(record)


def _granite() -> dict:
    path = BENCH / "configs" / "granite-4.0-h-small.json"
    return json.loads(path.read_text())["config"]


def test_ssd_decode_bytes_by_hand():
    # a slot: fp32 state 8 x 16 x 24 read and written, x and y 8 x 16
    # bf16, B and C 24 bf16, dt 8 fp32
    per_slot = 2 * 8 * 16 * 24 * 4 + 2 * 8 * 16 * 2 + 2 * 24 * 2 + 8 * 4
    assert per_slot == 25_216
    assert cost_hybrid.ssd_decode_bytes(TINY, 3) == 3 * per_slot
    # granite: 32 slots x 128 heads x 32 KB of state, read and written
    g = _granite()
    assert cost_hybrid.ssd_decode_bytes(g, 32) == 32 * (
        2 * 128 * 64 * 128 * 4 + 2 * 128 * 64 * 2 + 2 * 128 * 2 + 128 * 4
    )


def _traced_record() -> dict:
    return {
        "cfg": TINY,
        "steps": [(1.0, bytes([1, 1, 0, 1])), (1.1, bytes([1, 1, 1, 1])),
                  (1.2, bytes([1, 0, 0, 0]))],
        "trace": {
            "complete": ["bench.decode:0", "bench.decode:1", "bench.decode:2",
                         "bench.prefill:5:100"],
            "spans": {
                "bench.decode:0": {"ssd_decode_kernel": 2e-6, "decode_split_kernel": 5e-6},
                "bench.decode:1": {"ssd_decode_kernel": 1e-6},
                "bench.decode:2": {"decode_split_kernel": 4e-6},  # no SSD: left out
                "bench.prefill:5:100": {"ssd_decode_kernel": 9.0},  # not a decode span
            },
        },
    }


def test_ssd_decode_roofline_hand_count():
    # three Mamba layers a step, 3 then 4 active slots of 25,216 bytes
    bound = 3 * (3 + 4) * 25_216 / HBM
    want = 100 * bound / 3e-6
    assert _read("ssd_decode_roofline", _traced_record()) == pytest.approx(want, rel=1e-12)


def test_decode_attention_roofline_hybrid_hand_count():
    """One attention layer of the tiny hybrid's four: 4 heads of 16 over
    2 KV heads; the step's slots read 10, 20, 0 and 30 keys."""
    # step 0: K and V of 60 keys x 2 KV heads x 16 (bf16), 4 slots' query
    # and output of 4 x 16; step 1 has no split or merge time: left out;
    # step 2 has no keys recorded for it: left out
    record = dict(_traced_record(), step_keys=[[10, 20, 0, 30], [1, 1, 1, 1]])
    nbytes = 2 * 2 * 16 * 2 * 60 + 2 * 4 * 4 * 16 * 2
    flops = 2 * 2 * 4 * 16 * 60
    assert nbytes / HBM > flops / 989e12
    want = 100 * 1 * nbytes / HBM / 5e-6
    assert _read("decode_attention_roofline.hybrid", record) == pytest.approx(
        want, rel=1e-12)


def test_decode_mfu_hybrid_hand_count():
    """A step of 32 slots at 1,000 positions each at granite's sizes:
    the bytes bound it (74.8 GB)."""
    g = _granite()
    record = {"cfg": g, "window": (0.0, 1.0), "seconds": 1.0,
              "steps": [(0.5, bytes([1] * 32)), (2.0, bytes([1] * 32))],  # one in it
              "step_keys": [[1000] * 32, [1000] * 32]}
    mamba = (4096 * (8192 + 8448 + 128) + 8192 * 4096 + 4 * 8448 + 8448) * 2
    mamba += (3 * 128 + 8192) * 4  # A_log, D, dt_bias, the gated norm: fp32
    assert mamba == 204_591_104
    attn = (4096 * 48 * 128 + 32 * 128 * 4096) * 2
    ffn = 72 * 3 * 4096 * 768 * 2 + 4096 * 72 * 4 + 3 * 4096 * 1536 * 2 + 2 * 4096 * 4
    state = 32 * ((2 * 128 * 64 * 128 * 4 + 2 * 128 * 64 * 2 + 2 * 128 * 2 + 128 * 4)
                  + 2 * 3 * 8448 * 2)
    kv = 4 * 2 * 8 * 128 * 2 * (32 * 1000 + 32)
    rest = 32 * 4096 * 2 + 4096 * 100352 * 2 + 4096 * 4
    nbytes = 36 * mamba + 4 * attn + 40 * ffn + 36 * state + kv + rest
    assert 74.0e9 < nbytes < 75.0e9
    flops, counted = cost_hybrid.decode_step_cost(g, [1000] * 32)
    assert counted == nbytes and flops / 989e12 < nbytes / HBM
    want = 100 * nbytes / HBM / 1.0
    assert _read("decode_mfu.hybrid", record) == pytest.approx(want, rel=1e-12)


def _span_steps():
    ids = iter(range(1, 1 << 20))
    out = []

    def add(name, at, ms, parent=None, **fields):
        s = tracing.Span(next(ids), name, fields, 1, parent and parent.id,
                         at, at + round(ms * MS))
        out.append(s)
        return s

    for i, (at, mamba, retire) in enumerate([(T0 - 500 * MS, (9, 9), True),
                                             (T0, (1, 2), True),
                                             (T0 + 100 * MS, (3, 4), True),
                                             (T0 + 200 * MS, (50, 50), False)]):
        st = add("step", at, 60, step=i)
        dec = add("decode", at, 40, st, step=i)
        u = at
        for layer, ms in enumerate(mamba):
            add("mamba", u, ms, dec, layer=2 * layer)
            add("attn", u, 0.5, dec, layer=2 * layer + 1)
            add("moe", u, 5, dec, layer=2 * layer)
            u += 10 * MS
        if retire:
            add("retire", at + 50 * MS, 1, st, finished=0)
    return out


def test_mamba_enqueue_ms_hand_count(monkeypatch):
    spans = _span_steps()
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    record = {"window": (T0 / 1e9, T0 / 1e9 + 51)}
    # the window's whole steps: (1 + 2) and (3 + 4) ms of mamba spans
    assert _read("mamba_enqueue_ms", record) == pytest.approx((3 + 7) / 2, rel=1e-12)


@pytest.mark.parametrize("name", ["ssd_decode_roofline", "decode_mfu.hybrid",
                                  "mamba_enqueue_ms", "decode_attention_roofline.hybrid"])
def test_none_untraced_or_without_mamba(monkeypatch, name):
    monkeypatch.setattr(tracing, "spans", lambda: [])
    untraced = {"cfg": TINY, "window": (0.0, 1.0), "seconds": 1.0, "trace": None,
                "steps": [(0.5, bytes([1, 1]))]}
    assert _read(name, untraced) is None
    decoder = dict(_traced_record(), cfg={"n_layers": 6, "ssm_state": 0},
                   window=(0.0, 2.0), seconds=2.0, step_keys=[[5, 5, 5, 5]] * 3)
    assert _read(name, decoder) is None
