"""The benchmark harness on the CPU: files found by name, the
yardstick's counts against hand counts, the traffic generator, the
plain reference against the port at tiny sizes, the import check, and
whole runs of both cells on the tiny configurations (plain routes)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import cost, spec, traffic
from bench.reference import decoder
from bench.run import BANNED, banned_modules, result_line
from bench.testing import TINY_SECONDS, tiny_cell

BENCH = spec.entries()  # BENCHMARK.json's cells and the parked ones
CELLS = [w["name"] for w in BENCH["workloads"]]


def _cfg(name):
    return json.loads((spec.BENCH / "configs" / f"{name}.json").read_text())["config"]


# ---------------------------------------------------------------- files


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    entry, cell, config = spec.load_cell(name)
    assert cell["name"] == name and cell["config"] == entry["config"]
    assert cell["why"] == entry["why"]
    assert spec.load_driver(cell).run
    for trace in (False, True):
        ms = spec.metrics_for(name, trace)
        assert ms and all(callable(m.read) for m in ms)
    e2e = {m.name for m in spec.metrics_for(name, False)}
    assert "setup_s" in e2e and len(e2e) >= 2


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = spec.load_module(spec.BENCH / "metrics" / (m["name"] + ".py"))
        assert callable(mod.read), m["name"]


def test_parked_cells_stay_out_of_the_benchmark():
    listed = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    parked = json.loads(spec.PARKED.read_text())
    assert set(parked) <= set(listed)
    for key, entries in parked.items():
        names = {e["name"] for e in entries}
        assert names and not names & {e["name"] for e in listed[key]}, key
    cells = {w["name"] for w in parked["workloads"]}
    for m in parked["end_to_end"] + parked["per_layer"]:
        assert set(m["workloads"]) <= cells, m["name"]  # no listed cell reports them


def test_config_files_hold_what_benchmark_names():
    for c in BENCH["configs"]:
        f = json.loads((spec.ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"] and f["source"]
        from repro_torch.config import ArchConfig

        ArchConfig(**f["config"])  # every key a field of the port's config


# ---------------------------------------------------------------- cost


def test_cost_hand_counts():
    q, g = _cfg("qwen2-1.5b"), _cfg("grok-1-314b")
    assert cost.kv_bytes_per_token(q) == 28 * 2 * 2 * 128 * 2 == 28_672
    # the 3.77 GB cache of 16 slots of 8,208 positions
    assert cost.kv_bytes_per_token(q) * 16 * 8208 == 3_765_436_416
    assert cost.kv_bytes_per_token(g) * 128 * 1024 == 6 * 2 * 8 * 128 * 2 * 128 * 1024
    # flash: 2 products of H dh S(S+1)/2 pairs, 2 flops a MAC; q, k, v, out once
    f, b = cost.flash_attention_cost(q, 100)
    assert f == 2 * 2 * 12 * 128 * 100 * 101 // 2
    assert b == 100 * (12 + 2 + 2 + 12) * 128 * 2
    # decode attention: K and V over the keys, q and out per slot
    f, b = cost.decode_attention_cost(q, [10, 20])
    assert b == 2 * 2 * 128 * 2 * 30 + 2 * 2 * 12 * 128 * 2 and f == 4 * 12 * 128 * 30
    # a 1-token prefill: every matmul once over the real vocabulary
    d, ff, L, V = 1536, 8960, 28, 151936
    per_tok = 2 * d * (12 + 4) * 128 + 2 * 12 * 128 * d + 3 * 2 * d * ff
    assert cost.prefill_flops(q, 1) == L * (per_tok + 2 * 12 * 128 * 2) + 2 * d * V
    # grok: top-2 of 8 experts count in the flops, all 8 in a step's bytes
    per_tok = 2 * 6144 * 64 * 128 + 2 * 48 * 128 * 6144 + 2 * 6144 * 8
    per_tok += 2 * 3 * 2 * 6144 * 32768
    want = 6 * (per_tok + 2 * 48 * 128 * 2) + 2 * 6144 * 131072
    assert cost.prefill_flops(g, 1) == want
    _, b = cost.decode_step_cost(g, [1] * 128)
    experts = 6 * 8 * 3 * 6144 * 32768 * 2
    assert experts == 57_982_058_496 and b > experts + 6144 * 131072 * 2


def test_roofline_names_its_bound():
    assert cost.roofline_s(989e12, 1.0) == (1.0, "flops")
    assert cost.roofline_s(1.0, 3.35e12) == (1.0, "bytes")


# ---------------------------------------------------------------- traffic


def test_open_plan_same_work_every_seed():
    t = {"rate_per_s": 10.0, "strata": 8,
         "prompt": {"dist": "loguniform", "min": 1024, "max": 8192},
         "new_tokens": 16, "sessions": {"dist": "zipf", "exponent": 1.5, "ids": 64}}
    a = traffic.open_plan(t, 1, 30.0, 1000)
    b = traffic.open_plan(t, 2**31 + 12345, 30.0, 1000)
    assert len(a) == len(b) == 300
    # the seed draws the gaps, the lengths and the tokens ...
    assert [len(p.prompt) for p in a] != [len(p.prompt) for p in b]
    assert [p.due for p in a] != [p.due for p in b]
    assert a[0].prompt != b[0].prompt
    edges = 1024 * 8 ** (np.arange(9) / 8)
    for plan in (a, b):
        due = [p.due for p in plan]
        assert due[0] == 0.0 and all(0 <= x < 30.0 for x in due) and due == sorted(due)
        assert all(0 <= s < 64 for s in (p.session for p in plan))
        # ... and every block of 8 holds one prompt of each eighth of the
        # log-uniform range: the same work a block for every seed
        for i in range(0, 296, 8):
            lens = sorted(len(p.prompt) for p in plan[i : i + 8])
            assert all(edges[k] - 1 <= n <= edges[k + 1] + 1 for k, n in enumerate(lens))
    assert traffic.open_plan(t, 1, 30.0, 1000)[5].prompt == a[5].prompt


def test_stratified_draws_one_per_slice():
    u = traffic.stratified(20, 4, np.random.default_rng(5))
    assert u.shape == (20,)
    for i in range(0, 20, 4):
        assert sorted(np.floor(u[i : i + 4] * 4).astype(int)) == [0, 1, 2, 3]
    again = traffic.stratified(20, 4, np.random.default_rng(5))
    assert np.array_equal(u, again)


def test_closed_stream_blocks_of_quantiles():
    t = {
        "clients": 8,
        "ramp_s": 2.0,
        "strata": 4,
        "prompt": {"dist": "uniform", "min": 64, "max": 512},
        "new_tokens": 512,
    }
    s, o = traffic.ClosedStream(t, 3, 1000), traffic.ClosedStream(t, 4, 1000)
    assert list(s.first_dues()) == [i * 0.25 for i in range(8)]
    a, b = [s.next() for _ in range(16)], [o.next() for _ in range(16)]
    lens = [len(p.prompt) for p in a]
    for i in range(0, 16, 4):  # one length from each quarter of the range
        assert [int((n - 64) // 112) for n in sorted(lens[i : i + 4])] == [0, 1, 2, 3]
    assert lens != [len(p.prompt) for p in b] and a[0].prompt != b[0].prompt


# ---------------------------------------------------------------- reference


#: every configuration file, each tested through one of its cells' stand-ins
CONFIGS = sorted(p.stem for p in (spec.BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_port_at_tiny_size(name):
    """Each configuration's plain reference against the port's plain
    forward (fp32, MoE drop-free) on one of its cells' tiny stand-ins,
    parked cells included: the same weights give the same logits."""
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import unembed
    from repro_torch.config import ArchConfig

    from bench.weights import make_params, rules_of

    _, _, config = tiny_cell(next(w["name"] for w in BENCH["workloads"]
                                  if w["config"] == name))
    reference = spec.load_reference(config)
    cfg = ArchConfig(**config["config"])
    model = build_model(cfg)
    params = make_params(model, 11, torch.device("cpu"), torch.float32,
                         rules_of(reference))
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (40,), generator=gen)
    with torch.inference_mode():
        x = model.forward(params, toks[None])[0]
        port = unembed(params["embed"], x, cfg)[0]
    ref = reference.logits(params, config["config"], toks.tolist(), 0)
    torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-4)


def test_fp8_control_rounds_operands():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    w = torch.randn(64, 8, generator=torch.Generator().manual_seed(1))
    exact, low = decoder.fp32(x, w), decoder.fp8(x, w)
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.2  # e4m3: 3 mantissa bits


# ---------------------------------------------------------------- imports


def test_banned_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.x", "flax", "repro", "repro.core.ring",
             "repro_torch", "repro_torch.serving", "jaxtyping", "reprox"]
    want = ["flax", "jax", "jax.numpy", "jaxlib.x", "repro", "repro.core.ring"]
    assert banned_modules(names) == want
    assert set(BANNED) == {"jax", "jaxlib", "flax", "repro"}


def test_harness_imports_neither_jax_nor_the_jax_package():
    """A fresh process loads every module of the harness (the entry, the
    spec, each driver, metric reader, the reference, the tests' helper)
    and holds no module whose top-level name is banned."""
    code = (
        "import sys, runpy; sys.argv=['x'];"
        "from bench import run, spec, testing, control, knee;"
        "from bench.reference import judge;"
        "[spec.load_module(p) for p in sorted((spec.BENCH / 'drivers').glob('*.py'))];"
        "[spec.load_module(p) for p in sorted((spec.BENCH / 'metrics').glob('*.py'))];"
        "print(run.banned_modules())"
    )
    src = spec.ROOT / "src"
    env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}{spec.ROOT}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=spec.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


# ---------------------------------------------------------------- whole runs


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_whole_run_on_tiny_config(name, trace):
    entry, cell, config = tiny_cell(name)
    driver = spec.load_driver(cell)
    rec = driver.run(cell, config, 2**31 + 5, TINY_SECONDS, bool(trace), device="cpu")
    metrics = spec.metrics_for(name, bool(trace))
    out = result_line(rec, metrics, {"platform": "cpu"}, bool(trace))
    out = json.loads(json.dumps(out))
    keys = ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert list(out) == keys
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    got = set(out["metrics"])
    if trace:
        # the device's numbers need the card's trace; the host's are here
        names = {m.name for m in metrics}
        host = {n for n in names if n.startswith(("queue_wait", "decode_step"))}
        assert host and host <= got
        device = ("prefill_mfu", "flash_", "device_idle")
        assert not any(n.startswith(device) for n in got)
    else:
        assert {m.name for m in metrics} == got
        assert all(v["value"] > 0 for v in out["metrics"].values())


# ---------------------------------------------------------------- trace


def test_trace_reduction_attributes_by_launching_thread():
    from bench.trace import reduce_events, short_name

    rows = [
        ("span", "bench.prefill:7:100", 0, 100, 0, 10),
        ("span", "bench.decode:0", 50, 100, 0, 20),
        ("runtime", "cudaLaunchKernel", 10, 1, 1, 10),
        ("runtime", "cuLaunchKernelEx", 60, 1, 2, 20),
        ("device", "void (anonymous namespace)::flash_mma_kernel<128>()", 20, 20, 1, 7),
        ("device", "void decode_split_kernel<bf16, 128, 6>(bf16 const*)", 70, 20, 2, 7),
        ("device", "Memcpy HtoD (Pinned -> Device)", 95, 5, 3, 7),
        ("device", "void late_kernel(int)", 300, 10, 4, 7),  # after the window
    ]
    tr = reduce_events(rows, 0, 200)
    assert short_name(rows[4][1]) == "flash_mma_kernel"
    assert tr["kernels"] == 2 and tr["device_events"] == 4
    assert tr["busy_s"] == pytest.approx(45e-9)
    ns20 = pytest.approx(20e-9)
    assert tr["spans"]["bench.prefill:7:100"] == {"flash_mma_kernel": ns20}
    assert tr["spans"]["bench.decode:0"] == {"decode_split_kernel": ns20}
    assert tr["complete"] == ["bench.decode:0", "bench.prefill:7:100"]
    gaps = dict(tr["idle_gaps"])
    # each gap is labelled by the spans open at its middle
    assert gaps["prefill (host)"] == pytest.approx(20e-9)  # 0-20
    assert gaps["decode+prefill (host)"] == pytest.approx(35e-9)  # 40-70 + 90-95
    assert gaps["decode (host)"] == pytest.approx(100e-9)  # 100-200
    only_spans = reduce_events(rows[:2], 0, 200)["idle_gaps"]
    assert only_spans == [("decode+prefill (host)", 200e-9)]
