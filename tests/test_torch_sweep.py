"""The port's sweep API on its own draws, on the CPU.

Within the port: the compacted engine equals the per-claim reference
engine bit for bit (fault-free and faulted), a fused call equals one
call per policy, a tight claim budget fails loudly, every lane is
exactly-once, and the in-graph RFC 4737 metrics equal the host-side
reference.  Against ``repro``: the port's torch-RNG traffic is held
distributionally (torch and jax draws differ), per-policy medians over
16 seeds within the tolerances of ``test_jaxplane.py`` (P50_RTOL,
P99_RTOL); the policy catalog, the steering hash and the queue helpers
agree exactly, as do the counter hash and the MAWI tables that the
DES modules keep beside the lane engine's.  Last, importing and
running the port -- the lane engine, the DES and threaded planes and
the protocol model included -- loads neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import jaxplane as jp  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core.policy import jax_policies  # noqa: E402
from repro_torch.core import (  # noqa: E402
    SweepRequest,
    measure_reordering,
    run_sweep,
    torch_policies,
)
from repro_torch.core import faults, traffic  # noqa: E402
from repro_torch.core import torchplane as tp  # noqa: E402
from repro_torch.core.policy import TORCH_POLICIES, make_torch_policy  # noqa: E402

POLICIES = torch_policies()
SRC = Path(__file__).resolve().parents[1] / "src"

# stated parity tolerance: medians over seeds, relative error
P50_RTOL = 0.15
P99_RTOL = 0.35

FWD = dict(
    lane_params=dict(batch=8, max_batch=8, deschedule_prob=2e-3),
    n_packets=300,
    n_workers=4,
    return_times=True,
)
#: straggler + mid-run crash of worker 1 with a finite lease
FAULTED = dict(straggler=3.0, straggler_worker=0.0, crash_t=5.0, crash_worker=1.0)


def _assert_equal(a, b, ctx):
    for f in tp.LaneResult._fields:
        x, y = getattr(a, f).numpy(), getattr(b, f).numpy()
        assert x.shape == y.shape, (ctx, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: {f}")


def _sweep(policies=None, seeds=np.arange(4), **kw):
    req = SweepRequest(policies=policies, seeds=seeds, **{**FWD, **kw})
    return run_sweep(req, device="cpu")


@functools.lru_cache(maxsize=None)
def _engines(faulted: bool):
    fp = dict(FAULTED, lease=3.0) if faulted else {}
    return tuple(_sweep(engine=e, fault_params=fp) for e in ("compacted", "reference"))


# ---------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------
@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("faulted", [False, True])
def test_compacted_equals_reference_engine(faulted, name):
    compacted, reference = (s[name] for s in _engines(faulted))
    _assert_equal(compacted, reference, name)
    if not faulted:  # lossless, so the comparison is not inf == inf
        assert (compacted.items.numpy() == FWD["n_packets"]).all()
        assert (compacted.claimed_prefix.numpy() == FWD["n_packets"]).all()


@pytest.mark.parametrize("name", POLICIES)
def test_fused_call_equals_per_policy_call(name):
    fused = _engines(False)[0][name]
    single = _sweep(policies=[name])[name]
    _assert_equal(fused, single, name)


def test_tight_claim_budget_is_loud():
    # batch=1 needs one claim per packet: a budget of n/4 must leave
    # visible exactly-once violations, not quietly truncated stats
    res = _sweep(
        policies=["corec"],
        seeds=np.arange(2),
        lane_params=dict(batch=1),
        n_packets=200,
        claim_budget=50,
        chunk=16,
    )["corec"]
    assert (res.items.numpy() < 200).all()
    assert (res.claimed_popcount.numpy() < 200).all()
    assert (res.claimed_prefix.numpy() < 200).all()


@pytest.mark.parametrize("name", POLICIES)
def test_exactly_once_no_loss_own_draws(name):
    n = 300
    batches = np.array([1, 2, 8, 32, 8, 1], dtype=np.float32)
    res = _sweep(
        policies=[name],
        seeds=np.arange(6),
        lane_params=dict(batch=batches, max_batch=batches),
        n_packets=n,
    )[name]
    assert (res.items.numpy() == n).all()
    assert (res.claimed_popcount.numpy() == n).all()
    assert (res.claimed_prefix.numpy() == n).all()
    soj = res.sojourn.numpy()
    assert np.isfinite(soj).all() and (soj > 0).all()
    assert (res.batches.numpy() >= 1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reorder_metrics_match_host_reference(seed):
    rng = np.random.default_rng(seed)
    n = 400
    times = np.arange(n) + rng.normal(0.0, 5.0, size=n)
    ratio, maxd = tp.reorder_metrics(torch.tensor(times, dtype=torch.float32))
    rep = measure_reordering(list(np.argsort(times, kind="stable")))
    assert float(ratio) == pytest.approx(rep.ratio, abs=1e-6)
    assert int(maxd) == rep.max_distance


@pytest.mark.parametrize(
    "scenario,arrival,service",
    [
        ("forwarder", "bursty", None),
        ("forwarder", "diurnal", None),
        ("queueing", "poisson", "M"),
        ("queueing", "poisson", "D"),
        ("queueing", "poisson", "LN"),
    ],
)
def test_arrival_processes_and_service_kinds_run(scenario, arrival, service):
    n = 200
    traffic = dict(rate=3.2, mean_service=1.0) if scenario == "queueing" else {}
    sweep = _sweep(
        policies=["corec", "scaleout"],
        seeds=np.arange(3),
        scenario=scenario,
        arrival=arrival,
        service=service,
        traffic_params=traffic,
        n_packets=n,
    )
    for name in ("corec", "scaleout"):
        res = sweep[name]
        assert (res.claimed_popcount.numpy() == n).all()
        assert (res.claimed_prefix.numpy() == n).all()
        assert np.isfinite(res.p99.numpy()).all()
        pct = res.reorder_pct.numpy()
        assert ((pct >= 0) & (pct <= 100)).all()


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(prefix_impl="pallas"), "TPU route"),
        (dict(prefix_interpret=True), "TPU route"),
    ],
)
def test_unported_options_raise_by_name(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        _sweep(policies=["corec"], n_packets=50, **kw)


@pytest.mark.parametrize("scenario", ["serving", "tcp", "forwarder"])
def test_shards_without_a_process_group_raise(scenario):
    """``shards=2`` splits the lanes over two ranks of a process group;
    with none it raises and says how to start one (no serial fallback).
    The sharded runs themselves: ``tests/test_torch_shard.py``."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        _sweep(policies=["corec"], n_packets=50, scenario=scenario, shards=2)


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="unknown scenario"):
        _sweep(scenario="warp-drive")
    with pytest.raises(ValueError, match="unknown engine"):
        _sweep(policies=["corec"], n_packets=50, engine="warp-drive")
    with pytest.raises(ValueError, match="crash_tim"):
        _sweep(policies=["corec"], n_packets=50, fault_params=dict(crash_tim=5.0))
    with pytest.raises(ValueError, match="no-such-policy.*corec"):
        make_torch_policy("no-such-policy")


def test_default_device_is_cuda_with_no_fallback():
    req = SweepRequest(policies=["corec"], seeds=np.arange(2), n_packets=50)
    if torch.cuda.is_available():
        assert run_sweep(req)["corec"].items.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            run_sweep(req)


# ---------------------------------------------------------------------
# Against the reference package
# ---------------------------------------------------------------------
def test_policy_catalog_and_flags_match_reference():
    assert POLICIES == jax_policies()
    for name, pol in TORCH_POLICIES.items():
        ref = jp.build_policy(name)
        for flag in ("name", "shared", "uses_lock", "steals", "leases"):
            assert getattr(pol, flag) == getattr(ref, flag), (name, flag)


def test_steering_hash_and_queue_helpers_match_reference():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jp._select_rss(keys, 4))
    got = tp._select_rss(torch.from_numpy(keys.astype(np.int64)), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tp.rss_hash32(keys, 4), jp.rss_hash32(keys, 4))
    # sorted +inf-padded rows, per-lane claim pointers and claim times
    lanes, w, n = 5, 4, 30
    q_arr = np.sort(rng.random((lanes, w, n + 1)).astype(np.float32) * 10, axis=2)
    q_arr[:, :, -3:] = np.inf
    qptr = rng.integers(0, n + 1, size=(lanes, w)).astype(np.int32)
    t0 = (rng.random(lanes) * 10).astype(np.float32)
    own = rng.integers(0, w, size=lanes).astype(np.int32)
    tq, tptr = torch.from_numpy(q_arr), torch.from_numpy(qptr.astype(np.int64))
    tt0, town = torch.from_numpy(t0), torch.from_numpy(own.astype(np.int64))
    heads = jax.vmap(jp.queue_heads)(q_arr, qptr)
    np.testing.assert_array_equal(tp.queue_heads(tq, tptr).numpy(), heads)
    arrived = jax.vmap(jp.rows_arrived)(q_arr, t0)
    np.testing.assert_array_equal(tp.rows_arrived(tq, tt0).numpy(), arrived)
    q, backlog = jax.vmap(jp.steal_choice)(q_arr, qptr, own, t0)
    tq_, tback = tp.steal_choice(tq, tptr, town, tt0)
    np.testing.assert_array_equal(tq_.numpy(), q)
    np.testing.assert_array_equal(tback.numpy(), backlog)


def test_lane_grid_matches_reference():
    axes = {"batch": [1, 8], "rate": [20.0, 40.0, 50.0]}
    want, want_pts = jp.lane_grid(axes, np.arange(3))
    got, got_pts = tp.lane_grid(axes, np.arange(3))
    assert got_pts == want_pts
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@functools.lru_cache(maxsize=None)
def _distributional():
    kw = dict(
        seeds=np.arange(16),
        n_packets=2000,
        n_workers=4,
        lane_params=dict(batch=8, max_batch=8, claim_overhead=0.05),
        traffic_params=dict(rate=40.0, pkt_size=64.0),
    )
    ref = jsweep.run_sweep(jsweep.SweepRequest(**kw))
    port = run_sweep(SweepRequest(**kw), device="cpu")
    return ref, port


@pytest.mark.parametrize("name", POLICIES)
def test_distributional_parity_with_reference_sweep(name):
    ref, port = (s[name] for s in _distributional())
    j50, j99 = (float(np.median(np.asarray(getattr(ref, f)))) for f in ("p50", "p99"))
    t50, t99 = (float(np.median(getattr(port, f).numpy())) for f in ("p50", "p99"))
    assert t50 == pytest.approx(j50, rel=P50_RTOL), (name, t50, j50)
    assert t99 == pytest.approx(j99, rel=P99_RTOL), (name, t99, j99)
    assert (port.claimed_prefix.numpy() == 2000).all()


def test_fault_hash_equals_lane_engine_hash():
    """``faults.hash_u01`` (Python ints) equals ``torchplane.hash_u01``
    (int64 tensors) through float32, bit for bit, on a grid of counters."""
    seeds = [0, 1, 7, 0xA5A5A5A5, 2**31 + 5, 2**32 - 1]
    ab = [0, 1, 2, 3, 255, 1000, 65_537, 2**31 - 1, 2**32 - 1]
    grid = [(s, a, b) for s in seeds for a in ab for b in ab]
    want = np.array([faults.hash_u01(s, a, b) for s, a, b in grid], dtype=np.float32)
    s, a, b = (torch.tensor(c, dtype=torch.int64) for c in zip(*grid))
    got = tp.hash_u01(s, a, b).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_mawi_tables_equal_lane_engine():
    """The DES's MAWI packet-size mix (``traffic.py``) and the lane
    engine's copy (``torchplane.py``) are one table."""
    np.testing.assert_array_equal(
        tp._MAWI_SIZES, traffic._MAWI_SIZES.astype(np.float32)
    )
    np.testing.assert_array_equal(
        tp._MAWI_WEIGHTS, traffic._MAWI_WEIGHTS / traffic._MAWI_WEIGHTS.sum()
    )


def test_port_loads_neither_jax_nor_repro():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import numpy as np
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch.core import SweepRequest, run_sweep
        res = run_sweep(
            SweepRequest(seeds=np.arange(2), n_packets=64), device="cpu"
        )
        assert (res["corec"].claimed_prefix.numpy() == 64).all()
        tcp = run_sweep(
            SweepRequest(scenario="tcp", seeds=np.arange(2), n_packets=[12, 12],
                         t_start=[0.0, 37.0], tcp_params=dict(sack=True)),
            device="cpu",
        )
        assert all(bool(r.done.all()) for r in tcp.lanes.values())
        assert all(bool((r.claimed_prefix == r.sends).all())
                   for r in tcp.lanes.values())
        from repro_torch.config import ArchConfig
        from repro_torch.serving import EngineConfig, InferenceEngine, Request
        cfg = ArchConfig("t", "dense", n_layers=1, d_model=32, n_heads=2,
                         n_kv_heads=1, d_ff=64, vocab=64, dtype="float32")
        eng = InferenceEngine(cfg, EngineConfig(n_slots=2, max_seq=8,
                              eos_token=-1), device="cpu")
        out = eng.run([Request(rid=i, prompt=[3, 4, 5], max_new_tokens=2)
                       for i in range(2)], timeout=60)
        assert sorted(r.rid for r in out) == [0, 1] and eng.head == eng.tail
        from repro_torch import configs
        for name in ("rwkv6-3b", "zamba2-1.2b"):
            eng = InferenceEngine(configs.get_tiny(name), EngineConfig(
                n_slots=2, max_seq=12, eos_token=-1), device="cpu")
            out = eng.run([Request(rid=i, prompt=[3, 4, 5], max_new_tokens=2)
                           for i in range(2)], timeout=60)
            assert sorted(r.rid for r in out) == [0, 1] and eng.head == eng.tail
        import tempfile, torch
        from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
        from repro_torch.launch.steps import build_steps
        tiny = configs.get_tiny("qwen2-1.5b")
        bundle = build_steps(tiny, device="cpu")
        params = bundle.model.init(torch.Generator().manual_seed(0), device="cpu")
        opt = bundle.optimizer.init(params)
        toks = np.arange(16, dtype=np.int32).reshape(2, 8)
        params, opt, metrics = bundle.train_step(
            params, opt, {"tokens": toks, "labels": toks})
        assert np.isfinite(float(metrics["loss"])) and int(opt.step) == 1
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, 1, (params, opt), extra={"stream_position": 1})
            (p2, o2), extra = restore_checkpoint(d, (params, opt))
        assert extra["step"] == 1 and torch.equal(p2["embed"]["tok"],
                                                  params["embed"]["tok"])
        # the multi-device layer: rules, meshes, abstract state, the pod
        # all-reduce, "dots" remat, the serve launcher, the lane shards
        import torch.distributed as dist
        from repro_torch.distributed import run_ranks, sweep_rank
        from repro_torch.launch import serve
        from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
        from repro_torch.optim import compressed_pod_allreduce, error_feedback_init
        mesh = make_production_mesh(multi_pod=True)
        sb = build_steps(configs.get("grok-1-314b"), device="cpu", mesh=mesh)
        ap, _ = sb.abstract_state()
        assert ap["embed"]["tok"].device.type == "meta"
        assert sb.param_shardings["embed"]["tok"].spec == ("model", "data")
        dist.destroy_process_group()
        make_local_mesh(device="cpu")
        g = {"w": torch.randn(9)}
        red, err = compressed_pod_allreduce(g, error_feedback_init(g))
        assert torch.allclose(red["w"] + err["w"], g["w"], atol=1e-6)
        dist.destroy_process_group()
        dots = build_steps(tiny.replace(remat_policy="dots"), device="cpu")
        _, _, m2 = dots.train_step(dots.model.init(torch.Generator().manual_seed(0),
                                                   device="cpu"), dots.optimizer.init(
            params), {"tokens": toks, "labels": toks})
        assert np.isfinite(float(m2["loss"]))
        assert len(serve.main(["--device", "cpu", "--requests", "2",
                               "--new-tokens", "2"])) == 2
        req = SweepRequest(policies=["corec"], seeds=np.arange(3), n_packets=64)
        ranks = run_ranks(sweep_rank, 2, req, "cpu", timeout=120)
        base = run_sweep(req, device="cpu")["corec"]
        for r in ranks:
            assert (r["lanes"]["corec"]["p99"] == base.p99.numpy()).all()
        # the DES and threaded planes, and the protocol model
        from repro_torch.core import (
            ForwarderConfig, Item, WorkerPool, make_queue, simulate_forwarder,
            udp_stream,
        )
        from repro_torch.core.protocol_sim import (
            SimState, consumer_packed, producer_packed, run_schedule,
        )
        pkts = udp_stream(200, rate_pps=45.0, seed=3, n_flows=16)
        done = simulate_forwarder(pkts, ForwarderConfig(policy="hybrid"))
        assert sorted(p.seqno for _, p in done) == list(range(200))
        pool = WorkerPool(make_queue("corec", 2, 64), 2, lambda it: None)
        res = pool.run_open_loop([Item(seqno=i) for i in range(100)])
        assert sorted(it.seqno for it in res.items) == list(range(100))
        st = SimState(64)
        actors = [producer_packed(st, list(range(20)), burst=4)] + [
            consumer_packed(st, w, max_batch=4, rounds=500) for w in range(2)]
        run_schedule(st, actors, [i % 3 for i in range(3000)])
        assert sorted(st.delivered) == list(range(20))
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "repro")
        )
        assert not bad, bad
        print("clean")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
