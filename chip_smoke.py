#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the root of a checkout, on a host with a CUDA device)::

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught, no CPU fallback):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (five
   sources, one ``nvcc`` each, all at once);
3. the packed done-prefix kernel against its plain PyTorch version on
   the card (exact equality), plus its time, the plain version's and
   the bound;
3b. the model path's kernels (RMSNorm, flash attention, decode
   attention, batched done-prefix) against their plain versions on the
   card over the shape sweeps of ``tests/test_kernels.py`` and
   qwen2-1.5b's shapes (fp32 ``2e-5``, bf16 ``2e-2``, done-prefix
   exact), then each one's time at qwen2-1.5b's shape beside the plain
   version's, the bound and one PyTorch library call's;
4. the main path at the repo's full sweep size -- the forwarder grid
   of ``benchmarks/jax_sweep.py`` (batch x rate x deschedule_prob x 14
   seeds = 1,008 lanes per policy, all five policies fused, 2,000
   packets per lane) through ``repro_torch.core.run_sweep``: every lane
   exactly-once, and the launch count of every kernel on the path;
5. smaller queueing (M service) and bursty forwarder sweeps;
6. compacted engine == per-claim reference engine on the card, two
   runs of one request identical, and the card's results against the
   port's CPU run of the same small request;
7. the serving path at full width: qwen2-1.5b (28 layers, d_model
   1,536, 12 query heads over 2 KV heads, random weights from a seed,
   bf16 over fp32 masters) behind ``InferenceEngine`` (16 decode slots
   in 4 lanes, 512 positions, 2 prefill workers), 32 requests of 64-384
   prompt tokens and 32 new tokens in one burst, after an untimed
   warm-up run, once under COREC and once under RSS: every request
   answered, ``head == tail == 32``, the same tokens under both
   policies, and the launch count of every kernel on the path;
7b. one decode step and one prefill of the same model: host time,
   kernel time from a ``torch.profiler`` window, the device's idle
   share and the top kernels;
8. one 300-token prompt through ``prefill`` and 4 teacher-forced
   ``decode_step``s in fp32, with the kernels and with the plain
   versions: on phase 7's weights the difference is printed beside a
   perturbation control (the reference initialiser makes the stack
   chaotic); with the weights drawn at qwen2-1.5b's published
   initializer range the logits must agree within ``1e-3`` with the
   same argmax at every step (the bf16 difference is printed, not
   asserted).

Prints one JSON line of per-kernel numbers, then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core import SweepRequest, lane_grid, run_sweep  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.doneprefix import (  # noqa: E402
    done_prefix_batch_cuda,
    done_prefix_packed_cuda,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_cuda  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.spec import init_params, spec_map  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine, Request  # noqa: E402

#: the forwarder grid of benchmarks/jax_sweep.py: 72 configs x 14 seeds
AXES = {
    "batch": [1, 2, 4, 8, 16, 32],
    "rate": [20.0, 30.0, 40.0, 50.0],
    "deschedule_prob": [0.0, 5e-4, 5e-3],
}
N_SEEDS = 14
N_PACKETS = 2000
N_WORKERS = 4
MAX_BATCH = 64
LANE_KNOBS = ("batch", "deschedule_prob")
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor fp32 op/s,
#: dense bf16 tensor-core op/s
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: the serving cell: qwen2-1.5b behind the decode-slot engine
MODEL = "qwen2-1.5b"
SEED = 0
#: qwen2-1.5b's published initializer_range (its Hugging Face config)
INIT_RANGE = 0.02
ENGINE = dict(
    n_slots=16, n_lanes=4, max_seq=512, n_workers=2, claim_batch=4, eos_token=-1
)
N_REQUESTS = 32
PROMPT_LENS = (64, 384)
NEW_TOKENS = 32
#: the kernels of the serving path, by wrapper
MODEL_KERNELS = {
    "flash_attention": flash_attention_cuda,
    "decode_attention": decode_attention_cuda,
    "rmsnorm": rmsnorm_cuda,
    "done_prefix_batch": done_prefix_batch_cuda,
}


def _grid(axes, n_seeds):
    arrays, _ = lane_grid(axes, np.arange(n_seeds))
    seeds = arrays.pop("__seeds__")
    lane = {k: v for k, v in arrays.items() if k in LANE_KNOBS}
    traffic = {k: v for k, v in arrays.items() if k not in LANE_KNOBS}
    return seeds, lane, traffic


def _bitmaps(n_bits: int, rows: int, seed: int, device):
    """Rows whose first zero bit sits anywhere (all-ones rows included),
    garbage bits past it and in the padding, and limits at, below the
    run and 0."""
    rng = np.random.default_rng(seed)
    nw = -(-n_bits // 32)
    words = rng.integers(0, 2**32, size=(rows, nw), dtype=np.uint64)
    z = rng.integers(0, nw * 32 + 1, size=rows)  # first zero bit
    z[0] = nw * 32  # all ones
    if rows > 1:
        z[1] = 0
        words[1] = 0  # all zeros
    if rows > 2:
        z[2] = n_bits  # ones up to n_bits, garbage padding after
    j = np.arange(nw)[None, :]
    words = np.where(j < (z // 32)[:, None], 0xFFFFFFFF, words)
    at = j == (z // 32)[:, None]
    bit = (z % 32)[:, None].astype(np.uint64)
    low = (np.uint64(1) << bit) - np.uint64(1)
    words = np.where(at, (words | low) & ~(np.uint64(1) << bit), words)
    words = words.astype(np.uint32).view(np.int32)
    limits = np.full(rows, n_bits, dtype=np.int32)
    limits[1::3] = np.minimum(z[1::3], n_bits) // 2  # below the run
    limits[4::5] = 0
    w = torch.from_numpy(words).to(device)
    return w, torch.from_numpy(limits).to(device)


def _median_ms(fn, reps: int = 200) -> tuple:
    """(device ms, host-paced ms): medians of per-call CUDA-event times.

    Device: a sleep kernel holds the stream while every (event, call,
    event) triple is enqueued, so each pair brackets the device work
    alone.  Host-paced: one call at a time, synchronised, so the pair
    also holds the host's enqueue latency (ctypes, checks, allocation).
    """
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    ev = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps)
    ]
    torch.cuda._sleep(200_000_000)  # ~0.1 s at H100 clocks: covers enqueueing
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    device = float(np.median([a.elapsed_time(b) for a, b in ev]))
    paced = []
    for a, b in ev:
        a.record()
        fn()
        b.record()
        b.synchronize()
        paced.append(a.elapsed_time(b))
    return device, float(np.median(paced))


def phase_kernel(dev) -> dict:
    max_err = 0
    for n_bits in (1, 31, 32, 33, 1000, 2000, 65536):
        for rows in (1, 7, 5040):
            w, lim = _bitmaps(n_bits, rows, seed=n_bits * 7 + rows, device=dev)
            got = done_prefix_packed_cuda(w, lim, n_bits)
            want = kref.done_prefix_packed_ref(w, lim, n_bits)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(
                    f"done_prefix_packed: kernel != plain at n_bits={n_bits}, "
                    f"rows={rows} (max abs err {err})"
                )
            max_err = max(max_err, err)
    print("phase 3: done_prefix_packed == plain on 21 cases (exact)")
    # timing at the main path's shape: one row per lane, 2000 bits
    rows, n_bits = 5 * 72 * N_SEEDS, N_PACKETS
    w, lim = _bitmaps(n_bits, rows, seed=1, device=dev)
    ms, paced_ms = _median_ms(lambda: done_prefix_packed_cuda(w, lim, n_bits))
    plain_ms, plain_paced = _median_ms(
        lambda: kref.done_prefix_packed_ref(w, lim, n_bits)
    )
    nw = w.shape[1]
    moved = rows * nw * 4 + rows * 4 + rows * 4  # words + limit in, out
    ops = rows * nw * 3  # not, find-first-set, min per word
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    print(
        f"phase 3: [{rows}, {nw}] words, n_bits={n_bits}: device median kernel "
        f"{ms:.5f} ms, plain {plain_ms:.5f} ms; host-paced kernel "
        f"{paced_ms:.5f} ms, plain {plain_paced:.5f} ms; bound "
        f"{max(bytes_ms, ops_ms):.6f} ms ({moved} bytes)"
    )
    return dict(
        name="done_prefix_packed",
        route="cuda",
        source="src/repro_torch/kernels/csrc/done_prefix.cu",
        replaces="src/repro/kernels/doneprefix.py:106",
        launches=None,
        max_abs_err=float(max_err),
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None,
    )


def _exactly_once(sweep, n: int, what: str) -> None:
    for name, res in sweep.lanes.items():
        for f in ("claimed_popcount", "claimed_prefix", "items"):
            v = getattr(res, f)
            if not bool((v == n).all()):
                raise AssertionError(f"{what}/{name}: {f} != {n} on some lane")
        for f in ("p50", "p99"):
            if not bool(torch.isfinite(getattr(res, f)).all()):
                raise AssertionError(f"{what}/{name}: non-finite {f}")


def phase_main(dev) -> int:
    seeds, lane, traffic = _grid(AXES, N_SEEDS)
    req = SweepRequest(
        scenario="forwarder",
        seeds=seeds,
        arrival="poisson",
        lane_params=lane,
        traffic_params=traffic,
        n_packets=N_PACKETS,
        n_workers=N_WORKERS,
        max_batch=MAX_BATCH,
    )
    timings: dict = {}
    done_prefix_packed_cuda.launches = 0
    sweep = run_sweep(req, timings=timings, device=dev)
    launches = done_prefix_packed_cuda.launches
    lanes = sum(int(r.items.shape[0]) for r in sweep.lanes.values())
    if lanes != 5 * 72 * N_SEEDS:
        raise AssertionError(f"main path ran {lanes} lanes")
    if launches != 1:
        raise AssertionError(f"done_prefix_packed launched {launches}x, want 1")
    _exactly_once(sweep, N_PACKETS, "main")
    run_s, compile_s = timings["run_s"], timings["compile_s"]
    print(
        f"phase 4: {lanes} lanes x {N_PACKETS} packets, 5 policies fused: "
        f"compile_s={compile_s:.4f} run_s={run_s:.4f} "
        f"lane-points/s={lanes / run_s:.2f}; exactly-once on every lane; "
        f"done_prefix_packed launches={launches}"
    )
    for name, res in sweep.lanes.items():
        p50, p99, reorder = (
            float(getattr(res, f).median()) for f in ("p50", "p99", "reorder_pct")
        )
        print(
            f"phase 4: {name:15s} p50 {p50:.6f}  p99 {p99:.6f}  "
            f"reorder% {reorder:.4f}"
        )
    return launches


def phase_other_traffic(dev) -> None:
    q_axes = {
        "batch": AXES["batch"],
        "rate": [2.0, 2.8, 3.2, 3.6],
        "deschedule_prob": AXES["deschedule_prob"],
    }
    runs = [
        ("queueing/M", q_axes, dict(scenario="queueing", service="M")),
        ("forwarder/bursty", AXES, dict(scenario="forwarder", arrival="bursty")),
    ]
    for what, axes, kw in runs:
        seeds, lane, traffic = _grid(axes, 1)
        req = SweepRequest(
            seeds=seeds,
            lane_params=lane,
            traffic_params=traffic,
            n_packets=N_PACKETS,
            n_workers=N_WORKERS,
            max_batch=MAX_BATCH,
            **kw,
        )
        timings: dict = {}
        sweep = run_sweep(req, timings=timings, device=dev)
        _exactly_once(sweep, N_PACKETS, what)
        p99 = {n: round(float(r.p99.median()), 6) for n, r in sweep.lanes.items()}
        run_s = timings["run_s"]
        print(
            f"phase 5: {what}: {5 * len(seeds)} lanes exactly-once, "
            f"run_s={run_s:.4f}, p99 medians {p99}"
        )


def _same(a, b) -> bool:
    return all(
        torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()) for f in a._fields
    )


def phase_agreement(dev) -> None:
    batches = np.repeat([1, 2, 4, 8, 16, 32], 4).astype(np.float32)
    kw = dict(
        seeds=np.tile(np.arange(4), 6),
        lane_params=dict(batch=batches, deschedule_prob=2e-3),
        n_packets=300,
        return_times=True,
    )
    faults = dict(crash_t=5.0, crash_worker=1.0, lease=3.0, straggler=3.0)
    for label, fp in (("fault-free", {}), ("faulted", faults)):
        com = run_sweep(SweepRequest(fault_params=fp, **kw), device=dev)
        ref = run_sweep(
            SweepRequest(fault_params=fp, engine="reference", **kw), device=dev
        )
        again = run_sweep(SweepRequest(fault_params=fp, **kw), device=dev)
        for name in com.policies:
            if not _same(com[name], ref[name]):
                raise AssertionError(f"{label}/{name}: compacted != reference")
            if not _same(com[name], again[name]):
                raise AssertionError(f"{label}/{name}: two runs differ")
    print("phase 6: compacted == reference engine, bit for bit, and reruns equal")
    small = SweepRequest(seeds=np.arange(16), n_packets=1000)
    gpu = run_sweep(small, device=dev)
    cpu = run_sweep(small, device="cpu")
    for name in gpu.policies:
        for f in ("p50", "p99"):
            g = float(getattr(gpu[name], f).median())
            c = float(getattr(cpu[name], f).median())
            if not abs(g - c) <= 0.05 * abs(c):
                raise AssertionError(f"{name}: {f} median {g} on card, {c} on CPU")
    print("phase 6: card medians within 5% of the port's CPU run (same draws)")


FP32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _tol(dtype):
    return BF16_TOL if dtype == torch.bfloat16 else FP32_TOL


def _close(what: str, got, want, tol) -> float:
    """Max abs error of ``got`` against ``want``; raises past ``tol``."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, **tol):
        raise AssertionError(f"{what}: kernel != plain (max abs err {err})")
    return err


def _bound(moved: int, ops_n: float, peak: float) -> tuple:
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_n / peak * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, moved


def _entry(name, src, replaces, max_err, timed, bound) -> dict:
    ms, plain_ms, library_ms = timed
    bound_ms, bound_by, _ = bound
    return dict(
        name=name,
        route="cuda",
        source=f"src/repro_torch/kernels/csrc/{src}",
        replaces=replaces,
        launches=None,
        max_abs_err=float(max_err),
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=library_ms,
    )


def _time3(what: str, kernel, plain, library) -> tuple:
    """Device medians (ms) of the kernel, the plain version and the
    library call on the same inputs; prints them with the host-paced
    kernel time."""
    ms, paced = _median_ms(kernel)
    plain_ms, _ = _median_ms(plain)
    lib_ms = _median_ms(library)[0] if library is not None else None
    lib = "none" if lib_ms is None else f"{lib_ms:.5f} ms"
    print(
        f"phase 3b: {what}: device median kernel {ms:.5f} ms (host-paced "
        f"{paced:.5f} ms), plain {plain_ms:.5f} ms, library {lib}"
    )
    return ms, plain_ms, lib_ms


def phase_rmsnorm(dev, g) -> dict:
    err, n = 0.0, 0
    for dt in (torch.float32, torch.bfloat16):
        for rows in (1, 7, 16, 512):
            for d in (64, 96, 1536):
                for wdt in (torch.float32, torch.bfloat16):
                    x = torch.randn(rows, d, generator=g, device=dev).to(dt)
                    w = torch.randn(d, generator=g, device=dev).to(wdt)
                    got = rmsnorm_cuda(x, w, eps=1e-6)
                    want = kref.rmsnorm_ref(x, w, eps=1e-6)
                    what = f"rmsnorm {dt} {rows}x{d} w {wdt}"
                    err = max(err, _close(what, got, want, _tol(dt)))
                    n += 1
    print(f"phase 3b: rmsnorm == plain on {n} cases (max abs err {err})")
    # timed at a decode step of the serving cell: 16 slots x d_model, bf16
    # activations, the fp32 master weight (decode passes it as stored)
    d = configs.get(MODEL).d_model
    x = torch.randn(ENGINE["n_slots"], d, generator=g, device=dev).bfloat16()
    w = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    w16 = w.bfloat16()  # F.rms_norm fuses only with the weight in x's dtype
    timed = _time3(
        f"rmsnorm [{x.shape[0]}, {d}] bf16, fp32 weight",
        lambda: rmsnorm_cuda(x, w, eps=1e-6),
        lambda: kref.rmsnorm_ref(x, w, eps=1e-6),
        lambda: F.rms_norm(x, (d,), w16, 1e-6),
    )
    moved = 2 * x.numel() * 2 + d * 4  # x read, y written, weight read
    bound = _bound(moved, 4 * x.numel(), SCALAR_OPS_PER_S)
    return _entry(
        "rmsnorm",
        "rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:23",
        err,
        timed,
        bound,
    )


FLASH_CASES = [  # tests/test_kernels.py:41-50, then qwen2-1.5b's prefill
    (1, 32, 32, 4, 4, 32, True, 0),
    (2, 40, 40, 8, 2, 64, True, 0),
    (1, 16, 48, 4, 1, 32, False, 0),
    (1, 8, 72, 4, 2, 32, True, 64),
]


def phase_flash(dev, g) -> dict:
    cfg = configs.get(MODEL)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cases = [(c, dt) for c in FLASH_CASES for dt in (torch.float32, torch.bfloat16)]
    cases += [
        ((1, s, s, H, Hkv, D, True, 0), dt)
        for s in (200, 384)
        for dt in (torch.float32, torch.bfloat16)
    ]
    err = 0.0
    for (B, Sq, Sk, h, hkv, d, causal, qo), dt in cases:
        q = torch.randn(B, Sq, h, d, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, hkv, d, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, hkv, d, generator=g, device=dev).to(dt)
        got = flash_attention_cuda(q, k, v, causal=causal, q_offset=qo)
        want = kref.attention_ref(q, k, v, causal=causal, q_offset=qo)
        what = f"flash {dt} {(B, Sq, Sk, h, hkv, d, causal, qo)}"
        err = max(err, _close(what, got, want, _tol(dt)))
    print(f"phase 3b: flash_attention == plain on {len(cases)} cases (max err {err})")
    S = 384
    q = torch.randn(1, S, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(1, S, Hkv, D, generator=g, device=dev).bfloat16()
    v = torch.randn(1, S, Hkv, D, generator=g, device=dev).bfloat16()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    timed = _time3(
        f"flash_attention B=1 Sq=Sk={S} H={H} Hkv={Hkv} D={D} causal bf16",
        lambda: flash_attention_cuda(q, k, v, causal=True),
        lambda: kref.attention_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True
        ),
    )
    moved = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v in, out
    pairs = H * S * (S + 1) // 2  # admissible (query, key) pairs, causal
    bound = _bound(moved, 4 * D * pairs, BF16_OPS_PER_S)
    return _entry(
        "flash_attention",
        "flash_attention.cu",
        "src/repro/kernels/flash_attention.py:35",
        err,
        timed,
        bound,
    )


DECODE_CASES = [(2, 4, 4, 32, 40), (3, 8, 2, 64, 100), (1, 4, 1, 32, 513)]


def phase_decode(dev, g) -> dict:
    cfg = configs.get(MODEL)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S = ENGINE["n_slots"], ENGINE["max_seq"]
    cases = [c + (dt,) for c in DECODE_CASES for dt in (torch.float32, torch.bfloat16)]
    cases += [(B, H, Hkv, D, S, dt) for dt in (torch.float32, torch.bfloat16)]
    err = 0.0
    for b, h, hkv, d, s, dt in cases:
        q = torch.randn(b, h, d, generator=g, device=dev).to(dt)
        k = torch.randn(b, s, hkv, d, generator=g, device=dev).to(dt)
        v = torch.randn(b, s, hkv, d, generator=g, device=dev).to(dt)
        lens = torch.randint(1, s + 1, (b,), generator=g, device=dev, dtype=torch.int32)
        if b == B:  # the edges: one key, odd, S - 1, S and past S
            edges = torch.tensor([1, 37, S - 1, S, S + 88], device=dev)[:b]
            lens[: len(edges)] = edges
        got = decode_attention_cuda(q, k, v, lens)
        want = kref.decode_attention_ref(q, k, v, lens)
        err = max(err, _close(f"decode {dt} {(b, h, hkv, d, s)}", got, want, _tol(dt)))
    print(f"phase 3b: decode_attention == plain on {len(cases)} cases (max err {err})")
    # timed with every slot's cache full: the whole [16, 512] cache is valid
    q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).bfloat16()
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    q4 = q[:, :, None, :]
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(S, device=dev)[None] < lens[:, None])[:, None, None, :]
    timed = _time3(
        f"decode_attention B={B} S={S} H={H} Hkv={Hkv} D={D} full caches bf16",
        lambda: decode_attention_cuda(q, k, v, lens),
        lambda: kref.decode_attention_ref(q, k, v, lens),
        lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True
        ),
    )
    valid = int(lens.clamp(0, S).sum())
    moved = 2 * 2 * q.numel() + 2 * valid * Hkv * D * 2 + B * 4
    bound = _bound(moved, 4 * D * H * valid, BF16_OPS_PER_S)
    return _entry(
        "decode_attention",
        "decode_attention.cu",
        "src/repro/kernels/decode_attention.py:35",
        err,
        timed,
        bound,
    )


def phase_done_prefix_batch(dev, g) -> dict:
    n = 64  # tests/test_kernels.py:310-330: all done, none, wrap, clamp
    done = torch.zeros(4, n, dtype=torch.bool, device=dev)
    done[0] = True
    done[2, n - 1] = done[2, 0] = True
    done[3, :10] = True
    st = torch.tensor([3, 0, n - 1, 0], dtype=torch.int32, device=dev)
    lim = torch.tensor([n, n, n, 4], dtype=torch.int32, device=dev)
    got = done_prefix_batch_cuda(done, st, lim)
    if got.tolist() != [n, 0, 2, 4]:
        raise AssertionError(f"done_prefix_batch edge rows: {got.tolist()}")
    cases = 1
    for R in (1, 4, 64):
        for n in (4, 33, 512):
            done = torch.rand(R, n, generator=g, device=dev) < 0.8
            done[0] = True  # all done
            kw = dict(generator=g, device=dev, dtype=torch.int32)
            st = torch.randint(0, n, (R,), **kw)
            lim = torch.randint(0, n + 1, (R,), **kw)
            st[0], lim[0] = n - 1, n  # start at n - 1, full ring
            if R > 1:
                lim[1] = 0
            got = done_prefix_batch_cuda(done, st, lim)
            want = kref.done_prefix_batch_ref(done, st, lim)
            if not torch.equal(got, want):
                raise AssertionError(f"done_prefix_batch: kernel != plain at {R}x{n}")
            cases += 1
    print(f"phase 3b: done_prefix_batch == plain on {cases} cases (exact)")
    R, n = ENGINE["n_lanes"], ENGINE["n_slots"] // ENGINE["n_lanes"]
    done = torch.rand(R, n, generator=g, device=dev) < 0.5
    st = torch.randint(0, n, (R,), generator=g, device=dev, dtype=torch.int32)
    lim = torch.full((R,), n, dtype=torch.int32, device=dev)
    timed = _time3(
        f"done_prefix_batch [{R}, {n}] rings",
        lambda: done_prefix_batch_cuda(done, st, lim),
        lambda: kref.done_prefix_batch_ref(done, st, lim),
        None,
    )
    bound = _bound(R * n + 3 * R * 4, 3 * R * n, SCALAR_OPS_PER_S)
    return _entry(
        "done_prefix_batch",
        "done_prefix_batch.cu",
        "src/repro/kernels/doneprefix.py:58",
        0,
        timed,
        bound,
    )


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def phase_serving(dev) -> dict:
    """Phase 7: the slice's main path at full width.  Returns the launch
    count of each model-path kernel over both policies' runs, and the
    fp32 master weights for phase 8."""
    cfg = configs.get(MODEL)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = build_model(cfg).init(generator=gen, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    prompts = [list(map(int, rng.integers(0, cfg.vocab, int(n)))) for n in lens]
    sessions = rng.integers(0, 8, N_REQUESTS)
    print(
        f"phase 7: {MODEL}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_padded()}, {n_params} params (fp32 masters, bf16 compute); "
        f"{N_REQUESTS} requests, prompts {int(lens.min())}-{int(lens.max())} "
        f"tokens, {NEW_TOKENS} new tokens; engine {ENGINE}"
    )
    # warm-up, untimed and uncounted: the first engine in a process pays
    # for cuBLAS handles, allocator growth and first-shape heuristics, which
    # would otherwise fall on whichever policy runs first
    warm = InferenceEngine(cfg, EngineConfig(**ENGINE), params=params, device=dev)
    warm.run(
        [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)],
        timeout=600,
    )
    del warm
    tokens, launches = {}, dict.fromkeys(MODEL_KERNELS, 0)
    for policy in ("corec", "rss"):
        eng = InferenceEngine(
            cfg, EngineConfig(policy=policy, **ENGINE), params=params, device=dev
        )
        reqs = [
            Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS, session=int(s))
            for i, (p, s) in enumerate(zip(prompts, sessions))
        ]
        torch.cuda.synchronize()
        for fn in MODEL_KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = eng.run(reqs, timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: fn.launches for name, fn in MODEL_KERNELS.items()}
        for name in launches:
            launches[name] += got[name]
        tokens[policy] = {r.rid: r.tokens for r in res}
        if sorted(tokens[policy]) != list(range(N_REQUESTS)):
            raise AssertionError(f"{policy}: answered {sorted(tokens[policy])}")
        if any(len(t) != NEW_TOKENS + 1 for t in tokens[policy].values()):
            raise AssertionError(f"{policy}: a request got the wrong token count")
        if not eng.head == eng.tail == N_REQUESTS:
            raise AssertionError(f"{policy}: head {eng.head} tail {eng.tail}")
        if sum(eng.release_events) != N_REQUESTS:
            raise AssertionError(f"{policy}: released {sum(eng.release_events)}")
        L, steps, pre = cfg.n_layers, eng.decode_steps, eng.prefills
        want = {
            "flash_attention": L * pre,
            "decode_attention": L * steps,
            "rmsnorm": (2 * L + 1) * (pre + steps),
        }
        for name, n in want.items():
            if got[name] != n:
                raise AssertionError(f"{policy}: {name} ran {got[name]}x, want {n}")
        if got["done_prefix_batch"] < 1:
            raise AssertionError(f"{policy}: done_prefix_batch never launched")
        ttft = [r.ttft for r in res]
        lat = [r.latency for r in res]
        gen_tokens = sum(len(r.tokens) for r in res)
        print(
            f"phase 7: {policy}: wall {wall:.4f} s, prefills {pre}, decode steps "
            f"{steps}, decode steps/s {steps / wall:.3f}, generated tokens/s "
            f"{gen_tokens / wall:.3f}, TTFT p50 {_pct(ttft, 50):.4f} s p99 "
            f"{_pct(ttft, 99):.4f} s, latency p50 {_pct(lat, 50):.4f} s p99 "
            f"{_pct(lat, 99):.4f} s, release runs {len(eng.release_events)}; "
            f"launches {got}"
        )
        del eng
    if tokens["corec"] != tokens["rss"]:
        diff = [r for r in tokens["corec"] if tokens["corec"][r] != tokens["rss"][r]]
        raise AssertionError(f"tokens differ between policies for rids {diff}")
    print(
        f"phase 7: all {N_REQUESTS} requests answered with {NEW_TOKENS + 1} tokens "
        f"under both policies, identical tokens, head == tail == {N_REQUESTS}; "
        f"launches over both runs {launches}"
    )
    return launches, params


def _device_us(prof) -> tuple:
    """Total kernel time (us) of a profiler window, and the top kernels."""
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        kernels.append((float(t), e.count, e.key))
    kernels.sort(reverse=True)
    return sum(k[0] for k in kernels), kernels


def phase_breakdown(dev, params) -> None:
    """Phase 7b: where one decode step (every slot at the longest prompt's
    length) and one prefill of the longest prompt spend their time: host
    time per call (synchronised, unprofiled, median of 10), kernel time
    per call from a torch.profiler window of 5 calls, and the device's
    idle share between them."""
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get(MODEL)
    model = build_model(cfg)
    p = model.prepare(params)
    B, S = ENGINE["n_slots"], ENGINE["max_seq"]
    n = min(PROMPT_LENS[1], S - 1)
    rng = np.random.default_rng(SEED + 2)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, n)), device=dev)
    tok = torch.tensor(rng.integers(0, cfg.vocab, (B, 1)), device=dev)
    with torch.inference_mode():
        cache = model.init_cache(B, S, dev)
        cache["lengths"].fill_(n)

    def step():  # the cache keeps its lengths: every call writes row n
        model.decode_step(p, cache, tok)

    def prefill():
        model.prefill(p, {"tokens": prompt}, max_seq=S)

    calls = (
        (f"decode step [{B} slots, {n} positions]", step),
        (f"prefill [1, {n}]", prefill),
    )
    for what, fn in calls:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t0)
        host_ms = float(np.median(host)) * 1e3
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        dev_us, kernels = _device_us(prof)
        dev_ms = dev_us / 5 / 1e3
        if dev_ms > 0:
            idle = f"{1 - dev_ms / host_ms:.4f}"
            shown = ", ".join(
                f"{k[2][:48]} x{k[1] // 5} {k[0] / 5:.1f} us" for k in kernels[:6]
            )
        else:
            idle, shown = "not measured (the profiler saw no kernel)", ""
        print(
            f"phase 7b: {what}: host {host_ms:.4f} ms/call, kernels "
            f"{dev_ms:.4f} ms/call, {len(kernels)} kernel names, idle share "
            f"{idle}; top kernels per call: {shown}"
        )


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _teacher_forced(cfg, params, prompt, steps):
    model = build_model(cfg)
    p = model.prepare(params)
    cache, logits = model.prefill(p, {"tokens": prompt}, max_seq=prompt.shape[1] + 8)
    out = [logits.float()]
    for tok in steps:
        cache, logits = model.decode_step(p, cache, tok)
        out.append(logits.float())
    return out


def _max_diff(xs, ys) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(xs, ys))


def _same_argmax(xs, ys) -> int:
    return sum(bool(torch.equal(a.argmax(-1), b.argmax(-1))) for a, b in zip(xs, ys))


def phase_model_parity(dev, params) -> None:
    """Phase 8: the kernels against the plain versions through the whole
    model at full width: a 300-token prefill and 4 teacher-forced decode
    steps, fp32 matmuls in full fp32.

    With phase 7's weights (the reference's initialiser, whose fan-in for
    the 3-D attention weights is the head count, so scores have a
    standard deviation near 300 and attention is all but a hard max) the
    stack is chaotic: a relative perturbation of 2**-22 in the token
    table alone moves the logits by O(1) on the plain route.  Both
    differences are printed.  The 1e-3 assertion is made on the same
    architecture with every normal-initialised weight drawn at
    qwen2-1.5b's published ``initializer_range`` (0.02), where rounding
    differences stay rounding differences."""
    cfg = configs.get(MODEL)
    rng = np.random.default_rng(SEED + 1)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, 300)), device=dev)
    steps = [
        torch.tensor(rng.integers(0, cfg.vocab, (1, 1)), device=dev) for _ in range(4)
    ]
    f32 = cfg.replace(dtype="float32")
    plain32 = f32.replace(attention_impl="xla")

    def run(c, p):
        return _teacher_forced(c, p, prompt, steps)

    # phase 7's weights: reported, with the perturbation control
    base = run(plain32, params)
    kern_diff = _max_diff(run(f32, params), base)
    tok = params["embed"]["tok"] * (1 + 2**-22)
    nudged = dict(params, embed=dict(params["embed"], tok=tok))
    ctrl_diff = _max_diff(run(plain32, nudged), base)
    del tok, nudged
    print(
        f"phase 8: {MODEL} fp32, phase 7's weights (reference initialiser): "
        f"kernels vs plain max abs logit diff {kern_diff:.3e}; plain vs plain "
        f"with the token table scaled by 1 + 2**-22: {ctrl_diff:.3e} "
        "(reported, not asserted: the stack is chaotic at these weights)"
    )
    # published initializer_range: asserted
    specs = spec_map(
        lambda s: dataclasses.replace(s, scale=INIT_RANGE) if s.init == "normal" else s,
        build_model(cfg).param_specs(),
    )
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    wparams = init_params(specs, gen, dev)
    kern, plain = run(f32, wparams), run(plain32, wparams)
    for i, (a, b) in enumerate(zip(kern, plain)):
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            err = float((a - b).abs().max())
            raise AssertionError(f"phase 8: fp32 logits differ at step {i}: {err}")
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            raise AssertionError(f"phase 8: fp32 argmax differs at step {i}")
    err = _max_diff(kern, plain)
    kern16 = run(cfg, wparams)
    plain16 = run(cfg.replace(attention_impl="xla"), wparams)
    print(
        f"phase 8: {MODEL} fp32, weights at initializer_range {INIT_RANGE}: "
        f"kernels vs plain max abs logit diff {err:.3e} (<= 1e-3 asserted), "
        f"argmax equal at all 5 steps; bf16: max abs logit diff "
        f"{_max_diff(kern16, plain16):.3e}, argmax equal at "
        f"{_same_argmax(kern16, plain16)}/5 steps (reported, not asserted)"
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(smi.splitlines()[0])
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}"
    )
    # fp32 matmuls in full fp32 (phase 8's 1e-3 holds kernels, not TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    built_s = time.perf_counter() - t0
    print(f"phase 2: built {sorted(_build.SOURCES)} in {built_s:.2f} s")
    for name in sorted(_build.SOURCES):
        print(f"phase 2: {name}: {_build.build_log(name).strip()}")
    kernel = phase_kernel(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    model_kernels = [
        phase_done_prefix_batch(dev, g),
        phase_flash(dev, g),
        phase_decode(dev, g),
        phase_rmsnorm(dev, g),
    ]
    kernel["launches"] = phase_main(dev)
    phase_other_traffic(dev)
    phase_agreement(dev)
    launches, params = phase_serving(dev)
    for k in model_kernels:
        k["launches"] = launches[k["name"]]
    phase_breakdown(dev, params)
    phase_model_parity(dev, params)
    print(json.dumps({"kernels": [kernel, *model_kernels]}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
