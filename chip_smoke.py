#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the root of a checkout, on a host with a CUDA device)::

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught, no CPU fallback):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version on the card (exact
   equality), plus its time, the plain version's and the bound;
4. the main path at the repo's full sweep size -- the forwarder grid
   of ``benchmarks/jax_sweep.py`` (batch x rate x deschedule_prob x 14
   seeds = 1,008 lanes per policy, all five policies fused, 2,000
   packets per lane) through ``repro_torch.core.run_sweep``: every lane
   exactly-once, and the launch count of every kernel on the path;
5. smaller queueing (M service) and bursty forwarder sweeps;
6. compacted engine == per-claim reference engine on the card, two
   runs of one request identical, and the card's results against the
   port's CPU run of the same small request.

Prints one JSON line of per-kernel numbers, then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import SweepRequest, lane_grid, run_sweep  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.doneprefix import done_prefix_packed_cuda  # noqa: E402

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
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor fp32 op/s
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


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
    t0 = time.perf_counter()
    _build.build()
    built_s = time.perf_counter() - t0
    print(f"phase 2: built {sorted(_build.SOURCES)} in {built_s:.2f} s")
    for name in sorted(_build.SOURCES):
        print(f"phase 2: {name}: {_build.build_log(name).strip()}")
    kernel = phase_kernel(dev)
    kernel["launches"] = phase_main(dev)
    phase_other_traffic(dev)
    phase_agreement(dev)
    print(json.dumps({"kernels": [kernel]}))
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
