"""Where the port's fused sweeps spend their time, on one GPU.

Runs the main path of ``chip_smoke.py`` (the forwarder grid of
``benchmarks/jax_sweep.py``: 72 configs x ``--seeds`` seeds per
policy, all five policies, 2,000 packets per lane) twice:

1. phase by phase, with a device synchronisation after each phase
   and the host clock around it: per-lane draws and queue views
   (``_lane_setup``), the claim scan, the post-scan scatter and
   outputs, and the one claim-check launch;
2. a window of claim steps of every segment under ``torch.profiler``
   (CPU + CUDA activities): device busy time (sum of kernel self
   times), its share of the window's wall clock, kernels and outermost
   ``aten`` operator calls per step, and the top kernels by device
   time.

Then the serving grid of ``benchmarks/serving_sweep.py`` (48 configs x
3 ``--seeds`` seeds per policy, 1,000 users per lane, diurnal arrivals,
heavy-tailed sessions, admission and autoscale armed) the same two
ways.  The profiler's first window also holds its own start-up, so
read host time per step from the phase split.

``--scenario tcp`` profiles the TCP section of ``benchmarks/jax_sweep.py``
instead (``chip_smoke.py`` phase 4c): the grid (144 configs x
``--seeds`` seeds per policy, two flows of 128 packets) and its SACK
leg (16 configs, random loss and drop-once control rows), each phase
by phase (per-lane draws and state, the batched-event scan to the
all-quiet chunk, the outputs, the one words-route launch of the
exactly-once check) and under the profiler.

Usage (on a host with a CUDA device)::

    PYTHONPATH=src python3 tools/torch_sweep_profile.py --out prof.json
    PYTHONPATH=src python3 tools/torch_sweep_profile.py --scenario tcp
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import SweepRequest, lane_grid, run_sweep  # noqa: E402
from repro_torch.core import tcptorch as tt  # noqa: E402
from repro_torch.core import torchplane as tp  # noqa: E402
from repro_torch.core.policy import (  # noqa: E402
    _fused_requests,
    make_torch_policy,
    torch_policies,
)
from repro_torch.kernels import ops  # noqa: E402

AXES = {
    "batch": [1, 2, 4, 8, 16, 32],
    "rate": [20.0, 30.0, 40.0, 50.0],
    "deschedule_prob": [0.0, 5e-4, 5e-3],
}
N, W, MB, CHUNK = 2000, 4, 64, 64
#: the serving grid of benchmarks/serving_sweep.py
SERVING_AXES = {
    "admit_limit": [16.0, 48.0, 96.0],
    "scale_backlog": [12.0, 48.0],
    "rate": [2.0, 3.0, 4.0, 5.0],
    "slo_target": [20.0, 40.0],
}
SERVING_N, SERVING_MB = 1000, 32
#: the TCP section of benchmarks/jax_sweep.py and its SACK leg
TCP_AXES = {
    "batch": [1, 2, 4, 8, 16, 32],
    "deschedule_prob": [0.0, 5e-4, 5e-3],
    "link_pps": [0.55, 0.85, 1.1, 1.35],
    "pkt_budget": [1 << 30, 48],
}
TCP_SACK_AXES = {
    "batch": [1, 4, 16, 32],
    "deschedule_prob": [0.0, 5e-3],
    "loss_rate": [0.0, 0.03],
}
TCP_PKTS = np.array([128, 128])
TCP_START = np.array([0.0, 37.0], np.float32)
TCP_TB = 256 + 256 // 8 + 32  # the default transmission budget
TCP_STEPS = -(-(3 * TCP_TB + 2 + 64) // CHUNK) * CHUNK


def _grid(n_seeds):
    arrays, _ = lane_grid(AXES, np.arange(n_seeds))
    seeds = arrays.pop("__seeds__")
    lane = {k: arrays[k] for k in ("batch", "deschedule_prob")}
    return seeds, lane, {"rate": arrays["rate"]}


def _tick(dev) -> float:
    torch.cuda.synchronize(dev)
    return time.perf_counter()


def phases(dev, segs, mb, n) -> dict:
    """Host-clock seconds of each phase of the sweep over ``segs``
    (``(policy, params, setup, serving params or None)``), the device
    synchronised between: the claim scan, the post-scan scatter, the
    outputs, and the one claim check over every segment."""
    out = dict(scan_s=0.0, scatter_s=0.0, outputs_s=0.0, steps=0)
    masks = []
    for pol, params, su, sp in segs:
        lanes = su.arr.shape[0]
        t1 = _tick(dev)
        st = tp._init_state(lanes, W, dev)
        u_t, stall_t = su.u.t().contiguous(), su.stalls.t().contiguous()
        drained = su.offered if sp is not None else n
        recs = []
        for c0 in range(0, su.u.shape[1], CHUNK):
            if bool((st.halted | (st.items + st.shed >= drained)).all()):
                break
            for s in range(c0, c0 + CHUNK):
                rec = tp._claim_step(pol, mb, params, su, st, u_t[s], stall_t[s], sp)
                recs.append(rec if sp is not None else rec[:5])
        t2 = _tick(dev)
        rec = tp.ClaimRecord(*(torch.stack(x, dim=1) for x in zip(*recs)))
        done, claimed = tp._scatter_claims(rec, su.qid, su.rank, su.cumsvc)
        t3 = _tick(dev)
        if sp is None:
            tp._segment_outputs(st, done, su.arr, n, False)
        else:
            tp._serving_outputs(st, done, su, sp, tp.OverloadConfig(), False)
        masks.append(claimed)
        t4 = _tick(dev)
        out["scan_s"] += t2 - t1
        out["scatter_s"] += t3 - t2
        out["outputs_s"] += t4 - t3
        out["steps"] += len(recs)
    t0 = _tick(dev)
    ops.claim_check(torch.cat(masks), n)
    out["claim_check_s"] = _tick(dev) - t0
    out["scan_ms_per_step"] = 1e3 * out["scan_s"] / max(out["steps"], 1)
    return out


def _forwarder_segments(dev, n_seeds) -> tuple:
    """Every policy segment of the forwarder grid, ready to step, and the
    host seconds their setups took (device synchronised)."""
    seeds, lane, traffic = _grid(n_seeds)
    reqs = _fused_requests(seeds, lane_params=lane, traffic_params=traffic)
    lanes = len(seeds)
    t0 = _tick(dev)
    segs = []
    for req in reqs:
        pol = tp._resolve_policy(req["policy"])
        params = tp._lane_tensors(
            tp.default_lane_params(**req["lane_params"]), tp.LaneParams, lanes, dev
        )
        su = tp._lane_setup(
            pol,
            "udp",
            "fwd",
            N,
            256,
            W,
            N + (-N % CHUNK),
            tp._lane_tensors(
                tp.default_traffic_params(**traffic), tp.TrafficParams, lanes, dev
            ),
            tp._lane_tensors(tp.default_fault_params(), tp.FaultParams, lanes, dev),
            seeds,
        )
        segs.append((pol, params, su, None))
    return segs, _tick(dev) - t0


def _serving_segments(dev, n_seeds) -> tuple:
    """Every policy segment of the serving grid, ready to step, and the
    host seconds their setups took (device synchronised)."""
    arrays, _ = lane_grid(SERVING_AXES, np.arange(n_seeds))
    seeds = arrays.pop("__seeds__")
    lanes = len(seeds)
    traffic = tp.default_traffic_params(rate=arrays["rate"], session_alpha=1.8)
    serving = tp.default_serving_params(
        admit_limit=arrays["admit_limit"],
        scale_backlog=arrays["scale_backlog"],
        slo_target=arrays["slo_target"],
        base_workers=2.0,
    )
    t0 = _tick(dev)
    segs = []
    for name in torch_policies():
        pol = make_torch_policy(name)
        sp = tp._lane_tensors(serving, tp.ServingParams, lanes, dev)
        su = tp._lane_setup(
            pol,
            "diurnal",
            "HT",
            SERVING_N,
            256,
            W,
            SERVING_N + (-SERVING_N % CHUNK),
            tp._lane_tensors(traffic, tp.TrafficParams, lanes, dev),
            tp._lane_tensors(tp.default_fault_params(), tp.FaultParams, lanes, dev),
            seeds,
            sparams=sp,
        )
        params = tp._lane_tensors(tp.default_lane_params(), tp.LaneParams, lanes, dev)
        segs.append((pol, params, su, sp))
    return segs, _tick(dev) - t0


def profiled(dev, segs, mb, steps) -> dict:
    """``torch.profiler`` over a window of ``steps`` claim steps of every
    policy segment (the scan dominates ``run_s``; a trace of the whole
    sweep holds ~10^6 events and takes longer than the sweep)."""
    runs = []
    for pol, params, su, sp in segs:
        st = tp._init_state(su.arr.shape[0], W, dev)
        u_t, stall_t = su.u.t().contiguous(), su.stalls.t().contiguous()
        runs.append((pol, params, su, sp, st, u_t, stall_t))

    def window(first):
        for pol, params, su, sp, st, u_t, stall_t in runs:
            for s in range(first, first + steps):
                tp._claim_step(pol, mb, params, su, st, u_t[s], stall_t[s], sp)

    return _window(dev, window, steps, len(runs))


def _window(dev, window, steps: int, n_segs: int) -> dict:
    """Run ``window(0)`` to warm up, then ``window(steps)`` under the
    profiler: device busy time and share, kernels and outermost ``aten``
    calls per step, the top kernels."""
    window(0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        window(steps)
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    kernels = [
        e
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and getattr(e, "self_device_time_total", 0) > 0
    ]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_steps = steps * n_segs
    aten = [e for e in prof.events() if e.name.startswith("aten::")]
    outer = [
        e
        for e in aten
        if e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")
    ]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return dict(
        window_steps=n_steps,
        wall_s=wall,
        device_busy_s=busy_us / 1e6,
        device_busy_share=busy_us / 1e6 / wall,
        kernels_per_step=sum(e.count for e in kernels) / n_steps,
        aten_ops_per_step=len(outer) / n_steps,
        host_ms_per_step=1e3 * wall / n_steps,
        device_ms_per_step=busy_us / 1e3 / n_steps,
        top_kernels=[
            dict(
                name=e.key[:90], count=e.count, device_ms=e.self_device_time_total / 1e3
            )
            for e in top
        ],
    )


def _tcp_segments(dev, n_seeds: int, sack: bool) -> tuple:
    """Every policy segment of the TCP grid (or its SACK leg), ready to
    step, and the host seconds their draws and states took."""
    arrays, _ = lane_grid(TCP_SACK_AXES if sack else TCP_AXES, np.arange(n_seeds))
    seeds = arrays.pop("__seeds__")
    lane = {k: arrays.pop(k) for k in ("batch", "deschedule_prob")}
    if sack:
        every = np.where(arrays["loss_rate"] == 0.0, 10.0, 0.0)
        arrays.update(link_pps=0.85, loss_every=every)
    t0 = _tick(dev)
    segs = []
    for req in _fused_requests(seeds, lane_params=lane):
        segs.append(
            tt._segment(
                make_torch_policy(req["policy"]),
                seeds,
                tt.tcp_lane_defaults(**req["lane_params"]),
                tt.default_tcp_params(**arrays),
                tt.default_fault_params(),
                sack,
                TCP_PKTS,
                TCP_START,
                W,
                MB,
                TCP_TB,
                TCP_STEPS,
                32,
                dev,
            )
        )
    return segs, _tick(dev) - t0


def tcp_phases(dev, segs) -> dict:
    """Host-clock seconds of each phase of the TCP sweep over ``segs``,
    the device synchronised between: the scan (chunks of CHUNK steps
    until every lane is quiet, as ``_run_segment``), the outputs, and the
    one words-route launch over every segment's claim bitmaps."""
    out = dict(scan_s=0.0, outputs_s=0.0, steps=0)
    words = []
    for c, params, tcp, su, st in segs:
        u_t, stall_t = su.u.t().contiguous(), su.stalls.t().contiguous()
        t1 = _tick(dev)
        for c0 in range(0, TCP_STEPS, CHUNK):
            if bool(st["quiet"].all()):
                break
            for s in range(c0, c0 + CHUNK):
                tt._tcp_step(c, params, tcp, su, st, u_t[s], stall_t[s])
                out["steps"] += 1
        t2 = _tick(dev)
        o = tt._tcp_outputs(st, su, c.t_start, c.f_cnt, c.max_pkts, TCP_TB)
        words.append(o["words"])
        out["outputs_s"] += _tick(dev) - t2
        out["scan_s"] += t2 - t1
    t0 = _tick(dev)
    w = torch.cat(words)
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
    ops.done_prefix_packed(w, torch.full((w.shape[0],), TCP_TB, device=dev), TCP_TB)
    out["prefix_s"] = _tick(dev) - t0
    out["scan_ms_per_step"] = 1e3 * out["scan_s"] / max(out["steps"], 1)
    return out


def tcp_profiled(dev, n_seeds: int, sack: bool, steps: int) -> dict:
    """The profiler window over ``steps`` TCP steps of every segment, on
    fresh states."""
    segs, _ = _tcp_segments(dev, n_seeds, sack)
    runs = [(seg, seg[3].u.t().contiguous(), seg[3].stalls.t().contiguous())
            for seg in segs]

    def window(first):
        for (c, params, tcp, su, st), u_t, stall_t in runs:
            for s in range(first, first + steps):
                tt._tcp_step(c, params, tcp, su, st, u_t[s], stall_t[s])

    return _window(dev, window, steps, len(runs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--seeds", type=int, default=14, help="forwarder seeds (serving: 3x)"
    )
    ap.add_argument("--profile-steps", type=int, default=32)
    ap.add_argument(
        "--scenario",
        choices=("lanes", "tcp"),
        default="lanes",
        help="lanes: the forwarder and serving grids; tcp: the TCP grid and "
        "its SACK leg",
    )
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sweep_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    run_sweep(SweepRequest(seeds=np.arange(2), n_packets=64), device=dev)  # warm
    if args.scenario == "tcp":
        res = dict(card=card)
        for label, sack in (("tcp", False), ("tcp_sack", True)):
            segs, setup_s = _tcp_segments(dev, args.seeds, sack)
            lanes = sum(seg[3].u.shape[0] for seg in segs)
            res[label] = dict(
                lanes=lanes,
                phases=dict(setup_s=setup_s, **tcp_phases(dev, segs)),
                profile=tcp_profiled(dev, args.seeds, sack, args.profile_steps),
            )
            del segs
        return _report(res, args.out)
    fwd, setup_s = _forwarder_segments(dev, args.seeds)
    res = dict(
        card=card,
        lanes=5 * 72 * args.seeds,
        phases=dict(setup_s=setup_s, **phases(dev, fwd, MB, N)),
        profile=profiled(dev, fwd, MB, args.profile_steps),
    )
    del fwd
    srv, setup_s = _serving_segments(dev, args.seeds * 3)
    res["serving"] = dict(
        lanes=5 * 48 * args.seeds * 3,
        phases=dict(setup_s=setup_s, **phases(dev, srv, SERVING_MB, SERVING_N)),
        profile=profiled(dev, srv, SERVING_MB, args.profile_steps),
    )
    return _report(res, args.out)


def _report(res: dict, out) -> int:
    text = json.dumps(res, indent=1)
    print(text)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
