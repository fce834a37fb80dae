"""W ranks of one function over ``torch.distributed``, each in its own
process: the harness the lane-sharded sweeps and the pod all-reduce run
under.

:func:`run_ranks` spawns ``world_size`` processes (the ``spawn`` start
method: each starts from a fresh import), gives each a process group
over ``tcp://localhost:<free port>`` with the backend the caller names,
calls ``fn(rank, world_size, *args)`` in each and returns the results in
rank order.  ``fn`` is pickled by its import path and its result is
pickled back, so both must be plain data (numpy arrays, not device
tensors).  Every wait has a deadline: a rank that fails, dies or hangs
fails the whole call, and every process is stopped before it returns.

Two ranks may share one card: NCCL refuses that, so such a run names
``gloo``, which gathers through host memory (see
``core/shard.py::all_gather_lanes``).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback
from dataclasses import replace

__all__ = ["free_port", "run_ranks", "sweep_rank"]


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, args, out, timeout) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend,
            init_method=f"tcp://localhost:{port}",
            rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
        )
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except Exception:
        out.put((rank, False, traceback.format_exc()))
        raise
    out.put((rank, True, result))


def run_ranks(fn, world_size: int, *args, backend: str = "gloo", timeout: float = 300.0):
    """``[fn(r, world_size, *args) for r in ranks]``, each rank in its own
    process inside one process group of ``backend``; raises if any rank
    raises, exits early or is not done within ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn, r, world_size, port, backend, args, out, timeout),
            daemon=True,
        )
        for r in range(world_size)
    ]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: ranks {sorted(set(range(world_size)) - set(results))} "
                    f"not done within {timeout} s"
                )
            try:
                rank, ok, value = out.get(timeout=min(left, 0.5))
            except queue.Empty:
                gone = [
                    r
                    for r, p in enumerate(procs)
                    if p.exitcode is not None and r not in results
                ]
                # a rank that exited with its result still in the pipe is
                # read on the next turn; one that exited without is lost
                if gone and out.empty():
                    time.sleep(0.5)
                    if out.empty():
                        codes = {r: procs[r].exitcode for r in gone}
                        raise RuntimeError(f"run_ranks: ranks exited early: {codes}")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
    return [results[r] for r in range(world_size)]


def sweep_rank(rank: int, world: int, request, device) -> dict:
    """One rank of a lane-sharded :func:`repro_torch.core.run_sweep`
    (``shards=world``): every lane's fields as numpy arrays, the rank's
    timings, and the launches of the packed done-prefix kernel's two
    routes (the claim check, the words route) during the call."""
    from .core import run_sweep
    from .kernels.doneprefix import claim_check_cuda, done_prefix_packed_cuda

    claim_check_cuda.launches = 0
    done_prefix_packed_cuda.launches = 0
    timings: dict = {}
    sweep = run_sweep(replace(request, shards=world), timings=timings, device=device)
    launches = dict(
        claim_check=claim_check_cuda.launches, words=done_prefix_packed_cuda.launches
    )
    lanes = {
        name: {f: getattr(res, f).cpu().numpy() for f in res._fields}
        for name, res in sweep.lanes.items()
    }
    return dict(rank=rank, lanes=lanes, timings=timings, launches=launches)
