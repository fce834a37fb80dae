"""COREC core in PyTorch: the protocol, its three planes and the sweep API.

Layout (the reference's ``repro.core``, module for module):
  atomics.py       RMW primitives (CAS / fetch_add / trylock) on CPython
  ring.py          CorecRing -- the non-blocking single-queue protocol
  baseline.py      threaded queue drivers (RSS / locked / hybrid / ...)
  dispatch.py      worker pools draining any registered queue policy
  des.py           discrete-event core (event loop + worker plane)
  faults.py        fault model (FaultSpec) shared by all three planes
  policy.py        RxPolicy plugins + the registry all planes share
  torchplane.py    the lane engine (claim-compacted scan over lanes)
  tcptorch.py      the TCP lane engine
  shard.py         lane shards over a torch.distributed group
  queueing.py      M/G/N vs N x M/G/1 scenario layer (sec 3.2)
  forwarder.py     open-loop L3-forwarder scenario layer (sec 4.3.1)
  tcp.py           TCP-over-forwarder scenario layer (sec 4.3.2)
  servingtorch.py  open-loop serving scenario (both planes)
  sweep.py         SweepRequest / run_sweep -- the one sweep entry point
  reorder.py       RFC 4737 reordering metrics (sec 4.3)
  traffic.py       UDP / MAWI-mix / flow traffic generators
  protocol_sim.py  stepped interleaving model for property tests

The DES and threaded planes run on the host; build a
:class:`SweepRequest` and call :func:`run_sweep` for the lane engine,
which runs on the CUDA device unless ``device="cpu"`` is passed.
"""

from .atomics import AtomicU64, TryLock
from .baseline import (
    AdaptiveBatchSharedQueue,
    CorecSharedQueue,
    HybridStealDriver,
    LockedSharedQueue,
    ScaleOutDriver,
    rss_hash,
)
from .des import DesItem, EventLoop, PlaneStats, WorkerPlane
from .dispatch import DispatchResult, Item, WorkerPool, make_queue
from .faults import FaultSpec, StrandedRunError, WorkerCrash
from .forwarder import ForwarderConfig, simulate_forwarder
from .policy import (
    RxPolicy,
    available_policies,
    get_spec,
    make_policy,
    make_thread_queue,
    make_torch_policy,
    overload_defaults,
    register_policy,
    serving_defaults,
    torch_policies,
)
from .queueing import (
    simulate_policy,
    simulate_protocol,
    simulate_scale_out,
    simulate_scale_up,
    sweep_load,
)
from .reorder import ReorderReport, measure_reordering, per_flow_reordering
from .ring import Claim, CorecRing, RingStats
from .servingtorch import (
    ServingPolicy,
    ServingResult,
    ServingSimConfig,
    simulate_serving_des,
    sweep_serving_torch,
)
from .sweep import SweepRequest, SweepResult, run_sweep
from .tcp import FlowResult, TcpSimConfig, simulate_tcp
from .tcptorch import TcpLaneResult, run_tcp_lanes, run_tcp_lanes_fused
from .torchplane import LaneResult, lane_grid
from .traffic import MSS, FlowSpec, Packet, flow_packets, mawi_mix, udp_stream

__all__ = [
    "AtomicU64", "TryLock", "Claim", "CorecRing", "RingStats",
    "CorecSharedQueue", "LockedSharedQueue", "ScaleOutDriver", "rss_hash",
    "HybridStealDriver", "AdaptiveBatchSharedQueue",
    "DesItem", "EventLoop", "PlaneStats", "WorkerPlane",
    "RxPolicy", "available_policies", "get_spec", "make_policy",
    "make_thread_queue", "register_policy", "serving_defaults",
    "overload_defaults", "torch_policies", "make_torch_policy",
    "SweepRequest", "SweepResult", "run_sweep",
    "ServingPolicy", "ServingResult", "ServingSimConfig",
    "simulate_serving_des", "sweep_serving_torch",
    "DispatchResult", "Item", "WorkerPool", "make_queue",
    "FaultSpec", "StrandedRunError", "WorkerCrash",
    "ForwarderConfig", "simulate_forwarder",
    "simulate_policy", "simulate_protocol", "simulate_scale_out",
    "simulate_scale_up", "sweep_load",
    "ReorderReport", "measure_reordering", "per_flow_reordering",
    "FlowResult", "TcpSimConfig", "simulate_tcp",
    "MSS", "FlowSpec", "Packet", "flow_packets", "mawi_mix", "udp_stream",
    "LaneResult", "lane_grid", "TcpLaneResult", "run_tcp_lanes",
    "run_tcp_lanes_fused",
]
