"""The lane axis split over the ranks of a ``gloo`` process group (the
port's counterpart of the reference's ``shard_map`` over ``("lanes",)``),
held against the unsharded runs of both packages.

W = 2 and W = 4 ranks, each in its own process
(``repro_torch.distributed.run_ranks``: a free port, a deadline, every
process stopped), each run once per W in a module fixture.  The cases
mirror ``tests/test_compaction.py::test_sharded_equals_unsharded_forced_host_devices``,
which cannot run the reference's sharded lanes here:

* the forwarder, hybrid, 11 lanes (padded to 12 under both W),
  ``n_packets=200``, ``return_times=True``, on the reference's draws:
  every field equals the port's unsharded run bit for bit, and the
  reference's unsharded ``run_lanes`` as the port's unsharded run does
  (integers exact; floats at ``rtol=1e-6``, the parity of
  ``tests/test_torch_plane.py``: the port's percentiles round an ulp
  apart from XLA's on a few lanes);
* three policies fused over an 11-lane batch axis on the port's own
  draws through ``run_sweep(shards=W)`` and ``shards="auto"``: every
  field equals the unsharded ``run_sweep``, so each segment is padded
  and split on its own and its lanes come back in order;
* TCP ``scaleout``, 5 lanes, ``n_pkts=[30, 30]``, on the reference's
  draws (every field exact against both unsharded runs) and, with
  ``corec`` fused beside it, on the port's.

Without a process group of the right size, ``shards > 1`` raises.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import jaxplane as jp  # noqa: E402
from repro.core import tcpjax as tj  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.core import SweepRequest, run_sweep  # noqa: E402
from repro_torch.core import tcptorch as tt  # noqa: E402
from repro_torch.core import torchplane as tp  # noqa: E402
from repro_torch.distributed import run_ranks  # noqa: E402

LANES, N, W_WORKERS, N_FLOWS = 11, 200, 4, 256
S_PAD = -(-N // 64) * 64
FWD_LP = dict(batch=8, max_batch=8, deschedule_prob=1e-3)
#: a batch axis over the 11 lanes, so that a lane out of place shows
SWEEP_LP = dict(batch=np.array([1, 2, 4, 8, 16, 3, 5, 7, 9, 11, 13], np.float32))
TCP_LANES, TCP_PKTS = 5, [30, 30]
RANK_TIMEOUT = 240.0
#: the forwarder's float parity with the reference (tests/test_torch_plane.py)
FWD_FLOAT_RTOL = 1e-6


def _fwd_req():
    return dict(policy="hybrid", seeds=np.arange(LANES), lane_params=FWD_LP)


def _tcp_req():
    return dict(policy="scaleout", seeds=np.arange(TCP_LANES))


@functools.lru_cache(maxsize=None)
def reference():
    """The reference's unsharded runs and its draws (as numpy)."""
    fwd = jp.run_lanes("hybrid", np.arange(LANES), n_packets=N, return_times=True,
                       lane_params=FWD_LP)
    pol = jp.build_policy("hybrid")
    blocks = (
        jp.LaneParams(*jp._broadcast_lanes(jp.default_lane_params(**FWD_LP),
                                           jp.LaneParams._fields, LANES)),
        jp.TrafficParams(*jp._broadcast_lanes(jp.default_traffic_params(),
                                              jp.TrafficParams._fields, LANES)),
        jp.FaultParams(*jp._broadcast_lanes(jp.default_fault_params(),
                                            jp.FaultParams._fields, LANES)),
        jp.ServingParams(*jp._broadcast_lanes(jp.default_serving_params(),
                                              jp.ServingParams._fields, LANES)),
        jnp.asarray(np.arange(LANES, dtype=np.uint32)),
    )
    setup = jax.jit(
        jax.vmap(
            functools.partial(
                jp._lane_setup, pol, "udp", "fwd", N, N, N_FLOWS, W_WORKERS, S_PAD,
                False, jp.OverloadConfig(),
            )
        )
    )
    fwd_su = {k: np.asarray(v) for k, v in setup(*blocks).items()}
    tcp = tj.run_tcp_lanes("scaleout", np.arange(TCP_LANES), n_pkts=TCP_PKTS)
    total = sum(TCP_PKTS)
    tb = total + total // 8 + 32
    s_pad = -(-(3 * tb + len(TCP_PKTS) + 64) // 64) * 64
    tparams = tj.TcpParams(*jp._broadcast_lanes(tj.default_tcp_params(),
                                                tj.TcpParams._fields, TCP_LANES))
    tsetup = functools.partial(tj._tcp_setup, tx_budget=tb, n_steps=s_pad)
    seeds = jnp.asarray(np.arange(TCP_LANES, dtype=np.uint32))
    tcp_su = {
        k: np.asarray(v) for k, v in jax.jit(jax.vmap(tsetup))(tparams, seeds).items()
    }
    as_np = lambda r: {f: np.asarray(getattr(r, f)) for f in r._fields}  # noqa: E731
    return as_np(fwd), fwd_su, as_np(tcp), tcp_su


def _lanes(res) -> dict:
    return {f: getattr(res, f).cpu().numpy() for f in res._fields}


def _requests(shards):
    return dict(
        fwd=SweepRequest(scenario="forwarder", policies=["hybrid", "corec", "scaleout"],
                         seeds=np.arange(LANES), lane_params=SWEEP_LP, n_packets=N,
                         return_times=True, shards=shards),
        tcp=SweepRequest(scenario="tcp", policies=["scaleout", "corec"],
                         seeds=np.arange(TCP_LANES), n_packets=np.array(TCP_PKTS),
                         shards=shards),
    )


def _runs(shards, fwd_su, tcp_su) -> dict:
    """Every run of this file at ``shards``, as numpy."""
    torch.set_num_threads(1)
    fwd = tp._fused_lanes([_fwd_req()], n_packets=N, return_times=True, shards=shards,
                          device="cpu", setups=[tp.setups_from_reference(fwd_su)])[0]
    tcp = tt.run_tcp_lanes_fused([_tcp_req()], n_pkts=TCP_PKTS, shards=shards,
                                 device="cpu",
                                 setups=[tt.tcp_setups_from_reference(tcp_su)])[0]
    out = dict(fwd_ref_draws=_lanes(fwd), tcp_ref_draws=_lanes(tcp))
    for key, req in _requests(shards).items():
        timings: dict = {}
        sweep = run_sweep(req, timings=timings, device="cpu")
        out[key] = {name: _lanes(r) for name, r in sweep.lanes.items()}
        out[f"{key}_timings"] = timings
    return out


def _rank(rank, world, fwd_su, tcp_su):
    out = _runs(world, fwd_su, tcp_su)
    auto = run_sweep(_requests("auto")["fwd"], device="cpu")
    out["fwd_auto"] = {name: _lanes(r) for name, r in auto.lanes.items()}
    mesh = compat.lane_mesh(world, device="cpu")
    out["lane_mesh"] = (tuple(mesh.shape), mesh.mesh_dim_names, compat.device_count())
    return out


@functools.lru_cache(maxsize=None)
def unsharded():
    _, fwd_su, _, tcp_su = reference()
    return _runs(1, fwd_su, tcp_su)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"W{w}")
def sharded(request):
    _, fwd_su, _, tcp_su = reference()
    return request.param, run_ranks(
        _rank, request.param, fwd_su, tcp_su, backend="gloo", timeout=RANK_TIMEOUT
    )


def _equal(got: dict, want: dict, what: str, float_rtol: float = 0.0) -> None:
    assert set(got) == set(want), what
    for f, w in want.items():
        g = got[f]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, f, g.dtype, w.dtype)
        if float_rtol and w.dtype == np.float32:
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=f)
            np.testing.assert_allclose(g, w, rtol=float_rtol, err_msg=f"{what}: {f}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


def _equal_reference(got: dict, want: dict, what: str) -> None:
    """The port against the reference on the reference's draws, as
    ``tests/test_torch_plane.py`` holds it: every integer field exact, the
    forwarder's float fields at ``rtol=1e-6`` (its percentiles round an
    ulp apart from XLA's on a few lanes), the TCP engine's exact."""
    _equal(got, want, what, float_rtol=FWD_FLOAT_RTOL if "fct" not in want else 0.0)


def test_unsharded_port_equals_reference_on_its_draws():
    ref_fwd, _, ref_tcp, _ = reference()
    port = unsharded()
    _equal_reference(port["fwd_ref_draws"], ref_fwd, "forwarder")
    _equal_reference(port["tcp_ref_draws"], ref_tcp, "tcp")
    assert (ref_fwd["items"] == N).all() and ref_tcp["done"].all()


@pytest.mark.parametrize("key", ["fwd_ref_draws", "tcp_ref_draws"])
def test_sharded_equals_reference_on_its_draws(sharded, key):
    world, ranks = sharded
    ref_fwd, _, ref_tcp, _ = reference()
    want = ref_fwd if key.startswith("fwd") else ref_tcp
    for r, out in enumerate(ranks):
        _equal_reference(out[key], want, f"W={world} rank {r} {key}")
        _equal(out[key], unsharded()[key], f"W={world} rank {r} {key} vs port")


@pytest.mark.parametrize("key", ["fwd", "tcp", "fwd_auto"])
def test_sharded_sweep_equals_unsharded(sharded, key):
    world, ranks = sharded
    base = unsharded()[key.removesuffix("_auto")]
    for r, out in enumerate(ranks):
        assert list(out[key]) == list(base)
        for name in base:
            _equal(out[key][name], base[name], f"W={world} rank {r} {key}/{name}")
        if key != "fwd_auto":
            assert out[f"{key}_timings"]["gather_s"] >= 0.0


def test_lane_mesh_spans_the_group(sharded):
    world, ranks = sharded
    for out in ranks:
        assert out["lane_mesh"] == ((world,), ("lanes",), world)


def test_lanes_differ_so_order_shows():
    """The swept batch axis gives every forwarder lane its own results, so
    a lane returned out of place fails the equality above."""
    res = unsharded()["fwd"]["hybrid"]
    assert len({(b, p) for b, p in zip(res["batches"], res["p99"])}) == LANES


def test_shards_need_a_matching_process_group():
    assert compat.device_count() == 1
    assert compat.resolve_shards("auto") == 1
    with pytest.raises(RuntimeError, match="init_process_group"):
        run_sweep(_requests(2)["fwd"], device="cpu")
    with pytest.raises(RuntimeError, match="none is initialised"):
        tt.run_tcp_lanes("corec", np.arange(2), n_pkts=20, shards=3, device="cpu")


def test_shards_auto_without_a_group_is_unsharded():
    got = run_sweep(_requests("auto")["fwd"], device="cpu")
    base = unsharded()["fwd"]
    for name in base:
        _equal(_lanes(got[name]), base[name], f"auto/{name}")
