"""The port's lane engine vs ``repro.core.jaxplane`` on the same state.

The reference draws every lane's traffic with ``_lane_setup`` (jitted
and vmapped, exactly as its fused call does); the draws are carried
across with ``torchplane.setups_from_reference`` and both engines run
on them, on the CPU, for all five policies, fault-free and faulted:

* every integer output exact (batches, items, deschedules, the claim
  bitmap's popcount and done prefix, max_distance, undelivered,
  reclaimed, duplicates), and the packed claim words of one lane per
  policy;
* float outputs at ``rtol=1e-6`` with the same +-inf pattern -- equal
  arithmetic, but XLA may contract ``t1 + span * slow`` into one fused
  multiply-add where PyTorch rounds twice (straggler lanes only);
* the per-step ClaimRecords of one lane per policy, from a
  ``lax.scan`` over ``jaxplane._claim_step``: q, ptr, k, slow exact, t1
  at ``rtol=1e-6``.  The first claim of every lane is a tie between
  idle workers (all free at t=0); both take the first index.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import jaxplane as jp  # noqa: E402
from repro.core.policy import _fused_requests, jax_policies  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import torchplane as tp  # noqa: E402
from repro_torch.core.policy import make_torch_policy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

POLICIES = jax_policies()
N, W, MB, N_FLOWS, CHUNK, LANES = 256, 4, 64, 256, 64, 8
S_PAD = N  # the sound default claim budget, a multiple of CHUNK
OV = jp.OverloadConfig()
RTOL = 1e-6

LANE_PARAMS = dict(
    batch=np.array([1, 2, 4, 8, 16, 32, 8, 64], np.float32),
    deschedule_prob=np.array([0, 5e-3, 0, 2e-2, 0, 5e-3, 1e-2, 0], np.float32),
)
TRAFFIC = dict(rate=np.array([20, 30, 40, 50, 20, 30, 40, 50], np.float32))
#: worker 1 dies at t=5 (mid-run: arrivals span ~5-13 time units)
CRASH = dict(crash_t=5.0, crash_worker=1.0)
FAULTS = {
    "none": {},
    "crash_lease_straggler": dict(
        CRASH, lease=3.0, straggler=3.0, straggler_worker=0.0
    ),
    "crash_no_lease": dict(CRASH),
    "straggler": dict(straggler=6.0, straggler_worker=0.0),
}
INT_FIELDS = (
    "batches",
    "items",
    "deschedules",
    "claimed_popcount",
    "claimed_prefix",
    "max_distance",
    "undelivered",
    "reclaimed",
    "duplicates",
    "offered",
    "shed",
    "attempts",
    "delivered",
    "expired",
    "goodput",
    "dup_served",
)
FLOAT_FIELDS = (
    "p50",
    "p99",
    "mean",
    "throughput",
    "drain_t",
    "sojourn",
    "reorder_pct",
    "slo_attained",
)


@functools.partial(jax.jit, static_argnums=0)
def _ref_setup(pol, params, traffic, fparams, sparams, seeds):
    setup = functools.partial(
        jp._lane_setup, pol, "udp", "fwd", N, N, N_FLOWS, W, S_PAD, False, OV
    )
    return jax.vmap(setup)(params, traffic, fparams, sparams, seeds)


def _blocks(req):
    def lanes(defaults, cls, kw):
        return cls(*jp._broadcast_lanes(defaults(**kw), cls._fields, LANES))

    return (
        lanes(jp.default_lane_params, jp.LaneParams, req["lane_params"]),
        lanes(jp.default_traffic_params, jp.TrafficParams, req["traffic_params"]),
        lanes(jp.default_fault_params, jp.FaultParams, req["fault_params"]),
        lanes(jp.default_serving_params, jp.ServingParams, {}),
        jnp.asarray(np.arange(LANES, dtype=np.uint32)),
    )


@functools.lru_cache(maxsize=None)
def _scenario(fault: str):
    """Reference results, reference setups and port results of one
    fault scenario, all five policies fused on both sides."""
    reqs = _fused_requests(
        np.arange(LANES),
        lane_params=LANE_PARAMS,
        traffic_params=TRAFFIC,
        fault_params=FAULTS[fault],
    )
    ref = jp._fused_lanes(
        reqs,
        n_packets=N,
        n_workers=W,
        max_batch=MB,
        n_flows=N_FLOWS,
        chunk=CHUNK,
        prefix_impl="pallas",
        prefix_interpret=True,
        return_times=True,
    )
    sus = []
    for r in reqs:
        su = _ref_setup(jp.build_policy(r["policy"]), *_blocks(r))
        sus.append({k: np.asarray(v) for k, v in su.items()})
    port = tp._fused_lanes(
        reqs,
        n_packets=N,
        n_workers=W,
        max_batch=MB,
        n_flows=N_FLOWS,
        chunk=CHUNK,
        return_times=True,
        device="cpu",
        setups=[tp.setups_from_reference(su) for su in sus],
    )
    names = [r["policy"] for r in reqs]
    return dict(zip(names, zip(reqs, ref, sus, port)))


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_port_equals_reference_on_injected_setups(fault, name):
    _, ref, _, port = _scenario(fault)[name]
    for f in INT_FIELDS:
        want, got = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert got.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, err_msg=f"{fault}/{name}: {f}")
    for f in FLOAT_FIELDS:
        want, got = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=f)
        np.testing.assert_allclose(
            got, want, rtol=RTOL, err_msg=f"{fault}/{name}: {f}"
        )
    # the scenarios are not trivially equal: each shows its fault
    items = np.asarray(ref.items)
    undelivered = np.asarray(ref.undelivered)
    if fault in ("none", "straggler"):
        assert (items == N).all() and (np.asarray(ref.claimed_prefix) == N).all()
    elif fault == "crash_no_lease":
        assert (undelivered > 0).any(), "a stranded span must stay undelivered"
    elif name == "locked":  # crash with lease: locked wedges anyway
        assert (undelivered > 0).any() and (np.asarray(ref.reclaimed) == 0).all()
    else:
        # a lease re-opens the stranded span to live workers; a batch-1
        # lane may still end one item short, on both planes: its crashed
        # claim used one step of the claim budget (n steps) and delivered
        # nothing
        assert (np.asarray(ref.reclaimed) > 0).any()
        assert (undelivered[1:] == 0).all()


@functools.partial(jax.jit, static_argnums=0)
def _ref_records(pol, params, sparams, su):
    st0 = jax.tree_util.tree_map(lambda x: x[0], jp._init_state(1, W))
    flt = (su["crash_w"], su["slow_w"], su["lease"])

    def body(st, x):
        return jp._claim_step(
            pol, MB, False, OV, params, sparams, su["q_arr"], su["cumsvc"], flt, st, *x
        )

    _, rec = jax.lax.scan(body, st0, (su["u"], su["stalls"]))
    _, claimed = jp._scatter_claims(rec, su["qid"], su["rank"], su["cumsvc"])
    return rec, jops.pack_bits_u32(claimed)


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("fault", ["none", "crash_lease_straggler"])
def test_claim_records_equal_reference_scan(fault, name):
    req, _, su, _ = _scenario(fault)[name]
    lane = 3  # deschedule_prob > 0, batch 8
    params, traffic, fparams, sparams, _ = _blocks(req)
    rec_j, words_j = _ref_records(
        jp.build_policy(name),
        jax.tree_util.tree_map(lambda x: x[lane], params),
        jax.tree_util.tree_map(lambda x: x[lane], sparams),
        {k: v[lane] for k, v in su.items()},
    )
    tsu = tp.setups_from_reference({k: v[lane : lane + 1] for k, v in su.items()})
    lp = jp.default_lane_params(**req["lane_params"])
    lanes = tp._lane_tensors(lp, tp.LaneParams, LANES, "cpu")
    tparams = tp.LaneParams(*(x[lane : lane + 1] for x in lanes))
    st = tp._init_state(1, W, "cpu")
    pol = make_torch_policy(name)
    steps = [
        tp._claim_step(pol, MB, tparams, tsu, st, tsu.u[:, s], tsu.stalls[:, s])
        for s in range(S_PAD)
    ]
    rec = tp.ClaimRecord(*(torch.stack(x, dim=1) for x in zip(*steps)))
    for f in ("q", "ptr", "k", "slow"):
        np.testing.assert_array_equal(
            getattr(rec, f)[0].numpy(), np.asarray(getattr(rec_j, f)), err_msg=f
        )
    np.testing.assert_allclose(rec.t1[0].numpy(), np.asarray(rec_j.t1), rtol=RTOL)
    _, claimed = tp._scatter_claims(rec, tsu.qid, tsu.rank, tsu.cumsvc)
    words = tops.pack_bits_u32(claimed)[0].numpy().view(np.uint32)
    np.testing.assert_array_equal(words, np.asarray(words_j))
    assert int(rec.k.sum()) > 0
    if fault != "none" and name in ("corec", "locked", "adaptive-batch"):
        # idle workers tie at t=0: both engines hand the first claim to
        # worker 0, the straggler (slow == 3)
        assert float(rec.slow[0, 0]) == 3.0
