"""The port's serving mode vs ``repro.core.jaxplane`` on the same state.

The reference draws every lane's traffic with ``_lane_setup`` in serving
mode (jitted and vmapped, as its fused call does), the draws are carried
across with ``torchplane.setups_from_reference`` and both engines run on
them, on the CPU, for all five policies in one fused call each:

* a plain serving segment (diurnal arrivals cut at a horizon) and one
  with admission and autoscale armed (knobs swept per lane);
* integer outputs exact, floats at ``rtol=1e-6`` with the same +-inf
  pattern (XLA may contract a multiply-add where PyTorch rounds twice,
  and sums fp32 in its own order; the port sums the mean in float64);
* the per-step ClaimRecords of one lane per policy, ``shed`` included,
  from a ``lax.scan`` over ``jaxplane._claim_step``, and the packed
  claim words of that lane;
* the port's own setup (horizon, attempt expansion, queue views, the
  serving fields) built from the reference's traffic: integer arrays
  exactly, float arrays at ``rtol=1e-6``.

``tests/test_torch_overload_plane.py`` runs the overload scenarios
(retries, timeouts, hedges, response loss, the breaker, the
latency-reactive gate) through the same helpers.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import jaxplane as jp  # noqa: E402
from repro.core.policy import (  # noqa: E402
    _fused_requests,
    jax_policies,
    overload_defaults,
)
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import torchplane as tp  # noqa: E402
from repro_torch.core.policy import make_torch_policy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

POLICIES = jax_policies()
N, W, MB, N_FLOWS, CHUNK, LANES = 120, 4, 16, 256, 32, 4
RTOL = 1e-6
REC_LANE = 2

#: scenario -> (workload, traffic knobs, serving knobs per policy)
SCENARIOS = {
    "plain": (
        "diurnal",
        dict(rate=3.0),
        lambda name: dict(horizon=20.0, slo_target=15.0),
    ),
    "admission_autoscale": (
        "diurnal",
        dict(rate=4.0),
        lambda name: dict(
            horizon=18.0,
            slo_target=15.0,
            admit_limit=np.array([np.inf, 8.0, 4.0, 2.0], np.float32),
            base_workers=2.0,
            scale_backlog=np.array([np.inf, 4.0, 8.0, 2.0], np.float32),
        ),
    ),
    "retries_timeout": (
        "udp",
        dict(rate=3.0),
        lambda name: dict(
            timeout=2.0,
            retries=2,
            backoff=1.0,
            jitter=0.5,
            hedge=0.5,
            horizon=60.0,
            drop_rate=np.array([0.0, 0.1, 0.1, 0.3], np.float32),
        ),
    ),
    # the registry's graceful preset on the shared queues (3 copies per
    # request), a breaker without retries on the per-worker queues (one
    # copy, padded to the shared slot count)
    "breaker": (
        "udp",
        dict(rate=3.0),
        lambda name: (
            dict(overload_defaults(name), drop_rate=0.1)
            if jp.build_policy(name).shared
            else dict(timeout=2.0, breaker_age=0.5, admit_limit=1.0, drop_rate=0.1)
        ),
    ),
    # naive retries (backoff = jitter = 0: a retry can land on another
    # request's copy at the same instant) and the latency-reactive gate
    "scale_latency": (
        "udp",
        dict(rate=3.5),
        lambda name: dict(
            timeout=2.0,
            retries=1,
            scale_latency=3.0,
            base_workers=2.0,
            horizon=30.0,
        ),
    ),
}
#: the scenarios of this file; tests/test_torch_overload_plane.py runs
#: the others
SERVING = ["plain", "admission_autoscale"]
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


def _blocks(req):
    def lanes(defaults, cls, kw):
        return cls(*jp._broadcast_lanes(defaults(**kw), cls._fields, LANES))

    sp = jp.default_serving_params(**req["serving_params"])
    ov = jp._pop_overload(sp)
    return ov, (
        lanes(jp.default_lane_params, jp.LaneParams, req["lane_params"]),
        lanes(jp.default_traffic_params, jp.TrafficParams, req["traffic_params"]),
        lanes(jp.default_fault_params, jp.FaultParams, req["fault_params"]),
        lanes(lambda **kw: kw, jp.ServingParams, sp),
        jnp.asarray(np.arange(LANES, dtype=np.uint32)),
    )


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _ref_setup(pol, workload, n_slots, s_pad, ov, params, traffic, fparams, sp, seeds):
    """The reference's serving setups, and the raw traffic they come from
    (one jitted call, so both see the same arithmetic)."""

    def one(params, traffic, fparams, sp, seed):
        su = jp._lane_setup(
            pol, workload, "HT", N, n_slots, N_FLOWS, W, s_pad, True, ov,
            params, traffic, fparams, sp, seed,
        )
        kt, _ = jax.random.split(jax.random.PRNGKey(seed))
        raw = jp._gen_traffic(kt, traffic, workload, "HT", N, N_FLOWS)
        return su, raw

    return jax.vmap(one)(params, traffic, fparams, sp, seeds)


def _shared(name: str) -> bool:
    return jp.build_policy(name).shared


def requests_for(scenario: str):
    workload, traffic, knobs = SCENARIOS[scenario]
    reqs = _fused_requests(
        np.arange(LANES), traffic_params=traffic, fault_params={}
    )
    for r in reqs:
        r["serving_params"] = knobs(r["policy"])
    return workload, reqs


@functools.lru_cache(maxsize=None)
def scenario_runs(scenario: str):
    """Reference results, reference setups (with their raw traffic) and
    port results of one scenario, all five policies fused on both
    sides."""
    workload, reqs = requests_for(scenario)

    def fresh():  # _fused_lanes pops the static knobs out of its dicts
        return [dict(r, serving_params=dict(r["serving_params"])) for r in reqs]

    ref = jp._fused_lanes(
        fresh(),
        workload=workload,
        service="HT",
        serving=True,
        n_packets=N,
        n_workers=W,
        max_batch=MB,
        n_flows=N_FLOWS,
        chunk=CHUNK,
        return_times=True,
    )
    blocks = [_blocks(r) for r in reqs]
    n_slots = N * max(ov.cpr for ov, _ in blocks)
    s_pad = -(-n_slots // CHUNK) * CHUNK
    sus, raws = [], []
    for r, (ov, blk) in zip(reqs, blocks):
        # a setup depends on the policy through its steering alone
        steer = jp.build_policy("corec" if _shared(r["policy"]) else "scaleout")
        su, raw = _ref_setup(steer, workload, n_slots, s_pad, ov, *blk)
        sus.append({k: np.asarray(v) for k, v in su.items()})
        raws.append(tuple(np.asarray(x) for x in raw))
    port = tp._fused_lanes(
        fresh(),
        workload=workload,
        service="HT",
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
    return dict(zip(names, zip(reqs, blocks, ref, sus, raws, port))), n_slots


def assert_port_equals_reference(scenario: str, name: str) -> None:
    runs, _ = scenario_runs(scenario)
    _, _, ref, _, _, port = runs[name]
    for f in INT_FIELDS:
        want, got = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert got.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, err_msg=f"{scenario}/{name}: {f}")
    for f in FLOAT_FIELDS:
        want, got = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=f)
        np.testing.assert_allclose(
            got, want, rtol=RTOL, err_msg=f"{scenario}/{name}: {f}"
        )
    # exactly-once: every claim bit is a delivery, a late or lost serve,
    # or a shed; the prefix counts slots from seqno 0 (a stranded tail
    # of scaleout's gated queues leaves holes)
    pop = np.asarray(ref.claimed_popcount)
    items, shed = np.asarray(ref.items), np.asarray(ref.shed)
    assert (pop == items + shed).all()
    delivered, expired = np.asarray(ref.delivered), np.asarray(ref.expired)
    assert (pop == delivered + expired + shed).all()
    assert (np.asarray(ref.claimed_prefix) <= pop).all()


@functools.partial(jax.jit, static_argnums=(0, 1))
def _ref_records(pol, ov, params, sp, su):
    st0 = jax.tree_util.tree_map(lambda x: x[0], jp._init_state(1, W))
    flt = (su["crash_w"], su["slow_w"], su["lease"])

    def body(st, x):
        return jp._claim_step(
            pol, MB, True, ov, params, sp, su["q_arr"], su["cumsvc"], flt, st, *x
        )

    _, rec = jax.lax.scan(body, st0, (su["u"], su["stalls"]))
    _, claimed = jp._scatter_claims(rec, su["qid"], su["rank"], su["cumsvc"])
    return rec, jops.pack_bits_u32(claimed)


def assert_records_equal_reference(scenario: str, name: str) -> None:
    runs, _ = scenario_runs(scenario)
    req, (ov, blk), _, su, _, _ = runs[name]
    params, _, _, sp, _ = blk
    lane = REC_LANE
    rec_j, words_j = _ref_records(
        jp.build_policy(name),
        ov,
        jax.tree_util.tree_map(lambda x: x[lane], params),
        jax.tree_util.tree_map(lambda x: x[lane], sp),
        {k: v[lane] for k, v in su.items()},
    )
    tsu = tp.setups_from_reference({k: v[lane : lane + 1] for k, v in su.items()})
    lp = tp._lane_tensors(
        tp.default_lane_params(**req["lane_params"]), tp.LaneParams, LANES, "cpu"
    )
    tparams = tp.LaneParams(*(x[lane : lane + 1] for x in lp))
    tsp = tp.ServingParams(
        *(torch.tensor(np.asarray(x)[lane : lane + 1]) for x in sp)
    )
    st = tp._init_state(1, W, "cpu")
    pol = make_torch_policy(name)
    steps = [
        tp._claim_step(
            pol, MB, tparams, tsu, st, tsu.u[:, s], tsu.stalls[:, s], tsp, ov
        )
        for s in range(tsu.u.shape[1])
    ]
    rec = tp.ClaimRecord(*(torch.stack(x, dim=1) for x in zip(*steps)))
    for f in ("q", "ptr", "k", "slow", "shed"):
        np.testing.assert_array_equal(
            getattr(rec, f)[0].numpy(), np.asarray(getattr(rec_j, f)), err_msg=f
        )
    np.testing.assert_allclose(rec.t1[0].numpy(), np.asarray(rec_j.t1), rtol=RTOL)
    _, claimed = tp._scatter_claims(rec, tsu.qid, tsu.rank, tsu.cumsvc)
    words, _, _ = tops.claim_check(claimed, tsu.cumsvc.shape[-1])
    np.testing.assert_array_equal(words[0].numpy().view(np.uint32), np.asarray(words_j))
    assert int(rec.k.sum()) > 0


def assert_setup_equals_reference(scenario: str, name: str, monkeypatch) -> None:
    """The port's _lane_setup on the reference's raw traffic: the serving
    branch (horizon, attempt expansion, pad slots, queue views, the
    serving fields) gives the reference's integer arrays exactly and its
    float arrays at ``RTOL``: XLA computes the service prefix sums in an
    order of its own and contracts ``backoff + jitter * u`` into one
    multiply-add, an ulp from PyTorch's two roundings."""
    runs, n_slots = scenario_runs(scenario)
    req, (ov, blk), _, su, raw, _ = runs[name]
    workload = SCENARIOS[scenario][0]
    arr, svc, flows = (torch.tensor(x) for x in raw)
    monkeypatch.setattr(
        tp, "_gen_traffic", lambda *a: (arr, svc, flows.to(torch.int64))
    )
    sp = tp.ServingParams(*(torch.tensor(np.asarray(x)) for x in blk[3]))
    lanes = len(arr)

    def t(defaults, cls, kw):
        return tp._lane_tensors(defaults(**kw), cls, lanes, "cpu")

    port = tp._lane_setup(
        make_torch_policy(name),
        workload,
        "HT",
        N,
        N_FLOWS,
        W,
        su["u"].shape[1],
        t(tp.default_traffic_params, tp.TrafficParams, req["traffic_params"]),
        t(tp.default_fault_params, tp.FaultParams, {}),
        np.arange(LANES, dtype=np.uint32),
        n_slots=n_slots,
        sparams=sp,
        ov=ov,
    )
    want = tp.setups_from_reference(su)
    for f in ("qid", "rank", "parent", "att", "offered", "offered_req", "lseed"):
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), getattr(want, f).numpy(), err_msg=f
        )
    for f in ("arr", "arr0", "q_arr", "cumsvc", "crash_w", "slow_w", "lease"):
        got, exp = getattr(port, f).numpy(), getattr(want, f).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(exp), err_msg=f)
        np.testing.assert_allclose(got, exp, rtol=RTOL, err_msg=f)


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("scenario", SERVING)
def test_serving_port_equals_reference_on_injected_setups(scenario, name):
    assert_port_equals_reference(scenario, name)
    runs, _ = scenario_runs(scenario)
    ref = runs[name][2]
    assert (np.asarray(ref.offered) < N).all()  # the horizon cut
    if scenario == "admission_autoscale":
        assert np.asarray(ref.shed).sum() > 0


@pytest.mark.parametrize("name", POLICIES)
def test_serving_claim_records_equal_reference_scan(name):
    assert_records_equal_reference("admission_autoscale", name)


@pytest.mark.parametrize("name", ["corec", "scaleout"])
@pytest.mark.parametrize("scenario", SERVING)
def test_serving_setup_equals_reference_on_its_traffic(scenario, name, monkeypatch):
    assert_setup_equals_reference(scenario, name, monkeypatch)
