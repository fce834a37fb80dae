"""The port's DES plane against the reference's, on the CPU.

``repro_torch.core`` keeps its own copies of the discrete-event core and
its scenario layers (``des``, ``traffic``, ``reorder``, ``queueing``,
``forwarder``, ``tcp`` and the DES half of ``servingtorch``).  They draw
from the same numpy generators in the same order as the reference's, so:

* the port reproduces ``tests/golden/des_parity.json`` (integers and the
  order CRCs exactly, floats within 1e-9 relative), through the recipe
  ``chip_smoke.py`` phase 18a runs on the card's host;
* every scenario layer equals the reference's outputs exactly, for all
  five policies, on the same inputs: UDP and MAWI forwarding (fault-free
  and with a crash, a lease and a straggler), TCP (NewReno with random
  loss, and SACK), queueing (``simulate_policy``, ``simulate_protocol``,
  ``sweep_load``) and ``simulate_serving_des`` with the overload knobs;
* the traffic generators and the RFC 4737 metrics equal the
  reference's (the metrics on hypothesis permutations).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
from hypothesis_compat import given, settings, st

from repro.core import forwarder as rfwd
from repro.core import queueing as rq
from repro.core import reorder as rreorder
from repro.core import servingjax as rserving
from repro.core import tcp as rtcp
from repro.core import traffic as rtraffic
from repro.core.faults import FaultSpec as RFaultSpec
from repro_torch.core import forwarder as fwd
from repro_torch.core import queueing as q
from repro_torch.core import reorder
from repro_torch.core import servingtorch as serving
from repro_torch.core import tcp
from repro_torch.core import traffic
from repro_torch.core.faults import FaultSpec
from repro_torch.core.policy import available_policies

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests" / "golden" / "des_parity.json").read_text())
POLICIES = available_policies()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()


# ---------------------------------------------------------------------
# The golden of the seed simulators
# ---------------------------------------------------------------------
@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_port_reproduces_des_golden(key):
    assert CHIP.GOLDEN_RTOL == 1e-9  # tests/test_des_parity.py's RTOL
    got = CHIP.des_golden(key)
    assert CHIP.golden_mismatches(got, GOLDEN[key]) == [], key


def test_golden_check_catches_a_one_ulp_integer_and_a_float_past_rtol():
    want = GOLDEN["fwd_corec_udp"]
    off = dict(want, max_distance=want["max_distance"] + 1)
    assert [f for f, *_ in CHIP.golden_mismatches(off, want)] == ["max_distance"]
    off = dict(want, mean_sojourn=want["mean_sojourn"] * (1 + 3e-9))
    assert [f for f, *_ in CHIP.golden_mismatches(off, want)] == ["mean_sojourn"]


# ---------------------------------------------------------------------
# Scenario layers, port == reference exactly
# ---------------------------------------------------------------------
def _fwd_pair(pkts_fn, policy, **cfg_kw):
    """(port, reference) forwarder outputs: completions and stats."""
    out = []
    for mod, spec_cls, pkts in (
        (fwd, FaultSpec, pkts_fn(traffic)),
        (rfwd, RFaultSpec, pkts_fn(rtraffic)),
    ):
        kw = dict(cfg_kw)
        kw["faults"] = tuple(spec_cls(**f) for f in kw.get("faults", ()))
        stats: dict = {}
        done = mod.simulate_forwarder(
            pkts, mod.ForwarderConfig(policy=policy, **kw), stats_out=stats
        )
        out.append(([(t, p.seqno, p.flow, p.flow_seq) for t, p in done], stats))
    return out


def _udp(mod):
    return mod.udp_stream(3000, rate_pps=45.0, size=64, seed=3, n_flows=256)


def _mawi(mod):
    return mod.mawi_mix(3000, mean_rate_pps=35.0, seed=22)


FAULTS = (
    dict(worker=1, t=20.0),
    dict(worker=2, kind="straggler", t=0.0, factor=3.0),
)


def _tcp_pair(policy, flows, **cfg_kw):
    return [
        [dataclasses.astuple(r) for r in mod.simulate_tcp(
            flows, mod.TcpSimConfig(policy=policy, **cfg_kw)
        )]
        for mod in (tcp, rtcp)
    ]


def _queue_pair(fn_name, *args, **kw):
    out = []
    for mod in (q, rq):
        r = getattr(mod, fn_name)(*args, **kw)
        out.append((r.sojourn.tolist(), r.util))
    return out


def _serving_pair(policy, **cfg_kw):
    out = []
    for mod in (serving, rserving):
        r = mod.simulate_serving_des(
            mod.ServingSimConfig(policy=policy, **cfg_kw)
        )
        fields = dataclasses.asdict(r)
        fields["sojourns"] = r.sojourns.tolist()
        out.append(fields)
    return out


OVERLOAD = dict(
    arrival="diurnal",
    rate=4.5,
    capacity=500,
    horizon=100.0,
    slo_target=20.0,
    admit_limit=24.0,
    base_workers=2.0,
    scale_backlog=16.0,
    timeout=12.0,
    retries=2,
    backoff=4.0,
    jitter=1.0,
    hedge=6.0,
    breaker_age=30.0,
    drop_rate=0.1,
    deschedule_prob=0.01,
    seed=5,
)

SCENARIOS = {
    "udp": lambda p: _fwd_pair(_udp, p, seed=7, deschedule_prob=5e-4),
    "mawi": lambda p: _fwd_pair(_mawi, p, seed=7, deschedule_prob=5e-3),
    "udp-faulted": lambda p: _fwd_pair(_udp, p, seed=7, faults=FAULTS, lease=2.0),
    "tcp-loss": lambda p: _tcp_pair(
        p,
        [(i, 7, i * 1.5) for i in range(24)],
        service_mean=3.0,
        link_pps=2.0,
        deschedule_prob=5e-3,
        loss_rate=0.02,
        seed=17,
    ),
    "tcp-sack": lambda p: _tcp_pair(
        p,
        [(0, 160, 0.0), (1, 120, 30.0)],
        sack=True,
        loss_rate=0.03,
        loss_every=10,
        seed=4,
    ),
    "queueing": lambda p: _queue_pair(
        "simulate_policy", p, 3.4, 1.0, 4, 3000, "LN", seed=2, batch=4,
        claim_overhead=0.05,
    ),
    "protocol": lambda p: _queue_pair(
        "simulate_protocol", 4, p, 3.5, 1.0, claim_overhead=0.1,
        cas_retry_cost=0.2, batch=16, n_jobs=3000, seed=5,
    ),
    "serving": lambda p: _serving_pair(p, **OVERLOAD),
    "serving-bursty": lambda p: _serving_pair(
        p, arrival="bursty", rate=3.5, capacity=600, slo_target=15.0, seed=3
    ),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("policy", POLICIES)
def test_scenario_equals_reference(policy, scenario):
    port, ref = SCENARIOS[scenario](policy)
    assert port == ref, (policy, scenario)


def test_scenarios_exercise_their_knobs():
    """The equality above is not vacuous: faults strand and reclaim,
    random loss retransmits, SACK recovers, the overload client sheds,
    expires and retries."""
    _, stats = _fwd_pair(_udp, "corec", seed=7, faults=FAULTS, lease=2.0)[0]
    assert stats["dead_workers"] == 1 and stats["reclaims"] >= 1
    _, stats = _fwd_pair(_udp, "locked", seed=7, faults=FAULTS, lease=2.0)[0]
    assert stats["wedged"]
    loss = _tcp_pair("corec", [(i, 7, i * 1.5) for i in range(24)],
                     service_mean=3.0, link_pps=2.0, loss_rate=0.02, seed=17)[0]
    assert sum(r[3] for r in loss) > 0  # retransmissions
    sack = _tcp_pair("corec", [(0, 160, 0.0), (1, 120, 30.0)], sack=True,
                     loss_rate=0.03, loss_every=10, seed=4)[0]
    assert sum(r[3] for r in sack) > 0
    r = _serving_pair("scaleout", **OVERLOAD)[0]
    assert r["shed"] > 0 and r["expired"] > 0 and r["attempts"] > r["offered"]
    assert 0 < r["goodput"] < r["offered"]


def test_sweep_load_equals_reference():
    kw = dict(service="D", n_jobs=4000, seed=3)
    assert q.sweep_load(4, [0.5, 0.9], **kw) == rq.sweep_load(4, [0.5, 0.9], **kw)


def test_scale_out_assignments_equal_reference():
    for assign in ("hash", "rr"):
        got = q.simulate_scale_out(3.0, 1.0, 4, 3000, "M", seed=4, assign=assign)
        want = rq.simulate_scale_out(3.0, 1.0, 4, 3000, "M", seed=4, assign=assign)
        assert got.sojourn.tolist() == want.sojourn.tolist() and got.util == want.util
    with pytest.raises(ValueError):
        q.simulate_scale_out(3.0, 1.0, 4, 10, assign="zigzag")


# ---------------------------------------------------------------------
# Traffic generators and the RFC 4737 metrics
# ---------------------------------------------------------------------
GENERATORS = {
    "udp": lambda m: m.udp_stream(500, 12.0, seed=9, n_flows=8),
    "udp-cbr": lambda m: m.udp_stream(200, 3.0, size=1500, poisson=False),
    "mawi": lambda m: m.mawi_mix(500, 2.5, seed=22, n_flows=64),
    "flow": lambda m: m.flow_packets(m.FlowSpec(3, 10_000, t_start=2.5)),
    "diurnal": lambda m: m.diurnal_times(800, 4.0, amp=0.6, seed=1).tolist(),
    "heavy-tail": lambda m: m.heavy_tail_service(800, 1.0, seed=2).tolist(),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_traffic_generator_equals_reference(name):
    def plain(x):
        return [dataclasses.astuple(p) for p in x] if name in (
            "udp", "udp-cbr", "mawi", "flow"
        ) else x

    assert plain(GENERATORS[name](traffic)) == plain(GENERATORS[name](rtraffic))
    assert traffic.MSS == rtraffic.MSS


@settings(max_examples=60, deadline=None)
@given(seq=st.integers(1, 300).flatmap(lambda n: st.permutations(range(n))))
def test_measure_reordering_equals_reference(seq):
    got = dataclasses.astuple(reorder.measure_reordering(seq))
    assert got == dataclasses.astuple(rreorder.measure_reordering(seq))


@settings(max_examples=40, deadline=None)
@given(
    stream=st.lists(st.tuples(st.integers(0, 5), st.integers(0, 40)), max_size=200)
)
def test_per_flow_reordering_equals_reference(stream):
    def plain(reports):
        return {k: dataclasses.astuple(r) for k, r in reports.items()}

    got = plain(reorder.per_flow_reordering(stream))
    assert got == plain(rreorder.per_flow_reordering(stream))


@pytest.mark.parametrize(
    "seq,want",
    [
        (list(range(100)), (0, 0, 0)),
        ([0, 2, 1, 3], (1, 1, 1)),
        ([1, 2, 3, 4, 5, 0, 6, 7], (1, 5, 5)),
    ],
)
def test_reordering_hand_cases(seq, want):
    rep = reorder.measure_reordering(seq)
    assert (rep.n_reordered, rep.max_distance, rep.max_extent) == want
