"""The port's TCP lane engine vs ``repro.core.tcpjax``, NewReno (SACK off).

* The packed-bit helpers against the reference's on random, empty, full
  and partial rows: ``ops.first_set_bits`` for k below and above the
  popcount, and the engine's ``_trailing_ones``, ``_recv_prefix``,
  ``_popcnt_rows``, ``_high_seq`` and ``_bit_range``.  Exact.
* The reference's float32 orders: ``jnp.cumsum`` and ``jnp.sum`` under
  ``jax.jit`` on the CPU equal ``_xla_cumsum`` and ``_xla_sum`` bit for
  bit, where ``torch.cumsum`` and ``torch.sum`` do not.
* Parity on the reference's draws: ``_tcp_setup`` under ``jax.jit``
  carried across with ``tcp_setups_from_reference``; all five policies
  fused on both sides, two flows of 32 packets starting at 0 and 37,
  seeds ``np.arange(4)``.  Every output exact, ``fct`` included (the
  summation orders are mirrored).  Scenarios here: the defaults, and
  random + drop-once loss over a batch / deschedule axis.
  ``tests/test_torch_tcp_sack.py`` holds the SACK and fault scenarios.
* Within the port: the compacted engine equals the reference engine bit
  for bit; the send and claim windows stay inside their rows; the
  reference's exactly-once, unfinished-flow and receive-window
  assertions on the port's own draws; the errors.
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
from repro.core.policy import _fused_requests, jax_policies  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import SweepRequest, run_sweep  # noqa: E402
from repro_torch.core import tcptorch as tt  # noqa: E402
from repro_torch.core.policy import make_torch_policy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

POLICIES = jax_policies()
SEEDS = np.arange(4)
N_PKTS = np.array([32, 32])
T_START = np.array([0.0, 37.0], np.float32)
F32 = np.float32
#: a claim-batch and deschedule axis over the four lanes
LANE = dict(
    batch=np.array([1, 4, 16, 64], F32),
    deschedule_prob=np.array([0.0, 2e-2, 5e-3, 2e-2], F32),
)
SCENARIOS = {
    "defaults": {},
    "loss": dict(
        lane_params=LANE,
        tcp_params=dict(loss_rate=0.03, loss_every=np.array([0, 7, 0, 11], F32)),
    ),
    "sack": dict(
        lane_params=LANE,
        tcp_params=dict(
            sack=True,
            loss_rate=0.05,
            pkt_budget=np.array([1 << 30, 10, 1 << 30, 1 << 30], F32),
            send_burst=8,
        ),
    ),
    # worker 0 (flow 0's RSS queue) dies mid-run; worker 1 serves 3x slower
    "faults": dict(
        lane_params=LANE,
        fault_params=dict(
            crash_t=150.0, crash_worker=0.0, straggler=3.0, straggler_worker=1.0
        ),
    ),
}



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The lane tensors are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _as_np(x):
    a = np.asarray(x)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


# ---------------------------------------------------------------------
# Packed-bit helpers
# ---------------------------------------------------------------------
def _rows(seed: int, rows: int = 64, mw: int = 4):
    """uint32 rows: random, empty, full, a full prefix then random words,
    single bits, and sparse rows."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(rows, mw), dtype=np.uint64)
    w[0] = 0
    w[1] = 0xFFFFFFFF
    w[2, :2] = 0xFFFFFFFF
    w[3] = 0
    w[3, mw - 1] = 1 << 31
    w[4:12] &= rng.integers(0, 2**32, size=(8, mw), dtype=np.uint64)
    w[12:20] = 0
    w[12:20, rng.integers(0, mw, 8)] = 1 << rng.integers(0, 32, 8).astype(np.uint64)
    w[20, 0] = 0x7FFFFFFF
    return w.astype(np.uint32)


@pytest.mark.parametrize("k", [1, 3, 8, 32, 70])
def test_first_set_bits_equals_reference(k):
    words = _rows(k)
    want = np.stack([np.asarray(jops.first_set_bits(jnp.asarray(r), k)) for r in words])
    got = tops.first_set_bits(torch.from_numpy(words.astype(np.int64)), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and on the int32 bit pattern the claim words travel in
    got32 = tops.first_set_bits(torch.from_numpy(words.view(np.int32)), k)
    np.testing.assert_array_equal(got32.numpy(), want)


def test_tcp_bit_helpers_equal_reference():
    words = _rows(7)
    t = torch.from_numpy(words.astype(np.int64))
    want_to = np.asarray(jax.vmap(jax.vmap(tj._trailing_ones))(jnp.asarray(words)))
    np.testing.assert_array_equal(tt._trailing_ones(t).numpy(), want_to)
    for m_bits in (1, 40, 100, 128):
        want = np.asarray(jax.vmap(lambda r: tj._recv_prefix(r, m_bits))(words))
        np.testing.assert_array_equal(tt._recv_prefix(t, m_bits).numpy(), want)
    np.testing.assert_array_equal(
        tt._popcnt_rows(t).numpy(), np.asarray(tj._popcnt_rows(jnp.asarray(words)))
    )
    np.testing.assert_array_equal(
        tt._high_seq(t).numpy(), np.asarray(jax.vmap(tj._high_seq)(words))
    )
    rng = np.random.default_rng(3)
    lo = rng.integers(-3, 140, 200).astype(np.int32)
    hi = rng.integers(-3, 140, 200).astype(np.int32)
    lo[:3], hi[:3] = (0, 32, 5), (31, 63, 4)  # whole words, an empty range
    want = np.asarray(jax.vmap(lambda a, b: tj._bit_range(a, b, 4))(lo, hi))
    got = tt._bit_range(torch.from_numpy(lo).long(), torch.from_numpy(hi).long(), 4)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [5, 16, 17, 33, 64, 100, 300])
def test_summation_orders_equal_xla(n):
    """XLA's CPU orders for ``cumsum`` (blocks of 16) and ``sum`` (blocks
    of 32, the slack padded on both sides), mirrored bit for bit."""
    rng = np.random.default_rng(n)
    x = np.exp(rng.normal(size=(500, n)) * 0.35).astype(F32)
    x[:, rng.integers(0, n)] = 0.0
    t1 = (rng.random(500) * 1000).astype(F32)
    f = jax.jit(jax.vmap(lambda a, r: (a + jnp.cumsum(r), a + jnp.sum(r))))
    want_c, want_s = (np.asarray(v) for v in f(t1, x))
    xt, tt1 = torch.from_numpy(x), torch.from_numpy(t1)
    np.testing.assert_array_equal((tt1[:, None] + tt._xla_cumsum(xt)).numpy(), want_c)
    np.testing.assert_array_equal((tt1 + tt._xla_sum(xt)).numpy(), want_s)
    if n == 64:  # why the orders are written out: torch's own differ
        assert ((tt1[:, None] + torch.cumsum(xt, 1)).numpy() != want_c).any()


# ---------------------------------------------------------------------
# Parity on the reference's draws
# ---------------------------------------------------------------------
def _budgets(n_pkts, chunk: int = 64):
    total = int(np.sum(n_pkts))
    tb = total + total // 8 + 32
    return tb, -(-(3 * tb + len(n_pkts) + 64) // chunk) * chunk


def _ref_consts(req, tb: int, s_pad: int) -> dict:
    """The reference's ``_tcp_setup`` draws of one request, under jax.jit
    (eager vmap differs by an ulp), as numpy."""
    tp = tj.default_tcp_params(**(req.get("tcp_params") or {}))
    tp.pop("sack", None)
    tp.pop("send_burst", None)
    lanes = len(req["seeds"])
    tcp = tj.TcpParams(*jp._broadcast_lanes(tp, tj.TcpParams._fields, lanes))
    seeds = jnp.asarray(np.asarray(req["seeds"], np.uint32))
    setup = functools.partial(tj._tcp_setup, tx_budget=tb, n_steps=s_pad)
    return {k: np.asarray(v) for k, v in jax.jit(jax.vmap(setup))(tcp, seeds).items()}


@functools.lru_cache(maxsize=None)
def scenario(name: str):
    """Reference and port results of one scenario, five policies fused on
    both sides, the port on the reference's draws: {policy: (ref, port)}."""
    reqs = _fused_requests(SEEDS, **SCENARIOS[name])
    ref = tj.run_tcp_lanes_fused(
        reqs, n_pkts=N_PKTS, t_start=T_START, prefix_impl="xla"
    )
    tb, s_pad = _budgets(N_PKTS)
    setups = [tt.tcp_setups_from_reference(_ref_consts(r, tb, s_pad)) for r in reqs]
    port = tt.run_tcp_lanes_fused(
        reqs, n_pkts=N_PKTS, t_start=T_START, device="cpu", setups=setups
    )
    return {r["policy"]: (a, b) for r, a, b in zip(reqs, ref, port)}


def assert_port_equals_reference(name: str, policy: str):
    ref, port = scenario(name)[policy]
    for f in tj.TcpLaneResult._fields:
        want, got = _as_np(getattr(ref, f)), getattr(port, f).numpy()
        assert got.shape == want.shape, f
        if want.dtype == np.int32:
            assert got.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, err_msg=f"{name}/{policy}: {f}")
    return ref, port


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["defaults", "loss"])
def test_port_equals_reference_on_its_draws(name, policy):
    ref, _ = assert_port_equals_reference(name, policy)
    sends = np.asarray(ref.sends)
    assert np.asarray(ref.done).all()
    assert (np.asarray(ref.claimed_prefix) == sends).all()
    if name == "loss":  # the scenario shows its loss
        assert np.asarray(ref.retransmissions).sum() > 0
        assert (sends > N_PKTS.sum()).any()


# ---------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------
ENG_KW = dict(n_pkts=[40, 40], t_start=[0.0, 13.0], n_workers=4, device="cpu")


def test_compacted_engine_equals_reference_engine():
    reqs = _fused_requests(np.arange(3), lane_params=dict(deschedule_prob=2e-3))
    com = tt.run_tcp_lanes_fused(reqs, engine="compacted", **ENG_KW)
    ref = tt.run_tcp_lanes_fused(reqs, engine="reference", **ENG_KW)
    for r, a, b in zip(reqs, com, ref):
        for f in tt.TcpLaneResult._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (r["policy"], f)
        assert bool(a.done.all())
        assert torch.equal(a.claimed_popcount, a.sends)


@pytest.mark.parametrize("sack", [False, True])
def test_send_and_claim_windows_stay_inside_their_rows(sack):
    """The reference's dynamic slices clamp out-of-range starts; the
    port's gathers would raise instead.  Step a starved budget through
    every policy and check the bounds the windows rely on after each
    step: nsend <= tx_budget, qptr <= qapp <= tx_budget (so a burst at
    qapp and a claim window at qptr end inside rows of tx_budget +
    send_burst and tx_budget + max(max_batch, send_burst))."""
    n_arr, tb, s_pad, sb, mb = np.array([30, 30]), 40, 256, 32, 64
    for name in POLICIES:
        c, params, tcp, su, st = tt._segment(
            make_torch_policy(name), np.arange(3), tt.tcp_lane_defaults(),
            tt.default_tcp_params(loss_rate=0.05), tt.default_fault_params(),
            sack, n_arr, np.zeros(2, F32), 4, mb, tb, s_pad, sb, "cpu",
        )
        assert st["qidx"].shape[2] == tb + max(mb, sb)
        assert st["qarr"].shape[2] == st["txf"].shape[1] == tb + sb
        for s in range(s_pad):
            tt._tcp_step(c, params, tcp, su, st, su.u[:, s], su.stalls[:, s])
            assert (st["nsend"] <= tb).all()
            assert (st["qapp"] <= tb).all() and (st["qptr"] <= st["qapp"]).all()
        assert (st["nsend"] == tb).all(), "the budget was not starved"


@pytest.mark.parametrize("name", POLICIES)
def test_exactly_once_and_completion_own_draws(name):
    batches = np.array([1, 8, 32], dtype=np.float32)
    res = tt.run_tcp_lanes(
        name,
        np.arange(3),
        n_pkts=120,
        lane_params=dict(batch=batches, max_batch=batches),
        device="cpu",
    )
    assert bool(res.done.all())
    for f in ("claimed_popcount", "claimed_prefix", "items"):
        assert torch.equal(getattr(res, f), res.sends), f
    assert bool(torch.isfinite(res.fct).all()) and bool((res.fct > 0).all())
    assert bool((res.sends >= 120).all())


def test_unfinished_flows_report_not_done():
    res = tt.run_tcp_lanes("corec", np.arange(2), n_pkts=200, n_steps=40, device="cpu")
    assert not bool(res.done.any())
    assert bool(torch.isinf(res.fct).all())


def test_receive_window_cap_stretches_fct():
    kw = dict(n_pkts=300, device="cpu")
    open_w = tt.run_tcp_lanes("corec", np.arange(3), tcp_params=dict(rwnd=512), **kw)
    capped = tt.run_tcp_lanes("corec", np.arange(3), tcp_params=dict(rwnd=4), **kw)
    assert bool(capped.done.all())
    assert float(capped.fct.mean()) > 2.0 * float(open_w.fct.mean())


def test_tcp_sweep_errors():
    req = SweepRequest(
        scenario="tcp", policies=["corec"], seeds=np.arange(2), n_packets=20
    )
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_sweep(req)
    with pytest.raises(RuntimeError, match="init_process_group"):
        run_sweep(SweepRequest(scenario="tcp", shards=2, n_packets=20), device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tt.run_tcp_lanes("corec", np.arange(2), n_pkts=20, shards=2, device="cpu")
    with pytest.raises(ValueError, match="unknown sweep knobs"):
        tt.run_tcp_lanes("corec", [0], n_pkts=20, tcp_params=dict(rwin=4), device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tt.run_tcp_lanes("corec", [0], n_pkts=20, engine="warp", device="cpu")
    with pytest.raises(ValueError, match="t_start"):
        tt.run_tcp_lanes("corec", [0], n_pkts=[20, 20], t_start=[0.0], device="cpu")
