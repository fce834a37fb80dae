"""The port's serving engine: mirrors of ``tests/test_serving.py`` and
parity with the reference engine.

The mirrors run the port's engine on the CPU (``device="cpu"``, the
kernels' plain versions) with ``tests/test_serving.py``'s TINY config.
The wall-clock test (``test_work_conservation_under_skewed_sessions``)
is not mirrored: it is a timing assertion (ROADMAP.md Queue A, item 13).
The parity tests run the reference engine and the port's on the same
carried parameters and requests and want identical tokens per rid: on
the TINY config, and on the tiny configs of the two cross-attention
families (Whisper, whose engine feeds zero audio frames, and the VLM,
zero image embeddings), under both policies.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.config import ArchConfig as JArchConfig  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.config import ArchConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine, Request  # noqa: E402

TINY_KW = dict(
    name="t",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    attention_impl="xla",
    dtype="float32",
)
TINY = ArchConfig(**TINY_KW)


def _requests(n, new_tokens=4, prompt_len=6, sessions=4, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [
        cls(
            rid=i,
            prompt=list(map(int, rng.integers(2, 200, prompt_len))),
            max_new_tokens=new_tokens,
            session=int(rng.integers(0, sessions)),
        )
        for i in range(n)
    ]


def _engine(seed=0, cfg=TINY, **kw):
    kw.setdefault("eos_token", -1)
    return InferenceEngine(
        cfg,
        EngineConfig(**kw),
        generator=torch.Generator().manual_seed(seed),
        device="cpu",
    )


@pytest.mark.parametrize("policy", ["corec", "rss"])
def test_engine_completes_all_requests(policy):
    eng = _engine(n_slots=4, max_seq=24, n_workers=2, policy=policy)
    res = eng.run(_requests(10), timeout=90)
    assert len(res) == 10
    assert sorted(r.rid for r in res) == list(range(10))
    assert all(len(r.tokens) == 5 for r in res)  # first + 4 decoded
    assert all(r.t_done >= r.t_first_token >= r.t_arrival for r in res)
    assert eng.prefills == 10


def test_greedy_decode_deterministic_across_policies():
    outs = {}
    for policy in ("corec", "rss"):
        eng = _engine(seed=7, n_slots=2, max_seq=24, n_workers=1, policy=policy)
        res = eng.run(_requests(4, seed=5), timeout=90)
        outs[policy] = {r.rid: r.tokens for r in res}
    assert outs["corec"] == outs["rss"]


def test_contiguous_release_order():
    eng = _engine(n_slots=4, max_seq=24, n_workers=1, contiguous_release=True)
    res = eng.run(_requests(8), timeout=90)
    assert len(res) == 8
    assert eng.tail == eng.head  # everything released at drain
    assert sum(eng.release_events) == eng.tail


def test_multilane_slot_rings_release_batched():
    eng = _engine(n_slots=8, max_seq=24, n_workers=2, n_lanes=2)
    res = eng.run(_requests(12), timeout=120)
    assert len(res) == 12
    assert sorted(r.rid for r in res) == list(range(12))
    assert eng.tail == eng.head
    assert (eng.lane_tail == eng.lane_head).all()
    assert sum(eng.release_events) == eng.tail


def test_multilane_matches_single_lane_tokens():
    outs = {}
    for lanes in (1, 2):
        eng = _engine(seed=3, n_slots=4, max_seq=24, n_workers=1, n_lanes=lanes)
        res = eng.run(_requests(6, seed=11), timeout=120)
        outs[lanes] = {r.rid: r.tokens for r in res}
    assert outs[1] == outs[2]


def test_one_layer_one_slot_engine_writes_the_slot_axis():
    """n_layers == n_slots == 1: the reference's shape-matching guess in
    ``_insert`` picks the layer axis here (both have size 1, so the write
    lands in the same place); the port names the slot axis."""
    cfg = TINY.replace(n_layers=1)
    eng = _engine(cfg=cfg, n_slots=1, max_seq=16, n_workers=1)
    res = eng.run(_requests(3, new_tokens=3), timeout=60)
    assert sorted(r.rid for r in res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in res)
    assert eng.tail == eng.head == 3


def test_one_layer_one_slot_rwkv_engine_writes_the_slot_axis():
    """The same case for RWKV6, whose cache leaves differ in rank (``wkv``
    ``[1, 1, H, N, N]``, ``tm_last`` ``[1, 1, 1, d]``): each leaf's slot
    axis comes from its ``cache_specs`` name ``"batch"``."""
    from repro_torch import configs

    cfg = configs.get_tiny("rwkv6-3b").replace(n_layers=1)
    eng = _engine(cfg=cfg, n_slots=1, max_seq=16, n_workers=1)
    assert eng._slot_axis == {"wkv": 1, "tm_last": 1, "cm_last": 1, "lengths": 0}
    res = eng.run(_requests(3, new_tokens=3), timeout=60)
    assert sorted(r.rid for r in res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in res)
    assert eng.tail == eng.head == 3


def test_release_runs_one_batched_done_prefix_per_step(monkeypatch):
    """Every release goes through ops.done_prefix_batch with all lanes'
    rows at once, on the engine's device and through the "auto" impl."""
    calls = []
    real = ops.done_prefix_batch

    def spy(done, start, limit, impl="auto"):
        calls.append((tuple(done.shape), done.device.type, impl))
        return real(done, start, limit, impl=impl)

    monkeypatch.setattr(ops, "done_prefix_batch", spy)
    eng = _engine(n_slots=8, max_seq=24, n_workers=2, n_lanes=4)
    eng.run(_requests(10), timeout=90)
    assert calls and all(c == ((4, 2), "cpu", "auto") for c in calls)
    assert eng.tail == eng.head == 10


class _Late:
    """Requests submitted once ``delay`` seconds have passed."""

    def __init__(self, reqs, delay):
        self.reqs, self.delay = reqs, delay

    def __len__(self):
        return len(self.reqs)

    def __iter__(self):
        time.sleep(self.delay)
        yield from self.reqs


def test_idle_workers_back_off_and_still_serve():
    """The workers find nothing for 0.6 s: they nap longer after each
    empty claim, so that their empty claims over the run number about its
    seconds over the longest nap (half-millisecond polls made 16 times as
    many), and the request that ends the idle stretch is still claimed
    and served."""
    from repro_torch.serving.engine import _IDLE_NAP_S

    eng = _engine(n_slots=2, max_seq=24, n_workers=2)
    t = time.perf_counter()
    res = eng.run(_Late(_requests(1), 0.6), rate=1e9, timeout=60)
    run_s = time.perf_counter() - t
    assert [r.rid for r in res] == [0] and len(res[0].tokens) == 5
    # each worker naps at the longest but for its few shorter naps after
    # the start and after its claim (0.5, 1, 2 and 4 ms)
    assert eng.sched.stats()["empty_polls"] <= 2 * run_s / _IDLE_NAP_S[1] + 20


def test_mapped_done_prefix_refuses_unpinned_memory():
    """The in-place route takes pinned host memory only: pageable CPU
    tensors raise before anything is built or launched, never copied."""
    from repro_torch.kernels.doneprefix import done_prefix_batch_mapped

    done = torch.ones(4, 4, dtype=torch.bool)
    words = [torch.zeros(4, dtype=torch.int32) for _ in range(3)]
    before = done_prefix_batch_mapped.launches
    with pytest.raises(ValueError, match="pinned"):
        done_prefix_batch_mapped(done, *words, stream=None)
    assert done_prefix_batch_mapped.launches == before


def test_engine_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(TINY, EngineConfig(n_slots=2, max_seq=8))


def test_prompt_past_max_seq_raises():
    eng = _engine(n_slots=2, max_seq=4, n_workers=1)
    with pytest.raises(ValueError, match="max_seq"):
        eng._prefill(eng._run_params, eng._make_batch(_requests(1)[0]))


@pytest.fixture(scope="module")
def reference_run():
    """One reference engine run (its prefill jit dominates: ~10-30 s)."""
    jcfg = JArchConfig(**TINY_KW)
    ecfg = dict(n_slots=4, max_seq=24, n_workers=2, eos_token=-1, n_lanes=2)
    eng = JInferenceEngine(jcfg, JEngineConfig(**ecfg), rng=jax.random.PRNGKey(5))
    res = eng.run(_requests(8, seed=13, cls=JRequest), timeout=120)
    params = jax.tree_util.tree_map(np.asarray, eng.params)
    return ecfg, params, {r.rid: r.tokens for r in res}, (eng.head, eng.tail)


def test_port_engine_tokens_equal_reference_engine(reference_run):
    ecfg, params, want, (head, tail) = reference_run
    assert head == tail == 8
    eng = InferenceEngine(
        TINY,
        EngineConfig(**ecfg),
        params=params_from_reference(TINY, params, device="cpu"),
        device="cpu",
    )
    res = eng.run(_requests(8, seed=13), timeout=120)
    assert {r.rid: r.tokens for r in res} == want
    assert eng.head == eng.tail == 8
    assert sum(eng.release_events) == 8


@pytest.fixture(scope="module", params=["whisper-large-v3", "llama-3.2-vision-90b"])
def cross_reference_run(request):
    """One reference engine run per cross-attention family's tiny config
    (the engine's batch carries zero audio frames or image embeddings)."""
    name = request.param
    ecfg = dict(n_slots=4, max_seq=24, n_workers=2, eos_token=-1, n_lanes=2)
    jcfg = jconfigs.get_tiny(name)
    eng = JInferenceEngine(jcfg, JEngineConfig(**ecfg), rng=jax.random.PRNGKey(7))
    res = eng.run(_requests(8, seed=17, cls=JRequest), timeout=120)
    params = jax.tree_util.tree_map(np.asarray, eng.params)
    tokens = {r.rid: r.tokens for r in res}
    return name, ecfg, params, tokens, (eng.head, eng.tail)


@pytest.mark.parametrize("policy", ["corec", "rss"])
def test_port_engine_tokens_equal_reference_engine_cross_families(
    cross_reference_run, policy
):
    name, ecfg, params, want, (head, tail) = cross_reference_run
    assert head == tail == 8
    cfg = configs.get_tiny(name)
    eng = InferenceEngine(
        cfg,
        EngineConfig(policy=policy, **ecfg),
        params=params_from_reference(cfg, params, device="cpu"),
        device="cpu",
    )
    res = eng.run(_requests(8, seed=17), timeout=120)
    assert {r.rid: r.tokens for r in res} == want
    assert eng.head == eng.tail == 8
    assert sum(eng.release_events) == 8
