"""The port's model-path kernels (RMSNorm, prefill attention, decode
attention, batched done-prefix) vs the JAX package's.

Inputs come from a seeded numpy RNG and go through both packages: the
port runs its plain PyTorch versions here (CPU tensors), the reference
its pure-jnp oracle (``repro.kernels.ref``) and its Pallas kernel in
interpret mode, over the shape sweeps of ``tests/test_kernels.py`` and
with its tolerances (fp32 ``2e-5``, bf16 ``2e-2``).  bf16 inputs are the
same fp32 draws rounded to bf16 by each package (round to nearest even
in both, so the bits agree).  Done-prefix results must agree exactly.
qwen2's tiny GQA shape (3 query heads over 1 KV head) is in every
attention sweep.  The CUDA kernels are held against the plain versions
on the card in ``tests/test_torch_cuda.py``, which needs no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.doneprefix import done_prefix_batch_pallas  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.doneprefix import done_prefix_batch_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_cuda  # noqa: E402

DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}


def _tol(dtype: str):
    if dtype == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=2e-5, atol=2e-5)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ----------------------------------------------------------------------
# rmsnorm
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 64), (3, 5, 128), (1, 256), (7, 96), (2, 48)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("wdtype", sorted(DTYPES))
def test_rmsnorm_equals_reference_and_pallas(shape, dtype, wdtype):
    rng = np.random.default_rng(sum(shape))
    jx, tx = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    jw, tw = _pair(rng.standard_normal(shape[-1:]).astype(np.float32), wdtype)
    got = ops.rmsnorm(tx, tw, eps=1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want = jref.rmsnorm_ref(jx, jw)
    pallas = rmsnorm_pallas(jx, jw, interpret=True, block_rows=4)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(pallas), **_tol(dtype))


# ----------------------------------------------------------------------
# prefill attention
# ----------------------------------------------------------------------
ATTN_CASES = [
    (1, 32, 32, 4, 4, 32, True, 0),  # MHA causal
    (2, 40, 40, 8, 2, 64, True, 0),  # GQA, ragged blocks
    (1, 16, 48, 4, 1, 32, False, 0),  # MQA non-causal, Sq != Sk
    (1, 8, 72, 4, 2, 32, True, 64),  # decode-ish offset window
    (2, 12, 12, 3, 1, 16, True, 0),  # qwen2 tiny: 3 heads over 1 KV head
]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,q_offset", ATTN_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_equals_reference_and_pallas(
    B, Sq, Sk, H, Hkv, D, causal, q_offset, dtype
):
    rng = np.random.default_rng(Sq * 100 + Sk + H)
    jq, tq = _pair(rng.standard_normal((B, Sq, H, D)).astype(np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32), dtype)
    kw = dict(causal=causal, q_offset=q_offset)
    got = ops.attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jref.attention_ref(jq, jk, jv, **kw)
    pallas = jops.attention(jq, jk, jv, impl="pallas", interpret=True, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(pallas), **_tol(dtype))


# ----------------------------------------------------------------------
# decode attention
# ----------------------------------------------------------------------
DECODE_CASES = [
    (2, 4, 4, 32, 40, 16),
    (3, 8, 2, 64, 100, 32),
    (1, 4, 1, 32, 513, 128),
    (2, 3, 1, 16, 20, 8),  # qwen2 tiny: 3 heads over 1 KV head
]


@pytest.mark.parametrize("B,H,Hkv,D,S,block_k", DECODE_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_equals_reference_and_pallas(B, H, Hkv, D, S, block_k, dtype):
    rng = np.random.default_rng(S + H)
    jq, tq = _pair(rng.standard_normal((B, H, D)).astype(np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((B, S, Hkv, D)).astype(np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, S, Hkv, D)).astype(np.float32), dtype)
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    lengths[0] = S  # a full cache
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jref.decode_attention_ref(jq, jk, jv, lengths)
    pallas = jops.decode_attention(
        jq, jk, jv, lengths, impl="pallas", interpret=True, block_k=block_k
    )
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(pallas), **_tol(dtype))


def test_decode_attention_length_past_cache_admits_every_key():
    """An idle decode slot's length may pass S: both plain versions then
    attend over the whole cache, as a length of exactly S does."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    over = ops.decode_attention(*t, torch.tensor([12, 10], dtype=torch.int32))
    full = ops.decode_attention(*t, torch.tensor([10, 10], dtype=torch.int32))
    torch.testing.assert_close(over, full, rtol=0, atol=0)
    want = jref.decode_attention_ref(q, k, v, np.array([12, 10], np.int32))
    np.testing.assert_allclose(over.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------------
# done-prefix (COREC TAIL on device)
# ----------------------------------------------------------------------
def _oracle(done, start, limit):
    """Plain-python contiguous-run oracle (wraps mod n, clamps at limit)."""
    n = len(done)
    run = 0
    while run < min(limit, n) and done[(start + run) % n]:
        run += 1
    return min(run, limit)


def _check_batch(done, starts, limits, block_n=None):
    want = np.array([_oracle(d, s, lim) for d, s, lim in zip(done, starts, limits)])
    got = ops.done_prefix_batch(
        torch.from_numpy(done), torch.from_numpy(starts), torch.from_numpy(limits)
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = jref.done_prefix_batch_ref(done, starts, limits)
    np.testing.assert_array_equal(np.asarray(oracle), want)
    pallas = done_prefix_batch_pallas(
        jnp.asarray(done),
        jnp.asarray(starts),
        jnp.asarray(limits),
        block_n=block_n,
        interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(pallas), want)


@pytest.mark.parametrize("n", [64, 128])
def test_done_prefix_single_ring_sweep(n):
    rng = np.random.default_rng(0)
    for _ in range(25):
        done = rng.random(n) < 0.7
        start = int(rng.integers(0, n))
        limit = int(rng.integers(1, n + 1))
        got = ops.done_prefix(torch.from_numpy(done), start, limit)
        want = jref.done_prefix_ref(
            jnp.asarray(done), jnp.int32(start), jnp.int32(limit)
        )
        assert int(got) == int(want) == _oracle(done, start, limit)


@pytest.mark.parametrize("n,block_n", [(64, 16), (128, 32), (256, 64), (512, 128)])
def test_done_prefix_multiblock_sweep(n, block_n):
    rng = np.random.default_rng(1)
    done = rng.random((20, n)) < 0.7
    starts = rng.integers(0, n, 20).astype(np.int32)
    limits = rng.integers(0, n + 1, 20).astype(np.int32)
    _check_batch(done, starts, limits, block_n=block_n)


@pytest.mark.parametrize("n", [64, 128, 33, 4])
def test_done_prefix_edge_cases(n):
    """Wrap/rotation edges: start near n-1, all-done, none-done, clamp,
    limit 0, and a run that wraps across n-1 -> 0."""
    rows, starts, limits = [], [], []
    for start in (0, 1, n - 1):
        for done, limit in (
            (np.ones(n, bool), n),
            (np.ones(n, bool), min(5, n)),
            (np.zeros(n, bool), n),
            (np.ones(n, bool), 0),
        ):
            rows.append(done)
            starts.append(start)
            limits.append(limit)
    wrap = np.zeros(n, bool)
    wrap[n - 1] = wrap[0] = wrap[1] = True
    rows.append(wrap)
    starts.append(n - 1)
    limits.append(n)
    _check_batch(
        np.stack(rows), np.array(starts, np.int32), np.array(limits, np.int32)
    )
    got = ops.done_prefix(torch.from_numpy(wrap), n - 1, n)
    assert int(got) == min(3, n)


@pytest.mark.parametrize("R,n,block_n", [(1, 64, None), (4, 128, 32), (7, 96, 40)])
def test_done_prefix_batch_vs_oracle(R, n, block_n):
    rng = np.random.default_rng(2)
    for _ in range(10):
        done = rng.random((R, n)) < 0.6
        starts = rng.integers(0, n, R).astype(np.int32)
        limits = rng.integers(0, n + 1, R).astype(np.int32)
        _check_batch(done, starts, limits, block_n=block_n)


def test_done_prefix_batch_edge_rows():
    n = 64
    done = np.zeros((4, n), bool)
    done[0, :] = True  # all done
    done[2, n - 1] = done[2, 0] = True  # wrapping run of 2 from n-1
    done[3, :10] = True  # clamped by limit
    starts = np.array([3, 0, n - 1, 0], np.int32)
    limits = np.array([n, n, n, 4], np.int32)
    _check_batch(done, starts, limits)
    got = ops.done_prefix_batch(
        torch.from_numpy(done), torch.from_numpy(starts), torch.from_numpy(limits)
    )
    np.testing.assert_array_equal(got.numpy(), [n, 0, 2, 4])


# ----------------------------------------------------------------------
# impl rules
# ----------------------------------------------------------------------
def _op_calls():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    w = torch.ones(32)
    q = torch.from_numpy(rng.standard_normal((1, 5, 4, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 5, 2, 16)).astype(np.float32))
    qd = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, 6, 2, 16)).astype(np.float32))
    lens = torch.tensor([3, 6], dtype=torch.int32)
    done = torch.from_numpy(rng.random((3, 9)) < 0.7)
    st = torch.tensor([0, 4, 8], dtype=torch.int32)
    lim = torch.tensor([9, 2, 9], dtype=torch.int32)
    return {
        "rmsnorm": lambda impl: ops.rmsnorm(x, w, impl=impl),
        "add_rmsnorm": lambda impl: ops.add_rmsnorm(x, 0.5 * x, w, impl=impl),
        "attention": lambda impl: ops.attention(q, kv, kv, impl=impl),
        "decode_attention": lambda impl: ops.decode_attention(
            qd, cache, cache, lens, impl=impl
        ),
        "done_prefix_batch": lambda impl: ops.done_prefix_batch(
            done, st, lim, impl=impl
        ),
        "done_prefix": lambda impl: ops.done_prefix(done[1], 4, 9, impl=impl),
    }


@pytest.mark.parametrize("op", sorted(_op_calls()))
def test_impl_rules(op):
    call = _op_calls()[op]
    torch.testing.assert_close(call("auto"), call("plain"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        call("cuda")
    with pytest.raises(ValueError, match="pallas"):
        call("pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        call("xla")


def test_kernel_wrappers_take_cuda_tensors_only():
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        rmsnorm_cuda(x, torch.ones(8))
    with pytest.raises(ValueError, match="CUDA device"):
        kv = torch.ones(1, 2, 1, 32)
        flash_attention_cuda(torch.ones(1, 2, 2, 32), kv, kv)
    with pytest.raises(ValueError, match="CUDA device"):
        cache = torch.ones(1, 4, 1, 32)
        lens = torch.ones(1, dtype=torch.int32)
        decode_attention_cuda(torch.ones(1, 2, 32), cache, cache, lens)
    with pytest.raises(ValueError, match="CUDA device"):
        one = torch.ones(1, dtype=torch.int32)
        done_prefix_batch_cuda(torch.ones(1, 4, dtype=torch.bool), one - 1, one)
