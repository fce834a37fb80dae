"""The port's WKV6 and SSD scans vs the JAX package's.

Inputs come from a seeded numpy RNG and go through both packages: the
port runs its plain PyTorch versions (CPU tensors), the reference its
``ops.rwkv6``/``ops.ssd`` on the routes ``naive`` (the sequential
oracle), ``xla`` (the chunked jnp form) and ``pallas`` (the TPU kernel
in interpret mode), over the shape sweeps of ``tests/test_kernels.py``:
T = 20 over chunk 8 (padding), the split state carry, and G = 2 B/C
groups for SSD.  Tolerance: the reference's own for these scans, 2e-4
in fp32; bf16 inputs at 2e-2.  The CUDA kernels are held against the
plain versions on the card in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6_cuda  # noqa: E402
from repro_torch.kernels.ssd import ssd_cuda  # noqa: E402

FP32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
REF_IMPLS = ("naive", "xla", "pallas")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _reference(fn, *args, impl, **kw):
    if impl == "pallas":
        kw["interpret"] = True
    if impl == "naive":
        kw.pop("chunk", None)
    return fn(*args, impl=impl, **kw)


# ----------------------------------------------------------------------
# rwkv6
# ----------------------------------------------------------------------
def _wkv(rng, B, T, H, N, w_scale=0.5, w_shift=-1.0):
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)) for _ in range(3))
    w = np.exp(-np.exp(w_scale * rng.standard_normal((B, T, H, N)) + w_shift))
    u = 0.5 * rng.standard_normal((H, N))
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


RWKV_CASES = [(1, 32, 2, 16, 8), (2, 48, 3, 32, 16), (1, 20, 1, 16, 8)]


@pytest.mark.parametrize("B,T,H,N,chunk", RWKV_CASES)
@pytest.mark.parametrize("impl", REF_IMPLS)
def test_rwkv6_equals_reference_routes(B, T, H, N, chunk, impl):
    rng = np.random.default_rng(T * 10 + H)
    r, k, v, w, u = _wkv(rng, B, T, H, N)
    s0 = (0.3 * rng.standard_normal((B, H, N, N))).astype(np.float32)
    o, s = ops.rwkv6(_t(r), _t(k), _t(v), _t(w), _t(u), _t(s0), chunk=chunk)
    assert o.shape == (B, T, H, N) and s.dtype == torch.float32
    jo, js = _reference(jops.rwkv6, r, k, v, w, u, s0, chunk=chunk, impl=impl)
    np.testing.assert_allclose(_f32(o), _f32(jo), **FP32)
    np.testing.assert_allclose(_f32(s), _f32(js), **FP32)


@pytest.mark.parametrize("B,T,H,N,chunk", RWKV_CASES)
def test_rwkv6_bf16_equals_reference(B, T, H, N, chunk):
    """bf16 r/k/v (fp32 w, u, state, as the model passes them): the
    output in bf16 on both sides."""
    rng = np.random.default_rng(T + H)
    r, k, v, w, u = _wkv(rng, B, T, H, N)
    jr, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (r, k, v))
    tr, tk, tv = (_t(a).bfloat16() for a in (r, k, v))
    o, s = ops.rwkv6(tr, tk, tv, _t(w), _t(u), chunk=chunk)
    assert o.dtype == torch.bfloat16
    jo, js = jops.rwkv6(jr, jk, jv, w, u, chunk=chunk, impl="xla")
    np.testing.assert_allclose(_f32(o), _f32(jo), **BF16)
    np.testing.assert_allclose(_f32(s), _f32(js), **BF16)


def test_rwkv6_scan_ref_equals_reference_oracle():
    """The sequential oracle, one head at a time in the reference,
    batched over [B, H] here."""
    rng = np.random.default_rng(3)
    r, k, v, w, u = _wkv(rng, 2, 12, 2, 16)
    o, s = ref.rwkv6_scan_ref(*(_t(a).movedim(2, 1) for a in (r, k, v, w)), _t(u))
    jo, js = jops.rwkv6(r, k, v, w, u, impl="naive")
    np.testing.assert_allclose(_f32(o.movedim(1, 2)), _f32(jo), **FP32)
    np.testing.assert_allclose(_f32(s), _f32(js), **FP32)
    o1, s1 = jref.rwkv6_scan_ref(r[0, :, 1], k[0, :, 1], v[0, :, 1], w[0, :, 1], u[1])
    np.testing.assert_allclose(_f32(o[0, 1]), _f32(o1), **FP32)
    np.testing.assert_allclose(_f32(s[0, 1]), _f32(s1), **FP32)


def test_rwkv6_step_equals_reference_step_and_scan():
    B, T, H, N = 2, 12, 2, 16
    rng = np.random.default_rng(4)
    r, k, v, w, u = _wkv(rng, B, T, H, N, w_scale=0.3, w_shift=0.0)
    st = torch.zeros(B, H, N, N)
    jst = jnp.zeros((B, H, N, N))
    outs = []
    for t in range(T):
        o, st = ops.rwkv6_step(*(_t(a[:, t]) for a in (r, k, v, w)), _t(u), st)
        jo, jst = jops.rwkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, jst)
        np.testing.assert_allclose(_f32(o), _f32(jo), **FP32)
        outs.append(o)
    np.testing.assert_allclose(_f32(st), _f32(jst), **FP32)
    o_ref, s_ref = jops.rwkv6(r, k, v, w, u, impl="naive")
    np.testing.assert_allclose(_f32(torch.stack(outs, 1)), _f32(o_ref), **FP32)
    np.testing.assert_allclose(_f32(st), _f32(s_ref), **FP32)


def test_rwkv6_state_carry_split():
    """[0:T/2) then [T/2:T) with the carried state == the full run, and
    both halves == the reference's."""
    B, T, H, N = 1, 32, 2, 16
    rng = np.random.default_rng(5)
    r, k, v, w, u = _wkv(rng, B, T, H, N, w_scale=0.3, w_shift=0.0)
    o_full, s_full = ops.rwkv6(*(_t(a) for a in (r, k, v, w, u)), chunk=8)
    h = T // 2
    first = [_t(a[:, :h]) for a in (r, k, v, w)]
    o1, s1 = ops.rwkv6(*first, _t(u), chunk=8)
    second = [_t(a[:, h:]) for a in (r, k, v, w)]
    o2, s2 = ops.rwkv6(*second, _t(u), s1, chunk=8)
    np.testing.assert_allclose(_f32(torch.cat([o1, o2], 1)), _f32(o_full), **FP32)
    np.testing.assert_allclose(_f32(s2), _f32(s_full), **FP32)
    _, js1 = jops.rwkv6(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, impl="xla", chunk=8)
    np.testing.assert_allclose(_f32(s1), _f32(js1), **FP32)


# ----------------------------------------------------------------------
# ssd
# ----------------------------------------------------------------------
def _ssd(rng, B, T, H, P, G, N):
    x = 0.5 * rng.standard_normal((B, T, H, P))
    dt = 0.2 * np.log1p(np.exp(rng.standard_normal((B, T, H))))
    A = -np.exp(0.3 * rng.standard_normal(H))
    Bm = 0.5 * rng.standard_normal((B, T, G, N))
    Cm = 0.5 * rng.standard_normal((B, T, G, N))
    D = 0.3 * rng.standard_normal(H)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]


SSD_CASES = [
    (1, 32, 2, 8, 1, 16, 8),
    (2, 24, 4, 16, 2, 8, 8),  # G = 2
    (1, 20, 4, 16, 2, 8, 8),  # T = 20 over chunk 8 pads
]


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SSD_CASES)
@pytest.mark.parametrize("impl", REF_IMPLS)
def test_ssd_equals_reference_routes(B, T, H, P, G, N, chunk, impl):
    rng = np.random.default_rng(T * 10 + H + G)
    x, dt, A, Bm, Cm, D = _ssd(rng, B, T, H, P, G, N)
    s0 = (0.3 * rng.standard_normal((B, H, P, N))).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D, s0)
    y, s = ops.ssd(*(_t(a) for a in args), chunk=chunk)
    assert y.shape == (B, T, H, P) and s.dtype == torch.float32
    jy, js = _reference(jops.ssd, *args, chunk=chunk, impl=impl)
    np.testing.assert_allclose(_f32(y), _f32(jy), **FP32)
    np.testing.assert_allclose(_f32(s), _f32(js), **FP32)


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SSD_CASES)
def test_ssd_bf16_routes_round_as_the_reference_does(B, T, H, P, G, N, chunk):
    """bf16 x/B/C: the plain route adds D inside in fp32 and returns bf16,
    as the reference's xla route does; the reference's kernel route
    returns fp32 (bf16 y + fp32 D x), as the port's kernel route does on
    the card.  The two routes agree within the bf16 tolerance."""
    rng = np.random.default_rng(T + H + G)
    x, dt, A, Bm, Cm, D = _ssd(rng, B, T, H, P, G, N)
    jx, jB, jC = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, Bm, Cm))
    tx, tB, tC = (_t(a).bfloat16() for a in (x, Bm, Cm))
    y, s = ops.ssd(tx, _t(dt), _t(A), tB, tC, _t(D), chunk=chunk)
    jy, js = jops.ssd(jx, dt, A, jB, jC, D, chunk=chunk, impl="xla")
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(y), _f32(jy), **BF16)
    np.testing.assert_allclose(_f32(s), _f32(js), **BF16)
    py, _ = jops.ssd(jx, dt, A, jB, jC, D, chunk=chunk, impl="pallas", interpret=True)
    assert py.dtype == jnp.float32
    np.testing.assert_allclose(_f32(y), _f32(py), **BF16)


def test_ssd_scan_ref_equals_reference_oracle():
    rng = np.random.default_rng(6)
    x, dt, A, Bm, Cm, D = _ssd(rng, 1, 10, 2, 8, 1, 16)
    Bh, Ch = (np.repeat(a, 2, axis=2) for a in (Bm, Cm))
    y, s = ref.ssd_scan_ref(
        _t(x).movedim(2, 1),
        _t(dt).movedim(2, 1),
        _t(A),
        _t(Bh).movedim(2, 1),
        _t(Ch).movedim(2, 1),
        _t(D),
    )
    jy, js = jops.ssd(x, dt, A, Bm, Cm, D, impl="naive")
    np.testing.assert_allclose(_f32(y.movedim(1, 2)), _f32(jy), **FP32)
    np.testing.assert_allclose(_f32(s), _f32(js), **FP32)
    head = (x[0, :, 1], dt[0, :, 1], A[1], Bm[0, :, 0], Cm[0, :, 0], D[1])
    y1, _ = jref.ssd_scan_ref(*head)
    np.testing.assert_allclose(_f32(y[0, 1]), _f32(y1), **FP32)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_step_equals_reference_step_and_scan(G):
    B, T, H, P, N = 1, 10, 2, 8, 16
    rng = np.random.default_rng(7 + G)
    x, dt, A, Bm, Cm, D = _ssd(rng, B, T, H, P, G, N)
    st = torch.zeros(B, H, P, N)
    jst = jnp.zeros((B, H, P, N))
    ys = []
    for t in range(T):
        step = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D)
        y, st = ops.ssd_step(*(_t(a) for a in step), st)
        jy, jst = jops.ssd_step(*step, jst)
        np.testing.assert_allclose(_f32(y), _f32(jy), **FP32)
        ys.append(y)
    np.testing.assert_allclose(_f32(st), _f32(jst), **FP32)
    y_ref, s_ref = jops.ssd(x, dt, A, Bm, Cm, D, impl="naive")
    np.testing.assert_allclose(_f32(torch.stack(ys, 1)), _f32(y_ref), **FP32)
    np.testing.assert_allclose(_f32(st), _f32(s_ref), **FP32)


def test_ssd_state_carry_split():
    B, T, H, P, G, N = 1, 32, 2, 8, 1, 16
    rng = np.random.default_rng(9)
    x, dt, A, Bm, Cm, D = _ssd(rng, B, T, H, P, G, N)
    full = ops.ssd(*(_t(a) for a in (x, dt, A, Bm, Cm, D)), chunk=8)
    h = T // 2

    def half(sl, state=None):
        a = [_t(x[:, sl]), _t(dt[:, sl]), _t(A), _t(Bm[:, sl]), _t(Cm[:, sl]), _t(D)]
        return ops.ssd(*a, state, chunk=8)

    y1, s1 = half(slice(0, h))
    y2, s2 = half(slice(h, T), s1)
    np.testing.assert_allclose(_f32(torch.cat([y1, y2], 1)), _f32(full[0]), **FP32)
    np.testing.assert_allclose(_f32(s2), _f32(full[1]), **FP32)


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------
def _calls():
    rng = np.random.default_rng(10)
    r, k, v, w, u = (_t(a) for a in _wkv(rng, 1, 9, 2, 16))
    x, dt, A, Bm, Cm, D = (_t(a) for a in _ssd(rng, 1, 9, 2, 8, 1, 16))
    return {
        "rwkv6": lambda impl: ops.rwkv6(r, k, v, w, u, chunk=4, impl=impl),
        "ssd": lambda impl: ops.ssd(x, dt, A, Bm, Cm, D, chunk=4, impl=impl),
    }


@pytest.mark.parametrize("op", ["rwkv6", "ssd"])
def test_impl_rules(op):
    """'auto' on a CPU tensor is the plain version; 'cuda' needs a CUDA
    tensor; the TPU route is rejected by name."""
    call = _calls()[op]
    for a, b in zip(call("auto"), call("plain")):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        call("cuda")
    with pytest.raises(ValueError, match="pallas"):
        call("pallas")


def test_kernel_wrappers_take_cuda_tensors_only():
    x = torch.ones(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        rwkv6_cuda(x, x, x, x, torch.ones(2, 16), torch.zeros(1, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA device"):
        bc = torch.ones(1, 4, 1, 16)
        s0 = torch.zeros(1, 2, 16, 16)
        ssd_cuda(x, torch.ones(1, 4, 2), torch.ones(2), bc, bc, s0)
