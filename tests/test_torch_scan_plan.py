"""The chunk-parallel algebra of the WKV6 and SSD kernels, and their
launch plans, on the CPU.

``csrc/ssd.cu`` and ``csrc/rwkv6.cu`` split each scan into three passes
(each chunk's own state, the state passed from chunk to chunk, the
outputs), and the bf16 WKV6 kernel factors the part of the intra-chunk
matrix below its 16 x 16 diagonal blocks through a reference token.
Both are written out here in plain torch, pass by pass as the kernels
run them, and held against the port's chunked plain versions
(``ops.rwkv6`` / ``ops.ssd`` with ``impl="plain"``, i.e.
``ref.rwkv6_chunk_ref`` / ``ref.ssd_chunk_ref`` on padded inputs) at the
scans' tolerance, 2e-4, and in fp64 against a sequential fp64
recurrence at 1e-9.  Every exponential the kernels take is checked to
have an argument <= 0, and with w at its clip exp(-e^4) every
intermediate is checked finite (the plain chunked WKV6 form overflows
there, so the sequential oracle is the reference).

The launch plans (``ssd_plan``, ``rwkv6_plan``) are plain Python passed
to the launchers, so their grids, heads per output block, workspace and
the one-token route are pinned here.  The kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.rwkv6 import CHUNK_TILE, rwkv6_plan
from repro_torch.kernels.ssd import SMS, heads_per_block, ssd_plan

FP32 = dict(rtol=2e-4, atol=2e-4)
FP64 = dict(rtol=1e-9, atol=1e-9)
SUB = 16  # the bf16 WKV6 kernel's sub-chunk: one warp's rows
CLIP = math.exp(-math.exp(4.0))  # models/rwkv.py clips w here


def _chunks(a: torch.Tensor, T: int, value: float = 0.0) -> torch.Tensor:
    """``[B, T, H, ...]`` -> ``[B, H, nc, CHUNK_TILE, ...]``, padded
    along T with ``value``."""
    nc = -(-T // CHUNK_TILE)
    a = a.movedim(2, 1)
    pad = nc * CHUNK_TILE - T
    if pad:
        tail = a.new_full(a.shape[:2] + (pad,) + a.shape[3:], value)
        a = torch.cat([a, tail], dim=2)
    return a.reshape(a.shape[:2] + (nc, CHUNK_TILE) + a.shape[3:])


def _check_exp_args(*args: torch.Tensor) -> None:
    for a in args:
        assert bool((a <= 0).all()), "an exponential's argument is above 0"


# ----------------------------------------------------------------------
# WKV6
# ----------------------------------------------------------------------
def wkv_three_pass(r, k, v, w, u, s0, seen: list):
    """The kernels' WKV6 in plain torch, in the precision of the inputs:
    pass 1 (chunk state and decay), pass 2 (state passing), pass 3 (A
    through the reference token below the diagonal blocks, pairwise on
    them, then o = A v + (r exp2(la_{t-1})) S_{c-1}).  Appends every
    intermediate to ``seen``."""
    B, T, H, N = r.shape
    rc, kc, vc = (_chunks(a, T) for a in (r, k, v))
    wc = _chunks(w, T, value=1.0)
    la = torch.cumsum(torch.log2(torch.clamp(wc, min=1e-30)), dim=3)
    la_prev = torch.cat([torch.zeros_like(la[..., :1, :]), la[..., :-1, :]], dim=3)
    la_end = la[..., -1:, :]
    # pass 1
    _check_exp_args(la_end - la)
    kdec = kc * torch.exp2(la_end - la)
    dS = kdec.transpose(-1, -2) @ vc  # [B, H, nc, N, N]
    dec = torch.exp2(la_end[..., 0, :])  # [B, H, nc, N]
    # pass 2
    S, s_in = s0.to(r.dtype), []
    for c in range(la.shape[2]):
        s_in.append(S)
        S = dec[:, :, c, :, None] * S + dS[:, :, c]
    s_in = torch.stack(s_in, dim=2)
    # pass 3: A, sub-chunk by sub-chunk
    L = CHUNK_TILE
    A = torch.zeros(rc.shape[:3] + (L, L), dtype=r.dtype)
    for J in range(L // SUB):
        rows = slice(SUB * J, SUB * (J + 1))
        if J > 0:  # the earlier sub-chunks, through ref = 16 J - 1
            lref = la[..., SUB * J - 1 : SUB * J, :]
            _check_exp_args(la_prev[..., rows, :] - lref, lref - la[..., : SUB * J, :])
            rfac = rc[..., rows, :] * torch.exp2(la_prev[..., rows, :] - lref)
            kfac = kc[..., : SUB * J, :] * torch.exp2(lref - la[..., : SUB * J, :])
            A[..., rows, : SUB * J] = rfac @ kfac.transpose(-1, -2)
            seen += [rfac, kfac]
        # the diagonal block: pairwise factor whole, bonus on the diagonal
        for tl in range(SUB):
            t = SUB * J + tl
            for s in range(SUB * J, t):
                arg = la_prev[..., t, :] - la[..., s, :]
                _check_exp_args(arg)
                A[..., t, s] = (rc[..., t, :] * kc[..., s, :] * torch.exp2(arg)).sum(-1)
            A[..., t, t] = (rc[..., t, :] * u[None, :, None, :] * kc[..., t, :]).sum(-1)
    _check_exp_args(la_prev)
    rdec = rc * torch.exp2(la_prev)
    o = A @ vc + rdec @ s_in
    seen += [la, kdec, dS, dec, s_in, A, rdec, o, S]
    o = o.reshape(B, H, -1, N)[:, :, :T].movedim(1, 2)
    return o, S


def _wkv_seq64(r, k, v, w, u, s0):
    """The WKV6 recurrence in fp64, token by token."""
    r, k, v, w, u, S = (a.double() for a in (r, k, v, w, u, s0))
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        Su = S + u[None, :, :, None] * kv
        outs.append(torch.einsum("bhij,bhi->bhj", Su, r[:, t]))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1), S


def _wkv_inputs(B, T, H, N, seed, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)) for _ in range(3))
    if strong:
        w = np.full((B, T, H, N), CLIP)
    else:
        w = np.exp(-np.exp(0.5 * rng.standard_normal((B, T, H, N)) - 1.0))
    u = 0.5 * rng.standard_normal((H, N))
    s0 = 0.3 * rng.standard_normal((B, H, N, N))
    return [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]


#: (B, T, H, N): the sweep of tests/test_kernels.py, rwkv6-3b's prefill,
#: and T off and on the chunk tile's and sub-chunks' edges
WKV_SHAPES = [
    (1, 32, 2, 16),
    (2, 48, 3, 32),
    (1, 20, 1, 16),
    (1, 384, 40, 64),
    *[(2, T, 2, 16) for T in (1, 15, 16, 17, 20, 33, 383)],
]


@pytest.mark.parametrize("B,T,H,N", WKV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wkv_three_pass_equals_chunked_plain(B, T, H, N, dtype):
    r, k, v, w, u, s0 = _wkv_inputs(B, T, H, N, seed=T * 10 + H)
    seen: list = []
    o, s = wkv_three_pass(*(a.to(dtype) for a in (r, k, v, w, u, s0)), seen)
    assert all(bool(torch.isfinite(a).all()) for a in seen)
    f = [a.float() for a in (r, k, v, w, u, s0)]
    o_ref, s_ref = ops.rwkv6(*f, chunk=32, impl="plain")
    torch.testing.assert_close(o.float(), o_ref, **FP32)
    torch.testing.assert_close(s.float(), s_ref, **FP32)
    if dtype == torch.float64 and T <= 48:
        o64, s64 = _wkv_seq64(r, k, v, w, u, s0)
        torch.testing.assert_close(o, o64, **FP64)
        torch.testing.assert_close(s, s64, **FP64)


@pytest.mark.parametrize("T", [17, 64, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wkv_three_pass_at_the_decay_clip_stays_finite(T, dtype):
    """w = exp(-e^4) everywhere: every intermediate finite, every
    exponential's argument <= 0, and the result the sequential oracle's
    (the plain chunked form's exp(-la) overflows fp32 here)."""
    r, k, v, w, u, s0 = _wkv_inputs(1, T, 2, 64, seed=T, strong=True)
    seen: list = []
    o, s = wkv_three_pass(*(a.to(dtype) for a in (r, k, v, w, u, s0)), seen)
    assert all(bool(torch.isfinite(a).all()) for a in seen)
    o_seq, s_seq = ref.rwkv6_scan_ref(
        *(a.float().movedim(2, 1) for a in (r, k, v, w)), u.float(), s0.float()
    )
    torch.testing.assert_close(o.float(), o_seq.movedim(1, 2), **FP32)
    torch.testing.assert_close(s.float(), s_seq, **FP32)
    if dtype == torch.float32:  # the reference's split form overflows here
        o_chk, _ = ops.rwkv6(*(a.float() for a in (r, k, v, w, u, s0)), impl="plain")
        assert not bool(torch.isfinite(o_chk).all())


# ----------------------------------------------------------------------
# SSD
# ----------------------------------------------------------------------
def ssd_three_pass(x, dt, A, Bm, Cm, s0, seen: list):
    """The kernels' SSD in plain torch, in the precision of the inputs:
    pass 1 (chunk state and decay), pass 2 (state passing), pass 3 (CB
    once per chunk and group, then y = G x + exp(lcum) C S_{c-1}^T).
    Without the D-skip, as ``ssd_cuda``."""
    Bb, T, H, P = x.shape
    G = Bm.shape[2]
    rep = H // G
    xc = _chunks(x, T)
    dtc = _chunks(dt[..., None], T)[..., 0]  # [B, H, nc, L]
    Bc, Cc = (_chunks(a, T) for a in (Bm, Cm))  # [B, G, nc, L, N]
    lcum = torch.cumsum(A[None, :, None, None] * dtc, dim=-1)
    lend = lcum[..., -1:]
    # pass 1
    _check_exp_args(lend - lcum)
    xdec = (torch.exp(lend - lcum) * dtc)[..., None] * xc
    Bh, Ch = (a.repeat_interleave(rep, dim=1) for a in (Bc, Cc))
    dS = xdec.transpose(-1, -2) @ Bh  # [B, H, nc, P, N]
    dec = torch.exp(lend[..., 0])  # [B, H, nc]
    # pass 2
    S, s_in = s0.to(x.dtype), []
    for c in range(lcum.shape[2]):
        s_in.append(S)
        S = dec[:, :, c, None, None] * S + dS[:, :, c]
    s_in = torch.stack(s_in, dim=2)
    # pass 3: CB once per (chunk, group), shared by the group's heads
    CB = (Cc @ Bc.transpose(-1, -2)).repeat_interleave(rep, dim=1)
    L = CHUNK_TILE
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool))
    diff = lcum[..., :, None] - lcum[..., None, :]
    _check_exp_args(diff.masked_fill(~causal, 0.0), lcum)
    Gm = torch.where(causal, CB * torch.exp(diff.masked_fill(~causal, 0.0)), 0.0)
    Gm = Gm * dtc[..., None, :]
    y = Gm @ xc + torch.exp(lcum)[..., None] * (Ch @ s_in.transpose(-1, -2))
    seen += [lcum, xdec, dS, dec, s_in, CB, Gm, y, S]
    y = y.reshape(Bb, H, -1, P)[:, :, :T].movedim(1, 2)
    return y, S


def _ssd_seq64(x, dt, A, Bm, Cm, s0):
    """The SSD recurrence in fp64, token by token, without D."""
    x, dt, A, Bm, Cm, S = (a.double() for a in (x, dt, A, Bm, Cm, s0))
    rep = x.shape[2] // Bm.shape[2]
    Bh, Ch = (a.repeat_interleave(rep, dim=2) for a in (Bm, Cm))
    ys = []
    for t in range(x.shape[1]):
        dA = torch.exp(A[None, :] * dt[:, t])[..., None, None]
        S = dA * S + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append((S @ Ch[:, t, :, :, None])[..., 0])
    return torch.stack(ys, dim=1), S


def _ssd_inputs(B, T, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, T, H, P))
    dt = 0.2 * np.log1p(np.exp(rng.standard_normal((B, T, H))))
    A = -np.exp(0.3 * rng.standard_normal(H))
    Bm, Cm = (0.5 * rng.standard_normal((B, T, G, N)) for _ in range(2))
    s0 = 0.3 * rng.standard_normal((B, H, P, N))
    return [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, s0)]


#: (B, T, H, P, G, N): the sweep of tests/test_kernels.py (G = 2 among
#: them), zamba2-1.2b's prefill and decode step, T across the chunk
#: tile's edges with G = 2
SSD_SHAPES = [
    (1, 32, 2, 8, 1, 16),
    (2, 24, 4, 16, 2, 8),
    (1, 20, 4, 16, 2, 8),
    (1, 384, 64, 64, 1, 64),
    (16, 1, 64, 64, 1, 64),
    *[(2, T, 4, 16, 2, 16) for T in (1, 15, 16, 17, 20, 33, 383)],
]


@pytest.mark.parametrize("B,T,H,P,G,N", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ssd_three_pass_equals_chunked_plain(B, T, H, P, G, N, dtype):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(B, T, H, P, G, N, seed=T * 10 + H)
    seen: list = []
    y, s = ssd_three_pass(*(a.to(dtype) for a in (x, dt, A, Bm, Cm, s0)), seen)
    assert all(bool(torch.isfinite(a).all()) for a in seen)
    f = [a.float() for a in (x, dt, A, Bm, Cm, s0)]
    no_d = torch.zeros(H)
    y_ref, s_ref = ops.ssd(*f[:5], no_d, f[5], chunk=64, impl="plain")
    torch.testing.assert_close(y.float(), y_ref, **FP32)
    torch.testing.assert_close(s.float(), s_ref, **FP32)
    if dtype == torch.float64 and T <= 33:
        y64, s64 = _ssd_seq64(x, dt, A, Bm, Cm, s0)
        torch.testing.assert_close(y, y64, **FP64)
        torch.testing.assert_close(s, s64, **FP64)


@pytest.mark.parametrize("B,G", [(1, 1), (16, 1), (16, 2)])
def test_ssd_one_token_route_equals_the_chunked_route(B, G):
    """What the T == 1 kernel computes (S' = exp(A dt) S + dt x B^T,
    y = S' C) is the three-pass result on one token."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(B, 1, 8, 16, G, 16, seed=B + G)
    S = torch.exp(A[None, :] * dt[:, 0])[..., None, None] * s0
    rep = 8 // G
    Bh, Ch = (a[:, 0].repeat_interleave(rep, dim=1) for a in (Bm, Cm))
    S = S + (dt[:, 0, :, None] * x[:, 0])[..., None] * Bh[:, :, None, :]
    y = (S @ Ch[..., None])[..., 0]
    y3, s3 = ssd_three_pass(x, dt, A, Bm, Cm, s0, [])
    torch.testing.assert_close(y[:, None], y3, **FP64)
    torch.testing.assert_close(S, s3, **FP64)


# ----------------------------------------------------------------------
# launch plans
# ----------------------------------------------------------------------
def test_ssd_plan_at_the_served_prefill():
    p = ssd_plan(1, 384, 64, 1, 64, 64)
    assert p.route == "chunked" and p.n_chunks == 6
    assert p.heads_per_block == 2  # 192 output blocks for the 132 SMs
    assert p.state_grid == (6, 64, 1) and p.out_grid == (6, 32, 1)
    assert p.pass_grid == (64, 4)  # 4,096 state elements, 4 a thread
    states = 64 * 6 * 64 * 64  # fp32 chunk states, then bf16 high + low parts
    assert p.ws_offsets == (0, 4 * states, 8 * states)
    assert p.workspace_bytes == 8 * states + 1536  # + the 384 decays, aligned


def test_ssd_plan_one_token_is_the_decode_route():
    p = ssd_plan(16, 1, 64, 1, 64, 64)
    assert p.route == "decode" and p.decode_grid == (64, 16)
    assert p.workspace_bytes == 0 and p.n_chunks == 0


@pytest.mark.parametrize("T", [0, 2, 63, 64, 65, 383, 384, 1000])
@pytest.mark.parametrize("B,H,G", [(1, 64, 1), (1, 8, 2), (4, 64, 8), (16, 6, 3)])
def test_ssd_plan_covers_the_sequence(T, B, H, G):
    P, N = 64, 32
    p = ssd_plan(B, T, H, G, P, N)
    nc = p.n_chunks
    assert nc * CHUNK_TILE >= T > (nc - 1) * CHUNK_TILE or T == nc == 0
    hpb = p.heads_per_block
    assert (H // G) % hpb == 0  # a block's heads share one B/C group
    assert p.out_grid == ((nc, H // hpb, B) if nc else (0, H // hpb, B))
    assert p.pass_grid == (B * H, -(-P * N // 1024))
    delta, s_in, dec = p.ws_offsets
    assert delta == 0 and s_in >= 4 * B * H * nc * P * N and s_in % 256 == 0
    # fp32 incoming states, or their bf16 high and low parts
    assert dec - s_in >= 4 * B * H * nc * P * N and dec % 256 == 0
    assert p.workspace_bytes - dec >= 4 * B * H * nc


@pytest.mark.parametrize(
    "B,nc,H,G,want",
    [
        (1, 6, 64, 1, 2),  # zamba2 prefill, 384 tokens: 192 blocks
        (1, 1, 64, 1, 1),  # a 64-token prompt: 64 blocks already too few
        (4, 6, 64, 1, 2),
        (1, 6, 64, 16, 2),  # 4 heads per group
        (2, 12, 48, 16, 1),  # 3 heads per group: 2 does not divide
        (1, 6, 6, 3, 1),  # too few blocks either way
    ],
)
def test_heads_per_block(B, nc, H, G, want):
    hpb = heads_per_block(B, nc, H, G)
    assert hpb == want
    assert (H // G) % hpb == 0
    assert B * nc * (H // hpb) >= SMS or hpb == 1


def test_rwkv6_plan_at_the_served_prefill():
    p = rwkv6_plan(1, 384, 40, 64)
    assert p.n_chunks == 6
    assert p.state_grid == p.out_grid == (6, 40, 1)
    assert p.pass_grid == (40, 4)
    states = 40 * 6 * 64 * 64
    assert p.ws_offsets == (0, 4 * states, 8 * states)
    assert p.workspace_bytes == 8 * states + 4 * 40 * 6 * 64


@pytest.mark.parametrize("T", [0, 1, 15, 16, 17, 64, 65, 383])
@pytest.mark.parametrize("N", [8, 16, 64])
def test_rwkv6_plan_covers_the_prompt(T, N):
    p = rwkv6_plan(2, T, 3, N)
    nc = p.n_chunks
    assert nc * CHUNK_TILE >= T > (nc - 1) * CHUNK_TILE or T == nc == 0
    assert p.state_grid == p.out_grid == (nc, 3, 2)
    assert p.pass_grid == (6, -(-N * N // 1024))  # 4 a thread: N % 4 == 0
    delta, s_in, dec = p.ws_offsets
    assert s_in >= 4 * 6 * nc * N * N and dec - s_in >= 4 * 6 * nc * N * N
    assert p.workspace_bytes - dec >= 4 * 6 * nc * N


def test_rwkv6_pass_takes_one_element_a_thread_when_rows_are_not_fours():
    """Four elements a thread share one decay row only where 4 | N."""
    assert rwkv6_plan(1, 64, 2, 2).pass_grid == (2, 1)
    assert rwkv6_plan(1, 64, 2, 6).pass_grid == (2, 1)
    assert rwkv6_plan(1, 64, 2, 64).pass_grid == (2, 4)
