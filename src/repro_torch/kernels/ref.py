"""Plain PyTorch versions of the port's kernels.

The CPU tests run these against the JAX package's oracles, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
They repeat the kernels' arithmetic and are no yardstick of speed.
Each takes the layout of its counterpart in ``repro.kernels.ref``:
attention in the model layout ``[B, S, H, D]``, RMSNorm over the last
axis, done-prefix masks as ``[n]`` or ``[R, n]`` bools.  The WKV6 and
SSD scans take the reference's one-head layout (``[T, N]``, ``[T, P]``)
batched over any leading dims (``ops`` passes ``[B, H, T, ...]``), with
the per-head parameters broadcast against those dims.

Packed bitmaps are carried as the int32 bit pattern of the reference's
uint32 words (PyTorch has no ``~``, ``>>`` or popcount on
``torch.uint32``); arithmetic widens to int64 and masks to the low 32
bits, and comparisons with the reference view the words as uint32.
"""

from __future__ import annotations

import torch

__all__ = [
    "rmsnorm_ref",
    "add_rmsnorm_ref",
    "attention_ref",
    "decode_attention_ref",
    "done_prefix_ref",
    "done_prefix_batch_ref",
    "done_prefix_packed_ref",
    "rwkv6_scan_ref",
    "rwkv6_chunk_ref",
    "ssd_scan_ref",
    "ssd_chunk_ref",
    "popcount32",
    "MASK32",
]

MASK32 = 0xFFFFFFFF


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR), as int64 of ``words``' shape.

    ``words`` holds the low 32 bits of each word in an int32 bit pattern
    or an int64; the count works in int64, where no step overflows.
    """
    x = words.to(torch.int64) & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def done_prefix_packed_ref(
    words: torch.Tensor,  # [R, n_words] int32 bit pattern (bit b of word
    limit: torch.Tensor,  # j = slot 32*j + b), [R] int32 cap per row
    n_bits: int | None = None,
) -> torch.Tensor:  # [R] int32
    """Contiguous set-bit run from bit 0 of each row, capped by ``limit``
    and ``n_bits``: unpacks to bits and counts the leading run, as
    ``repro.kernels.ref.done_prefix_packed_ref`` does."""
    r, nw = words.shape
    if n_bits is None:
        n_bits = 32 * nw
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = ((words.to(torch.int64) & MASK32)[:, :, None] >> shifts) & 1
    flat = bits.reshape(r, nw * 32)[:, :n_bits]
    run = torch.cumprod(flat, dim=1).sum(dim=1)
    return torch.minimum(run, limit.to(torch.int64)).to(torch.int32)


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """``x / rms(x) * w`` with the reduction in fp32, cast back to x's
    dtype (``repro.kernels.ref.rmsnorm_ref``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def add_rmsnorm_ref(
    x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
):
    """``s = x + delta``, then ``rmsnorm_ref(s, weight)``: the residual add
    and the norm after it, as the reference's models compute them one
    after the other.  Returns (s, y)."""
    s = x + delta
    return s, rmsnorm_ref(s, weight, eps=eps)


def attention_ref(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    causal: bool = True,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:  # [B, Sq, H, D], q's dtype
    """Materialised-scores GQA attention in fp32: query head h reads KV
    head ``h // G``.  ``q_offset`` places the query block in the key
    timeline (``repro.kernels.ref.attention_ref``)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} KV heads")
    G = H // Hkv
    scale = scale if scale is not None else D**-0.5
    qg = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # [B, H, D], one new token per sequence
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    lengths: torch.Tensor,  # [B] valid cache length per sequence
    scale: float | None = None,
) -> torch.Tensor:  # [B, H, D], q's dtype
    """One-token GQA attention over a cache, keys at positions
    ``>= lengths[b]`` masked (``repro.kernels.ref.decode_attention_ref``).
    A length above S admits every key; a length of 0 gives NaN, as the
    reference's softmax over no key does."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else D**-0.5
    qg = (q.float() * scale).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    mask = torch.arange(S, device=q.device)[None] < lengths.to(q.device)[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def done_prefix_batch_ref(
    done: torch.Tensor,  # [R, n] bool, one READ_DONE row per slot ring
    start: torch.Tensor,  # [R] TAIL slot index per ring
    limit: torch.Tensor,  # [R] cap per ring
) -> torch.Tensor:  # [R] int32
    """Length of the contiguous done run from ``start`` (mod n) in each
    row, capped at ``limit`` (``repro.kernels.ref.done_prefix_batch_ref``)."""
    r, n = done.shape
    start = start.to(device=done.device, dtype=torch.int64)
    idx = (start[:, None] + torch.arange(n, device=done.device)) % n
    run = torch.cumprod(torch.gather(done, 1, idx).to(torch.int64), dim=1)
    return torch.minimum(run.sum(dim=1), limit.to(done.device)).to(torch.int32)


def done_prefix_ref(
    done: torch.Tensor, start: torch.Tensor, limit: torch.Tensor
) -> torch.Tensor:  # [] int32
    """One ``[n]`` ring: :func:`done_prefix_batch_ref` on a single row."""
    return done_prefix_batch_ref(
        done[None], torch.as_tensor(start).reshape(1), torch.as_tensor(limit).reshape(1)
    )[0]


# ----------------------------------------------------------------------
# RWKV6 (Finch) WKV: data-dependent per-channel decay
# ----------------------------------------------------------------------
def _state0(state, shape, device) -> torch.Tensor:
    if state is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return state.float()


def rwkv6_scan_ref(
    r: torch.Tensor,  # [..., T, N]
    k: torch.Tensor,  # [..., T, N]
    v: torch.Tensor,  # [..., T, N]
    w: torch.Tensor,  # [..., T, N] decay in (0, 1): w = exp(-exp(w_raw))
    u: torch.Tensor,  # [..., N] bonus for the current token
    state: torch.Tensor | None = None,  # [..., N, N] (k-dim, v-dim)
):
    """Sequential oracle (``repro.kernels.ref.rwkv6_scan_ref``):
    ``o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t``,
    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``; returns (o in r's dtype,
    the fp32 state)."""
    T, N = r.shape[-2:]
    S = _state0(state, r.shape[:-2] + (N, N), r.device)
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[..., :, None]
    outs = []
    for t in range(T):
        kv = kf[..., t, :, None] * vf[..., t, None, :]
        outs.append(torch.einsum("...ij,...i->...j", S + uf * kv, rf[..., t, :]))
        S = wf[..., t, :, None] * S + kv
    o = torch.stack(outs, dim=-2) if outs else rf
    return o.to(r.dtype), S


def rwkv6_chunk_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
    chunk: int = 32,
):
    """Chunked-parallel form (``repro.kernels.ref.rwkv6_chunk_ref``, the
    algorithm of the TPU kernel): within a chunk the decays are log-space
    cumulative sums ``la`` (inclusive) and ``la_prev`` (exclusive); the
    intra-chunk term is the strictly lower-triangular
    ``(r * a_{t-1}) (k / a_s)^T`` plus the diagonal bonus ``r . u . k``,
    the cross-chunk term ``(r * a_{t-1}) S``, and the carry
    ``S = diag(a_end) S + (k * a_end / a_s)^T v``.  T must be a multiple
    of ``chunk``."""
    T, N = r.shape[-2:]
    if T % chunk:
        raise ValueError(f"pad T={T} to a multiple of the chunk {chunk}")
    S = _state0(state, r.shape[:-2] + (N, N), r.device)
    rf, kf, vf = (a.float() for a in (r, k, v))
    logw = torch.log(torch.clamp(w.float(), min=1e-30))
    uf = u.float()[..., None, :]
    strict = torch.tril(
        torch.ones(chunk, chunk, dtype=torch.bool, device=r.device), diagonal=-1
    )
    outs = []
    for c0 in range(0, T, chunk):
        rc, kc, vc, lw = (a[..., c0 : c0 + chunk, :] for a in (rf, kf, vf, logw))
        la = torch.cumsum(lw, dim=-2)
        la_prev = la - lw
        r_decay = rc * torch.exp(la_prev)
        k_scaled = kc * torch.exp(-la)
        A = (r_decay @ k_scaled.transpose(-1, -2)).masked_fill(~strict, 0.0)
        diag = (rc * (uf * kc)).sum(dim=-1)
        o = A @ vc + diag[..., None] * vc
        outs.append(o + r_decay @ S)
        la_end = la[..., -1:, :]
        S = torch.exp(la_end).transpose(-1, -2) * S + (
            (kc * torch.exp(la_end - la)).transpose(-1, -2) @ vc
        )
    o = torch.cat(outs, dim=-2) if outs else rf
    return o.to(r.dtype), S


# ----------------------------------------------------------------------
# Mamba2 SSD (scalar per-head decay, vector B/C)
# ----------------------------------------------------------------------
def ssd_scan_ref(
    x: torch.Tensor,  # [..., T, P] head channels
    dt: torch.Tensor,  # [..., T] softplus'd step size
    A: torch.Tensor,  # [...] scalar decay rate per head (negative)
    B: torch.Tensor,  # [..., T, N]
    C: torch.Tensor,  # [..., T, N]
    D: torch.Tensor,  # [...] skip
    state: torch.Tensor | None = None,  # [..., P, N]
):
    """Sequential oracle (``repro.kernels.ref.ssd_scan_ref``):
    ``S_t = exp(A dt_t) S_{t-1} + dt_t x_t B_t^T``,
    ``y_t = S_t C_t + D x_t``; returns (y in x's dtype, the fp32 state)."""
    T, P = x.shape[-2:]
    N = B.shape[-1]
    S = _state0(state, x.shape[:-2] + (P, N), x.device)
    xf, dtf, Bf, Cf = (a.float() for a in (x, dt, B, C))
    Af, Df = A.float()[..., None, None], D.float()[..., None]
    ys = []
    for t in range(T):
        dA = torch.exp(Af * dtf[..., t, None, None])
        S = dA * S + (dtf[..., t, None] * xf[..., t, :])[..., :, None] * Bf[
            ..., t, None, :
        ]
        ys.append((S @ Cf[..., t, :, None])[..., 0] + Df * xf[..., t, :])
    y = torch.stack(ys, dim=-2) if ys else xf
    return y.to(x.dtype), S


def ssd_chunk_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    state: torch.Tensor | None = None,
    chunk: int = 64,
):
    """Chunked SSD (``repro.kernels.ref.ssd_chunk_ref``, Mamba2's state
    space dual): per chunk ``lcum = cumsum(A dt)``,
    ``y = (tril(exp(lcum_t - lcum_s)) * C B^T) (dt x) + exp(lcum) (C S^T)``
    and ``S = exp(lcum_end) S + (exp(lcum_end - lcum) dt x)^T B``; the
    D-skip is added in fp32 before the cast.  T must be a multiple of
    ``chunk``."""
    T, P = x.shape[-2:]
    N = B.shape[-1]
    if T % chunk:
        raise ValueError(f"pad T={T} to a multiple of the chunk {chunk}")
    S = _state0(state, x.shape[:-2] + (P, N), x.device)
    xf, dtf, Bf, Cf = (a.float() for a in (x, dt, B, C))
    Af = A.float()[..., None]
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    ys = []
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc, Bc, Cc = xf[..., sl, :], dtf[..., sl], Bf[..., sl, :], Cf[..., sl, :]
        lcum = torch.cumsum(Af * dtc, dim=-1)
        L = lcum[..., :, None] - lcum[..., None, :]
        G = torch.where(causal, torch.exp(L), 0.0) * (Cc @ Bc.transpose(-1, -2))
        y = G @ (dtc[..., None] * xc)
        ys.append(y + torch.exp(lcum)[..., None] * (Cc @ S.transpose(-1, -2)))
        decay_to_end = torch.exp(lcum[..., -1:] - lcum)
        S = torch.exp(lcum[..., -1:, None]) * S + (
            (decay_to_end[..., None] * dtc[..., None] * xc).transpose(-1, -2) @ Bc
        )
    y = torch.cat(ys, dim=-2) if ys else xf
    y = y + D.float()[..., None, None] * xf
    return y.to(x.dtype), S
