"""Kernel dispatch and the COREC bit operations of the port.

Every op takes the reference's model layout (``repro.kernels.ops``) and
an ``impl``:

  'auto'   the hand-written kernel for a CUDA tensor, the plain PyTorch
           version for a CPU tensor -- the default
  'cuda'   the kernel; raises for a CPU tensor
  'plain'  the plain PyTorch version on any device, asked for by name
           (the models map the reference's 'xla' and 'naive' here)

There is no fallback: a CUDA tensor goes through the kernel unless the
caller named 'plain', and a kernel that cannot take its input raises.
The TPU route of the reference (``impl="pallas"``) has no counterpart
here and is rejected by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, ref
from .decode_attention import decode_attention_cuda
from .doneprefix import (
    claim_check_cuda,
    done_prefix_batch_cuda,
    done_prefix_packed_cuda,
)
from .flash_attention import flash_attention_cuda
from .rmsnorm import add_rmsnorm_cuda, rmsnorm_cuda
from .rwkv6 import rwkv6_cuda
from .ssd import ssd_cuda

__all__ = [
    "attention",
    "decode_attention",
    "rmsnorm",
    "add_rmsnorm",
    "rwkv6",
    "rwkv6_step",
    "ssd",
    "ssd_step",
    "done_prefix",
    "done_prefix_batch",
    "done_prefix_packed",
    "claim_check",
    "pack_bits_u32",
    "first_set_bits",
    "IMPLS",
    "selects_kernel",
]

IMPLS = ("auto", "cuda", "plain")


def selects_kernel(impl: str, t: torch.Tensor) -> bool:
    """Whether an op asked for ``impl`` picks its kernel for ``t``: by
    name, or ``"auto"`` on a CUDA tensor."""
    return impl == "cuda" or (impl == "auto" and t.is_cuda)


def _use_kernel(impl: str, t: torch.Tensor, *inputs) -> bool:
    """Whether the op runs its kernel on ``t`` (the tensor that decides the
    device).  Where a kernel would run, or is asked for by name, and grad
    mode is on, ``t`` and the op's other ``inputs`` go through
    ``_build.refuse_grad`` first, before the device check: a kernel has
    no backward, and nothing switches to the plain version on its own.
    Training asks for the plain versions by name (``attention_impl='xla'``),
    as the reference trains on its XLA routes."""
    if impl == "pallas":
        raise ValueError(
            "impl='pallas' is the JAX package's TPU route; the port has the "
            "CUDA kernel ('auto' or 'cuda') and the plain version ('plain')"
        )
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    kernel = selects_kernel(impl, t)
    if kernel:
        _build.refuse_grad(f"impl={impl!r}", t, *inputs)
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs a CUDA tensor")
    return kernel


def done_prefix_packed(
    words: torch.Tensor,  # [R, n_words] int32 bit pattern, bit b of word j
    limit: torch.Tensor,  # is slot 32*j + b; [R] cap per row
    n_bits: int | None = None,
    impl: str = "auto",
) -> torch.Tensor:  # [R] int32
    """Contiguous done prefix of R word-packed bitmaps in one launch
    (mirrors ``repro.kernels.ops.done_prefix_packed``)."""
    if n_bits is None:
        n_bits = 32 * words.shape[-1]
    if _use_kernel(impl, words):
        return done_prefix_packed_cuda(
            words.to(torch.int32).contiguous(),
            limit.to(device=words.device, dtype=torch.int32).contiguous(),
            n_bits,
        )
    return ref.done_prefix_packed_ref(words, limit, n_bits=n_bits)


def claim_check(
    claimed: torch.Tensor,  # [R, n] bool claim masks
    limit,  # [R] cap per row, or one int for every row
    n_bits: int | None = None,
    impl: str = "auto",
) -> tuple:  # (words [R, ceil(n/32)] int32, popcount [R] int32, prefix [R] int32)
    """The exactly-once check of R claim rows in one launch: the words of
    :func:`pack_bits_u32`, their popcount per row, and
    :func:`done_prefix_packed` of the words (``n_bits`` defaults to n).
    The plain version runs those three steps as the reference does
    (``pack_bits_u32``, ``lax.population_count`` summed, the prefix)."""
    rows, n = claimed.shape
    if n_bits is None:
        n_bits = n
    if _use_kernel(impl, claimed):
        if isinstance(limit, torch.Tensor):
            limit = limit.to(device=claimed.device, dtype=torch.int32).contiguous()
        return claim_check_cuda(claimed.to(torch.bool).contiguous(), limit, n_bits)
    words = pack_bits_u32(claimed)
    popcount = ref.popcount32(words).sum(dim=1).to(torch.int32)
    if not isinstance(limit, torch.Tensor):
        limit = torch.full((rows,), int(limit), dtype=torch.int32)
    prefix = ref.done_prefix_packed_ref(words, limit.to(words.device), n_bits)
    return words, popcount, prefix


def attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
    q_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:  # [B, Sq, H, D]
    """Prefill GQA attention (``repro.kernels.ops.attention``).  The
    kernel reads the model layout as it lies, so the reference's fold to
    ``[B*H, S, D]`` (query row ``bh`` reads KV row ``bh // G``) happens
    in its indexing, not in a copy."""
    if _use_kernel(impl, q, k, v):
        return flash_attention_cuda(
            q.contiguous(),
            k.contiguous(),
            v.contiguous(),
            causal=causal,
            scale=scale,
            q_offset=q_offset,
        )
    return ref.attention_ref(q, k, v, causal=causal, scale=scale, q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,  # [B, H, D], one new token per sequence
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid cache length per sequence
    scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:  # [B, H, D]
    """One-token attention over a cache (``repro.kernels.ops.decode_attention``).
    The kernel groups the G query heads of a KV head as the reference's
    ``q.reshape(B, Hkv, G, D)`` does, reading the cache in place."""
    if _use_kernel(impl, q, k_cache, v_cache):
        return decode_attention_cuda(
            q.contiguous(),
            k_cache.contiguous(),
            v_cache.contiguous(),
            lengths.to(device=q.device, dtype=torch.int32).contiguous(),
            scale=scale,
        )
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)


def rmsnorm(
    x: torch.Tensor,  # [..., d]
    weight: torch.Tensor,  # [d]
    eps: float = 1e-5,
    impl: str = "auto",
) -> torch.Tensor:
    """RMSNorm over the last axis (``repro.kernels.ops.rmsnorm``); the
    kernel sees ``x`` flattened to ``[rows, d]``."""
    if _use_kernel(impl, x, weight):
        y = rmsnorm_cuda(
            x.reshape(-1, x.shape[-1]).contiguous(), weight.contiguous(), eps=eps
        )
        return y.reshape(x.shape)
    return ref.rmsnorm_ref(x, weight, eps=eps)


def add_rmsnorm(
    x: torch.Tensor,  # [..., d] the residual stream
    delta: torch.Tensor,  # [..., d] what a block adds to it, x's dtype
    weight: torch.Tensor,  # [d]
    eps: float = 1e-5,
    impl: str = "auto",
):  # -> (s = x + delta, y = rmsnorm(s, weight)), x's shape each
    """The residual add and the RMSNorm after it: ``s = x + delta`` in x's
    dtype, then :func:`rmsnorm` of ``s``.  The kernel does both in one
    launch (``add_rmsnorm_cuda``), ``s`` bit for bit the eager add's; the
    plain version is the two steps (``ref.add_rmsnorm_ref``).  ``s`` is a
    new tensor on both routes."""
    if _use_kernel(impl, x, delta, weight):
        d = x.shape[-1]
        s, y = add_rmsnorm_cuda(
            x.reshape(-1, d).contiguous(),
            delta.reshape(-1, d).contiguous(),
            weight.contiguous(),
            eps=eps,
        )
        return s.reshape(x.shape), y.reshape(x.shape)
    return ref.add_rmsnorm_ref(x, delta, weight, eps=eps)


def _heads_first(a: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``[B, T, H, ...]`` -> ``[B, H, T + pad, ...]`` (a permuted view,
    padded along T with ``value``): the plain scans' layout."""
    a = a.movedim(2, 1)
    if not pad:
        return a
    tail = (0, 0) * (a.dim() - 3)
    return F.pad(a, tail + (0, pad), value=value)


def rwkv6(
    r: torch.Tensor,  # [B, T, H, N]
    k: torch.Tensor,  # [B, T, H, N]
    v: torch.Tensor,  # [B, T, H, N]
    w: torch.Tensor,  # [B, T, H, N] decay in (0, 1)
    u: torch.Tensor,  # [H, N] bonus
    state: torch.Tensor | None = None,  # [B, H, N, N] fp32
    chunk: int = 32,
    impl: str = "auto",
):  # -> (o [B, T, H, N] in r's dtype, final state [B, H, N, N] fp32)
    """Chunked WKV6 over a whole sequence (``repro.kernels.ops.rwkv6``).
    The plain route pads T to a multiple of ``chunk`` with ``w = 1`` and
    ``r = k = v = 0`` (no decay, no contribution) and slices o back; the
    kernel reads the model layout in place and takes the ragged last
    chunk as that padding would."""
    B, T, H, N = r.shape
    if state is None:
        state = torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
    if _use_kernel(impl, r, k, v, w, u, state):
        return rwkv6_cuda(
            r.contiguous(),
            k.contiguous(),
            v.contiguous(),
            w.float().contiguous(),
            u.float().contiguous(),
            state.float().contiguous(),
            chunk=chunk,
        )
    pad = (-T) % chunk
    o, s = ref.rwkv6_chunk_ref(
        _heads_first(r, pad),
        _heads_first(k, pad),
        _heads_first(v, pad),
        _heads_first(w, pad, value=1.0),
        u.float(),
        state,
        chunk=chunk,
    )
    return o[:, :, :T].movedim(1, 2), s


def rwkv6_step(
    r: torch.Tensor,  # [B, H, N] one token
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,  # [H, N]
    state: torch.Tensor,  # [B, H, N, N]
):  # -> (o [B, H, N] in r's dtype, new state fp32)
    """One decode step of the WKV6 recurrence, plain PyTorch on any
    device (``repro.kernels.ops.rwkv6_step``, plain ``jnp`` there too)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    Sf = state.float()
    kv = kf[..., :, None] * vf[..., None, :]
    o = torch.einsum("bhij,bhi->bhj", Sf + u[None, :, :, None] * kv, rf)
    return o.to(r.dtype), wf[..., :, None] * Sf + kv


def ssd(
    x: torch.Tensor,  # [B, T, H, P]
    dt: torch.Tensor,  # [B, T, H] step sizes
    A: torch.Tensor,  # [H] decay rates
    B: torch.Tensor,  # [B, T, G, N]
    C: torch.Tensor,  # [B, T, G, N]
    D: torch.Tensor,  # [H] skip
    state: torch.Tensor | None = None,  # [B, H, P, N] fp32
    chunk: int = 64,
    impl: str = "auto",
):  # -> (y [B, T, H, P], final state [B, H, P, N] fp32)
    """Mamba-2 SSD chunk scan (``repro.kernels.ops.ssd``), each route as
    its reference counterpart computes it.  The kernel route gets y
    without D in x's dtype and adds ``D * x`` outside: with fp32 D and a
    bf16 x the sum promotes to fp32, as ``jnp`` does.  The plain route
    repeats B/C over the H/G heads of a group, zero-pads T (``dt = 0``:
    no decay, no input) and adds D inside, in fp32, before the cast to
    x's dtype.  In bf16 the two routes therefore round differently."""
    Bb, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if state is None:
        state = torch.zeros(Bb, H, P, N, dtype=torch.float32, device=x.device)
    if _use_kernel(impl, x, dt, A, B, C, D, state):
        y, s = ssd_cuda(
            x,
            dt.float().contiguous(),
            A.float().contiguous(),
            B,
            C,
            state.float().contiguous(),
            chunk=chunk,
        )
        return y + D[None, None, :, None] * x, s
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2)
    Ch = C.repeat_interleave(rep, dim=2)
    pad = (-T) % chunk
    y, s = ref.ssd_chunk_ref(
        _heads_first(x, pad),
        _heads_first(dt, pad),
        A,
        _heads_first(Bh, pad),
        _heads_first(Ch, pad),
        D,
        state,
        chunk=chunk,
    )
    return y[:, :, :T].movedim(1, 2), s


def ssd_step(
    x: torch.Tensor,  # [B, H, P]
    dt: torch.Tensor,  # [B, H]
    A: torch.Tensor,  # [H]
    B: torch.Tensor,  # [B, G, N]
    C: torch.Tensor,  # [B, G, N]
    D: torch.Tensor,  # [H]
    state: torch.Tensor,  # [B, H, P, N]
):  # -> (y [B, H, P] in x's dtype, new state fp32)
    """One step of the SSD recurrence, plain PyTorch on any device
    (``repro.kernels.ops.ssd_step``, plain ``jnp`` there too).  No model
    calls it: Zamba's decode step runs :func:`ssd` on its one token, as
    the reference's ``_mamba_step`` does."""
    rep = x.shape[1] // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1).float()
    Ch = C.repeat_interleave(rep, dim=1).float()
    xf, dtf = x.float(), dt.float()
    dA = torch.exp(A[None].float() * dtf)
    S_new = dA[..., None, None] * state + torch.einsum(
        "bhp,bhn->bhpn", dtf[..., None] * xf, Bh
    )
    y = torch.einsum("bhpn,bhn->bhp", S_new, Ch) + D[None, :, None] * xf
    return y.to(x.dtype), S_new


def done_prefix_batch(
    done: torch.Tensor,  # [R, n] bool, one READ_DONE row per slot ring
    start: torch.Tensor,  # [R] TAIL slot index per ring
    limit: torch.Tensor,  # [R] cap per ring
    impl: str = "auto",
) -> torch.Tensor:  # [R] int32
    """Releasable prefixes of R slot rings in one kernel launch
    (``repro.kernels.ops.done_prefix_batch``)."""
    if _use_kernel(impl, done):
        dev = done.device
        return done_prefix_batch_cuda(
            done.to(torch.bool).contiguous(),
            start.to(device=dev, dtype=torch.int32).contiguous(),
            limit.to(device=dev, dtype=torch.int32).contiguous(),
        )
    return ref.done_prefix_batch_ref(done, start, limit)


def done_prefix(
    done: torch.Tensor,  # [n] bool
    start,  # TAIL slot index
    limit,  # cap
    impl: str = "auto",
) -> torch.Tensor:  # [] int32
    """One ring: :func:`done_prefix_batch` on a single row
    (``repro.kernels.ops.done_prefix``)."""
    dev = done.device
    start = torch.as_tensor(start, device=dev).reshape(1)
    limit = torch.as_tensor(limit, device=dev).reshape(1)
    return done_prefix_batch(done[None], start, limit, impl=impl)[0]


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """Pack a trailing bool axis into 32-bit words (AtomicBitmap layout).

    ``bits[..., 32*j + b]`` becomes bit ``b`` of ``words[..., j]``, as
    ``repro.kernels.ops.pack_bits_u32`` lays them out; the words come
    back as the int32 bit pattern that :func:`done_prefix_packed` takes.
    """
    *lead, n = bits.shape
    n_words = -(-n // 32)
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, n_words * 32 - n))
    b = b.reshape(*lead, n_words, 32)
    shifts = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, dtype=torch.int64, device=bits.device
    )
    w = (b * shifts).sum(dim=-1)  # < 2**32: no overflow in int64
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def first_set_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the ``k`` lowest set bits of packed rows.

    ``words`` is ``[..., n_words]`` in the layout of :func:`pack_bits_u32`
    (the int32 bit pattern, or int64 holding the low 32 bits); returns
    ``[..., k]`` int32 positions in ascending order, padded with ``-1``
    where a row has fewer than ``k`` set bits -- ``repro.kernels.ops.
    first_set_bits`` on every row at once.  Where the reference peels
    one bit a round (``k`` rounds of find-lowest and clear), this unpacks
    the row, ranks its set bits with a running count and scatters the
    first ``k`` to their ranks: a handful of launches whatever ``k``.
    """
    *lead, n_words = words.shape
    dev = words.device
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((words.to(torch.int64) & ref.MASK32)[..., None] >> shifts) & 1
    bits = bits.reshape(*lead, n_words * 32)
    rank = torch.cumsum(bits, dim=-1) - 1
    keep = (bits == 1) & (rank < k)
    pos = torch.arange(n_words * 32, dtype=torch.int64, device=dev).expand_as(bits)
    # bits past the k-th, and clear bits, all write -1 to a dump column
    out = torch.full((*lead, k + 1), -1, dtype=torch.int64, device=dev)
    out.scatter_(-1, torch.where(keep, rank, k), torch.where(keep, pos, -1))
    return out[..., :k].to(torch.int32)
