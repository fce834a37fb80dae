"""Plain PyTorch versions of the port's kernels.

The CPU tests run these against the JAX package's oracles, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
They repeat the kernels' arithmetic and are no yardstick of speed.
Each takes the layout of its counterpart in ``repro.kernels.ref``:
attention in the model layout ``[B, S, H, D]``, RMSNorm over the last
axis, done-prefix masks as ``[n]`` or ``[R, n]`` bools.

Packed bitmaps are carried as the int32 bit pattern of the reference's
uint32 words (PyTorch has no ``~``, ``>>`` or popcount on
``torch.uint32``); arithmetic widens to int64 and masks to the low 32
bits, and comparisons with the reference view the words as uint32.
"""

from __future__ import annotations

import torch

__all__ = [
    "rmsnorm_ref",
    "attention_ref",
    "decode_attention_ref",
    "done_prefix_ref",
    "done_prefix_batch_ref",
    "done_prefix_packed_ref",
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
