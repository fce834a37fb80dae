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

from . import ref
from .decode_attention import decode_attention_cuda
from .doneprefix import done_prefix_batch_cuda, done_prefix_packed_cuda
from .flash_attention import flash_attention_cuda
from .rmsnorm import rmsnorm_cuda

__all__ = [
    "attention",
    "decode_attention",
    "rmsnorm",
    "done_prefix",
    "done_prefix_batch",
    "done_prefix_packed",
    "pack_bits_u32",
    "popcount32",
    "IMPLS",
]

IMPLS = ("auto", "cuda", "plain")
popcount32 = ref.popcount32


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl == "pallas":
        raise ValueError(
            "impl='pallas' is the JAX package's TPU route; the port has the "
            "CUDA kernel ('auto' or 'cuda') and the plain version ('plain')"
        )
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs a CUDA tensor")
    return impl != "plain" and t.is_cuda


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
    if _use_kernel(impl, q):
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
    if _use_kernel(impl, q):
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
    if _use_kernel(impl, x):
        y = rmsnorm_cuda(
            x.reshape(-1, x.shape[-1]).contiguous(), weight.contiguous(), eps=eps
        )
        return y.reshape(x.shape)
    return ref.rmsnorm_ref(x, weight, eps=eps)


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
