"""Kernel dispatch and the COREC bit operations of the port.

``impl="auto"`` launches the hand-written kernel for a CUDA tensor and
runs the plain PyTorch version for a CPU tensor; ``impl="cuda"``
insists on the kernel and raises for a CPU tensor.  There is no
fallback: a CUDA tensor either goes through the kernel or raises.  The
TPU route of the reference (``impl="pallas"``) has no counterpart here
and is rejected by name.
"""

from __future__ import annotations

import torch

from . import ref
from .doneprefix import done_prefix_packed_cuda

__all__ = ["done_prefix_packed", "pack_bits_u32", "popcount32", "IMPLS"]

IMPLS = ("auto", "cuda")
popcount32 = ref.popcount32


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl == "pallas":
        raise ValueError(
            "impl='pallas' is the JAX package's TPU route; the port has the "
            "CUDA kernel ('auto' or 'cuda')"
        )
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs a CUDA tensor")
    return t.is_cuda


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
