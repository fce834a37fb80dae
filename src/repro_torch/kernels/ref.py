"""Plain PyTorch versions of the port's kernels.

The CPU tests run these against the JAX package's oracles, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
They repeat the kernels' arithmetic and are no yardstick of speed.

Packed bitmaps are carried as the int32 bit pattern of the reference's
uint32 words (PyTorch has no ``~``, ``>>`` or popcount on
``torch.uint32``); arithmetic widens to int64 and masks to the low 32
bits, and comparisons with the reference view the words as uint32.
"""

from __future__ import annotations

import torch

__all__ = ["done_prefix_packed_ref", "popcount32", "MASK32"]

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
