"""CUDA wrapper of the packed done-prefix kernel (``csrc/done_prefix.cu``).

Replaces the TPU kernel ``src/repro/kernels/doneprefix.py:106-162``
(``_done_prefix_packed_kernel`` under ``done_prefix_packed_pallas``):
the contiguous run of set bits from bit 0 of each word-packed bitmap
row, capped by ``n_bits`` and a per-row ``limit`` -- the lane engine's
exactly-once check, one launch for every lane of a fused sweep.

Design: one warp per row; lanes stride over the row's words (coalesced
reads), take each word's trailing ones with ``__ffs(~w) - 1`` and merge
their minima with ``__reduce_min_sync``.  The TPU kernel's running min
over a sequential grid axis has no Hopper counterpart (blocks run in
no order), so the word loop lives inside the warp.

Bound on the H100: bytes.  At the sweep's shape, [5040, 63] words, the
kernel moves about 1.3 MB (each word and limit read once, one int32
written per row), about 0.4 us at 3.35 TB/s -- far below the cost of a
launch, so launch latency dominates and the simple layout is enough.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["done_prefix_packed_cuda"]

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("done_prefix").done_prefix_packed_launch
        fn.argtypes = [
            ctypes.c_void_p,  # words
            ctypes.c_void_p,  # limit
            ctypes.c_void_p,  # out
            ctypes.c_int,  # rows
            ctypes.c_int,  # n_words
            ctypes.c_int,  # n_bits
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def done_prefix_packed_cuda(
    words: torch.Tensor,  # [R, n_words] int32 bit pattern, on a CUDA device
    limit: torch.Tensor,  # [R] int32
    n_bits: int,
) -> torch.Tensor:  # [R] int32
    """Launch the kernel on the current stream; raises on any input it
    does not take and on a launch the driver refuses."""
    if not (words.is_cuda and limit.is_cuda and words.device == limit.device):
        raise ValueError("done_prefix_packed_cuda: tensors must share a CUDA device")
    if words.dtype != torch.int32 or limit.dtype != torch.int32:
        raise TypeError("done_prefix_packed_cuda: words and limit must be int32")
    if words.dim() != 2 or limit.shape != (words.shape[0],):
        raise ValueError(
            f"done_prefix_packed_cuda: words [R, n_words] and limit [R], got "
            f"{tuple(words.shape)} and {tuple(limit.shape)}"
        )
    if not (words.is_contiguous() and limit.is_contiguous()):
        raise ValueError("done_prefix_packed_cuda: inputs must be contiguous")
    rows, n_words = words.shape
    n_bits = int(n_bits)
    if not 0 <= n_bits <= 32 * n_words < 2**31 or rows >= 2**31:
        raise ValueError(
            f"done_prefix_packed_cuda: n_bits {n_bits} outside [0, 32 * n_words] "
            "or a dimension past the kernel's int32 indexing"
        )
    out = torch.empty(rows, dtype=torch.int32, device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = _launcher()(
        words.data_ptr(),
        limit.data_ptr(),
        out.data_ptr(),
        rows,
        n_words,
        n_bits,
        words.device.index or 0,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"done_prefix_packed launch failed: cudaError {rc}")
    done_prefix_packed_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
done_prefix_packed_cuda.launches = 0
