"""CUDA wrappers of the done-prefix kernels.

``done_prefix_packed_cuda`` (``csrc/done_prefix.cu``) serves the lane
engine; ``done_prefix_batch_cuda`` (``csrc/done_prefix_batch.cu``) the
serving engine's slot rings.

Packed (``done_prefix_packed_cuda``).

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

Batched rings (``done_prefix_batch_cuda``).  Replaces the TPU kernel
``src/repro/kernels/doneprefix.py:58-103`` (``_done_prefix_kernel``
under ``done_prefix_batch_pallas``, ``:81``): for each of R bool rings
the contiguous run of done slots from ``start`` (mod n), capped by
``limit`` -- the paper's TAIL advance, for every decode-slot ring of
the serving engine in one launch.  One warp per ring walks it in
rotated order, 32 offsets a round; ``__ballot_sync`` finds the first
not-done offset and the loop stops there.  Bound: bytes (each mask byte
at most once), a few bytes at the serving engine's shapes, so a launch
is all it costs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["done_prefix_packed_cuda", "done_prefix_batch_cuda"]

_fn = None
_batch_fn = None


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
    _build.count_launch(done_prefix_packed_cuda)
    return out


#: launches of the kernel since the count was last set to 0
done_prefix_packed_cuda.launches = 0


def _batch_launcher():
    global _batch_fn
    if _batch_fn is None:
        fn = _build.load("done_prefix_batch").done_prefix_batch_launch
        fn.argtypes = [
            ctypes.c_void_p,  # done (one byte per slot)
            ctypes.c_void_p,  # start
            ctypes.c_void_p,  # limit
            ctypes.c_void_p,  # out
            ctypes.c_int,  # rows
            ctypes.c_int,  # n
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _batch_fn = fn
    return _batch_fn


def done_prefix_batch_cuda(
    done: torch.Tensor,  # [R, n] bool, one READ_DONE row per ring, CUDA
    start: torch.Tensor,  # [R] int32 TAIL slot index per ring
    limit: torch.Tensor,  # [R] int32 cap per ring
) -> torch.Tensor:  # [R] int32
    """Launch the kernel on the current stream; raises on any input it
    does not take and on a launch the driver refuses."""
    ts = (done, start, limit)
    if not all(t.is_cuda and t.device == done.device for t in ts):
        raise ValueError("done_prefix_batch_cuda: tensors must share a CUDA device")
    if done.dtype != torch.bool or start.dtype != torch.int32:
        raise TypeError("done_prefix_batch_cuda: done must be bool, start int32")
    if limit.dtype != torch.int32:
        raise TypeError("done_prefix_batch_cuda: limit must be int32")
    if done.dim() != 2 or start.shape != (done.shape[0],) or limit.shape != start.shape:
        raise ValueError(
            f"done_prefix_batch_cuda: done [R, n], start and limit [R], got "
            f"{tuple(done.shape)}, {tuple(start.shape)}, {tuple(limit.shape)}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("done_prefix_batch_cuda: inputs must be contiguous")
    rows, n = done.shape
    if not 0 < n < 2**30 or rows >= 2**31:
        raise ValueError(f"done_prefix_batch_cuda: ring size {n} or rows {rows}")
    out = torch.empty(rows, dtype=torch.int32, device=done.device)
    stream = torch.cuda.current_stream(done.device).cuda_stream
    rc = _batch_launcher()(
        done.data_ptr(),
        start.data_ptr(),
        limit.data_ptr(),
        out.data_ptr(),
        rows,
        n,
        done.device.index or 0,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"done_prefix_batch launch failed: cudaError {rc}")
    _build.count_launch(done_prefix_batch_cuda)
    return out


#: launches of the kernel since the count was last set to 0
done_prefix_batch_cuda.launches = 0
