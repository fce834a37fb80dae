"""CUDA wrappers of the done-prefix kernels.

``claim_check_cuda`` (``csrc/done_prefix.cu``) serves the lane engine:
the packed done-prefix redesigned to take the claim masks themselves;
``done_prefix_packed_cuda`` (same source) the prefix of bitmaps that are
already packed; ``done_prefix_batch_cuda`` (``csrc/done_prefix_batch.cu``)
the serving engine's slot rings.

Claim check (``claim_check_cuda``).

Replaces the same TPU kernel as the packed route below, together with
the two steps the reference runs before it on the sweep's exactly-once
path (``src/repro/core/jaxplane.py:1348`` ``pack_bits_u32``, ``:1447``
the popcount): from R bool claim rows of n slots, one launch returns
the packed words (bit b of word j is slot 32*j + b, pad bits 0), each
row's popcount and its done prefix ``min(run from bit 0, n_bits,
limit)``.  The lane engine calls it once per fused sweep, on one
[lanes, n_slots] mask that every policy segment wrote its rows into.

Design: one warp per row, 512 slots a round; each lane turns 16 bool
bytes into 16 bits and two lanes' halves make a word (one shuffle);
``__popc`` and ``__ffs(~w) - 1`` per word, merged with
``__reduce_add_sync`` / ``__reduce_min_sync``.  The load width is the
widest of 16, 8, 4 and 1 bytes that divides n and the mask's address
(:func:`claim_vector_bytes`), so rows that do not start on 16 bytes
(n = 1000) take narrower loads.  Bound: bytes, ~11.4 MB at the sweep's
[5040, 2000] (~3.4 us at 3.35 TB/s).

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

Batched rings, read in place (``done_prefix_batch_mapped``).  The same
kernel on pinned host memory: under unified addressing a page-locked
tensor is mapped into the device, so the kernel reads the engine's ring
state and writes the runs where the host keeps them, with no copy and
on a stream of the caller's, not behind the work queued on the default
stream.  The wrapper asks the CUDA runtime
(``done_prefix_batch_device_pointer``) where the device reaches each
tensor and raises for one it cannot; it never copies.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "claim_check_cuda",
    "claim_check_grid",
    "claim_vector_bytes",
    "done_prefix_packed_cuda",
    "done_prefix_batch_cuda",
    "done_prefix_batch_mapped",
]

_fn = None
_claim_fn = None
_batch_fn = None
_pointer_fn = None


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

#: rows per block of the claim-check kernel (one warp each)
CLAIM_WARPS = 8


def _claim_launcher():
    global _claim_fn
    if _claim_fn is None:
        fn = _build.load("done_prefix").claim_check_launch
        fn.argtypes = [
            ctypes.c_void_p,  # claimed (one byte per slot)
            ctypes.c_void_p,  # limit (null: every row takes limit_all)
            ctypes.c_int,  # limit_all
            ctypes.c_void_p,  # words
            ctypes.c_void_p,  # popcount
            ctypes.c_void_p,  # prefix
            ctypes.c_int,  # rows
            ctypes.c_int,  # n
            ctypes.c_int,  # n_words
            ctypes.c_int,  # n_bits
            ctypes.c_int,  # vec: load width in bytes
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _claim_fn = fn
    return _claim_fn


def claim_vector_bytes(address: int, n: int) -> int:
    """The claim-check kernel's load width: the widest of 16, 8 and 4
    bytes that divides both the row length ``n`` and the mask's
    ``address`` (then every row starts aligned and a chunk never
    straddles a row's end), else 1."""
    for v in (16, 8, 4):
        if n % v == 0 and address % v == 0:
            return v
    return 1


def claim_check_grid(rows: int) -> tuple:
    """(blocks, threads per block) of a claim-check launch over ``rows``."""
    return -(-rows // CLAIM_WARPS), 32 * CLAIM_WARPS


def claim_check_cuda(
    claimed: torch.Tensor,  # [R, n] bool claim masks, on a CUDA device
    limit,  # [R] int32 cap per row, or one int for every row
    n_bits: int,
) -> tuple:  # (words [R, ceil(n/32)] int32, popcount [R] int32, prefix [R] int32)
    """Pack, count and take the done prefix of R claim rows in one
    launch on the current stream; raises on any input it does not take
    and on a launch the driver refuses."""
    name = "claim_check_cuda"
    if not claimed.is_cuda:
        raise ValueError(f"{name}: claimed must be on a CUDA device")
    if claimed.dtype != torch.bool:
        raise TypeError(f"{name}: claimed must be bool, got {claimed.dtype}")
    if claimed.dim() != 2 or not claimed.is_contiguous():
        raise ValueError(f"{name}: claimed must be a contiguous [R, n] tensor")
    rows, n = claimed.shape
    n_words = -(-n // 32)
    n_bits = int(n_bits)
    if not 0 <= n_bits <= 32 * n_words or n >= 2**30 or rows >= 2**31:
        raise ValueError(
            f"{name}: n_bits {n_bits} outside [0, 32 * ceil(n / 32)] or a "
            "dimension past the kernel's int32 indexing"
        )
    if isinstance(limit, torch.Tensor):
        if limit.dtype != torch.int32 or limit.shape != (rows,):
            raise ValueError(
                f"{name}: limit must be an int or an int32 [{rows}] tensor, got "
                f"{limit.dtype} {tuple(limit.shape)}"
            )
        if limit.device != claimed.device or not limit.is_contiguous():
            raise ValueError(f"{name}: limit must be contiguous, on claimed's device")
        lim_ptr, lim_all = limit.data_ptr(), 0
    else:
        lim_ptr, lim_all = None, int(limit)
        if not -(2**31) <= lim_all < 2**31:
            raise ValueError(f"{name}: limit {lim_all} past int32")
    dev = claimed.device
    words = torch.empty((rows, n_words), dtype=torch.int32, device=dev)
    popcount = torch.empty(rows, dtype=torch.int32, device=dev)
    prefix = torch.empty(rows, dtype=torch.int32, device=dev)
    rc = _claim_launcher()(
        claimed.data_ptr(),
        lim_ptr,
        lim_all,
        words.data_ptr(),
        popcount.data_ptr(),
        prefix.data_ptr(),
        rows,
        n,
        n_words,
        n_bits,
        claim_vector_bytes(claimed.data_ptr(), n),
        dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"claim_check launch failed: cudaError {rc}")
    _build.count_launch(claim_check_cuda)
    return words, popcount, prefix


#: launches of the kernel since the count was last set to 0
claim_check_cuda.launches = 0


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


def _check_batch(name: str, done, start, limit) -> None:
    if done.dtype != torch.bool or start.dtype != torch.int32:
        raise TypeError(f"{name}: done must be bool, start int32")
    if limit.dtype != torch.int32:
        raise TypeError(f"{name}: limit must be int32")
    if done.dim() != 2 or start.shape != (done.shape[0],) or limit.shape != start.shape:
        raise ValueError(
            f"{name}: done [R, n], start and limit [R], got "
            f"{tuple(done.shape)}, {tuple(start.shape)}, {tuple(limit.shape)}"
        )
    if not all(t.is_contiguous() for t in (done, start, limit)):
        raise ValueError(f"{name}: inputs must be contiguous")
    rows, n = done.shape
    if not 0 < n < 2**30 or rows >= 2**31:
        raise ValueError(f"{name}: ring size {n} or rows {rows}")


def _launch_batch(ptrs, rows: int, n: int, device: int, stream: int) -> None:
    rc = _batch_launcher()(*ptrs, rows, n, device, stream)
    if rc != 0:
        raise RuntimeError(f"done_prefix_batch launch failed: cudaError {rc}")


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
    _check_batch("done_prefix_batch_cuda", done, start, limit)
    rows, n = done.shape
    out = torch.empty(rows, dtype=torch.int32, device=done.device)
    stream = torch.cuda.current_stream(done.device).cuda_stream
    ptrs = [t.data_ptr() for t in (done, start, limit, out)]
    _launch_batch(ptrs, rows, n, done.device.index or 0, stream)
    _build.count_launch(done_prefix_batch_cuda)
    return out


def _pointer_helper():
    global _pointer_fn
    if _pointer_fn is None:
        fn = _build.load("done_prefix_batch").done_prefix_batch_device_pointer
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
        fn.restype = ctypes.c_int
        _pointer_fn = fn
    return _pointer_fn


def _device_pointer(name: str, t: torch.Tensor, device: int) -> int:
    """Where ``device`` reaches ``t``; raises where it cannot."""
    out = ctypes.c_void_p()
    rc = _pointer_helper()(t.data_ptr(), device, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"{name}: cudaPointerGetAttributes failed: cudaError {rc}")
    if not out.value:
        raise ValueError(f"{name}: pinned memory the device cannot reach")
    return out.value


def done_prefix_batch_mapped(
    done: torch.Tensor,  # [R, n] bool, pinned host memory
    start: torch.Tensor,  # [R] int32, pinned
    limit: torch.Tensor,  # [R] int32, pinned
    out: torch.Tensor,  # [R] int32, pinned: the runs are written here
    stream: torch.cuda.Stream,
) -> torch.Tensor:  # out
    """Launch the kernel on ``stream`` over the tensors where they lie,
    in pinned host memory; ``out`` holds the runs once ``stream`` has
    passed the launch (record an event on it and wait for that).
    Raises for a tensor that is not pinned or that the device cannot
    reach, and on a launch the driver refuses; never copies."""
    name = "done_prefix_batch_mapped"
    ts = (done, start, limit, out)
    if any(t.is_cuda or not t.is_pinned() for t in ts):
        raise ValueError(f"{name}: every tensor must be pinned host memory")
    _check_batch(name, done, start, limit)
    rows, n = done.shape
    if out.dtype != torch.int32 or out.shape != (rows,) or not out.is_contiguous():
        raise ValueError(f"{name}: out must be a contiguous [{rows}] int32 tensor")
    device = stream.device.index or 0
    ptrs = [_device_pointer(name, t, device) for t in ts]
    _launch_batch(ptrs, rows, n, device, stream.cuda_stream)
    _build.count_launch(done_prefix_batch_mapped)
    return out


#: launches of the kernel since the count was last set to 0
done_prefix_batch_cuda.launches = 0
done_prefix_batch_mapped.launches = 0
