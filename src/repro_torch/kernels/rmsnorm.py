"""CUDA wrappers of the RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py:23-59``
(``_rmsnorm_kernel`` under ``rmsnorm_pallas``, ``:31``): a row RMSNorm
with the mean of squares in fp32, ``rsqrt(var + eps)``, the product with
the weight in fp32 and the result cast back to x's dtype.

One kernel serves two wrappers.  :func:`add_rmsnorm_cuda` folds the
residual add beside a norm into it: ``s = x + delta`` in x's dtype
(bit for bit PyTorch's add: the fp32 sum rounded once) and
``y = rmsnorm(s, w)``, one launch where the eager pair takes two.
:func:`rmsnorm_cuda` launches the same kernel without ``delta``.

Design: one block per row of about d / 8 threads (whole warps), each
holding 16-byte chunks of the row in registers (8 bf16 or 4 fp32
values): the row is read once, the sum of squares reduced by warp
shuffles and one shared-memory step.  The weight is loaded before the
kernel waits on the one ahead of it on the stream (programmatic
dependent launch), so it must not be written by that kernel.  x and
the weight may each be fp32 or bf16, as template parameters of the
kernel, so a bf16-rounded weight (prefill) and an fp32 master (decode)
both go in without a cast launch.  Rows up to 8,192 fp32 or 16,384 bf16
values.

Bound on the H100: bytes.  At a decode step of the full-width qwen2
cell, [16, 1536] bf16 with an fp32 weight, the fused kernel moves
202,752 bytes (x and delta read, s and y written, the weight read),
0.0605 us at 3.35 TB/s, the plain norm 104,448 bytes, 0.031 us: both
are launch-bound there.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rmsnorm_cuda", "add_rmsnorm_cuda", "DTYPE_CODES", "MAX_D"]

#: the kernels' type codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest row the register tile holds (2 chunks x 1,024 threads)
MAX_D = {torch.float32: 8192, torch.bfloat16: 16384}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("rmsnorm").rmsnorm_launch
        fn.argtypes = [
            ctypes.c_void_p,  # x
            ctypes.c_void_p,  # delta (null: the plain norm)
            ctypes.c_void_p,  # w
            ctypes.c_void_p,  # s (null with delta)
            ctypes.c_void_p,  # y
            ctypes.c_int,  # rows
            ctypes.c_int,  # d
            ctypes.c_float,  # eps
            ctypes.c_int,  # x type code
            ctypes.c_int,  # w type code
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name: str, x: torch.Tensor, weight: torch.Tensor) -> None:
    if not (x.is_cuda and weight.is_cuda and x.device == weight.device):
        raise ValueError(f"{name}: tensors must share a CUDA device")
    if x.dtype not in DTYPE_CODES or weight.dtype not in DTYPE_CODES:
        raise TypeError(
            f"{name}: x and weight must be fp32 or bf16, got {x.dtype} "
            f"and {weight.dtype}"
        )
    if x.dim() != 2 or weight.shape != (x.shape[1],):
        raise ValueError(
            f"{name}: x [rows, d] and weight [d], got {tuple(x.shape)} "
            f"and {tuple(weight.shape)}"
        )
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    rows, d = x.shape
    if not 0 < d <= MAX_D[x.dtype] or rows >= 2**31:
        raise ValueError(
            f"{name}: shape {tuple(x.shape)} out of range (d at most "
            f"{MAX_D[x.dtype]} for {x.dtype})"
        )


def _launch(name, x, delta, weight, s, y, eps) -> None:
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launcher()(
        x.data_ptr(),
        None if delta is None else delta.data_ptr(),
        weight.data_ptr(),
        None if s is None else s.data_ptr(),
        y.data_ptr(),
        x.shape[0],
        x.shape[1],
        float(eps),
        DTYPE_CODES[x.dtype],
        DTYPE_CODES[weight.dtype],
        x.device.index or 0,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def rmsnorm_cuda(
    x: torch.Tensor,  # [rows, d] fp32 or bf16, on a CUDA device
    weight: torch.Tensor,  # [d] fp32 or bf16
    eps: float = 1e-5,
) -> torch.Tensor:  # [rows, d], x's dtype
    """Launch the kernel on the current stream; raises on any input it
    does not take and on a launch the driver refuses."""
    _build.refuse_grad("rmsnorm_cuda", x, weight)
    _check("rmsnorm_cuda", x, weight)
    y = torch.empty_like(x)
    _launch("rmsnorm", x, None, weight, None, y, eps)
    _build.count_launch(rmsnorm_cuda)
    return y


def add_rmsnorm_cuda(
    x: torch.Tensor,  # [rows, d] fp32 or bf16, on a CUDA device: the residual
    delta: torch.Tensor,  # [rows, d], x's dtype: what the block adds to it
    weight: torch.Tensor,  # [d] fp32 or bf16
    eps: float = 1e-5,
):  # -> (s = x + delta, y = rmsnorm(s, weight)), both new [rows, d] tensors
    """Launch the fused kernel on the current stream; raises on any input
    it does not take and on a launch the driver refuses.  ``s`` is a new
    tensor: ``x`` is left as it was."""
    _build.refuse_grad("add_rmsnorm_cuda", x, delta, weight)
    _check("add_rmsnorm_cuda", x, weight)
    if delta.device != x.device or delta.dtype != x.dtype:
        raise TypeError(
            f"add_rmsnorm_cuda: delta must match x's device and dtype, got "
            f"{delta.device} {delta.dtype} and {x.device} {x.dtype}"
        )
    if delta.shape != x.shape or not delta.is_contiguous():
        raise ValueError(
            f"add_rmsnorm_cuda: delta must be contiguous of x's shape "
            f"{tuple(x.shape)}, got {tuple(delta.shape)}"
        )
    s = torch.empty_like(x)
    y = torch.empty_like(x)
    _launch("add_rmsnorm", x, delta, weight, s, y, eps)
    _build.count_launch(add_rmsnorm_cuda)
    return s, y


#: launches of the kernel since the count was last set to 0
rmsnorm_cuda.launches = 0
add_rmsnorm_cuda.launches = 0
