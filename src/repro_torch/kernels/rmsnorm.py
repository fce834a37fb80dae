"""CUDA wrapper of the RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py:23-59``
(``_rmsnorm_kernel`` under ``rmsnorm_pallas``, ``:31``): a row RMSNorm
with the mean of squares in fp32, ``rsqrt(var + eps)``, the product with
the weight in fp32 and the result cast back to x's dtype.

Design: one 256-thread block per row (a row is at most d_model = 8,192
values, so it needs no tiling), a shuffle-tree reduction, and a second
pass that writes ``(x * inv) * w`` in the reference's order.  x and the
weight may each be fp32 or bf16, as template parameters of the kernel,
so a bf16-rounded weight (prefill) and an fp32 master (decode) both go
in without a cast launch.

Bound on the H100: bytes (x read, y written, the weight read once).  A
decode step of the full-width cell normalises 16 rows of 1,536 bf16
values, 104 KB, about 0.03 us: the kernel is launch-bound there.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rmsnorm_cuda", "DTYPE_CODES"]

#: the kernels' type codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("rmsnorm").rmsnorm_launch
        fn.argtypes = [
            ctypes.c_void_p,  # x
            ctypes.c_void_p,  # w
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


def rmsnorm_cuda(
    x: torch.Tensor,  # [rows, d] fp32 or bf16, on a CUDA device
    weight: torch.Tensor,  # [d] fp32 or bf16
    eps: float = 1e-5,
) -> torch.Tensor:  # [rows, d], x's dtype
    """Launch the kernel on the current stream; raises on any input it
    does not take and on a launch the driver refuses."""
    if not (x.is_cuda and weight.is_cuda and x.device == weight.device):
        raise ValueError("rmsnorm_cuda: tensors must share a CUDA device")
    if x.dtype not in DTYPE_CODES or weight.dtype not in DTYPE_CODES:
        raise TypeError(
            f"rmsnorm_cuda: x and weight must be fp32 or bf16, got {x.dtype} "
            f"and {weight.dtype}"
        )
    if x.dim() != 2 or weight.shape != (x.shape[1],):
        raise ValueError(
            f"rmsnorm_cuda: x [rows, d] and weight [d], got {tuple(x.shape)} "
            f"and {tuple(weight.shape)}"
        )
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm_cuda: inputs must be contiguous")
    rows, d = x.shape
    if not 0 < d < 2**31 or rows >= 2**31:
        raise ValueError(f"rmsnorm_cuda: shape {tuple(x.shape)} out of range")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launcher()(
        x.data_ptr(),
        weight.data_ptr(),
        y.data_ptr(),
        rows,
        d,
        float(eps),
        DTYPE_CODES[x.dtype],
        DTYPE_CODES[weight.dtype],
        x.device.index or 0,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"rmsnorm launch failed: cudaError {rc}")
    _build.count_launch(rmsnorm_cuda)
    return y


#: launches of the kernel since the count was last set to 0
rmsnorm_cuda.launches = 0
