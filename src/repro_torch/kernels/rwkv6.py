"""CUDA wrapper of the chunked WKV6 kernel (``csrc/rwkv6.cu``).

Replaces the TPU kernel ``src/repro/kernels/rwkv6.py:29-90``
(``_rwkv6_kernel`` under ``rwkv6_pallas``, ``:93``): the RWKV6 "Finch"
recurrence ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` with the bonus ``u``,
in chunks whose ``[N, N]`` fp32 state crosses a sequential chunk loop;
returns the output and the final fp32 state.

Design: the kernel reads the model layout ``[B, T, H, N]`` where it
lies and treats a ragged last chunk as the reference's padding
(``w = 1``, ``r = k = v = 0``) would, so the wrapper neither pads nor
folds.  One 512-thread block per (b, h, 16 value columns), the state
slice in shared memory, scalar fp32 FMAs over the lower triangle of
each chunk only; the intra-chunk decay is the pairwise factor
``exp(la_{t-1} - la_s) <= 1``, which cannot overflow where the
reference's split factors can.

Bound on the H100 at rwkv6-3b's prefill (B = 1, T = 384, 40 heads of
64, chunk 32): 0.32 GFLOP of fp32 (4.7 us at 67 TFLOP/s) against
13.1 MB (3.9 us at 3.35 TB/s), so operations.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .rmsnorm import DTYPE_CODES

__all__ = ["rwkv6_cuda", "MAX_CHUNK", "MAX_N"]

#: the largest chunk and head size the kernel's shared memory is laid out for
MAX_CHUNK = 64
MAX_N = 64

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("rwkv6").rwkv6_launch
        fn.argtypes = [
            ctypes.c_void_p,  # r
            ctypes.c_void_p,  # k
            ctypes.c_void_p,  # v
            ctypes.c_void_p,  # w
            ctypes.c_void_p,  # u
            ctypes.c_void_p,  # s0
            ctypes.c_void_p,  # o
            ctypes.c_void_p,  # s_out
            ctypes.c_int,  # B
            ctypes.c_int,  # T
            ctypes.c_int,  # H
            ctypes.c_int,  # N
            ctypes.c_int,  # chunk
            ctypes.c_int,  # type code
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rwkv6_cuda(
    r: torch.Tensor,  # [B, T, H, N] fp32 or bf16, on a CUDA device
    k: torch.Tensor,  # [B, T, H, N], r's dtype
    v: torch.Tensor,  # [B, T, H, N], r's dtype
    w: torch.Tensor,  # [B, T, H, N] fp32 decay in (0, 1)
    u: torch.Tensor,  # [H, N] fp32 bonus
    state: torch.Tensor,  # [B, H, N, N] fp32 initial state
    chunk: int = 32,
):  # -> (o [B, T, H, N] in r's dtype, final state [B, H, N, N] fp32)
    """Launch the kernel on the current stream; raises on any input it
    does not take and on a launch the CUDA runtime refuses."""
    ts = (r, k, v, w, u, state)
    if not all(t.is_cuda and t.device == r.device for t in ts):
        raise ValueError("rwkv6_cuda: tensors must share a CUDA device")
    if r.dtype not in DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("rwkv6_cuda: r, k, v must all be fp32 or bf16")
    if not all(t.dtype == torch.float32 for t in (w, u, state)):
        raise TypeError("rwkv6_cuda: w, u and the state must be fp32")
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError("rwkv6_cuda: r, k, v, w must all be [B, T, H, N]")
    B, T, H, N = r.shape
    if u.shape != (H, N) or state.shape != (B, H, N, N):
        raise ValueError(
            f"rwkv6_cuda: u {tuple(u.shape)} and state {tuple(state.shape)} "
            f"do not fit r {tuple(r.shape)}"
        )
    if not (0 < N <= MAX_N and (N <= 16 or N % 16 == 0)):
        raise ValueError(f"rwkv6_cuda: head size {N}: at most {MAX_N}, 16 | N past 16")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"rwkv6_cuda: chunk {chunk} not in 1..{MAX_CHUNK}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rwkv6_cuda: inputs must be contiguous")
    if B * H >= 2**31 or r.numel() >= 2**62:
        raise ValueError(f"rwkv6_cuda: shape {tuple(r.shape)} out of range")
    o = torch.empty_like(r)
    s_out = torch.empty_like(state)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _launcher()(
        r.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        w.data_ptr(),
        u.data_ptr(),
        state.data_ptr(),
        o.data_ptr(),
        s_out.data_ptr(),
        B,
        T,
        H,
        N,
        int(chunk),
        DTYPE_CODES[r.dtype],
        r.device.index or 0,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"rwkv6 launch failed: cudaError {rc}")
    _build.count_launch(rwkv6_cuda)
    return o, s_out


#: launches of the kernel since the count was last set to 0
rwkv6_cuda.launches = 0
