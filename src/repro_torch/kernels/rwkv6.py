"""CUDA wrapper of the chunked WKV6 kernels (``csrc/rwkv6.cu``).

Replaces the TPU kernel ``src/repro/kernels/rwkv6.py:29-90``
(``_rwkv6_kernel`` under ``rwkv6_pallas``, ``:93``): the RWKV6 "Finch"
recurrence ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` with the bonus ``u``;
returns the output and the final fp32 state.

Design: the kernels read the model layout ``[B, T, H, N]`` where it
lies and treat a ragged last chunk as the reference's padding
(``w = 1``, ``r = k = v = 0``) would, so the wrapper neither pads nor
folds.  The prompt runs chunk-parallel in three passes of one call, over
chunks of 64 tokens: each chunk's own state, the state passed from chunk
to chunk, then the outputs with the intra-chunk matrix built once per
(b, h, chunk).  bf16 runs the products on the tensor cores, the part of
the intra-chunk matrix below its 16 x 16 diagonal blocks factored
through a reference token so that no factor exceeds its input; fp32
runs scalar FMAs (a dispatch on dtype).  No exponential takes an
argument above 0, so nothing overflows where the reference's split
factors can.  :func:`rwkv6_plan` holds the launch plan in plain Python;
the workspace is allocated here per call, and the wrapper counts one
launch per call.

Bound on the H100 at rwkv6-3b's prefill (B = 1, T = 384, 40 heads of
64): 13,117,440 bytes, 3.916 us at 3.35 TB/s; 0.32 GFLOP, 4.72 us at the
67 TFLOP/s fp32 scalar rate, 0.32 us at the 989 TFLOP/s bf16 tensor rate.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .rmsnorm import DTYPE_CODES
from .scan_workspace import state_pass_blocks, workspace

__all__ = ["rwkv6_cuda", "rwkv6_plan", "Rwkv6Plan", "MAX_CHUNK", "MAX_N"]

#: the largest chunk and head size the kernel's shared memory is laid out for
MAX_CHUNK = 64
MAX_N = 64
#: tokens per chunk of the kernels' passes, whatever chunk the caller asks
CHUNK_TILE = 64

_fn = None


class Rwkv6Plan(NamedTuple):
    """The launch plan of one call: pass 1 ``state_grid`` and pass 3
    ``out_grid`` (chunks, heads, batch), pass 2 ``pass_grid`` (batch *
    heads, element blocks), and the workspace."""

    n_chunks: int
    state_grid: tuple
    pass_grid: tuple
    out_grid: tuple
    ws_offsets: tuple  # bytes: (chunk states fp32, incoming states, decays fp32)
    workspace_bytes: int


def rwkv6_plan(B: int, T: int, H: int, N: int) -> Rwkv6Plan:
    """The kernels' launch plan for r/k/v ``[B, T, H, N]`` (either dtype)."""
    nc = -(-T // CHUNK_TILE)
    offsets, total = workspace(B * H * nc * N * N, B * H * nc * N)
    return Rwkv6Plan(
        nc,
        (nc, H, B),
        (B * H, state_pass_blocks(N * N, N % 4 == 0)),  # 4 share a decay row
        (nc, H, B),
        offsets,
        total,
    )


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
            ctypes.c_int,  # chunks
            ctypes.c_void_p,  # workspace
            *[ctypes.c_longlong] * 3,  # its parts' byte offsets
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
    _build.refuse_grad("rwkv6_cuda", r, k, v, w, u, state)
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
    if B * H >= 2**31 or B >= 65536 or H >= 65536 or r.numel() >= 2**62:
        raise ValueError(f"rwkv6_cuda: shape {tuple(r.shape)} out of range")
    plan = rwkv6_plan(B, T, H, N)
    o = torch.empty_like(r)
    s_out = torch.empty_like(state)
    # per call, so that threads launching at once never share it
    ws = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=r.device)
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
        plan.n_chunks,
        ws.data_ptr(),
        *plan.ws_offsets,
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
