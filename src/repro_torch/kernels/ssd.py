"""CUDA wrapper of the Mamba-2 SSD chunk-scan kernels (``csrc/ssd.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd.py:29-84``
(``_ssd_kernel`` under ``ssd_pallas``, ``:87``): the state-space-dual
scan ``S_t = exp(A dt_t) S_{t-1} + dt_t x_t B_t^T``, ``y_t = S_t C_t``;
returns y without the D-skip (``ops.ssd`` adds it, as the reference's
``ops.ssd`` does) and the final fp32 state.

Design: the kernels read the model layout where it lies: x
``[B, T, H, P]``, dt ``[B, T, H]``, B/C ``[B, T, G, N]`` read by group
``h // (H / G)`` (no H/G-fold copy), x, B and C possibly views into the
Mamba block's conv output (a batch and a token stride each).  A
sequence (T > 1) runs chunk-parallel in three passes of one call, over
chunks of 64 tokens: each chunk's own state, the state passed from
chunk to chunk, then the outputs with ``C B^T`` computed once per chunk
and block of heads; bf16 runs them on the tensor cores, fp32 on scalar
FMAs (a dispatch on dtype).  One token (T == 1, a decode step) runs a
kernel of its own that reads and writes each state row once.
:func:`ssd_plan` holds the launch plan (grids, heads per output block,
workspace) in plain Python; the workspace is allocated here per call,
and the wrapper counts one launch per call.

Bound on the H100 at zamba2-1.2b's prefill (B = 1, T = 384, 64 heads,
P = N = 64, G = 1): 8,585,472 bytes, 2.563 us at 3.35 TB/s; 0.61 GFLOP,
9.06 us at the 67 TFLOP/s fp32 scalar rate, 0.61 us at the 989 TFLOP/s
bf16 tensor rate.  At a decode step (16 slots) the fp32 states alone
are 33.6 MB read and written: 10.1 us, bytes.  At granite-4.0-h-small's
decode step (32 slots, 128 heads, P = 64, N = 128) they are 268.4 MB:
80.1 us, bytes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .decode_attention import SMS
from .rmsnorm import DTYPE_CODES
from .scan_workspace import state_pass_blocks, workspace

__all__ = [
    "ssd_cuda", "ssd_plan", "heads_per_block", "SsdPlan", "MAX_CHUNK", "MAX_P", "MAX_N",
]

#: the largest chunk the kernel takes
MAX_CHUNK = 64
#: the largest head dim P (four warps of 16 state rows) and state width N
#: (eight 16-wide register tiles) the kernel takes
MAX_P = 64
MAX_N = 128
#: tokens per chunk of the kernels' passes, whatever chunk the caller asks
CHUNK_TILE = 64
#: the most heads of one B/C group an output block serves (a group of
#: four warps each, side by side)
MAX_HEADS_PER_BLOCK = 2

_fn = None


class SsdPlan(NamedTuple):
    """The launch plan of one call.  ``route`` is "decode" for T == 1
    (one kernel, grid ``decode_grid``, no workspace) and "chunked"
    otherwise (pass 1 ``state_grid``, pass 2 ``pass_grid``, pass 3
    ``out_grid``; ``(chunks, heads or head blocks, batch)`` and
    ``(batch * heads, element blocks)``)."""

    route: str
    n_chunks: int
    heads_per_block: int
    state_grid: tuple
    pass_grid: tuple
    out_grid: tuple
    decode_grid: tuple
    ws_offsets: tuple  # bytes: (chunk states fp32, incoming states, decays fp32)
    workspace_bytes: int


def heads_per_block(B: int, n_chunks: int, H: int, G: int) -> int:
    """Heads of one B/C group an output block serves (they share its
    ``C B^T``): the most, up to ``MAX_HEADS_PER_BLOCK`` and dividing the
    group's heads, that still leaves a block for every SM; else 1."""
    per_group = H // G
    for hpb in range(MAX_HEADS_PER_BLOCK, 0, -1):
        if per_group % hpb == 0 and B * n_chunks * (H // hpb) >= SMS:
            return hpb
    return 1


def ssd_plan(B: int, T: int, H: int, G: int, P: int, N: int) -> SsdPlan:
    """The kernels' launch plan for x ``[B, T, H, P]`` and B/C
    ``[B, T, G, N]`` (either dtype)."""
    if T == 1:
        return SsdPlan("decode", 0, 1, (), (), (), (H, B), (0, 0, 0), 0)
    nc = -(-T // CHUNK_TILE)
    hpb = heads_per_block(B, nc, H, G)
    offsets, total = workspace(B * H * nc * P * N, B * H * nc)
    return SsdPlan(
        "chunked",
        nc,
        hpb,
        (nc, H, B),
        (B * H, state_pass_blocks(P * N, P * N % 4 == 0)),
        (nc, H // hpb, B),
        (),
        offsets,
        total,
    )


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("ssd").ssd_launch
        fn.argtypes = [
            ctypes.c_void_p,  # x
            ctypes.c_void_p,  # dt
            ctypes.c_void_p,  # A
            ctypes.c_void_p,  # B
            ctypes.c_void_p,  # C
            ctypes.c_void_p,  # s0
            ctypes.c_void_p,  # y
            ctypes.c_void_p,  # s_out
            *[ctypes.c_longlong] * 6,  # batch and token strides of x, B, C
            ctypes.c_int,  # batch
            ctypes.c_int,  # T
            ctypes.c_int,  # H
            ctypes.c_int,  # G
            ctypes.c_int,  # P
            ctypes.c_int,  # N
            ctypes.c_int,  # chunks
            ctypes.c_int,  # heads per output block
            ctypes.c_void_p,  # workspace
            *[ctypes.c_longlong] * 3,  # its parts' byte offsets
            ctypes.c_int,  # type code
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _rows_dense(t: torch.Tensor) -> bool:
    """The last two dims dense (a token's [heads, width] block)."""
    inner = t.shape[-1] == 1 or t.stride(-1) == 1
    return inner and (t.shape[-2] == 1 or t.stride(-2) == t.shape[-1])


def ssd_cuda(
    x: torch.Tensor,  # [B, T, H, P] fp32 or bf16, on a CUDA device
    dt: torch.Tensor,  # [B, T, H] fp32 step sizes
    A: torch.Tensor,  # [H] fp32 decay rates
    Bm: torch.Tensor,  # [B, T, G, N], x's dtype
    Cm: torch.Tensor,  # [B, T, G, N], x's dtype
    state: torch.Tensor,  # [B, H, P, N] fp32 initial state
    chunk: int = 64,
):  # -> (y [B, T, H, P] in x's dtype, no D-skip; final state fp32)
    """Launch the kernel on the current stream; raises on any input it
    does not take and on a launch the CUDA runtime refuses."""
    _build.refuse_grad("ssd_cuda", x, dt, A, Bm, Cm, state)
    ts = (x, dt, A, Bm, Cm, state)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("ssd_cuda: tensors must share a CUDA device")
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError("ssd_cuda: x, B, C must all be fp32 or bf16")
    if not all(t.dtype == torch.float32 for t in (dt, A, state)):
        raise TypeError("ssd_cuda: dt, A and the state must be fp32")
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError("ssd_cuda: x [B, T, H, P], B/C [B, T, G, N]")
    Bb, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (
        Bm.shape[:2] != (Bb, T)
        or G == 0
        or H % G
        or dt.shape != (Bb, T, H)
        or A.shape != (H,)
        or state.shape != (Bb, H, P, N)
    ):
        raise ValueError(
            f"ssd_cuda: x {tuple(x.shape)}, B {tuple(Bm.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)} and state "
            f"{tuple(state.shape)} disagree, or H is not a multiple of G"
        )
    if not (0 < P <= MAX_P and (P <= 16 or P % 16 == 0) and 0 < N <= MAX_N):
        raise ValueError(
            f"ssd_cuda: P={P}, N={N}: P at most {MAX_P}, 16 | P past 16; N at most {MAX_N}"
        )
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_cuda: chunk {chunk} not in 1..{MAX_CHUNK}")
    if not (
        all(_rows_dense(t) for t in (x, Bm, Cm))
        and all(t.is_contiguous() for t in (dt, A, state))
    ):
        raise ValueError(
            "ssd_cuda: x, B, C need dense last two dims; dt, A, state contiguous"
        )
    if Bb * H >= 2**31 or Bb >= 65536 or H >= 65536:
        raise ValueError(f"ssd_cuda: shape {tuple(x.shape)} out of range")
    plan = ssd_plan(Bb, T, H, G, P, N)
    y = torch.empty((Bb, T, H, P), dtype=x.dtype, device=x.device)
    s_out = torch.empty_like(state)
    # per call, so that threads launching at once never share it
    ws = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launcher()(
        x.data_ptr(),
        dt.data_ptr(),
        A.data_ptr(),
        Bm.data_ptr(),
        Cm.data_ptr(),
        state.data_ptr(),
        y.data_ptr(),
        s_out.data_ptr(),
        x.stride(0),
        x.stride(1),
        Bm.stride(0),
        Bm.stride(1),
        Cm.stride(0),
        Cm.stride(1),
        Bb,
        T,
        H,
        G,
        P,
        N,
        plan.n_chunks,
        plan.heads_per_block,
        ws.data_ptr(),
        *plan.ws_offsets,
        DTYPE_CODES[x.dtype],
        x.device.index or 0,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"ssd launch failed: cudaError {rc}")
    _build.count_launch(ssd_cuda)
    return y, s_out


#: launches of the kernel since the count was last set to 0
ssd_cuda.launches = 0
