"""CUDA wrapper of the prefill flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:35-166``
(``_flash_kernel`` under ``flash_attention_pallas``, ``:107``): causal
or full GQA attention, online softmax with fp32 running max,
denominator and accumulator, ``q_offset`` placing the queries in the
key timeline, and 0 for a row with no admissible key.

Design: the kernel reads the model layout ``[B, S, H, D]`` where it
lies (no transpose to ``[B*H, S, D]``); query head h reads KV head
``h // G``; D is 32, 64 or 128.  The storage type picks the
instantiation.  bf16, the serving paths' type, runs on the tensor
cores: ``mma.sync`` m16n8k16 for both Q K^T and P V, blocks of 32
queries whose four warps each hold 16 query rows in registers and take
half of every 64-key bf16 K/V tile from a two-stage ``cp.async`` ring
(:func:`flash_grid`: 144 blocks at qwen2-1.5b's 384-token prompt, for
132 SMs).  fp32, which
only the parity checks use, keeps the scalar FMA kernel: TF32 tensor
cores could not hold their ``2e-5``.

Bound on the H100 at qwen2-1.5b's prefill (B = 1, Sq = Sk = 384,
H = 12, Hkv = 2, D = 128, causal, bf16): 0.45 GFLOP (0.46 us at the
bf16 tensor-core peak) and 2.75 MB (0.82 us at 3.35 TB/s), so bytes.
The tensor-core design removes the scalar FMAs that kept the first
version at 172 us; what remains is each warp's walk over up to Sk / 64
key tiles in order.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .rmsnorm import DTYPE_CODES

__all__ = ["flash_attention_cuda", "flash_grid", "HEAD_DIMS"]

#: head dimensions the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
#: queries per block of the bf16 (tensor-core) and fp32 (scalar) kernels
_MMA_ROWS = 32
_SCALAR_ROWS = 64

_fn = None


def flash_grid(B: int, Sq: int, H: int, dtype: torch.dtype) -> tuple:
    """``(warps per block, (grid_x, grid_y))`` of one launch.  bf16: four
    warps per 32 queries (two row groups of 16, each split over the two
    halves of every key tile), grid (B * H, query tiles).  fp32: the
    scalar kernel's 256 threads per 64 queries, grid (query tiles,
    B * H)."""
    if dtype != torch.bfloat16:
        return 8, (-(-Sq // _SCALAR_ROWS), B * H)
    return 4, (B * H, -(-Sq // _MMA_ROWS))


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = [
            ctypes.c_void_p,  # q
            ctypes.c_void_p,  # k
            ctypes.c_void_p,  # v
            ctypes.c_void_p,  # out
            ctypes.c_int,  # B
            ctypes.c_int,  # Sq
            ctypes.c_int,  # Sk
            ctypes.c_int,  # H
            ctypes.c_int,  # Hkv
            ctypes.c_int,  # D
            ctypes.c_int,  # q_offset
            ctypes.c_int,  # causal
            ctypes.c_float,  # scale
            ctypes.c_int,  # type code
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_cuda(
    q: torch.Tensor,  # [B, Sq, H, D] fp32 or bf16, on a CUDA device
    k: torch.Tensor,  # [B, Sk, Hkv, D], q's dtype
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    causal: bool = True,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:  # [B, Sq, H, D], q's dtype
    """Launch the kernel on the current stream; raises on any input it
    does not take and on a launch the driver refuses."""
    _build.refuse_grad("flash_attention_cuda", q, k, v)
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda: q, k, v must all be fp32 or bf16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_cuda: q [B,Sq,H,D], k/v [B,Sk,Hkv,D]")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(
            f"flash_attention_cuda: q {tuple(q.shape)} and k {tuple(k.shape)} "
            "disagree, or H is not a multiple of Hkv"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in {HEAD_DIMS}")
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: tensors must share a CUDA device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: inputs must be 16-byte aligned")
    _, grid = flash_grid(B, Sq, H, q.dtype)
    if grid[0] >= 2**31 or grid[1] >= 65536 or max(Sq, Sk) >= 2**31:
        raise ValueError("flash_attention_cuda: shape past the launch grid")
    if q_offset < 0:
        raise ValueError("flash_attention_cuda: q_offset < 0")
    scale = float(scale) if scale is not None else D**-0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        B,
        Sq,
        Sk,
        H,
        Hkv,
        D,
        int(q_offset),
        int(bool(causal)),
        scale,
        DTYPE_CODES[q.dtype],
        q.device.index or 0,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    _build.count_launch(flash_attention_cuda)
    return out


#: launches of the kernel since the count was last set to 0
flash_attention_cuda.launches = 0
