"""CUDA wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:35-141``
(``_decode_kernel`` under ``decode_attention_pallas``, ``:92``): one new
query token per sequence against its KV cache, keys at or past
``lengths[b]`` masked, the G query heads of a KV head sharing each K/V
read, online softmax in fp32.

Design: the kernel reads one layer's cache ``[B, S, Hkv, D]`` where it
lies (no transpose to ``[B*Hkv, S, D]`` per layer per step).  One
128-thread block per (sequence, KV head) walks its cache in 64-key
tiles through shared memory, up to ``min(lengths[b], S)`` only: every
key it reads is valid, so it moves no byte past the length.  A length
above S counts as S (an idle decode slot's length may pass the cache);
a length of 0 gives zeros.

Bound on the H100: bytes.  At the full-width cell (16 slots of 512
positions, Hkv = 2, D = 128, bf16) a full cache is 8.4 MB of K/V,
about 2.5 us at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .rmsnorm import DTYPE_CODES

__all__ = ["decode_attention_cuda"]

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        fn.argtypes = [
            ctypes.c_void_p,  # q
            ctypes.c_void_p,  # k
            ctypes.c_void_p,  # v
            ctypes.c_void_p,  # lengths
            ctypes.c_void_p,  # out
            ctypes.c_int,  # B
            ctypes.c_int,  # S
            ctypes.c_int,  # Hkv
            ctypes.c_int,  # G
            ctypes.c_int,  # D
            ctypes.c_float,  # scale
            ctypes.c_int,  # type code
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def decode_attention_cuda(
    q: torch.Tensor,  # [B, H, D] fp32 or bf16, on a CUDA device
    k_cache: torch.Tensor,  # [B, S, Hkv, D], q's dtype
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    lengths: torch.Tensor,  # [B] int32
    scale: float | None = None,
) -> torch.Tensor:  # [B, H, D], q's dtype
    """Launch the kernel on the current stream; raises on any input it
    does not take and on a launch the driver refuses."""
    ts = (q, k_cache, v_cache, lengths)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("decode_attention_cuda: tensors must share a CUDA device")
    dt = q.dtype
    if dt not in DTYPE_CODES or k_cache.dtype != dt or v_cache.dtype != dt:
        raise TypeError("decode_attention_cuda: q and the cache must be fp32 or bf16")
    if lengths.dtype != torch.int32:
        raise TypeError("decode_attention_cuda: lengths must be int32")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("decode_attention_cuda: q [B, H, D], cache [B, S, Hkv, D]")
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (
        k_cache.shape[0] != B
        or k_cache.shape[3] != D
        or lengths.shape != (B,)
        or Hkv == 0
        or H % Hkv
    ):
        raise ValueError(
            f"decode_attention_cuda: q {tuple(q.shape)}, cache "
            f"{tuple(k_cache.shape)} and lengths {tuple(lengths.shape)} disagree"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("decode_attention_cuda: inputs must be contiguous")
    G = H // Hkv
    # shared memory: q and acc (G x D), a K and a V tile (64 x D), scores
    smem = 4 * (2 * G * D + 64 * (2 * D + 1) + 64 * G + 3 * G)
    if smem > 227 * 1024 or B * Hkv >= 2**31:
        raise ValueError(f"decode_attention_cuda: G={G}, D={D} past shared memory")
    scale = float(scale) if scale is not None else D**-0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(
        q.data_ptr(),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        lengths.data_ptr(),
        out.data_ptr(),
        B,
        S,
        Hkv,
        G,
        D,
        scale,
        DTYPE_CODES[dt],
        q.device.index or 0,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {rc}")
    _build.count_launch(decode_attention_cuda)
    return out


#: launches of the kernel since the count was last set to 0
decode_attention_cuda.launches = 0
