"""CUDA wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:35-141``
(``_decode_kernel`` under ``decode_attention_pallas``, ``:92``): one new
query token per sequence against its KV cache, keys at or past
``lengths[b]`` masked, the G query heads of a KV head sharing each K/V
read, online softmax in fp32.

Design: the kernel reads one layer's cache ``[B, S, Hkv, D]`` where it
lies (no transpose to ``[B*Hkv, S, D]`` per layer per step) and splits
the keys over blocks (flash-decoding): the grid is (key split, KV head
x block of query heads, slot).  :func:`decode_splits` picks the splits
so that the grid holds about two blocks per SM where the cache allows
it.  A block streams its keys in 64-key tiles through a two-stage
``cp.async`` ring in the storage type, lanes splitting D in 16-byte
chunks, and writes its partial (m, l, acc) to an fp32 workspace
allocated here per call; a second kernel in the same call merges the
splits (skipped with one split).  It reads up to ``min(lengths[b], S)``
only, so it moves no byte past the length.  A length above S counts as
S (an idle decode slot's length may pass the cache); a length of 0
gives zeros.

Bound on the H100: bytes.  At the full-width cell (16 slots of 512
positions, Hkv = 2, D = 128, bf16) a full cache is 8.4 MB of K/V,
about 2.5 us at 3.35 TB/s; the splits put 256 blocks on the 132 SMs
there, where the first version's one block per (slot, KV head) put 32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .rmsnorm import DTYPE_CODES

__all__ = [
    "decode_attention_cuda",
    "decode_splits",
    "group_block",
    "HEAD_DIMS",
    "KEY_TILE",
    "SMS",
]

#: head dimensions the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
#: keys per shared-memory tile; a split is a whole number of tiles
KEY_TILE = 64
#: streaming multiprocessors of the H100 SXM
SMS = 132
#: blocks the split choice aims at: two per SM
TARGET_BLOCKS = 2 * SMS
#: query heads per block the kernel is instantiated for
GROUP_BLOCKS = (1, 2, 4, 6, 8)
#: the largest dynamic shared memory a block may take (227 KB)
MAX_SMEM = 232448

_fn = None
_smem = None


def group_block(G: int) -> int:
    """Query heads one block serves: the smallest instantiated size that
    holds all G heads of a KV head (qwen2's 6 exactly), else 8 (the heads
    then split over ``ceil(G / 8)`` blocks, each reading the keys once)."""
    return next((gb for gb in GROUP_BLOCKS if gb >= G), GROUP_BLOCKS[-1])


def decode_splits(B: int, Hkv: int, S: int, G: int = 1) -> tuple:
    """``(n_splits, keys_per_split)``: the key splits of one launch.

    Each split is a whole number of 64-key tiles, every key of
    ``[0, S)`` lies in exactly one split, and no split is empty.  The
    number aims at ``TARGET_BLOCKS`` blocks over the ``B * Hkv *
    ceil(G / group_block(G))`` (slot, KV head, head block) rows, and
    never gives fewer than half of that while the tiles allow it."""
    rows = B * Hkv * -(-G // group_block(G))
    tiles = max(1, -(-S // KEY_TILE))
    want = min(tiles, max(1, -(-TARGET_BLOCKS // max(rows, 1))))
    per = -(-tiles // want)  # tiles per split
    return -(-tiles // per), per * KEY_TILE


def _load():
    global _fn, _smem
    if _fn is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = [
            ctypes.c_void_p,  # q
            ctypes.c_void_p,  # k
            ctypes.c_void_p,  # v
            ctypes.c_void_p,  # lengths
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # fp32 workspace
            ctypes.c_int,  # B
            ctypes.c_int,  # S
            ctypes.c_int,  # Hkv
            ctypes.c_int,  # G
            ctypes.c_int,  # D
            ctypes.c_int,  # query heads per block
            ctypes.c_int,  # splits
            ctypes.c_int,  # keys per split
            ctypes.c_float,  # scale
            ctypes.c_int,  # type code
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        smem = lib.decode_attention_smem_bytes
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_int
        _fn, _smem = fn, smem
    return _fn, _smem


def decode_attention_cuda(
    q: torch.Tensor,  # [B, H, D] fp32 or bf16, on a CUDA device
    k_cache: torch.Tensor,  # [B, S, Hkv, D], q's dtype
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    lengths: torch.Tensor,  # [B] int32
    scale: float | None = None,
) -> torch.Tensor:  # [B, H, D], q's dtype
    """Launch the kernels on the current stream; raises on any input they
    do not take and on a launch the CUDA runtime refuses."""
    _build.refuse_grad("decode_attention_cuda", q, k_cache, v_cache)
    ts = (q, k_cache, v_cache, lengths)
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
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention_cuda: head dim {D} not in {HEAD_DIMS}")
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("decode_attention_cuda: tensors must share a CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("decode_attention_cuda: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in ts[:3]):
        raise ValueError("decode_attention_cuda: inputs must be 16-byte aligned")
    G = H // Hkv
    gb = group_block(G)
    n_splits, kps = decode_splits(B, Hkv, S, G)
    launch, smem_bytes = _load()
    if smem_bytes(D, DTYPE_CODES[dt]) > MAX_SMEM:
        raise ValueError(f"decode_attention_cuda: D={D} past shared memory")
    if B >= 65536 or Hkv * -(-G // gb) >= 65536 or S >= 2**31:
        raise ValueError("decode_attention_cuda: shape past the launch grid")
    scale = float(scale) if scale is not None else D**-0.5
    out = torch.empty_like(q)
    # partial (acc, m, l) per (b, h, split); per call, so that threads
    # launching at once never share it
    ws = torch.empty(
        B * H * n_splits * (D + 2) if n_splits > 1 else 0,
        dtype=torch.float32,
        device=q.device,
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = launch(
        q.data_ptr(),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        lengths.data_ptr(),
        out.data_ptr(),
        ws.data_ptr(),
        B,
        S,
        Hkv,
        G,
        D,
        gb,
        n_splits,
        kps,
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
