"""Launch plans of the attention kernels, and the refusals of their
wrappers that need no card.

The split choice of the decode kernel (``decode_splits``), the heads a
decode block serves (``group_block``) and the prefill kernel's grid
(``flash_grid``) are plain Python, so they are pinned here on
the CPU; the kernels themselves are held against the plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.decode_attention import (
    KEY_TILE,
    SMS,
    decode_attention_cuda,
    decode_splits,
    group_block,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_grid

#: (B, Hkv, S, G): the served cells, tiny and long caches, many slots
SPLIT_SHAPES = [
    (16, 2, 512, 6),  # qwen2-1.5b: B * Hkv = 32
    (16, 32, 512, 1),  # zamba2-1.2b: B * Hkv = 512
    (1, 1, 1, 1),
    (1, 1, 0, 1),
    (1, 1, 63, 4),
    (1, 1, 64, 4),
    (1, 1, 65, 4),
    (2, 4, 40, 1),
    (3, 2, 100, 4),
    (1, 1, 513, 4),
    (1, 8, 32768, 8),
    (4, 1, 4097, 48),  # granite-like G = 48: six head blocks
    (64, 8, 2048, 5),
    (200, 2, 700, 6),
]


def _rows(B, Hkv, G):
    return B * Hkv * -(-G // group_block(G))


@pytest.mark.parametrize("B,Hkv,S,G", SPLIT_SHAPES)
def test_decode_splits_partition_the_keys(B, Hkv, S, G):
    """Every key of [0, S) lies in exactly one split; splits are whole
    64-key tiles, at least one, and none is empty."""
    n, per = decode_splits(B, Hkv, S, G)
    assert n >= 1 and per >= KEY_TILE and per % KEY_TILE == 0
    owner = [k // per for k in range(S)]
    assert all(0 <= o < n for o in owner)
    assert sorted(set(owner)) == list(range(n)) or S == 0
    if S == 0:
        assert n == 1


@pytest.mark.parametrize("B,Hkv,S,G", SPLIT_SHAPES)
def test_decode_splits_fill_the_card_when_the_cache_allows(B, Hkv, S, G):
    n, _ = decode_splits(B, Hkv, S, G)
    rows = _rows(B, Hkv, G)
    tiles = max(1, -(-S // KEY_TILE))
    if tiles * rows >= SMS:
        assert n * rows >= SMS
    else:  # too few tiles: one split per tile
        assert n == tiles


def test_decode_splits_at_the_served_cells():
    assert decode_splits(16, 2, 512, 6) == (8, 64)  # 256 blocks of 8 KV rows
    assert decode_splits(16, 32, 512, 1) == (1, 512)  # 512 blocks, no merge


@pytest.mark.parametrize(
    "G,gb", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 6), (6, 6), (7, 8), (48, 8)]
)
def test_group_block_holds_the_heads_of_a_kv_head(G, gb):
    assert group_block(G) == gb


@pytest.mark.parametrize(
    "B,Sq,H,blocks",
    [
        (1, 384, 12, 144),  # qwen2-1.5b's longest prompt: past the 132 SMs
        (1, 384, 32, 384),  # zamba2-1.2b's
        (1, 64, 12, 24),  # the shortest served prompt
        (1, 1, 1, 1),
        (4, 1000, 12, 1536),
    ],
)
def test_flash_grid_bf16_tiles_32_queries_per_block(B, Sq, H, blocks):
    warps, grid = flash_grid(B, Sq, H, torch.bfloat16)
    assert warps == 4 and grid[0] == B * H and grid[0] * grid[1] == blocks
    assert grid[1] * 32 >= Sq > (grid[1] - 1) * 32


def test_flash_grid_fp32_is_the_scalar_kernels():
    assert flash_grid(2, 100, 8, torch.float32) == (8, (2, 16))


def test_wrappers_refuse_cpu_tensors():
    kv = torch.ones(1, 4, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(torch.ones(1, 2, 2, 64, dtype=torch.bfloat16), kv, kv)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        decode_attention_cuda(torch.ones(1, 2, 64), kv.float(), kv.float(), lens)


@pytest.mark.parametrize("D", [16, 48, 96, 256])
def test_wrappers_refuse_head_dims_without_an_instantiation(D):
    q, kv = torch.ones(1, 3, 2, D), torch.ones(1, 3, 1, D)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention_cuda(q[:, 0], kv, kv, torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.int64, torch.float32, torch.int16])
def test_decode_wrapper_refuses_lengths_not_int32(dtype):
    kv = torch.ones(1, 4, 1, 32)
    with pytest.raises(TypeError, match="int32"):
        decode_attention_cuda(torch.ones(1, 2, 32), kv, kv, torch.ones(1, dtype=dtype))
