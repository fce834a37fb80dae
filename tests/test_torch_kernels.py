"""The port's done-prefix kernel and bit ops vs the JAX package's.

Inputs come from a seeded numpy RNG and go through both packages; the
port runs its plain PyTorch version here (CPU tensors), the reference
its pure-jnp oracle and its Pallas kernel in interpret mode.  Integer
results must agree exactly.  The CUDA kernel itself is held against
the plain version on the card (``cuda`` marker; skips without one).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.doneprefix import done_prefix_packed_cuda  # noqa: E402


def _pack(masks: np.ndarray, n_words: int) -> np.ndarray:
    """[R, n] bool -> [R, n_words] uint32, bit b of word j = slot 32j+b."""
    words = np.zeros((masks.shape[0], n_words), dtype=np.uint32)
    for row, i in zip(*np.nonzero(masks)):
        words[row, i >> 5] |= np.uint32(1) << np.uint32(i & 31)
    return words


def _bitmaps(n_bits: int, rows: int, seed: int):
    """Edge-case rows: all ones, all zeros, a half prefix, dense random
    rows, and garbage in the padding bits past ``n_bits``."""
    rng = np.random.default_rng(seed)
    nw = -(-n_bits // 32)
    masks = rng.random((rows, nw * 32)) < 0.97
    kinds = [np.ones(nw * 32, bool), np.zeros(nw * 32, bool)]
    half = np.ones(nw * 32, bool)
    half[n_bits // 2] = False
    kinds.append(half)
    for r, m in enumerate(kinds[:rows]):
        masks[r] = m
    masks[:, n_bits:] = rng.random((rows, nw * 32 - n_bits)) < 0.5  # garbage
    words = _pack(masks, nw)
    run = np.asarray(
        jref.done_prefix_packed_ref(words, np.full(rows, n_bits, np.int32), n_bits)
    )
    limits = np.full(rows, n_bits, dtype=np.int32)
    limits[rows // 2] = run[rows // 2] // 2  # below the run
    if rows > 1:
        limits[-1] = 0
    return words, limits


def _port(words: np.ndarray, limits: np.ndarray, n_bits: int) -> np.ndarray:
    got = ops.done_prefix_packed(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(limits), n_bits
    )
    assert got.dtype == torch.int32
    return got.numpy()


@pytest.mark.parametrize("rows", [1, 7])
@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 1000, 2000, 65536])
def test_done_prefix_packed_equals_reference_and_pallas(n_bits, rows):
    words, limits = _bitmaps(n_bits, rows, seed=n_bits * 10 + rows)
    want = np.asarray(jref.done_prefix_packed_ref(words, limits, n_bits=n_bits))
    pallas = np.asarray(
        jops.done_prefix_packed(
            words, limits, n_bits=n_bits, impl="pallas", interpret=True
        )
    )
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(_port(words, limits, n_bits), want)


@pytest.mark.parametrize("n,block_w", [(64, 2), (200, 4), (1024, 32)])
def test_packed_prefix_matches_bool_mask_oracle(n, block_w):
    # mirrors test_jaxplane.py::test_packed_prefix_pallas_interpret_equals_ref
    rng = np.random.default_rng(n)
    r = 6
    masks = rng.random((r, n)) < 0.8
    masks[0] = True
    masks[1] = False
    masks[2, : n // 2] = True
    masks[2, n // 2] = False
    words = _pack(masks, (n + 31) // 32)
    limits = np.array([n, n, n, n, 7, 0], dtype=np.int32)
    want = np.asarray(jref.done_prefix_batch_ref(masks, np.zeros(r, np.int32), limits))
    pallas = jops.done_prefix_packed(
        words, limits, n_bits=n, impl="pallas", interpret=True, block_w=block_w
    )
    np.testing.assert_array_equal(np.asarray(pallas), want)
    np.testing.assert_array_equal(_port(words, limits, n), want)


@pytest.mark.parametrize("shape", [(5, 1), (3, 31), (4, 64), (2, 3, 100)])
def test_pack_bits_u32_equals_reference(shape):
    bits = np.random.default_rng(sum(shape)).random(shape) < 0.6
    want = np.asarray(jops.pack_bits_u32(bits))
    got = ops.pack_bits_u32(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_popcount32_equals_lax_population_count():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2**32, size=(9, 40), dtype=np.uint64).astype(np.uint32)
    words[0] = [0, 0xFFFFFFFF, 1, 0x80000000] * 10
    want = np.asarray(jax.lax.population_count(words))
    got = ref.popcount32(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    got64 = ref.popcount32(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got64.numpy(), want)


def test_impl_dispatch_rules():
    words, limits = _bitmaps(100, 4, seed=3)
    w, lim = torch.from_numpy(words.view(np.int32)), torch.from_numpy(limits)
    want = ref.done_prefix_packed_ref(w, lim, 100)
    # auto on a CPU tensor runs the plain version
    assert torch.equal(ops.done_prefix_packed(w, lim, 100, impl="auto"), want)
    with pytest.raises(ValueError, match="pallas"):
        ops.done_prefix_packed(w, lim, 100, impl="pallas")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.done_prefix_packed(w, lim, 100, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.done_prefix_packed(w, lim, 100, impl="torch")
    # the kernel wrapper takes CUDA tensors only: no CPU path inside it
    with pytest.raises(ValueError, match="CUDA device"):
        done_prefix_packed_cuda(w, lim, 100)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,rows", [(1, 1), (33, 7), (2000, 5040), (65536, 7)])
def test_cuda_kernel_equals_plain_on_card(n_bits, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    words, limits = _bitmaps(n_bits, rows, seed=n_bits + rows)
    w = torch.from_numpy(words.view(np.int32)).cuda()
    lim = torch.from_numpy(limits).cuda()
    before = done_prefix_packed_cuda.launches
    got = ops.done_prefix_packed(w, lim, n_bits)
    torch.cuda.synchronize()
    assert done_prefix_packed_cuda.launches == before + 1
    assert torch.equal(got, ref.done_prefix_packed_ref(w, lim, n_bits))
