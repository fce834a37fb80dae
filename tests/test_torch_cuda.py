"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips (inside the test)
on a host without a CUDA device.  The file imports no JAX, so it runs
on the machine with the card, where JAX is not installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are qwen2-1.5b's on the serving path; tolerances are those of
``tests/test_kernels.py`` (fp32 ``2e-5``, bf16 ``2e-2``), done-prefix
exact.  Each test also checks that the call went through the kernel
(its launch count rose by one).
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.doneprefix import done_prefix_batch_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype: str):
    if dtype == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=2e-5, atol=2e-5)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_rmsnorm_equals_plain_on_card(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(16, 1536, generator=g, device=dev).to(DTYPES[dtype])
    w = torch.randn(1536, generator=g, device=dev)
    before = rmsnorm_cuda.launches
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    torch.testing.assert_close(
        got.float(), ref.rmsnorm_ref(x, w).float(), **_tol(dtype)
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_flash_attention_equals_plain_on_card(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    tdt = DTYPES[dtype]
    q = torch.randn(1, 200, 12, 128, generator=g, device=dev).to(tdt)
    k = torch.randn(1, 200, 2, 128, generator=g, device=dev).to(tdt)
    v = torch.randn(1, 200, 2, 128, generator=g, device=dev).to(tdt)
    before = flash_attention_cuda.launches
    got = ops.attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    torch.testing.assert_close(
        got.float(), ref.attention_ref(q, k, v).float(), **_tol(dtype)
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_decode_attention_equals_plain_on_card(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    tdt = DTYPES[dtype]
    q = torch.randn(16, 12, 128, generator=g, device=dev).to(tdt)
    k = torch.randn(16, 512, 2, 128, generator=g, device=dev).to(tdt)
    v = torch.randn(16, 512, 2, 128, generator=g, device=dev).to(tdt)
    lens = torch.randint(1, 513, (16,), generator=g, device=dev, dtype=torch.int32)
    lens[:3] = torch.tensor([1, 512, 600], device=dev)
    before = decode_attention_cuda.launches
    got = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(
        got.float(), ref.decode_attention_ref(q, k, v, lens).float(), **_tol(dtype)
    )


@pytest.mark.cuda
def test_cuda_done_prefix_batch_equals_plain_on_card():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    done = torch.rand(64, 33, generator=g, device=dev) < 0.8
    done[0] = True
    st = torch.randint(0, 33, (64,), generator=g, device=dev, dtype=torch.int32)
    lim = torch.randint(0, 34, (64,), generator=g, device=dev, dtype=torch.int32)
    before = done_prefix_batch_cuda.launches
    got = ops.done_prefix_batch(done, st, lim)
    torch.cuda.synchronize()
    assert done_prefix_batch_cuda.launches == before + 1
    assert torch.equal(got, ref.done_prefix_batch_ref(done, st, lim))
