"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips (inside the test)
on a host without a CUDA device.  The file imports no JAX, so it runs
on the machine with the card, where JAX is not installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are those of the serving paths (qwen2-1.5b, rwkv6-3b,
zamba2-1.2b, granite-4.0-h-small's SSD at N = 128, whisper-large-v3's
encoder and cross caches, the VLM's
cross-attention, moonshot's and grok-1's self-attention and MoE block)
and of the reference's sweeps; tolerances are those of
``tests/test_kernels.py`` (fp32 ``2e-5``, bf16 ``2e-2``; the WKV6 and SSD
scans ``2e-4`` in fp32, the reference's own for them), done-prefix
exact, and the claim check exact on ``chip_smoke.py``'s edge set.  Each
test also checks that the call went through the kernel (its launch
count rose by one).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import SweepRequest, run_sweep, tcptorch
from repro_torch.core.policy import _fused_requests, make_torch_policy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.doneprefix import (
    claim_check_cuda,
    claim_vector_bytes,
    done_prefix_batch_cuda,
    done_prefix_batch_mapped,
    done_prefix_packed_cuda,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rmsnorm import add_rmsnorm_cuda, rmsnorm_cuda
from repro_torch.kernels.rwkv6 import rwkv6_cuda
from repro_torch.kernels.ssd import ssd_cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype: str, fp32: float = 2e-5):
    if dtype == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=fp32, atol=fp32)


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
@pytest.mark.parametrize("d", [2048, 2560, 4096])  # zamba2 ln, rwkv6, zamba2 ln1/ln2
def test_cuda_rmsnorm_equals_plain_at_ssm_widths(d):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn(384, d, generator=g, device=dev).bfloat16()
    w = torch.randn(d, generator=g, device=dev)
    for wt in (w, w.bfloat16()):  # decode's fp32 master, prefill's bf16
        torch.testing.assert_close(
            ops.rmsnorm(x, wt).float(),
            ref.rmsnorm_ref(x, wt).float(),
            **_tol("bfloat16"),
        )


#: the fused norm's widths: the reference sweep's 64 and 96 (one warp,
#: most lanes idle), qwen2-1.5b's d_model, zamba2-1.2b's and rwkv6-3b's,
#: zamba2's concatenation [x, emb0]
ADD_NORM_WIDTHS = [64, 96, 1536, 2048, 2560, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("d", ADD_NORM_WIDTHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("wdtype", sorted(DTYPES))
def test_cuda_add_rmsnorm_equals_plain_with_the_sum_bit_exact(d, dtype, wdtype):
    """s = x + delta bit for bit PyTorch's add, y within the norm's
    tolerance of the plain version, at a decode step's 16 rows and a
    prefill's 384; one launch a call."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(d)
    tdt = DTYPES[dtype]
    for rows in (16, 384):
        x = torch.randn(rows, d, generator=g, device=dev).to(tdt)
        delta = torch.randn(rows, d, generator=g, device=dev).to(tdt)
        w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(DTYPES[wdtype])
        before = add_rmsnorm_cuda.launches
        s, y = ops.add_rmsnorm(x, delta, w)
        torch.cuda.synchronize()
        assert add_rmsnorm_cuda.launches == before + 1
        s_ref, y_ref = ref.add_rmsnorm_ref(x, delta, w)
        assert torch.equal(s, x + delta) and torch.equal(s, s_ref)
        torch.testing.assert_close(y.float(), y_ref.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_add_rmsnorm_scalar_route_on_unaligned_rows(dtype):
    """Rows that start off a 16-byte boundary (a view one element into
    its storage) and a width that is no multiple of the 16-byte chunk
    take the scalar loads: the same values as the plain version."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    tdt = DTYPES[dtype]
    for rows, d, shift in ((16, 1536, 1), (7, 100, 0), (3, 37, 1)):
        xb = torch.randn(rows * d + shift, generator=g, device=dev).to(tdt)
        db = torch.randn(rows * d + shift, generator=g, device=dev).to(tdt)
        x, delta = xb[shift:].view(rows, d), db[shift:].view(rows, d)
        w = torch.randn(d, generator=g, device=dev)
        s, y = add_rmsnorm_cuda(x, delta, w)
        torch.testing.assert_close(
            rmsnorm_cuda(x, w).float(), ref.rmsnorm_ref(x, w).float(), **_tol(dtype)
        )
        torch.cuda.synchronize()
        assert torch.equal(s, x + delta)
        torch.testing.assert_close(
            y.float(), ref.rmsnorm_ref(x + delta, w).float(), **_tol(dtype)
        )


@pytest.mark.cuda
def test_cuda_add_rmsnorm_from_two_threads_equals_serial():
    """The fused and the plain norm launched from two Python threads at
    once, 100 rounds each, on the shared stream: every result equals the
    serial one (the kernel sets no attribute, each call owns its
    outputs)."""
    import threading

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    shapes = ((16, 1536), (384, 2560))
    args = [
        tuple(torch.randn(r, d, generator=g, device=dev).bfloat16() for _ in "xd")
        + (torch.randn(d, generator=g, device=dev),)
        for r, d in shapes
    ]
    calls = [
        lambda a=a: add_rmsnorm_cuda(*a) + (rmsnorm_cuda(a[0], a[2]),) for a in args
    ]
    serial = [c() for c in calls]
    torch.cuda.synchronize()
    bad = []

    def worker(order):
        for _ in range(100):
            for i in order:
                got = calls[i]()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, serial[i])):
                    bad.append(i)

    threads = [threading.Thread(target=worker, args=(o,)) for o in ((0, 1), (1, 0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad, f"calls {sorted(set(bad))} differed under concurrency"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [
        (1, 200, 12, 2, 128),
        (1, 384, 32, 32, 64),
        (1, 384, 16, 16, 128),
        (1, 384, 48, 8, 128),
    ],
)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_flash_attention_equals_plain_on_card(shape, dtype):
    """qwen2-1.5b's GQA prefill shape, zamba2-1.2b's shared block (MHA,
    head dim 64), moonshot's MHA and grok-1's GQA 48/8 (head dim 128)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    tdt = DTYPES[dtype]
    B, S, H, Hkv, D = shape
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(tdt)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(tdt)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(tdt)
    before = flash_attention_cuda.launches
    got = ops.attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    torch.testing.assert_close(
        got.float(), ref.attention_ref(q, k, v).float(), **_tol(dtype)
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(12, 2, 128), (32, 32, 64), (16, 16, 128), (48, 8, 128)]
)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_decode_attention_equals_plain_on_card(shape, dtype):
    """qwen2-1.5b's, zamba2-1.2b's, moonshot's and grok-1's heads over 16
    512-position caches."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    tdt = DTYPES[dtype]
    H, Hkv, D = shape
    q = torch.randn(16, H, D, generator=g, device=dev).to(tdt)
    k = torch.randn(16, 512, Hkv, D, generator=g, device=dev).to(tdt)
    v = torch.randn(16, 512, Hkv, D, generator=g, device=dev).to(tdt)
    lens = torch.randint(1, 513, (16,), generator=g, device=dev, dtype=torch.int32)
    lens[:3] = torch.tensor([1, 512, 600], device=dev)
    before = decode_attention_cuda.launches
    got = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(
        got.float(), ref.decode_attention_ref(q, k, v, lens).float(), **_tol(dtype)
    )


#: flash edges: (B, Sq, Sk, H, Hkv, D, causal, q_offset).  Sq and Sk off
#: the 16-row and 64-key tiles, queries placed past the keys' start
#: (Sk > Sq), non-causal, D 32/64/128, G 1/4/6, and the 64-token prompt
FLASH_EDGES = [
    (1, 100, 100, 12, 2, 128, True, 0),  # G = 6, ragged last tiles
    (1, 8, 72, 4, 2, 32, True, 64),  # the reference sweep's q_offset case
    (1, 50, 130, 8, 2, 64, True, 80),  # G = 4, Sk > Sq, q_offset > 0
    (2, 70, 45, 4, 4, 128, False, 0),  # non-causal, G = 1, Sk < Sq
    (1, 33, 97, 6, 1, 32, False, 0),  # non-causal, G = 6
    (1, 64, 64, 12, 2, 128, True, 0),  # qwen2-1.5b's shortest prompt
    (1, 200, 200, 16, 4, 64, True, 0),  # G = 4, two warps per block
    (3, 17, 17, 2, 1, 64, True, 0),  # one query past a 16-row tile
    (1, 1500, 1500, 20, 20, 64, False, 0),  # Whisper's encoder: 23 x 64 + 28 keys
    (1, 64, 1500, 20, 20, 64, False, 0),  # its cross-attention prefill
    (1, 200, 1600, 64, 8, 128, False, 0),  # the VLM's cross-attention prefill
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_EDGES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_flash_attention_edges_equal_plain(case, dtype):
    dev = _card()
    B, Sq, Sk, H, Hkv, D, causal, qo = case
    g = torch.Generator(device=dev).manual_seed(Sq * 131 + Sk)
    tdt = DTYPES[dtype]
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(tdt)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device=dev).to(tdt)
    v = torch.randn(B, Sk, Hkv, D, generator=g, device=dev).to(tdt)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=causal, q_offset=qo)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, q_offset=qo)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 20, 20, 64, 1500), (16, 64, 8, 128, 1600)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_decode_attention_full_cross_caches(shape, dtype):
    """The cross caches, every slot at its full length: Whisper's 1,500
    frames (G = 1, D = 64), the VLM's 1,600 image tokens (G = 8, D = 128)."""
    dev = _card()
    B, H, Hkv, D, S = shape
    g = torch.Generator(device=dev).manual_seed(S)
    tdt = DTYPES[dtype]
    q = torch.randn(B, H, D, generator=g, device=dev).to(tdt)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(tdt)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(tdt)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    before = decode_attention_cuda.launches
    got = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(
        got.float(), ref.decode_attention_ref(q, k, v, lens).float(), **_tol(dtype)
    )


#: the cross-attention families at card-sized heads (64 wide: the
#: kernels take head dims 32, 64 and 128, the tiny configs' are 16)
CROSS_MODELS = {
    "whisper-large-v3": dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=512),
    "llama-3.2-vision-90b": dict(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CROSS_MODELS))
def test_cuda_cross_attention_models_equal_plain(name):
    """Whisper and the VLM stack in fp32 on the card: prefill and 3
    decode steps with the kernels equal the plain versions (1e-3, as
    chip_smoke.py's parity phases), and every attention of the path
    launched its kernel."""
    from repro_torch import configs
    from repro_torch.models.api import build_model

    dev = _card()
    cfg = configs.get_tiny(name).replace(**CROSS_MODELS[name])
    model = build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(3)
    params = model.prepare(model.init(generator=g, device=dev))
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=g, device=dev)
    if cfg.is_encdec:
        key, n = "audio_embeds", cfg.enc_len
    else:
        key, n = "image_embeds", cfg.n_image_tokens
    emb = torch.randn(2, n, cfg.d_model, generator=g, device=dev)
    steps = [
        torch.randint(0, cfg.vocab, (2, 1), generator=g, device=dev) for _ in range(3)
    ]

    def run(c):
        m = build_model(c)
        cache, logits = m.prefill(params, {"tokens": tokens, key: emb}, max_seq=16)
        out = [logits]
        for tok in steps:
            cache, logits = m.decode_step(params, cache, tok)
            out.append(logits)
        return out

    f0, d0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    got = run(cfg)
    torch.cuda.synchronize()
    attn = cfg.n_layers * (2 if cfg.is_encdec else 1)
    assert flash_attention_cuda.launches - f0 == attn + cfg.enc_layers
    assert decode_attention_cuda.launches - d0 == 3 * attn
    want = run(cfg.replace(attention_impl="xla"))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


#: the MoE decoders at card-sized heads (64 wide), drops on (capacity 1.25)
MOE_MODELS = {
    "grok-1-314b": dict(d_model=256, n_heads=4, n_kv_heads=2, d_ff=256),
    "moonshot-v1-16b-a3b": dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MOE_MODELS))
def test_cuda_moe_models_equal_plain(name):
    """The MoE stacks in fp32 on the card: prefill and 3 decode steps with
    the kernels equal the plain versions (1e-3, as chip_smoke.py's parity
    phases), every attention launched its kernel, and the loss agrees."""
    from repro_torch import configs
    from repro_torch.models.api import build_model

    dev = _card()
    cfg = configs.get_tiny(name).replace(capacity_factor=1.25, **MOE_MODELS[name])
    g = torch.Generator(device=dev).manual_seed(4)
    params = build_model(cfg).init(generator=g, device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=g, device=dev)
    steps = [
        torch.randint(0, cfg.vocab, (2, 1), generator=g, device=dev) for _ in range(3)
    ]
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}

    def run(c):
        m = build_model(c)
        cache, logits = m.prefill(params, {"tokens": tokens}, max_seq=16)
        out = [logits]
        for tok in steps:
            cache, logits = m.decode_step(params, cache, tok)
            out.append(logits)
        return out, m.loss(params, batch)

    f0, d0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    got, got_loss = run(cfg)
    torch.cuda.synchronize()
    # prefill, then the loss's forward: one flash launch a layer each
    assert flash_attention_cuda.launches - f0 == 2 * cfg.n_layers
    assert decode_attention_cuda.launches - d0 == 3 * cfg.n_layers
    want, want_loss = run(cfg.replace(attention_impl="xla"))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got_loss[0], want_loss[0], rtol=1e-3, atol=1e-3)
    for k in want_loss[1]:
        torch.testing.assert_close(
            got_loss[1][k], want_loss[1][k], rtol=1e-3, atol=1e-3
        )


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [384, 16])  # a prefill, a decode step's slots
def test_cuda_moe_block_gives_the_same_bits_twice(tokens):
    """moonshot's MoE block at full width (64 experts, top-6, d_ff 1,408)
    in bf16: each token sums its k outputs in a loop, no atomic add, so
    two runs give the same bits; the drops (capacity 1.25) too."""
    from repro_torch import configs
    from repro_torch.models.layers import moe_block, moe_specs
    from repro_torch.models.spec import init_params

    dev = _card()
    cfg = configs.get("moonshot-v1-16b-a3b")
    g = torch.Generator(device=dev).manual_seed(5)
    p = init_params(moe_specs(cfg), g, dev)
    p = {k: v if k == "router" else v.bfloat16() for k, v in p.items()}
    x = torch.randn(1, tokens, cfg.d_model, generator=g, device=dev).bfloat16()
    outs = []
    for _ in range(2):
        stats = {
            k: torch.zeros((), dtype=torch.int64, device=dev)
            for k in ("kept", "assigned")
        }
        y, aux = moe_block(p, x, cfg, stats)
        outs.append((y, aux, int(stats["kept"]), int(stats["assigned"])))
    (y0, a0, k0, n0), (y1, a1, k1, n1) = outs
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert (k0, n0) == (k1, n1) and n0 == tokens * cfg.top_k
    assert torch.isfinite(y0.float()).all()


def _edge_lengths(S: int) -> list:
    """0, 1, each 64-key tile boundary (every split boundary is one) -1,
    0 and +1, S - 1, S and S + 88 (an idle slot past the cache)."""
    lens = [0, 1, S - 1, S, S + 88]
    for edge in range(64, S, 64):
        lens += [edge - 1, edge, edge + 1]
    return lens


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 12, 2, 128), (16, 32, 32, 64)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_decode_attention_edges_equal_plain(shape, dtype):
    """B * Hkv = 32 (qwen2-1.5b: 8 splits of 64 keys) and 512 (zamba2-
    1.2b: one split): every edge length, mixed with random ones over the
    16 slots; a length of 0 gives exactly 0 (the plain version's softmax
    over no key gives NaN)."""
    dev = _card()
    B, H, Hkv, D = shape
    S = 512
    g = torch.Generator(device=dev).manual_seed(H)
    tdt = DTYPES[dtype]
    edges = _edge_lengths(S)
    for at in range(0, len(edges), B // 2):
        q = torch.randn(B, H, D, generator=g, device=dev).to(tdt)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(tdt)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(tdt)
        lens = torch.randint(
            1, S + 1, (B,), generator=g, device=dev, dtype=torch.int32
        )
        part = torch.tensor(edges[at : at + B // 2], device=dev, dtype=torch.int32)
        lens[1 : 1 + 2 * len(part) : 2] = part  # edges between random slots
        before = decode_attention_cuda.launches
        got = decode_attention_cuda(q, k, v, lens)
        torch.cuda.synchronize()
        assert decode_attention_cuda.launches == before + 1
        want = ref.decode_attention_ref(q, k, v, lens).float()
        empty = (lens == 0)[:, None, None]
        assert torch.equal(got.float() * empty, torch.zeros_like(want))
        want = torch.where(empty, torch.zeros_like(want), want)
        torch.testing.assert_close(got.float(), want, **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 32, 33])  # read whole (n <= 32) and walked
def test_cuda_done_prefix_batch_equals_plain_on_card(n):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    done = torch.rand(64, n, generator=g, device=dev) < 0.8
    done[0] = True
    st = torch.randint(-n, 2 * n, (64,), generator=g, device=dev, dtype=torch.int32)
    lim = torch.randint(0, n + 2, (64,), generator=g, device=dev, dtype=torch.int32)
    before = done_prefix_batch_cuda.launches
    got = ops.done_prefix_batch(done, st, lim)
    torch.cuda.synchronize()
    assert done_prefix_batch_cuda.launches == before + 1
    assert torch.equal(got, ref.done_prefix_batch_ref(done, st, lim))


def _claim_rows(n: int):
    """``chip_smoke.py``'s claim-check edge rows (numpy) and widths."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.claim_rows(n, seed=n)


def _assert_claim_check(claimed, limit, n_bits):
    before = claim_check_cuda.launches
    got = ops.claim_check(claimed, limit, n_bits)
    torch.cuda.synchronize()
    assert claim_check_cuda.launches == before + 1
    want = ops.claim_check(claimed, limit, n_bits, impl="plain")
    for what, a, b in zip(("words", "popcount", "prefix"), got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b), what


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3, 8])  # row starts off 16 bytes
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 1200, 2000, 4097])
def test_cuda_claim_check_equals_plain_on_edges(n, offset):
    dev = _card()
    rows, limits = (torch.from_numpy(x).to(dev) for x in _claim_rows(n))
    flat = torch.zeros(offset + rows.numel(), dtype=torch.bool, device=dev)
    claimed = flat[offset:].view(rows.shape)
    claimed.copy_(rows)
    want_vec = max(v for v in (16, 8, 4, 1) if n % v == 0 and offset % v == 0)
    assert claim_vector_bytes(claimed.data_ptr(), n) == want_vec
    _assert_claim_check(claimed, limits, n)
    _assert_claim_check(claimed, n, n)  # one limit for every row
    _assert_claim_check(claimed, limits, 32 * (-(-n // 32)))  # n_bits past n


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(5040, 2000), (10080, 1000), (480, 1200)])
def test_cuda_claim_check_equals_plain_at_the_sweep_shapes(rows, n):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(rows + n)
    claimed = torch.rand(rows, n, generator=g, device=dev) < 0.999
    claimed[: rows // 2] = True  # whole rows claimed, as on a drained lane
    _assert_claim_check(claimed, n, n)


@pytest.mark.cuda
def test_cuda_claim_check_refuses_what_it_does_not_take():
    dev = _card()
    claimed = torch.ones(8, 64, dtype=torch.bool, device=dev)
    lim = torch.full((8,), 64, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="bool"):
        claim_check_cuda(claimed.to(torch.uint8), lim, 64)
    with pytest.raises(ValueError, match="contiguous"):
        claim_check_cuda(claimed[:, ::2], lim, 32)
    with pytest.raises(ValueError, match="contiguous"):
        claim_check_cuda(claimed.t(), lim, 8)
    with pytest.raises(ValueError, match="limit"):
        claim_check_cuda(claimed, lim[:7], 64)
    with pytest.raises(ValueError, match="limit"):
        claim_check_cuda(claimed, lim.long(), 64)
    with pytest.raises(ValueError, match="n_bits"):
        claim_check_cuda(claimed, lim, 65)
    with pytest.raises(ValueError, match="CUDA"):
        claim_check_cuda(claimed.cpu(), 64, 64)


@pytest.mark.cuda
def test_cuda_serving_sweep_equals_cpu_on_integers():
    """One small serving sweep, overload knobs armed, on the card and on
    the CPU from the same draws: the integer outputs agree (the claim
    check on the card, its plain version on the CPU)."""
    dev = _card()
    req = SweepRequest(
        scenario="serving",
        seeds=np.arange(3),
        arrival="diurnal",
        traffic_params=dict(rate=4.0),
        serving_params=dict(horizon=60.0, timeout=2.0, retries=1, drop_rate=0.1),
        n_packets=150,
        max_batch=16,
    )
    before = claim_check_cuda.launches
    card = run_sweep(req, device=dev)
    torch.cuda.synchronize()
    assert claim_check_cuda.launches == before + 1
    cpu = run_sweep(req, device="cpu")
    for name in card.policies:
        for f in ("items", "shed", "batches", "offered", "attempts", "delivered",
                  "expired", "goodput", "dup_served", "claimed_popcount",
                  "claimed_prefix", "undelivered"):
            a, b = getattr(card[name], f).cpu(), getattr(cpu[name], f)
            assert torch.equal(a, b), (name, f)
        pop, items, shed = (
            getattr(card[name], f) for f in ("claimed_popcount", "items", "shed")
        )
        assert torch.equal(pop, items + shed), name


#: a small TCP layout: two flows starting 37 apart
TCP_PKTS, TCP_START = np.array([40, 40]), np.array([0.0, 37.0], np.float32)
TCP_TB = 80 + 80 // 8 + 32  # the default transmission budget
TCP_STEPS = -(-(3 * TCP_TB + 2 + 64) // 64) * 64
#: SACK on, random loss, worker 0 crashes at t = 150
TCP_KNOBS = dict(
    tcp_params=dict(sack=True, loss_rate=0.03),
    fault_params=dict(crash_t=150.0, crash_worker=0.0),
)


def _tcp_cpu_setup(seeds):
    """The port's own draws, made on the CPU, as a setup either device can
    take (``exp`` may round differently on the card)."""
    tp = tcptorch.default_tcp_params()
    tcp = tcptorch._lane_tensors(tp, tcptorch.TcpParams, len(seeds), "cpu")
    su = tcptorch._tcp_draws(tcp, seeds, TCP_TB, TCP_STEPS)
    return {k: getattr(su, k).numpy() for k in ("svc_pad", "u", "stalls", "lseed")}


@pytest.mark.cuda
def test_cuda_tcp_sweep_equals_cpu_on_integers():
    """One small TCP sweep, SACK on, random loss and a crashed worker, on
    the card and on the CPU from the same draws: every integer output and
    the FCTs agree, and the card's exactly-once check is one launch of the
    words route (and none of the claim check)."""
    dev = _card()
    seeds = np.arange(4)
    reqs = _fused_requests(seeds, **TCP_KNOBS)
    consts = _tcp_cpu_setup(seeds)
    out = {}
    for where in (dev, "cpu"):
        setups = [tcptorch.tcp_setups_from_reference(consts, where) for _ in reqs]
        before = (done_prefix_packed_cuda.launches, claim_check_cuda.launches)
        out[str(where)] = tcptorch.run_tcp_lanes_fused(
            reqs, n_pkts=TCP_PKTS, t_start=TCP_START, device=where, setups=setups
        )
        if where == dev:
            torch.cuda.synchronize()
            after = (done_prefix_packed_cuda.launches, claim_check_cuda.launches)
            assert after == (before[0] + 1, before[1])
    for req, card, cpu in zip(reqs, out[str(dev)], out["cpu"]):
        for f in tcptorch.TcpLaneResult._fields:
            a, b = getattr(card, f).cpu(), getattr(cpu, f)
            assert torch.equal(a, b), (req["policy"], f)
        # every claimed bit is a claimed item; a lane with a stranded queue
        # (a flow pinned to the crashed worker) leaves holes in the prefix
        assert torch.equal(card.claimed_popcount, card.items), req["policy"]
        drained = card.done.all(dim=1)
        assert torch.equal(card.claimed_prefix[drained], card.sends[drained])
        assert int(card.retransmissions.sum()) > 0, req["policy"]
    # static steering strands flow 0 (RSS queue 0) on the crashed worker;
    # stealing does not
    card = {r["policy"]: res for r, res in zip(reqs, out[str(dev)])}
    assert not bool(card["scaleout"].done[:, 0].any())
    assert bool(card["hybrid"].done.all())


@pytest.mark.cuda
@pytest.mark.parametrize("sack", [False, True])
def test_cuda_tcp_step_makes_no_host_sync(sack):
    """A few steps of every policy's TCP step under
    ``set_sync_debug_mode("error")``: no device-to-host sync inside."""
    dev = _card()
    seeds = np.arange(8)
    tp = tcptorch.default_tcp_params(loss_rate=0.03)
    for name in ("corec", "scaleout", "locked", "hybrid", "adaptive-batch"):
        c, params, tcp, su, st = tcptorch._segment(
            make_torch_policy(name), seeds, tcptorch.tcp_lane_defaults(),
            dict(tp), tcptorch.default_fault_params(), sack, TCP_PKTS,
            TCP_START, 4, 64, TCP_TB, TCP_STEPS, 32, dev,
        )
        u, stalls = su.u.t().contiguous(), su.stalls.t().contiguous()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for s in range(24):
                tcptorch._tcp_step(c, params, tcp, su, st, u[s], stalls[s])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert int(st["nsend"].sum()) > 0 and int(st["batches"].sum()) > 0, name


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return t.cpu().pin_memory()


@pytest.mark.cuda
def test_cuda_done_prefix_batch_mapped_equals_plain_and_refuses_pageable():
    """The in-place route on pinned host memory: the runs equal the plain
    version on the edge rows and random rings, written where the host
    reads them once the engine-style event has passed; pageable memory
    raises, whatever else is right."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    stream, ev = torch.cuda.Stream(dev), torch.cuda.Event()
    n = 64
    edge = torch.zeros(4, n, dtype=torch.bool)
    edge[0] = True
    edge[2, n - 1] = edge[2, 0] = True
    edge[3, :10] = True
    cases = [(edge, [3, 0, n - 1, 0], [n, n, n, 4])]
    for R, n in ((4, 4), (2, 1), (5, 32), (64, 33), (3, 512)):
        done = (torch.rand(R, n, generator=g, device=dev) < 0.8).cpu()
        st = torch.randint(0, n, (R,), generator=g, device=dev).tolist()
        lim = torch.randint(0, n + 1, (R,), generator=g, device=dev).tolist()
        cases.append((done, st, lim))
    for done, st, lim in cases:
        st, lim = (torch.tensor(v, dtype=torch.int32) for v in (st, lim))
        want = ref.done_prefix_batch_ref(done, st, lim)
        out = _pinned(torch.full_like(st, -1))
        before = done_prefix_batch_mapped.launches
        done_prefix_batch_mapped(_pinned(done), _pinned(st), _pinned(lim), out, stream)
        ev.record(stream)
        ev.synchronize()
        assert done_prefix_batch_mapped.launches == before + 1
        assert torch.equal(out, want)
    words = (st[:4], lim[:4], torch.zeros(4, dtype=torch.int32))
    pinned = [_pinned(t) for t in (edge, *words)]
    for i in range(4):
        args = list(pinned)
        args[i] = args[i].clone()  # pageable
        with pytest.raises(ValueError, match="pinned"):
            done_prefix_batch_mapped(*args, stream)


@pytest.mark.cuda
def test_cuda_engine_release_copies_nothing_and_waits_on_its_own_launch():
    """The engine's TAIL advance on the card: one launch of the mapped
    route, the runs the plain version gives on the same state, no
    Memcpy in a profiler window over it, none of the copy route's
    launches, and it returns while a long kernel still holds the default
    stream (the wait covers its own launch only)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ArchConfig
    from repro_torch.serving import EngineConfig, InferenceEngine

    dev = _card()
    cfg = ArchConfig(
        "t",
        "dense",
        n_layers=1,
        d_model=32,
        n_heads=2,
        n_kv_heads=2,
        d_ff=64,
        vocab=64,
        dtype="float32",
    )
    eng = InferenceEngine(
        cfg, EngineConfig(n_slots=16, n_lanes=4, max_seq=16), device=dev
    )
    n = eng.lane_slots
    rng = torch.Generator().manual_seed(5)

    def arm():
        """Random in-flight rings: head - tail in [0, n], done bits set."""
        eng.lane_tail[:] = torch.randint(0, 50, (4,), generator=rng).numpy()
        in_flight = torch.randint(0, n + 1, (4,), generator=rng).numpy()
        eng.lane_head[:] = eng.lane_tail + in_flight
        eng.done_mask[:] = (torch.rand(4, n, generator=rng) < 0.7).numpy()
        return (
            torch.from_numpy(eng.done_mask.copy()),
            torch.from_numpy((eng.lane_tail % n).astype("int32")),
            torch.from_numpy((eng.lane_head - eng.lane_tail).astype("int32")),
        )

    for _ in range(20):
        want = ref.done_prefix_batch_ref(*arm()).numpy()
        tail0 = eng.lane_tail.copy()
        eng._release()
        assert (eng.lane_tail - tail0 == want).all()
    arm()
    eng.lane_head[0] = eng.lane_tail[0] + 1  # at least one ring in flight
    copies = done_prefix_batch_cuda.launches
    mapped = done_prefix_batch_mapped.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng._release()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert not [m for m in names if "memcpy" in m.lower()], names
    assert done_prefix_batch_mapped.launches == mapped + 1
    assert done_prefix_batch_cuda.launches == copies
    arm()
    eng.lane_head[0] = eng.lane_tail[0] + 1
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s on the default stream
    eng._release()
    busy = not torch.cuda.current_stream(dev).query()
    torch.cuda.synchronize()
    assert busy, "the TAIL advance waited for the default stream"


def _wkv_inputs(dev, B, T, H, N, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    r, k, v = (0.5 * rn(B, T, H, N) for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * rn(B, T, H, N) - 1.0))
    u = 0.5 * rn(H, N)
    s0 = 0.3 * rn(B, H, N, N)
    tdt = DTYPES[dtype]
    return r.to(tdt), k.to(tdt), v.to(tdt), w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,H,N,chunk",
    [(1, 32, 2, 16, 8), (2, 48, 3, 32, 16), (1, 20, 1, 16, 8), (1, 384, 40, 64, 32)],
)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_rwkv6_equals_plain_on_card(B, T, H, N, chunk, dtype):
    """The reference's sweep (T = 20 over chunk 8 pads) and rwkv6-3b's
    prefill (40 heads of 64, chunk 32), from a nonzero state."""
    dev = _card()
    r, k, v, w, u, s0 = _wkv_inputs(dev, B, T, H, N, dtype, seed=T + H)
    before = rwkv6_cuda.launches
    o, s = ops.rwkv6(r, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert rwkv6_cuda.launches == before + 1
    o_ref, s_ref = ops.rwkv6(r, k, v, w, u, s0, chunk=chunk, impl="plain")
    assert o.dtype == r.dtype and s.dtype == torch.float32
    torch.testing.assert_close(o.float(), o_ref.float(), **_tol(dtype, 2e-4))
    torch.testing.assert_close(s, s_ref, **_tol(dtype, 2e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_rwkv6_state_carry_split_equals_full_run(dtype):
    """Two calls carrying the state (the split off the 64-token chunk
    tile and the 16-token sub-chunks) against one plain call."""
    dev = _card()
    r, k, v, w, u, _ = _wkv_inputs(dev, 1, 100, 4, 64, dtype, seed=7)
    o_full, s_full = ops.rwkv6(r, k, v, w, u, chunk=32, impl="plain")
    o1, s1 = ops.rwkv6(r[:, :40], k[:, :40], v[:, :40], w[:, :40], u, chunk=32)
    o2, s2 = ops.rwkv6(r[:, 40:], k[:, 40:], v[:, 40:], w[:, 40:], u, s1, chunk=32)
    got = torch.cat([o1, o2], 1).float()
    torch.testing.assert_close(got, o_full.float(), **_tol(dtype, 2e-4))
    torch.testing.assert_close(s2, s_full, **_tol(dtype, 2e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_rwkv6_strong_decay_stays_finite(dtype):
    """w at its clip, exp(-e^4), over whole chunks: no factor of the
    kernels' decays can overflow (the sequential oracle as reference:
    the chunked plain version's split factors overflow there)."""
    dev = _card()
    r, k, v, _, u, s0 = _wkv_inputs(dev, 1, 100, 2, 64, dtype, seed=8)
    w = torch.full(r.shape, float(torch.exp(-torch.exp(torch.tensor(4.0)))), device=dev)
    o, s = ops.rwkv6(r, k, v, w, u, s0, chunk=32)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    o_seq, s_seq = ref.rwkv6_scan_ref(
        r.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1), w.movedim(2, 1), u, s0
    )
    torch.testing.assert_close(
        o.float(), o_seq.movedim(1, 2).float(), **_tol(dtype, 2e-4)
    )
    torch.testing.assert_close(s, s_seq, **_tol(dtype, 2e-4))


#: ragged prompts: below the 64-token chunk tile, on and across its
#: 16-token sub-chunk edges, and over several chunks
RAGGED_T = [2, 5, 15, 16, 17, 20, 33, 47, 63, 64, 65, 130]


@pytest.mark.cuda
@pytest.mark.parametrize("T", RAGGED_T)
@pytest.mark.parametrize("N", [6, 16, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_rwkv6_ragged_equals_plain(T, N, dtype):
    dev = _card()
    r, k, v, w, u, s0 = _wkv_inputs(dev, 2, T, 3, N, dtype, seed=T * 7 + N)
    before = rwkv6_cuda.launches
    o, s = rwkv6_cuda(r, k, v, w, u, s0, chunk=32)
    torch.cuda.synchronize()
    assert rwkv6_cuda.launches == before + 1
    o_ref, s_ref = ops.rwkv6(r, k, v, w, u, s0, chunk=32, impl="plain")
    torch.testing.assert_close(o.float(), o_ref.float(), **_tol(dtype, 2e-4))
    torch.testing.assert_close(s, s_ref, **_tol(dtype, 2e-4))


def _ssd_inputs(dev, B, T, H, P, G, N, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x = 0.5 * rn(B, T, H, P)
    dt = 0.2 * torch.nn.functional.softplus(rn(B, T, H))
    A = -torch.exp(0.3 * rn(H))
    Bm, Cm = 0.5 * rn(B, T, G, N), 0.5 * rn(B, T, G, N)
    D = 0.3 * rn(H)
    s0 = 0.3 * rn(B, H, P, N)
    tdt = DTYPES[dtype]
    return x.to(tdt), dt, A, Bm.to(tdt), Cm.to(tdt), D, s0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,H,P,G,N,chunk",
    [
        (1, 32, 2, 8, 1, 16, 8),
        (2, 24, 4, 16, 2, 8, 8),  # G = 2
        (1, 20, 4, 16, 2, 8, 8),  # T = 20 over chunk 8 pads
        (1, 384, 64, 64, 1, 64, 64),  # zamba2-1.2b's prefill
        (16, 1, 64, 64, 1, 64, 64),  # zamba2-1.2b's decode step
        (1, 1024, 128, 64, 1, 128, 64),  # granite-4.0-h-small's prefill, N = 128
        (32, 1, 128, 64, 1, 128, 64),  # granite-4.0-h-small's 32-slot decode step
    ],
)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_ssd_equals_plain_on_card(B, T, H, P, G, N, chunk, dtype):
    """The kernel route (y in x's dtype, then + D x outside) against the
    plain route (D inside, in fp32): the same function, rounded in other
    places in bf16."""
    dev = _card()
    x, dt, A, Bm, Cm, D, s0 = _ssd_inputs(dev, B, T, H, P, G, N, dtype, seed=T + H)
    before = ssd_cuda.launches
    y, s = ops.ssd(x, dt, A, Bm, Cm, D, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    y_ref, s_ref = ops.ssd(x, dt, A, Bm, Cm, D, s0, chunk=chunk, impl="plain")
    torch.testing.assert_close(y.float(), y_ref.float(), **_tol(dtype, 2e-4))
    torch.testing.assert_close(s, s_ref, **_tol(dtype, 2e-4))


@pytest.mark.cuda
def test_cuda_ssd_reads_strided_views_of_the_conv_output():
    """x, B and C as views into one [B, T, d_in + 2N] tensor, as the
    Mamba block passes them: no copy, the same result as dense inputs."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(9)
    H, P, N, T = 8, 64, 64, 100
    conv = torch.randn(2, T, H * P + 2 * N, generator=g, device=dev).bfloat16()
    x = conv[..., : H * P].reshape(2, T, H, P)
    Bm = conv[..., H * P : H * P + N].reshape(2, T, 1, N)
    Cm = conv[..., H * P + N :].reshape(2, T, 1, N)
    assert not x.is_contiguous()
    dt = 0.1 * torch.rand(2, T, H, generator=g, device=dev)
    A = -torch.rand(H, generator=g, device=dev)
    got = ssd_cuda(x, dt, A, Bm, Cm, torch.zeros(2, H, P, N, device=dev))
    want = ssd_cuda(
        x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(),
        torch.zeros(2, H, P, N, device=dev),
    )
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("T", RAGGED_T)
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_ssd_ragged_equals_plain(T, G, dtype):
    """The chunked route on prompts below, on and across the chunk
    tile's edges, with one and two B/C groups."""
    dev = _card()
    x, dt, A, Bm, Cm, D, s0 = _ssd_inputs(dev, 2, T, 8, 64, G, 64, dtype, seed=T + G)
    before = ssd_cuda.launches
    y, s = ops.ssd(x, dt, A, Bm, Cm, D, s0, chunk=64)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    y_ref, s_ref = ops.ssd(x, dt, A, Bm, Cm, D, s0, chunk=64, impl="plain")
    torch.testing.assert_close(y.float(), y_ref.float(), **_tol(dtype, 2e-4))
    torch.testing.assert_close(s, s_ref, **_tol(dtype, 2e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 20, 70])
@pytest.mark.parametrize("P,N", [(6, 10), (5, 3), (16, 40), (16, 100), (64, 72)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_ssd_odd_widths_equal_plain(T, P, N, dtype):
    """Head and state widths off the 16-wide tensor-core tiles and the
    16-byte copies: padded tiles, element loads."""
    dev = _card()
    x, dt, A, Bm, Cm, D, s0 = _ssd_inputs(dev, 2, T, 4, P, 2, N, dtype, seed=P * N)
    y, s = ops.ssd(x, dt, A, Bm, Cm, D, s0, chunk=64)
    y_ref, s_ref = ops.ssd(x, dt, A, Bm, Cm, D, s0, chunk=64, impl="plain")
    torch.testing.assert_close(y.float(), y_ref.float(), **_tol(dtype, 2e-4))
    torch.testing.assert_close(s, s_ref, **_tol(dtype, 2e-4))


def _conv_views(dev, B, T, H, P, G, N, dtype, seed):
    """x, B and C as views into one [B, T, H P + 2 G N] tensor, as the
    Mamba block passes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    conv = 0.5 * torch.randn(B, T, H * P + 2 * G * N, generator=g, device=dev)
    conv = conv.to(DTYPES[dtype])
    x = conv[..., : H * P].reshape(B, T, H, P)
    Bm = conv[..., H * P : H * P + G * N].reshape(B, T, G, N)
    Cm = conv[..., H * P + G * N :].reshape(B, T, G, N)
    dt = torch.nn.functional.softplus(torch.randn(B, T, H, generator=g, device=dev))
    dt = 0.2 * dt
    A = -torch.exp(0.3 * torch.randn(H, generator=g, device=dev))
    s0 = 0.3 * torch.randn(B, H, P, N, generator=g, device=dev)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_ssd_decode_route_equals_plain(B, G, dtype):
    """T == 1 (the decode step's own kernel) on strided views of the conv
    output, against the plain route on dense copies."""
    dev = _card()
    x, dt, A, Bm, Cm, s0 = _conv_views(dev, B, 1, 64, 64, G, 64, dtype, seed=B + G)
    assert x.untyped_storage().data_ptr() == Cm.untyped_storage().data_ptr()
    D = torch.zeros(64, device=dev)
    before = ssd_cuda.launches
    y, s = ssd_cuda(x, dt, A, Bm, Cm, s0)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    y_ref, s_ref = ops.ssd(
        x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), D, s0, impl="plain"
    )
    torch.testing.assert_close(y.float(), y_ref.float(), **_tol(dtype, 2e-4))
    torch.testing.assert_close(s, s_ref, **_tol(dtype, 2e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_ssd_state_carry_through_both_routes(dtype):
    """A ragged prefill, three one-token calls, then another prefill,
    each carrying the state: one plain call over the whole sequence."""
    dev = _card()
    T = 150
    x, dt, A, Bm, Cm, D, s0 = _ssd_inputs(dev, 2, T, 8, 64, 2, 64, dtype, seed=11)
    no_d = torch.zeros_like(D)
    ys, s = [], s0
    for lo, hi in ((0, 70), (70, 71), (71, 72), (72, 73), (73, T)):
        y, s = ssd_cuda(
            x[:, lo:hi], dt[:, lo:hi].contiguous(), A, Bm[:, lo:hi], Cm[:, lo:hi], s
        )
        ys.append(y)
    y_ref, s_ref = ops.ssd(x, dt, A, Bm, Cm, no_d, s0, chunk=64, impl="plain")
    torch.testing.assert_close(
        torch.cat(ys, 1).float(), y_ref.float(), **_tol(dtype, 2e-4)
    )
    torch.testing.assert_close(s, s_ref, **_tol(dtype, 2e-4))


@pytest.mark.cuda
def test_cuda_scans_from_two_threads_equal_plain():
    """Prefill-sized and decode-sized ssd and rwkv6 calls from two Python
    threads at once, 50 rounds each, on the shared stream: every result
    equals the serial kernel result, which is held against the plain
    version (each call owns its workspace)."""
    import threading

    dev = _card()
    tol = _tol("bfloat16", 2e-4)
    wkv = _wkv_inputs(dev, 1, 200, 8, 64, "bfloat16", seed=21)
    pre = _ssd_inputs(dev, 1, 200, 16, 64, 1, 64, "bfloat16", seed=22)
    dec = _ssd_inputs(dev, 16, 1, 16, 64, 1, 64, "bfloat16", seed=23)

    def ssd_k(a):
        return ssd_cuda(a[0], a[1], a[2], a[3], a[4], a[6])

    def ssd_p(a):
        return ops.ssd(*a[:5], torch.zeros_like(a[5]), a[6], impl="plain")

    calls = [
        (lambda: rwkv6_cuda(*wkv), lambda: ops.rwkv6(*wkv, impl="plain")),
        (lambda: ssd_k(pre), lambda: ssd_p(pre)),
        (lambda: ssd_k(dec), lambda: ssd_p(dec)),
    ]
    serial = []
    for kern, plain in calls:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), **tol)
        serial.append(got)
    bad = []

    def worker(order):
        for _ in range(50):
            for i in order:
                got = calls[i][0]()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, serial[i])):
                    bad.append(i)

    orders = ((0, 2, 1), (2, 1, 0))
    threads = [threading.Thread(target=worker, args=(o,)) for o in orders]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad, f"calls {sorted(set(bad))} differed under concurrency"


# ----------------------------------------------------------------------
# training: the grad guard and one train step
# ----------------------------------------------------------------------
def _grad_calls(dev):
    """Each float kernel as (wrapper, a call on inputs of which the first
    requires a gradient)."""
    g = torch.Generator(device=dev).manual_seed(31)

    def rn(*s):
        return torch.randn(*s, generator=g, device=dev)

    q = rn(1, 16, 2, 64).requires_grad_(True)
    kv = rn(1, 16, 1, 64)
    lengths = torch.full((1,), 16, dtype=torch.int32, device=dev)
    r = rn(1, 64, 2, 64).requires_grad_(True)
    w = torch.sigmoid(rn(1, 64, 2, 64))
    st = torch.zeros(1, 2, 64, 64, device=dev)
    x = rn(1, 64, 2, 64).requires_grad_(True)
    dt, A = torch.rand(1, 64, 2, generator=g, device=dev), -torch.rand(2, device=dev)
    Bm = rn(1, 64, 1, 64)
    ones = torch.ones(64, device=dev)
    return [
        (flash_attention_cuda, lambda: flash_attention_cuda(q, kv, kv)),
        (
            decode_attention_cuda,
            lambda: decode_attention_cuda(q[:, 0].contiguous(), kv, kv, lengths),
        ),
        (rmsnorm_cuda, lambda: rmsnorm_cuda(q.reshape(-1, 64), ones)),
        (
            add_rmsnorm_cuda,
            lambda: add_rmsnorm_cuda(
                kv.reshape(-1, 64), q[:, :, 0].reshape(-1, 64).contiguous(), ones
            ),
        ),
        (rwkv6_cuda, lambda: rwkv6_cuda(r, r.detach(), r.detach(), w, w[0, 0], st)),
        (ssd_cuda, lambda: ssd_cuda(x, dt, A, Bm, Bm, st)),
    ]


@pytest.mark.cuda
def test_cuda_wrappers_refuse_inputs_that_require_grad():
    """Under grad mode a wrapper raises before it launches (its output
    would carry no ``grad_fn``), and ``ops``' ``"auto"`` on a CUDA tensor
    that requires a gradient raises too: no quiet switch to the plain
    version."""
    dev = _card()
    for wrapper, call in _grad_calls(dev):
        before = wrapper.launches
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
        assert wrapper.launches == before, wrapper.__name__
        with torch.no_grad():
            call()
        assert wrapper.launches == before + 1, wrapper.__name__
    q = torch.randn(1, 8, 2, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        ops.attention(q, q, q)
    out = ops.attention(q, q, q, impl="plain")
    assert out.grad_fn is not None


@pytest.mark.cuda
def test_cuda_train_step_equals_cpu():
    """One tiny fp32 train step on the plain routes (TF32 off), on the card
    and on the CPU from the same parameters and batch, every attention's
    wq/wk/wv drawn at fan-in d (as ``tests/test_torch_grad.py`` does: at
    the reference initialiser's fan-in of H the tiny stack's attention is
    all but a hard max, which amplifies rounding).  The loss agrees
    within ``1e-5`` relative and every gradient leaf within ``2e-5`` of
    its magnitude (the card's embedding backward sums with atomics, its
    GEMMs in another order).  After the AdamW step the moments agree
    within ``2e-5`` of their magnitude, and each parameter within
    ``0.1 lr``: Adam's first step is ``lr g / (|g| + eps)``, so where a
    gradient element is within a few ``eps`` of zero its step moves with
    the gradient's last bits."""
    from repro_torch import configs
    from repro_torch.launch.steps import build_steps, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    dev = _card()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = configs.get_tiny("qwen2-1.5b").replace(attention_impl="xla")
        lr = 1e-3
        rng = np.random.default_rng(5)
        toks = rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        params0, out = None, {}
        for where in ("cpu", dev):
            bundle = build_steps(cfg, lr_fn=lambda s: torch.tensor(lr), device=where)
            if params0 is None:
                params0 = bundle.model.init(torch.Generator().manual_seed(0), "cpu")
                attn = params0["layers"]["attn"]
                for key in ("wq", "wk", "wv"):  # [L, d, H, dh]: fan-in H -> d
                    d, h = attn[key].shape[-3:-1]
                    attn[key] = attn[key] * (h / d) ** 0.5
            params = tree_map(lambda t: t.to(where), params0)
            tb = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
            loss, _, grads = value_and_grad(bundle.model, params, tb)
            opt = bundle.optimizer.init(params)
            p1, o1, _ = bundle.train_step(params, opt, batch)
            out[str(where)] = [
                float(loss),
                *([t.cpu() for t in tree_leaves(x)] for x in (grads, o1.m, p1)),
            ]
        (lc, gc_, mc, pc), (lg, gg, mg, pg) = out["cpu"], out[str(dev)]
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        for a, b in zip(gc_, gg):
            assert float((a - b).abs().max()) <= 2e-5 * float(a.abs().max())
        for a, b in zip(mc, mg):
            assert float((a - b).abs().max()) <= 2e-5 * float(a.abs().max())
        for a, b in zip(pc, pg):
            assert float((a - b).abs().max()) <= 0.1 * lr
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_cuda_quantize_int8_equals_cpu(scale):
    """The pod all-reduce's int8 payload and scale on the card equal the
    CPU's bit for bit (a Python-scalar divisor would be a reciprocal
    multiply on the card, an ulp off)."""
    from repro_torch.optim import quantize_int8

    dev = _card()
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4097, 33, generator=g) * scale
    q, s = quantize_int8(x.to(dev))
    q_cpu, s_cpu = quantize_int8(x)
    assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)


@pytest.mark.cuda
def test_cuda_sharded_sweep_equals_unsharded():
    """Two gloo ranks on the one card: every lane of a small two-policy
    sweep equals the unsharded run on the card, and the claim check ran
    once on each rank."""
    from repro_torch.distributed import run_ranks, sweep_rank

    dev = _card()
    req = SweepRequest(policies=["corec", "hybrid"], seeds=np.arange(7), n_packets=128,
                       lane_params=dict(batch=np.arange(1, 8, dtype=np.float32)))
    base = run_sweep(req, device=dev)
    ranks = run_ranks(sweep_rank, 2, req, str(dev), backend="gloo", timeout=300)
    for out in ranks:
        assert out["launches"] == dict(claim_check=1, words=0)
        for name, res in base.lanes.items():
            for f in res._fields:
                assert np.array_equal(out["lanes"][name][f], getattr(res, f).cpu().numpy())
