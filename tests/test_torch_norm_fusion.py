"""The residual add folded into RMSNorm: ``ops.add_rmsnorm`` against the
JAX package, and the launch plan of each served model.

``ops.add_rmsnorm`` on a CPU tensor runs its plain version
(``ref.add_rmsnorm_ref``); the same numpy-seeded x, delta and weight go
through ``jnp``'s add and the reference's ``rmsnorm_ref``, and through
``rmsnorm_pallas`` in interpret mode.  The sum ``s`` must equal the
reference's bit for bit (the kernel on the card is held to the same);
``y`` is held at the tolerances of ``tests/test_kernels.py`` (fp32
``2e-5``, bf16 ``2e-2``).

The launch plan: every norm of the served models whose input is a
residual add runs as ``ops.add_rmsnorm``; the rest as ``ops.rmsnorm``.
The calls of each are counted per prefill and per decode step on the
tiny configs and held against the formulas ``chip_smoke.py`` asserts on
the card, which give 56/1 (qwen2-1.5b), 64/1 (rwkv6-3b), 38/13
(zamba2-1.2b) and 20/1 (llama-3.2-vision at its served depth of 10
layers) at full depth, 32/1 (moonshot at 16 layers) and 4/1 (grok-1 at
2), as many norms a call as before; Whisper's LayerNorms launch no
RMSNorm kernel.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ROOT = Path(__file__).resolve().parents[1]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("rows", [1, 7, 16])
@pytest.mark.parametrize("d", [64, 96, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("wdtype", sorted(DTYPES))
def test_add_rmsnorm_equals_reference_and_pallas(rows, d, dtype, wdtype):
    rng = np.random.default_rng(rows * 1000 + d)
    jdt, tdt = DTYPES[dtype]
    x, delta = (rng.standard_normal((rows, d)).astype(np.float32) for _ in "xd")
    w = (1 + 0.3 * rng.standard_normal(d)).astype(np.float32)
    jx, jd = jnp.asarray(x).astype(jdt), jnp.asarray(delta).astype(jdt)
    jw = jnp.asarray(w).astype(DTYPES[wdtype][0])
    tw = torch.from_numpy(w).to(DTYPES[wdtype][1])
    s, y = ops.add_rmsnorm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(delta).to(tdt), tw, eps=1e-5
    )
    js = jx + jd
    assert s.dtype == y.dtype == tdt and s.shape == y.shape == (rows, d)
    np.testing.assert_array_equal(_f32(s), _f32(js))
    np.testing.assert_allclose(_f32(y), _f32(jref.rmsnorm_ref(js, jw)), **TOL[dtype])
    pallas = rmsnorm_pallas(js, jw, eps=1e-5, interpret=True, block_rows=8)
    np.testing.assert_allclose(_f32(y), _f32(pallas), **TOL[dtype])


def test_add_rmsnorm_keeps_leading_dims_and_leaves_x_as_it_was():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 48)).astype(np.float32))
    delta = torch.from_numpy(rng.standard_normal((2, 3, 48)).astype(np.float32))
    w = torch.full((48,), 0.5)
    x0 = x.clone()
    s, y = ops.add_rmsnorm(x, delta, w)
    assert torch.equal(x, x0) and s.data_ptr() != x.data_ptr()
    assert torch.equal(s, x0 + delta)
    assert torch.equal(y, ops.rmsnorm(x0 + delta, w))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _count_norm_calls(monkeypatch, fn) -> dict:
    """Calls of ops.rmsnorm and ops.add_rmsnorm while ``fn`` runs."""
    counts = {"rmsnorm": 0, "add_rmsnorm": 0}
    for name in counts:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    fn()
    monkeypatch.undo()
    return counts


SERVED = (
    "qwen2-1.5b",
    "rwkv6-3b",
    "zamba2-1.2b",
    "whisper-large-v3",
    "llama-3.2-vision-90b",
    "moonshot-v1-16b-a3b",
    "grok-1-314b",
)


@pytest.mark.parametrize("name", SERVED)
def test_norm_launch_plan_equals_chip_smoke_formula(monkeypatch, name):
    """One prefill and one decode step of the tiny config: the norms
    that fold a residual add in and the plain ones, as chip_smoke.py's
    launch formula counts them, together as many as the model has."""
    smoke = _chip_smoke()
    served = smoke.SERVED[name]
    cfg = configs.get_tiny(name)
    model = build_model(cfg)
    params = model.prepare(
        model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    )
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 7)).astype(np.int32)
    )
    batch = smoke.model_batch(cfg, tokens, "cpu")
    box = {}

    def prefill():
        box["cache"], _ = model.prefill(params, batch, max_seq=12)

    def step():
        model.decode_step(params, box["cache"], tokens[:, :1])

    for fn, pre, steps in ((prefill, 1, 0), (step, 0, 1)):
        got = _count_norm_calls(monkeypatch, fn)
        want = served["launches"](cfg, pre, steps)
        assert got == {k: want[k] for k in got}
        assert sum(got.values()) == served["norms"](cfg)


def test_full_depth_norm_plans():
    """56/1, 64/1 and 38/13 fused/plain norms per call at full depth:
    one eager add launch fewer per fused norm than before the fusion,
    and the same number of norms (57, 65, 51); the VLM at its served
    depth (10 layers) 20/1, its cross layers' norms fused too; Whisper
    none (LayerNorm, plain PyTorch); the MoE paths at their served
    depths (moonshot 16 layers, grok-1 2) 32/1 and 4/1."""
    smoke = _chip_smoke()
    want = {
        "qwen2-1.5b": (56, 1),
        "rwkv6-3b": (64, 1),
        "zamba2-1.2b": (38, 13),
        "whisper-large-v3": (0, 0),
        "llama-3.2-vision-90b": (20, 1),
        "moonshot-v1-16b-a3b": (32, 1),
        "grok-1-314b": (4, 1),
    }
    assert sorted(want) == sorted(smoke.SERVED)
    for name, (fused, plain) in want.items():
        cfg = smoke.served_config(name)
        got = smoke.SERVED[name]["launches"](cfg, 1, 0)
        assert (got["add_rmsnorm"], got["rmsnorm"]) == (fused, plain)
        assert smoke.SERVED[name]["norms"](cfg) == fused + plain
