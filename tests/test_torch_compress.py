"""The int8 pod all-reduce with error feedback (``optim/compress.py``)
against the reference's ``repro.optim.compress``.

* ``quantize_int8`` equals ``jnp``'s bit for bit (both round half to
  even), on random, tiny, all-zero and half-way inputs; the round-trip
  error bound of ``tests/test_optim.py``.
* One rank (a one-process ``gloo`` group): the cases of
  ``tests/test_optim.py::test_compressed_allreduce_with_error_feedback``
  -- the reduction plus its residual gives back the gradient, and 100
  error-feedback steps keep the mean within 2e-3.
* Four ranks (``gloo``, one process each, a free port and a deadline)
  against the reference under ``shard_map`` on four forced host devices
  (a subprocess, since the device count is fixed when jax starts): three
  chained steps, each pod's ``q`` exact, the reduced gradients and the
  new errors to 1e-6 of the leaf's largest gradient magnitude (XLA fuses
  the residual's multiply and subtract; torch rounds between them).
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import quantize_int8 as jquantize  # noqa: E402

from repro_torch.distributed import run_ranks  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    compressed_pod_allreduce,
    dequantize_int8,
    error_feedback_init,
    quantize_int8,
)

PODS, STEPS = 4, 3
SHAPES = {"a": (64, 33), "b": (257,), "c": ()}
TOL = 1e-6
SUBPROCESS_TIMEOUT = 300
RANK_TIMEOUT = 180.0


def _pod_inputs():
    """Per pod: a gradient tree per step and a starting error tree."""
    rng = np.random.default_rng(7)
    grads = [
        [
            {k: np.asarray(rng.normal(size=s) * (p + 1), np.float32) for k, s in SHAPES.items()}
            for _ in range(STEPS)
        ]
        for p in range(PODS)
    ]
    errs = [
        {k: np.asarray(rng.normal(size=s) * 1e-2, np.float32) for k, s in SHAPES.items()}
        for _ in range(PODS)
    ]
    return grads, errs


@pytest.mark.parametrize("case", ["normal", "tiny", "zeros", "halfway"])
def test_quantize_equals_reference(case):
    rng = np.random.default_rng(3)
    x = {
        "normal": rng.normal(size=(128, 65)) * 3.0,
        "tiny": rng.normal(size=(40,)) * 1e-20,
        "zeros": np.zeros((7, 3)),
        # 127 * k / 2 / 127 of the max: every value a half-way point
        "halfway": np.concatenate([[127.0], np.arange(-253, 254, 2) / 2.0]),
    }[case].astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jquantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    if case == "halfway":
        assert (np.abs(x / float(s) - np.round(x / float(s))) == 0.5).sum() > 100


def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 32)) * 3.0).float()
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.51 + 1e-6


@pytest.fixture
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_compressed_allreduce_with_error_feedback(one_rank):
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(128,))).float()}
    e = error_feedback_init(g)
    red, e2 = compressed_pod_allreduce(g, e)
    # one pod: reduction == dequant(quant(g)); the residual is g - that
    np.testing.assert_allclose(
        (red["w"] + e2["w"]).numpy(), g["w"].numpy(), rtol=1e-6, atol=1e-6
    )
    acc = torch.zeros_like(g["w"])
    e = error_feedback_init(g)
    for _ in range(100):
        red, e = compressed_pod_allreduce(g, e)
        acc = acc + red["w"]
    np.testing.assert_allclose((acc / 100).numpy(), g["w"].numpy(), atol=2e-3)


def _rank(rank, world, grads, errs):
    e = {k: torch.from_numpy(v) for k, v in errs[rank].items()}
    out = []
    for step in range(STEPS):
        g = {k: torch.from_numpy(v) for k, v in grads[rank][step].items()}
        q = {k: quantize_int8(g[k] + e[k])[0].numpy() for k in g}
        red, e = compressed_pod_allreduce(g, e)
        out.append(
            dict(q=q, red={k: v.numpy() for k, v in red.items()},
                 err={k: v.numpy() for k, v in e.items()})
        )
    return out


_REFERENCE = textwrap.dedent(
    """
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    assert jax.local_device_count() == 4, jax.local_device_count()
    from repro.compat import make_mesh, shard_map
    from repro.optim import compressed_pod_allreduce, quantize_int8

    d = np.load(sys.argv[1])
    keys = sorted({k.split("/")[1] for k in d.files})
    steps = max(int(k.split("/")[2]) for k in d.files if k.startswith("g/")) + 1
    mesh = make_mesh((4,), ("pod",))
    fn = jax.jit(shard_map(
        lambda g, e: compressed_pod_allreduce(g, e, "pod"),
        mesh=mesh, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")),
    ))
    e = {k: jnp.asarray(d[f"e/{k}"]) for k in keys}
    out = {}
    for s in range(steps):
        g = {k: jnp.asarray(d[f"g/{k}/{s}"]) for k in keys}
        for k in keys:
            for p in range(4):
                target = np.asarray(g[k])[p] + np.asarray(e[k])[p]
                out[f"q/{k}/{s}/{p}"] = np.asarray(quantize_int8(jnp.asarray(target))[0])
        red, e = fn(g, e)
        for k in keys:
            out[f"red/{k}/{s}"] = np.asarray(red[k])
            out[f"err/{k}/{s}"] = np.asarray(e[k])
    np.savez(sys.argv[2], **out)
    print("REFERENCE-OK")
    """
)


def _reference(tmp_path, grads, errs) -> dict:
    """The reference on four forced host devices: every input leaf stacked
    over pods on a leading axis that ``shard_map`` splits."""
    inp = {}
    for k in SHAPES:
        inp[f"e/{k}"] = np.stack([errs[p][k] for p in range(PODS)])
        for s in range(STEPS):
            inp[f"g/{k}/{s}"] = np.stack([grads[p][s][k] for p in range(PODS)])
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    ).strip()
    env["JAX_PLATFORMS"] = "cpu"
    src_dir = str(Path(__file__).resolve().parent.parent / "src")
    env["PYTHONPATH"] = src_dir + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(src), str(dst)],
        env=env, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return dict(np.load(dst))


def test_four_ranks_equal_reference_shard_map(tmp_path):
    grads, errs = _pod_inputs()
    want = _reference(tmp_path, grads, errs)
    ranks = run_ranks(_rank, PODS, grads, errs, backend="gloo", timeout=RANK_TIMEOUT)
    for s in range(STEPS):
        for k, shape in SHAPES.items():
            for p, out in enumerate(ranks):
                got = out[s]
                np.testing.assert_array_equal(got["q"][k], want[f"q/{k}/{s}/{p}"])
                # the reference's out_specs stack each pod's block
                ref_red = want[f"red/{k}/{s}"].reshape((PODS,) + shape)[p]
                ref_err = want[f"err/{k}/{s}"].reshape((PODS,) + shape)[p]
                assert got["red"][k].shape == shape
                # to 1e-6 of the leaf's magnitude: XLA contracts the
                # residual (g + e) - q * scale into one fused multiply-add,
                # torch rounds q * scale first, an ulp of |g + e| apart
                mag = max(float(np.abs(grads[i][s][k]).max()) for i in range(PODS))
                np.testing.assert_allclose(got["red"][k], ref_red, rtol=0, atol=TOL * mag)
                np.testing.assert_allclose(got["err"][k], ref_err, rtol=0, atol=TOL * mag)
            # every pod holds the same reduction
            for out in ranks[1:]:
                np.testing.assert_array_equal(out[s]["red"][k], ranks[0][s]["red"][k])
