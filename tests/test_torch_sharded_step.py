"""The sharded train, prefill and serve steps against the one-device ones
and against the JAX package's sharded steps, rehearsed over ``gloo`` on
the CPU.

Each mesh shape -- ``(data, model)`` of ``(2, 1)``, ``(1, 2)``, ``(2, 2)``
and ``(pod, data, model)`` of ``(2, 1, 2)`` -- is a group of ranks
spawned once (``run_ranks``, with its deadline) that runs every family;
the groups run side by side.  Each rank builds the one-device bundle and
the bundle on its ``DeviceMesh`` from the same seeded parameters and
batch, places the state (``place_state``), takes one train step on
each, one prefill and one decode step, and returns what the tests
compare.  Against the one-device steps:

* the loss within ``1e-6`` relative;
* every gradient leaf within ``2e-5`` of the leaf's magnitude;
* the parameters after the step within ``test_torch_train.py``'s
  tolerance (``2e-2`` of the learning rate plus ``2e-5`` of the leaf's
  magnitude) of the one-device AdamW update applied to the sharded
  run's gradients.  Held against the one-device step itself, Adam's
  first step divides each gradient by its own size, so an element whose
  gradient is near zero turns the gradients' last-bit difference into a
  step difference of a fraction of lr (qwen2's zero-initialised key
  bias, which the softmax cancels but for RoPE: 1.14 times that
  tolerance at ``(2, 2)``; ROADMAP Queue C, "Adam amplifies
  rounding").  The gradients themselves are held above;
* every output leaf on the bundle's placement: parameters on
  ``param_shardings``, the AdamW state on ``opt_shardings``, the caches
  on ``cache_shardings``;
* the prefill's last logits and caches and one decode step's logits and
  caches within ``1e-5`` of their magnitude.

Against the reference: the same parameters and batch go through the
JAX package's own ``build_steps`` on a ``(2, 2)`` mesh of 4 forced host
devices with Auto axes (a subprocess the fixture starts beside the rank
groups; the reference's ``make_mesh`` gives Explicit axes, which its
sharding constraints fail on under jax 0.9: ROADMAP Queue C) -- the loss
and ``jax.grad`` with its ``rules``, the prefill with ``rules``, one
decode step with ``serve_rules``.  Each mesh's sharded results are held
to it at the parity tests' fp32 tolerances: the loss at ``rtol = atol =
2e-5`` (``test_torch_loss.py``), every gradient leaf within ``2e-5`` of
the reference leaf's magnitude where the reference is finite
(``test_torch_grad.py``; RWKV6's chunked form overflows there, Queue C)
and RWKV6's within ``1e-4`` (``REF_GRAD`` says why),
the logits at ``rtol = atol = 2e-5`` and the caches at ``rtol = 2e-5``,
``atol = 2e-5`` times their magnitude (``test_torch_model.py``).

The families are the tiny configs of qwen2, moonshot (MoE), rwkv6,
zamba2, whisper and llama-3.2-vision, plus two replacements: qwen2 with
4 query heads over 1 KV head (its query heads shard over ``model``
where its KV heads cannot: the ``attn_tp`` branch with the KV heads
repeated per query head), and moonshot with groups of 8 tokens (4
groups, so the MoE dispatch shards over ``batch``; the tiny config's
one group is routed whole on every rank), on ``(2, 1)`` alone.  The
3-D mesh runs the six families alone: the 4/1-head qwen2's heads shard
there as on ``(2, 2)``.

``Trainer(mesh=...)`` at ``(2, 1)`` gives the one-device trainer's
losses, and two microbatches at ``(2, 2)`` the one-device step's.  At
``(1, 2)``, where the decode cache shards its sequence over ``model``,
the route the decode kernel takes (the cache's sequence shards gathered
first) gives the merged plain route's logits.  Without rules the models
are pinned bit for bit to their outputs before the sharded path was
added (``ONE_DEVICE_PINS``), an extra guard beside the parity tests:
the pins are of torch 2.13's CPU kernels on one thread.
"""

from __future__ import annotations

import importlib.util
import math
import os
import pickle
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.distributed import run_ranks

MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2), "2x1x2": (2, 1, 2)}
FAMILIES = {
    "qwen2": ("qwen2-1.5b", {}),
    "qwen2_tp": ("qwen2-1.5b", {"n_heads": 4, "n_kv_heads": 1}),
    "moonshot": ("moonshot-v1-16b-a3b", {}),
    "moonshot_groups": ("moonshot-v1-16b-a3b", {"moe_group_size": 8}),
    "rwkv6": ("rwkv6-3b", {}),
    "zamba2": ("zamba2-1.2b", {}),
    "whisper": ("whisper-large-v3", {}),
    "vlm": ("llama-3.2-vision-90b", {}),
}
B, S, MAX_SEQ = 4, 8, 12
#: each group's deadline: about 3x the slowest group's measured time
RANK_TIMEOUT = 300
FP32 = dict(rtol=2e-5, atol=2e-5)
#: a gradient leaf against the reference's, over the leaf's magnitude:
#: the parity tests' 2e-5, but 1e-4 for RWKV6, whose reference gradients
#: on the (2, 2) mesh differ from its own one-device ones by up to 6.3e-5
#: of a leaf on these inputs (``tm/u``; the port's one-device gradients
#: are within 1.7e-5 of the reference's one-device ones, its sharded
#: within 2e-5 of its one-device): the chunked WKV form amplifies XLA's
#: rounding (ROADMAP Queue C)
REF_GRAD = {"rwkv6": 1e-4}
#: per tiny family with rules=None: the loss (float.hex), then sha256 (16
#: hex digits) of its gradients, of its prefill's logits and cache, and
#: of one decode step's; taken from the models before the sharded path
#: was added (torch 2.13 on the CPU, one thread)
ONE_DEVICE_PINS = {
    "qwen2-1.5b": ("0x1.8eeef80000000p+2", "13bc76a094376faa", "ec200eed94a3ac5c", "4f534f6c3ea6bc3c"),
    "grok-1-314b": ("0x1.918e060000000p+2", "7cc236f4197e14b1", "70c5dd447ee33ca3", "cf3283d02c74e736"),
    "rwkv6-3b": ("0x1.91164a0000000p+2", "19c1557d6ba68cdc", "af120f0eaf9bf183", "dbf287e84f1ddb78"),
    "zamba2-1.2b": ("0x1.8fc9f20000000p+2", "ce0dd75e9d5c2cfc", "75a2117ed32ece2f", "c932c0fd3e0dd7c7"),
    "whisper-large-v3": ("0x1.8d568a0000000p+2", "3789ca4a3b31bb2d", "ef8caa918891b7dc", "9c5da138e2018bd0"),
    "llama-3.2-vision-90b": ("0x1.90ed900000000p+2", "0c4e7403551d13f2", "ffdf0fd8b4a40edd", "917f58ada9b85682"),
}


def _cfg(family):
    arch, rep = FAMILIES[family]
    return configs.get_tiny(arch).replace(attention_impl="xla", **rep)


def _batch(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    batch = {
        "tokens": torch.randint(0, cfg.vocab, (B, S), generator=g),
        "labels": torch.randint(0, cfg.vocab, (B, S), generator=g),
    }
    if cfg.cross_attn_every:
        batch["image_embeds"] = torch.randn(B, cfg.n_image_tokens, cfg.d_model, generator=g)
    if cfg.is_encdec:
        batch["audio_embeds"] = torch.randn(B, cfg.enc_len, cfg.d_model, generator=g)
    return batch


def _inputs(family):
    """(cfg, parameters, batch, decode tokens) of a family, drawn from
    seeds: the port's ``init`` with every attention at fan-in d."""
    from repro_torch.models.api import build_model

    cfg = _cfg(family)
    params = _fan_in_d(build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu"))
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=torch.Generator().manual_seed(2))
    return cfg, params, _batch(cfg), tok


def _fan_in_d(tree):
    """Every attention's (a node with ``wq`` and ``wo``) wq/wk/wv, whose
    last three axes are [d, H, dh], scaled from fan-in H to fan-in d, as
    ``test_torch_loss.py`` draws them: at the initialiser's fan-in of H
    the tiny stacks are chaotic (ROADMAP Queue C, "The initialiser's
    fan-in"), and a sharded sum's last-bit difference grows past the
    gradients' ``2e-5`` (to 4e-4 of the VLM's ``wk``)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _fan_in_d(v) for k, v in tree.items()}
    if "wq" in tree and "wo" in tree:
        for key in ("wq", "wk", "wv"):
            d, h = tree[key].shape[-3:-1]
            out[key] = tree[key] * math.sqrt(h / d)
    return out


def _rel(a, b):
    """max |a - b| over the magnitude max |a| (1 where a is all zeros)."""
    a, b = a.float(), b.float()
    mag = float(a.abs().max()) if a.numel() else 0.0
    return float((a - b).abs().max()) / (mag or 1.0) if a.numel() else 0.0


def _family(family, mesh):
    from repro_torch.launch.steps import (
        _batch_shardings,
        _to_params,
        build_steps,
        gather_state,
        place,
        place_state,
        value_and_grad,
    )
    from repro_torch.optim import apply_updates
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    cfg, params, batch, tok = _inputs(family)
    one = build_steps(cfg, device="cpu")
    sh = build_steps(cfg, device="cpu", mesh=mesh)
    opt = one.optimizer.init(params)
    out = {}

    # the loss and every gradient leaf
    loss1, _, g1 = value_and_grad(one.model, params, batch)
    ps, os_ = place_state(sh, params, opt)
    placed = tree_map(place, batch, _batch_shardings(sh.rules, batch))
    loss2, _, g2 = value_and_grad(sh.model, ps, placed, sh.rules)
    g2 = gather_state(_to_params(g2, ps))
    out["loss"] = (float(loss1), float(loss2.full_tensor()))
    out["grads"] = {p: _rel(a, b) for (p, a), b in zip(tree_paths(g1), tree_leaves(g2))}
    ref = {"loss": float(loss2.full_tensor()), "grads": [(p, g.numpy()) for p, g in tree_paths(g2)]}

    # one train step; the outputs on the bundle's placements
    p1, o1, m1 = one.train_step(params, opt, batch)
    p2, o2, m2 = sh.train_step(ps, os_, batch)
    want = [s.placements for s in tree_leaves(sh.param_shardings)]
    out["param_placed"] = [a.placements for a in tree_leaves(p2)] == want
    want_opt = [s.placements for s in tree_leaves(sh.opt_shardings)]
    out["opt_placed"] = [a.placements for a in tree_leaves(o2)] == want_opt
    out["step_loss"] = (float(m1["loss"]), float(m2["loss"]))
    p2 = gather_state(p2)
    updates, _ = one.optimizer.update(g2, opt, params, m1["lr"])
    want = apply_updates(params, updates)
    lr = float(m1["lr"])  # the bundle's default, a constant 3e-4
    out["params"] = {
        p: float((a - b).abs().max()) / (2e-2 * lr + 2e-5 * float(a.abs().max()))
        for (p, a), b in zip(tree_paths(want), tree_leaves(p2))
    }

    # prefill, then one decode step
    pb = {k: v for k, v in batch.items() if k != "labels"}
    c1, l1 = one.prefill_step(params, pb, max_seq=MAX_SEQ)
    c2, l2 = sh.prefill_step(ps, pb, max_seq=MAX_SEQ)
    csh = sh.cache_shardings(B, MAX_SEQ)
    out["cache_placed"] = all(
        c2[k].placements == csh[k].placements for k in c1
    )
    out["prefill_logits"] = _rel(l1, l2.full_tensor())
    out["prefill_cache"] = {k: _rel(c1[k], c2[k].full_tensor()) for k in c1}
    ref["prefill"] = _host(c2, l2)
    c1, d1 = one.serve_step(params, c1, tok)
    c2, d2 = sh.serve_step(place_state(sh, params, serve=True), c2, tok)
    out["decode_placed"] = all(c2[k].placements == csh[k].placements for k in c1)
    out["decode_logits"] = _rel(d1, d2.full_tensor())
    out["decode_cache"] = {k: _rel(c1[k], c2[k].full_tensor()) for k in c1}
    ref["decode"] = _host(c2, d2)
    out["sharded"] = ref
    return out


def _host(cache, logits):
    """A sharded step's (cache, logits) as whole numpy arrays, copied: a
    replicated DTensor's ``full_tensor()`` is its local tensor, which the
    next decode step writes in place."""
    return ({k: v.full_tensor().numpy().copy() for k, v in cache.items()},
            logits.full_tensor().numpy().copy())


def _runs(family, shape) -> bool:
    """Every family on every mesh, but the grouped MoE on ``(2, 1)`` alone
    (its groups shard over ``batch`` the same way on the other meshes)
    and the six families alone on the 3-D mesh (the 4/1-head qwen2's
    heads shard there as on ``(2, 2)``): each family costs seconds of
    DTensor's first-call sharding propagation per mesh."""
    if family == "moonshot_groups":
        return shape == (2, 1)
    return len(shape) == 2 or family != "qwen2_tp"


def _mesh_rank(rank, world, shape, families):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    results = {f: _family(f, mesh) for f in families}
    if shape == (2, 1):
        results["trainer"] = _trainer(mesh)
    if shape == (2, 2):
        results["microbatches"] = _microbatches(mesh)
    if shape == (1, 2):
        results["gathered_decode"] = _gathered_decode(mesh)
    return results


def _gathered_decode(mesh):
    """One decode step of qwen2 over a cache whose sequence shards over
    ``model``, on the merged plain route and on the route the decode
    kernel takes (``_kernel_route`` made to say yes, the plain version
    standing in for the kernel): (the sequence lengths the decode
    attention was given on each route, the logits' difference over
    their magnitude)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_steps, place_state
    from repro_torch.models import layers

    cfg, params, batch, tok = _inputs("qwen2")
    sh = build_steps(cfg, device="cpu", mesh=mesh)
    ps, served = place_state(sh, params), place_state(sh, params, serve=True)
    seen, plain_attend, route = [], ops.decode_attention, layers._kernel_route

    def attend(q, k, v, n, **kw):
        seen.append(k.shape[1])
        return plain_attend(q, k, v, n, **kw)

    ops.decode_attention = attend
    try:
        logits, lengths = [], []
        for kernel in (False, True):
            layers._kernel_route = lambda cfg, t: kernel
            cache, _ = sh.prefill_step(ps, {"tokens": batch["tokens"]}, max_seq=MAX_SEQ)
            seen.clear()
            _, d = sh.serve_step(served, cache, tok)
            logits.append(d.full_tensor())
            lengths.append(sorted(set(seen)))
    finally:
        ops.decode_attention, layers._kernel_route = plain_attend, route
    return lengths, _rel(logits[0], logits[1])


def _microbatches(mesh):
    """One train step of two microbatches, one device against the mesh:
    (losses, the AdamW moments' largest difference over their magnitude)."""
    from repro_torch.launch.steps import build_steps, gather_state, place_state
    from repro_torch.tree import tree_leaves

    cfg = _cfg("qwen2")
    one = build_steps(cfg, device="cpu", microbatches=2)
    sh = build_steps(cfg, device="cpu", mesh=mesh, microbatches=2)
    params = _fan_in_d(one.model.init(torch.Generator().manual_seed(0), device="cpu"))
    opt = one.optimizer.init(params)
    batch = _batch(cfg)
    _, o1, m1 = one.train_step(params, opt, batch)
    _, o2, m2 = sh.train_step(*place_state(sh, params, opt), batch)
    o2 = gather_state(o2)
    moments = max(_rel(a, b) for a, b in zip(tree_leaves(o1), tree_leaves(o2)))
    return (float(m1["loss"]), float(m2["loss"])), moments


def _groups():
    """(mesh name, families) of each group of ranks: one per mesh (the 3-D
    mesh's split over two groups ran slower: more ranks share the
    cores)."""
    return [(name, [f for f in FAMILIES if _runs(f, shape)])
            for name, shape in MESHES.items()]


def _trainer(mesh):
    from repro_torch.train import Trainer, TrainerConfig

    cfg = _cfg("qwen2")
    tc = TrainerConfig(batch=4, seq=8, steps=3, warmup=1, n_producers=1)
    one = Trainer(cfg, tc, device="cpu").run()["losses"]
    sharded = Trainer(cfg, tc, device="cpu", mesh=mesh).run()["losses"]
    return one, sharded


_REFERENCE = textwrap.dedent(
    """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np
    from jax.sharding import AxisType
    from repro import configs
    from repro.launch.steps import build_steps

    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    put = lambda tree, sh: jax.tree_util.tree_map(jax.device_put, tree, sh)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    out = {}
    with open(sys.argv[1], "rb") as f:
        inputs = pickle.load(f)
    for family, (arch, rep, params, batch, tok, max_seq) in inputs.items():
        cfg = configs.get_tiny(arch).replace(attention_impl="xla", **rep)
        b = build_steps(cfg, mesh)
        with mesh:
            ps = put(params, b.param_shardings)
            xs = put(batch, b.batch_sharding(batch))
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, x: b.model.loss(p, x, b.rules)[0]))(ps, xs)
            prompt = {k: v for k, v in xs.items() if k != "labels"}
            cache, logits = jax.jit(
                lambda p, x: b.prefill_step(p, x, max_seq=max_seq))(ps, prompt)
            prefill = (host(cache), np.asarray(logits))
            cache, logits = jax.jit(b.serve_step)(
                put(params, b.serve_param_shardings), cache,
                put(tok, b.batch_sharding(tok)))
        out[family] = dict(
            loss=float(loss), grads=host(jax.tree_util.tree_leaves(grads)),
            prefill=prefill, decode=(host(cache), np.asarray(logits)))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    """
)


def _np(t):
    """A tensor as numpy, int64 token ids as the reference's int32."""
    a = t.numpy()
    return a.astype(np.int32) if a.dtype == np.int64 else a


def _reference(tmp: Path):
    """Start the reference's sharded steps on every family's inputs in a
    subprocess; returns (the process, its output file), or None where
    the JAX package's dependencies are not installed."""
    if importlib.util.find_spec("jax") is None:
        return None
    from repro_torch.tree import tree_map

    inputs = {}
    for family, (arch, rep) in FAMILIES.items():
        _, params, batch, tok = _inputs(family)
        inputs[family] = (arch, rep, tree_map(_np, params), tree_map(_np, batch), _np(tok), MAX_SEQ)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src_dir = str(Path(__file__).resolve().parent.parent / "src")
    env["PYTHONPATH"] = src_dir + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "inputs.pkl"), str(tmp / "out.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, tmp / "out.pkl"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every group of ranks, spawned side by side, and the reference
    beside them: (rank 0's results by mesh, the reference's by family,
    or None without JAX)."""
    out, errors = {name: {} for name in MESHES}, []
    ref = _reference(tmp_path_factory.mktemp("reference"))

    def run(name, families):
        shape = MESHES[name]
        try:
            out[name].update(run_ranks(
                _mesh_rank, math.prod(shape), shape, families, timeout=RANK_TIMEOUT
            )[0])
        except Exception as e:  # noqa: BLE001 -- re-raised below
            errors.append((name, e))

    threads = [threading.Thread(target=run, args=g) for g in _groups()]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
        if errors:
            raise errors[0][1]
        if ref is None:
            return out, None
        proc, path = ref
        stdout, stderr = proc.communicate(timeout=RANK_TIMEOUT)
        assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
        with open(path, "rb") as f:
            return out, pickle.load(f)
    finally:
        if ref is not None and ref[0].poll() is None:
            ref[0].kill()
            ref[0].communicate()


CASES = [(m, f) for m in MESHES for f in FAMILIES if _runs(f, MESHES[m])]


@pytest.mark.parametrize("mesh,family", CASES)
def test_sharded_train_step_equals_one_device(ranks, mesh, family):
    r = ranks[0][mesh][family]
    one, sharded = r["loss"]
    assert abs(sharded - one) <= 1e-6 * abs(one), r["loss"]
    one, sharded = r["step_loss"]
    assert abs(sharded - one) <= 1e-6 * abs(one), r["step_loss"]
    bad = {p: e for p, e in r["grads"].items() if e > 2e-5}
    assert not bad, bad
    bad = {p: e for p, e in r["params"].items() if e > 1.0}
    assert not bad, bad
    assert r["param_placed"] and r["opt_placed"]


@pytest.mark.parametrize("mesh,family", CASES)
def test_sharded_prefill_and_decode_equal_one_device(ranks, mesh, family):
    r = ranks[0][mesh][family]
    assert r["cache_placed"] and r["decode_placed"]
    assert r["prefill_logits"] <= 1e-5 and r["decode_logits"] <= 1e-5, r
    for k in ("prefill_cache", "decode_cache"):
        bad = {c: e for c, e in r[k].items() if e > 1e-5}
        assert not bad, (k, bad)


def _close(got, want, scale: bool, what):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    atol = FP32["atol"] * (max(1.0, float(np.abs(want).max())) if scale else 1.0)
    np.testing.assert_allclose(got, want, rtol=FP32["rtol"], atol=atol, err_msg=what)


@pytest.mark.parametrize("mesh,family", CASES)
def test_sharded_steps_equal_reference(ranks, mesh, family):
    """The port's sharded loss, gradients, prefill and decode step against
    the reference's sharded ones on the same inputs."""
    if ranks[1] is None:
        pytest.skip("the JAX package's dependencies are not installed")
    got, want = ranks[0][mesh][family]["sharded"], ranks[1][family]
    np.testing.assert_allclose(got["loss"], want["loss"], **FP32)
    assert len(got["grads"]) == len(want["grads"])
    bad = {}
    for (path, g), w in zip(got["grads"], want["grads"]):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        fin = np.isfinite(w)
        assert np.isfinite(g[fin]).all(), path
        err = float(np.abs(g - w)[fin].max(initial=0.0))
        mag = max(float(np.abs(w[fin]).max(initial=0.0)), 1e-6)
        if err > REF_GRAD.get(family, 2e-5) * mag:
            bad[path] = err / mag
    assert not bad, bad
    for step in ("prefill", "decode"):
        (gc, gl), (wc, wl) = got[step], want[step]
        _close(gl, wl, False, f"{step} logits")
        assert sorted(gc) == sorted(wc), step
        for k in gc:
            if np.issubdtype(np.asarray(wc[k]).dtype, np.integer):
                np.testing.assert_array_equal(gc[k], wc[k], err_msg=f"{step} {k}")
            else:
                _close(gc[k], wc[k], True, f"{step} cache {k}")


def test_sequence_sharded_cache_gathered_for_the_kernel(ranks):
    """At (1, 2) the decode cache shards its sequence over ``model``: the
    plain route merges the shards' partial softmaxes without calling the
    decode op, and the kernel's route gathers the shards and gives the
    op every position, with the same logits."""
    lengths, diff = ranks[0]["1x2"]["gathered_decode"]
    assert lengths == [[], [MAX_SEQ]]
    assert diff <= 1e-6


def test_sharded_trainer_equals_one_device(ranks):
    one, sharded = ranks[0]["2x1"]["trainer"]
    assert len(one) == len(sharded) == 3
    np.testing.assert_allclose(sharded, one, rtol=1e-6)


def test_sharded_microbatches_equal_one_device(ranks):
    """Two microbatches at (2, 2): each rank splits its own batch shard,
    the gradients sum in fp32 as on one device."""
    (one, sharded), moments = ranks[0]["2x2"]["microbatches"]
    assert abs(sharded - one) <= 1e-6 * abs(one)
    assert moments <= 2e-5


def test_size_one_axis_replicates():
    """A part on a mesh axis of size 1 places as ``Replicate()``: DTensor
    refuses to reshape a dim it holds as sharded, even over one device
    (qwen2 tiny's ``wk`` [48, 1, 16], whose kv heads map to ``model``,
    viewed as [48, 16] on a ``(1, 1)`` mesh)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.sharding import make_rules

    cfg = _cfg("qwen2").replace(attn_tp=True)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        sh = make_rules(cfg, mesh).sharding(("embed", "kv_heads", None))
        assert sh.spec == ("data", "model")
        w = distribute_tensor(torch.randn(48, 1, 16), mesh, list(sh.placements))
        assert w.reshape(48, 16).shape == (48, 16)
        assert sh.placements == (Replicate(), Replicate())
    finally:
        dist.destroy_process_group()


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("arch", list(ONE_DEVICE_PINS))
def test_one_device_path_bit_for_bit(arch):
    """rules=None: loss, gradients, prefill and one decode step equal the
    pinned bits of the one-device models as they were before."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_leaves

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = configs.get_tiny(arch).replace(attention_impl="xla")
        m = build_model(cfg)
        p = m.init(torch.Generator().manual_seed(0), device="cpu")
        g = torch.Generator().manual_seed(1)
        b, s = 2, 8
        batch = {
            "tokens": torch.randint(0, cfg.vocab, (b, s), generator=g),
            "labels": torch.randint(0, cfg.vocab, (b, s), generator=g),
        }
        if cfg.cross_attn_every:
            batch["image_embeds"] = torch.randn(b, cfg.n_image_tokens, cfg.d_model, generator=g)
        if cfg.is_encdec:
            batch["audio_embeds"] = torch.randn(b, cfg.enc_len, cfg.d_model, generator=g)
        loss, _, grads = value_and_grad(m, p, batch)
        pb = {k: v for k, v in batch.items() if k != "labels"}
        cache, logits = m.prefill(p, pb, max_seq=12)
        pre = _digest([logits] + [cache[k] for k in sorted(cache)])
        tok = torch.randint(0, cfg.vocab, (b, 1), generator=g)
        cache, dl = m.decode_step(m.prepare(p), cache, tok)
        dec = _digest([dl] + [cache[k] for k in sorted(cache)])
        got = (float(loss).hex(), _digest(tree_leaves(grads)), pre, dec)
    finally:
        torch.set_num_threads(threads)
    assert got == ONE_DEVICE_PINS[arch]
