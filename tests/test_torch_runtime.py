"""The port's runtime copies, its serve launcher and the ``"dots"`` remat
policy.

* ``runtime.{fault,elastic}`` (own copies of the reference's): the cases
  of ``tests/test_runtime.py`` -- the failure detector, ``SimCluster``'s
  kill and refit, the elastic plan.
* ``python -m repro_torch.launch.serve --device cpu`` answers every
  request under both ingestion policies.
* ``remat_policy="dots"`` (jax's ``checkpoint_dots_with_no_batch_dims``;
  the port keeps the outputs of ``aten.mm``/``aten.addmm`` and recomputes
  the rest): one tiny config per family, its gradients equal ``"full"``'s
  and ``"none"``'s bit for bit and ``jax.grad`` of the reference's loss
  under ``"dots"`` to the tolerance of ``tests/test_torch_grad.py``; the
  backward of ``"dots"`` runs no more un-batched matmuls than ``"none"``'s
  (the kept outputs are not recomputed), and ``"full"``'s runs more.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

pytest.importorskip("jax")
from test_torch_grad import FP32_GRAD, _grads  # noqa: E402
from test_torch_loss import _batch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    FailureDetector,
    HeartbeatTable,
    SimCluster,
    plan_elastic_mesh,
)
from repro_torch.tree import tree_leaves  # noqa: E402

#: one tiny config per family: dense, MoE, VLM, audio, RWKV6, hybrid
FAMILIES = [
    "qwen2-1.5b",
    "moonshot-v1-16b-a3b",
    "llama-3.2-vision-90b",
    "whisper-large-v3",
    "rwkv6-3b",
    "zamba2-1.2b",
]


def test_failure_detector_marks_dead():
    tab = HeartbeatTable()
    for h in range(4):
        tab.beat(h, t=100.0)
    det = FailureDetector(tab, timeout=1.0)
    tab.beat(0, t=102.0)
    tab.beat(1, t=102.0)
    tab.beat(2, t=102.0)
    dead = det.check(now=102.5)
    assert dead == {3}
    assert det.alive() == [0, 1, 2]


def test_sim_cluster_detects_kill_and_refits():
    work = []
    cluster = SimCluster(
        n_hosts=4,
        work_fn=lambda h, s: work.append((h, s)),
        heartbeat_every=0.01,
        detect_timeout=0.08,
    )
    seen = []

    def killer():
        time.sleep(0.15)
        cluster.kill(2)

    t = threading.Thread(target=killer, daemon=True)
    t.start()
    cluster.run(duration=0.6, on_refit=lambda survivors: seen.append(survivors))
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert seen and 2 not in seen[-1]
    assert len(seen[-1]) == 3


def test_elastic_plan_keeps_model_groups():
    plan = plan_elastic_mesh(list(range(13)), model_size=4)
    assert plan.model == 4
    assert plan.data == 3
    assert plan.n_used == 12
    assert len(plan.spares) == 1
    assert plan_elastic_mesh([0, 1], model_size=4) is None
    pods = plan_elastic_mesh(list(range(20)), model_size=4, pods=2)
    assert (pods.pod, pods.data, pods.n_used, len(pods.spares)) == (2, 2, 16, 4)


@pytest.mark.parametrize("policy", ["corec", "rss"])
def test_serve_launcher_answers_every_request(policy, capsys):
    res = serve.main(["--device", "cpu", "--policy", policy, "--requests", "6",
                      "--new-tokens", "3", "--slots", "4"])
    assert len(res) == 6 and sorted(r.rid for r in res) == list(range(6))
    # the prefill's token and then one a decode step (eos_token=-1)
    assert all(len(r.tokens) == 3 + 1 for r in res)
    out = capsys.readouterr().out
    assert f"policy={policy} device=cpu: 6/6 done" in out


def test_serve_launcher_refuses_tiny_heads_on_the_card():
    """The default device is the card, whose attention kernels take heads
    of 32, 64 or 128: the tiny config (heads of 16) is refused up front,
    on any host, with the way out named."""
    with pytest.raises(ValueError, match="--full"):
        serve.main([])


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _port_grads(name: str, policy: str):
    """(gradient leaves, un-batched matmuls in the backward) of the tiny
    config's loss under ``policy``, seed-0 parameters."""
    cfg = configs.get_tiny(name).replace(remat=True, remat_policy=policy)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.loss(params, batch)
    with _CountMatmuls() as count:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return grads, count.n


@pytest.mark.parametrize("name", FAMILIES)
def test_dots_equals_full_and_none(name):
    dots, n_dots = _port_grads(name, "dots")
    full, n_full = _port_grads(name, "full")
    none, n_none = _port_grads(name, "none")
    for a, b, c in zip(dots, full, none):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert n_dots == n_none < n_full, (n_dots, n_none, n_full)


@pytest.mark.parametrize("name", FAMILIES)
def test_dots_gradients_match_reference(name):
    ref, port = _grads(name, {"remat": True, "remat_policy": "dots"})
    nonfinite = 0
    for (path, a), b in zip(ref, port):
        fin = np.isfinite(a)
        nonfinite += int((~fin).sum())
        scale = float(np.abs(a[fin]).max(initial=0.0))
        err = float(np.abs(a - b)[fin].max(initial=0.0))
        assert err <= FP32_GRAD * max(scale, 1e-6), (path, err, scale)
    if name != "rwkv6-3b":  # the chunked WKV form can overflow (Queue C)
        assert nonfinite == 0
