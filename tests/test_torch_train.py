"""The port's train step, trainer and launcher on the CPU.

* ``build_steps(...).train_step`` against the reference's composition
  (``repro/launch/steps.py:94-130``: ``value_and_grad`` of the
  reference's ``loss``, fp32 microbatch accumulation, the schedule's lr
  at the step count before the update, ``AdamW.update`` and
  ``apply_updates``), written out here under ``jax.jit``: the reference's
  own ``build_steps(cfg, mesh)`` puts a sharding constraint on an
  Explicit-axes mesh that jax 0.9 refuses (ROADMAP Queue C).  Three
  steps from carried params, microbatches 1 and 2, for a dense, an MoE,
  the RWKV6 and the Zamba2 tiny arch: losses within ``2e-5`` relative,
  parameters within ``2e-2`` of the summed learning rate, moments within
  ``1e-4`` of each leaf's magnitude (RWKV6 ``1e-3``: ``MOMENT_TOL``).
  Adam's first steps divide a gradient by its own size, so an element
  whose gradient is near zero (qwen2's key bias, which the softmax
  cancels but for RoPE) turns a rounding difference into a step
  difference of a fraction of lr; the next steps' gradients, at
  parameters that far apart, then differ by more than the one-step
  ``2e-5`` of ``test_torch_grad.py``.
* The train-step half of ``tests/test_arch_smoke.py:50`` for all ten.
* The ``Trainer``'s crash at step 6 and restart from the step-4
  checkpoint and stream position: 4 losses, equal to its own
  uninterrupted run and to the reference composition's trajectory on the
  reference's ``SyntheticLMSource`` batches from the same parameters.
* The straggler detector and the claim-expiry reissuer
  (``tests/test_runtime.py:65,74``).
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs  # noqa: E402
from repro.config import ArchConfig as JArchConfig  # noqa: E402
from repro.data import SyntheticLMSource as JSource  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import apply_updates as japply  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from test_torch_loss import _batch, _fan_in_d, _np_tree  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.config import ArchConfig  # noqa: E402
from repro_torch.core.ring import CorecRing  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import build_steps  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.runtime import ClaimExpiryReissuer, StragglerDetector  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

LR, WARMUP, STEPS = 1e-3, 1, 3
#: RWKV6's chunked WKV form (``exp(-la)``, ROADMAP Queue C) carries the
#: steps' parameter differences into its gradients at ~1e-4 of a leaf's
#: magnitude, moving with the CPU's thread count (4e-6 to 1.1e-4
#: measured); the other families stay under 4e-6
MOMENT_TOL = {"rwkv6-3b": 1e-3}


def reference_step(jcfg, lr_fn, optimizer, microbatches: int):
    """The reference's ``train_step`` composition under ``jax.jit``."""
    model = jbuild_model(jcfg)

    def step(params, opt_state, batch):
        def loss_fn(p, b):
            return model.loss(p, b)

        if microbatches > 1:

            def micro(carry, mb):
                gsum, msum = carry
                (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    params, mb
                )
                gsum = jax.tree_util.tree_map(
                    lambda a, g: a + g.astype(jnp.float32), gsum, grads
                )
                return (gsum, msum + loss), None

            mb_batch = jax.tree_util.tree_map(
                lambda x: x.reshape(
                    (microbatches, x.shape[0] // microbatches) + x.shape[1:]
                ),
                batch,
            )
            zeros = jax.tree_util.tree_map(
                lambda p: jnp.zeros(p.shape, jnp.float32), params
            )
            (grads, loss_sum), _ = jax.lax.scan(micro, (zeros, 0.0), mb_batch)
            grads = jax.tree_util.tree_map(lambda g: g / microbatches, grads)
            loss = loss_sum / microbatches
        else:
            (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, batch
            )
        lr = lr_fn(opt_state.step)
        updates, new_opt = optimizer.update(grads, opt_state, params, lr)
        return japply(params, updates), new_opt, loss, lr

    return jax.jit(step)


def _close_leaves(want, got, atol_of):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want), got):
        a, b = np.asarray(a), b.numpy()
        err = float(np.abs(a - b).max())
        assert err <= atol_of(a), (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize(
    "name", ["qwen2-1.5b", "grok-1-314b", "rwkv6-3b", "zamba2-1.2b"]
)
def test_train_step_matches_reference_composition(name, microbatches):
    jcfg, tcfg = jconfigs.get_tiny(name), configs.get_tiny(name)
    params = _fan_in_d(_np_tree(jbuild_model(jcfg).init(jax.random.PRNGKey(1))))
    batches = [_batch(tcfg, 10 + i, "none", B=4) for i in range(STEPS)]
    jstep = reference_step(
        jcfg, jcosine(LR, WARMUP, STEPS), JAdamW(), microbatches
    )
    jp, jo = params, JAdamW().init(params)
    bundle = build_steps(
        tcfg,
        lr_fn=cosine_schedule(LR, WARMUP, STEPS),
        microbatches=microbatches,
        device="cpu",
    )
    tp = params_from_reference(tcfg, params, device="cpu")
    to = bundle.optimizer.init(tp)
    lr_sum = 0.0
    for b in batches:
        jp, jo, jloss, jlr = jstep(jp, jo, b)
        tp, to, metrics = bundle.train_step(tp, to, b)
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=2e-5)
        assert float(metrics["lr"]) == float(jlr)
        if microbatches > 1:
            assert set(metrics) == {"ce", "loss", "lr"}
        lr_sum += float(jlr)
    assert int(to.step) == int(jo.step) == STEPS
    _close_leaves(jp, tree_leaves(tp), lambda a: 2e-2 * lr_sum + 2e-5 * abs(a).max())
    tol = MOMENT_TOL.get(name, 1e-4)
    _close_leaves(jo.m, tree_leaves(to.m), lambda a: tol * abs(a).max())
    _close_leaves(jo.v, tree_leaves(to.v), lambda a: tol * abs(a).max())


def test_step_bundle_serving_steps_and_sharding_fields():
    cfg = configs.get_tiny("qwen2-1.5b")
    bundle = build_steps(cfg, device="cpu")
    assert bundle.rules is None and bundle.param_shardings is None
    params = bundle.model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg, 0, "none")
    cache, logits = bundle.prefill_step(params, {"tokens": batch["tokens"]}, 12)
    assert logits.is_inference() and logits.shape == (2, cfg.vocab_padded())
    cache, logits = bundle.serve_step(params, cache, torch.ones(2, 1, dtype=torch.long))
    assert logits.is_inference()
    # the default lr is a constant 3e-4
    opt = bundle.optimizer.init(params)
    _, _, metrics = bundle.train_step(params, opt, batch)
    assert float(metrics["lr"]) == pytest.approx(3e-4)


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_arch_train_step(arch):
    """The train-step half of ``tests/test_arch_smoke.py:50``: one step,
    the loss finite, some parameter moved."""
    cfg = configs.get_tiny(arch)
    bundle = build_steps(
        cfg,
        lr_fn=lambda step: torch.tensor(1e-3),
        optimizer=AdamW(weight_decay=0.0),
        device="cpu",
    )
    params = bundle.model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = bundle.optimizer.init(params)
    batch = _batch(cfg, 0, "none", S=12)
    p2, opt, metrics = bundle.train_step(params, opt, batch)
    assert torch.isfinite(metrics["loss"]), arch
    assert any(
        not torch.allclose(a, b) for a, b in zip(tree_leaves(params), tree_leaves(p2))
    ), f"{arch}: no parameter moved"


# ----------------------------------------------------------------------
# the trainer
# ----------------------------------------------------------------------
TRAINER_ARCH = dict(
    family="dense",
    n_layers=2,
    d_model=32,
    n_heads=2,
    n_kv_heads=1,
    d_ff=64,
    vocab=128,
    attention_impl="xla",
    dtype="float32",
    remat=False,
)
TRAINER_RUN = dict(
    batch=4,
    seq=16,
    steps=8,
    checkpoint_every=4,
    lr=1e-3,
    warmup=2,
    ring_size=16,
    n_producers=1,
)


@pytest.fixture(scope="module")
def uninterrupted():
    cfg = ArchConfig("t", **TRAINER_ARCH)
    trainer = Trainer(cfg, TrainerConfig(**TRAINER_RUN), device="cpu")
    return trainer, trainer.run()


def test_trainer_crash_restart_resumes(tmp_path, uninterrupted):
    """Crash at step 6 (a checkpoint exists at 4), restart: the second run
    resumes at step 4 from the checkpoint and the stream position and
    takes 4 more steps, their losses those of the uninterrupted run."""
    _, ref = uninterrupted
    cfg = ArchConfig("t", **TRAINER_ARCH)
    ckdir = str(tmp_path / "ck")
    t1 = Trainer(cfg, TrainerConfig(checkpoint_dir=ckdir, **TRAINER_RUN), device="cpu")
    with pytest.raises(RuntimeError, match="injected crash at step 6"):
        t1.run(crash_at=6)
    t2 = Trainer(cfg, TrainerConfig(checkpoint_dir=ckdir, **TRAINER_RUN), device="cpu")
    out = t2.run()
    assert len(out["losses"]) == 4
    assert [m["step"] for m in out["metrics_log"]] == [4, 5, 6, 7]
    np.testing.assert_array_equal(out["losses"], ref["losses"][4:])
    for a, b in zip(tree_leaves(out["params"]), tree_leaves(ref["params"])):
        assert torch.equal(a, b)
    assert t2.ckpt.last_committed == 8


def test_trainer_matches_reference_trajectory(uninterrupted):
    """The uninterrupted run's 8 losses against the reference composition
    on the reference's own batches, from the trainer's parameters."""
    trainer, out = uninterrupted
    params, _ = trainer.init_state()
    jparams = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    jcfg = JArchConfig("t", **TRAINER_ARCH)
    tc = TrainerConfig(**TRAINER_RUN)
    step = reference_step(jcfg, jcosine(tc.lr, tc.warmup, tc.steps), JAdamW(), 1)
    source = JSource(jcfg.vocab, tc.batch, tc.seq, tc.seed)
    jp, jo, want = jparams, JAdamW().init(jparams), []
    for i in range(tc.steps):
        raw = source.batch_at(i)
        batch = {"tokens": raw["tokens"], "labels": raw["labels"]}
        jp, jo, loss, _ = step(jp, jo, batch)
        want.append(float(loss))
    np.testing.assert_allclose(out["losses"], want, rtol=2e-5)
    assert len(set(out["losses"])) == len(want)  # the loss moves each step


def test_trainer_init_is_device_independent_seed_zero():
    """``init_state`` draws on the CPU from seed 0 and moves the tree: the
    same numbers whichever device trains."""
    cfg = ArchConfig("t", **TRAINER_ARCH)
    trainer = Trainer(cfg, TrainerConfig(**TRAINER_RUN), device="cpu")
    p, opt = trainer.init_state()
    want = trainer.bundle.model.init(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(tree_leaves(p), tree_leaves(want)):
        assert torch.equal(a, b)
    assert int(opt.step) == 0 and opt.step.dtype == torch.int32


def test_trainer_runs_the_config_it_is_given():
    """The trainer never rewrites ``attention_impl``: a config that
    insists on the kernels raises the grad guard's error at the first
    step (on the card ``"auto"`` does the same)."""
    cfg = ArchConfig("t", **dict(TRAINER_ARCH, attention_impl="pallas"))
    trainer = Trainer(cfg, TrainerConfig(**dict(TRAINER_RUN, steps=1)), device="cpu")
    with pytest.raises(RuntimeError, match="has no backward"):
        trainer.run()


@pytest.mark.parametrize(
    "arch,schedule", [("qwen2-1.5b", "cosine"), ("minicpm-2b", "wsd")]
)
def test_launcher_trains_tiny_config(arch, schedule, capsys, monkeypatch):
    """``python -m repro_torch.launch.train``: the plain routes named in the
    config, minicpm on WSD as in the reference's launcher."""
    made = []

    class Recording(Trainer):
        def __init__(self, cfg, tcfg, device=None):
            made.append((cfg, tcfg, device))
            super().__init__(cfg, tcfg, device=device)

    monkeypatch.setattr(train_cli, "Trainer", Recording)
    out = train_cli.main(
        ["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "8"]
        + ["--microbatches", "2", "--device", "cpu"]
    )
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert f"{configs.get_tiny(arch).name}: 3 steps" in capsys.readouterr().out
    (cfg, tcfg, device), = made
    assert cfg.attention_impl == "xla" and device == "cpu"
    assert tcfg.schedule == schedule and tcfg.microbatches == 2


# ----------------------------------------------------------------------
# mirrors of tests/test_runtime.py:65,74
# ----------------------------------------------------------------------
def test_straggler_detector_flags_outlier():
    det = StragglerDetector(mad_k=4.0)
    flagged = []
    for i in range(50):
        flagged.append(det.observe(0, 1.0 + 0.01 * (i % 3)))
    assert not any(flagged[10:])
    assert det.observe(1, 10.0) is True
    assert det.slowest() == 1


def test_claim_expiry_reissue_at_least_once():
    ring = CorecRing(64)
    for i in range(8):
        ring.produce(i)
    reissuer = ClaimExpiryReissuer(lambda item: ring.produce(item), timeout=0.05)
    # worker A claims 0..3 and stalls forever
    c = ring.claim(max_batch=4)
    reissuer.track(c, c.payloads)
    time.sleep(0.08)
    assert reissuer.sweep() == 4  # re-enqueued
    got = []
    while True:
        c2 = ring.claim(max_batch=8)
        if c2 is None:
            break
        ring.complete(c2)
        ring.try_release()
        for x in c2.payloads:
            if reissuer.first_time(x):
                got.append(x)
    assert sorted(got) == list(range(8))  # nothing lost, dedup holds
