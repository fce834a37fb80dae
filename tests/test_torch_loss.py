"""Every family's training loss, forward only, vs the JAX package's.

The reference's ``build_model(cfg).init(PRNGKey(s))`` parameters cross
over through ``params_from_reference``; the same numpy-seeded batch
(tokens, labels, a ``loss_mask`` with zeros, and the VLM's image or
Whisper's audio embeddings) goes through the reference's ``loss`` under
``jax.jit`` and the port's, for the tiny variant of each of the ten
configurations.  The total and every metric (the decoder's ``ce``,
``aux`` and ``zloss``; the other families' ``ce``) agree at fp32
``rtol=atol=2e-5``, bf16 at ``2e-2`` (``tests/test_kernels.py``'s).

Every attention's ``wq``/``wk``/``wv`` are drawn at fan-in d here (the
reference's weights scaled by sqrt(H / d)), as ``test_torch_whisper.py``
and ``test_torch_zamba.py`` do: the reference initialiser takes the
fan-in from the head count, which makes attention all but a hard max and
amplifies XLA's compiled rounding past the fp32 tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro.models.layers import label_logprobs as jlabel_logprobs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.api import build_model, frontend_inputs  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import label_logprobs  # noqa: E402

FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
#: the ten tiny configurations, then the MoE at the reference's default
#: capacity factor (the aux loss with drops) and two bf16 decoders
CASES = {name: (name, {}) for name in configs.ALL_ARCHS}
CASES["moonshot-cf1.25"] = ("moonshot-v1-16b-a3b", {"capacity_factor": 1.25})
CASES["qwen2-bf16"] = ("qwen2-1.5b", {"dtype": "bfloat16"})
CASES["grok-bf16"] = ("grok-1-314b", {"dtype": "bfloat16"})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fan_in_d(tree):
    """Every attention's (a node with ``wq`` and ``wo``) wq/wk/wv, whose
    last three axes are [d, H, dh], scaled from fan-in H to fan-in d."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _fan_in_d(v) for k, v in tree.items()}
    if "wq" in tree and "wo" in tree:
        for key in ("wq", "wk", "wv"):
            d, h = tree[key].shape[-3:-1]
            out[key] = (tree[key] * np.sqrt(h / d)).astype(np.float32)
    return out


def _batch(cfg, seed: int, mask: str = "some", B: int = 2, S: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
    }
    if mask == "some":
        batch["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
        batch["loss_mask"][0, :3] = 0.0
    elif mask == "zeros":
        batch["loss_mask"] = np.zeros((B, S), np.float32)
    for key, shape in frontend_inputs(cfg).items():
        batch[key] = rng.standard_normal((B, *shape)).astype(np.float32)
    return batch


def _reference_loss(jcfg, params, batch):
    model = jbuild_model(jcfg)
    total, metrics = jax.jit(model.loss)(params, batch)
    return float(total), {k: float(v) for k, v in metrics.items()}


def _port_loss(tcfg, params, batch):
    model = build_model(tcfg)
    tparams = params_from_reference(tcfg, params, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics = model.loss(tparams, tbatch)
    assert total.dtype == torch.float32 and total.dim() == 0
    return float(total), {k: float(v) for k, v in metrics.items()}


def _both(case: str, seed: int, mask: str = "some"):
    name, over = CASES[case]
    jcfg = jconfigs.get_tiny(name).replace(**over)
    tcfg = configs.get_tiny(name).replace(**over)
    params = _fan_in_d(_np_tree(jbuild_model(jcfg).init(jax.random.PRNGKey(seed))))
    batch = _batch(tcfg, seed + 1, mask)
    return tcfg, _reference_loss(jcfg, params, batch), _port_loss(tcfg, params, batch)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_reference(case):
    cfg, (jtotal, jm), (ttotal, tm) = _both(case, seed=1)
    tol = BF16 if cfg.dtype == "bfloat16" else FP32
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(ttotal, jtotal, **tol)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **tol)
    if cfg.is_moe:
        assert tm["aux"] > 0
    assert np.isfinite(ttotal) and ttotal > 0


@pytest.mark.parametrize("mask", ["none", "zeros"])
def test_decoder_loss_mask_default_and_empty_match_reference(mask):
    """No ``loss_mask`` weighs every position; an all-zero one gives 0
    cross-entropy and z-loss (the denominator held at 1)."""
    _, (jtotal, jm), (ttotal, tm) = _both("qwen2-1.5b", seed=3, mask=mask)
    np.testing.assert_allclose(ttotal, jtotal, **FP32)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **FP32)
    if mask == "zeros":
        assert tm["ce"] == tm["zloss"] == 0.0


@pytest.mark.parametrize("real_vocab", [50, 64])
def test_label_logprobs_match_reference(real_vocab):
    """Over a vocabulary padded from ``real_vocab`` to 64: the padded
    tail is out of the logsumexp, and a label's logit is read by the
    where-reduction, after the mask (a label in the tail reads -1e30)."""
    rng = np.random.default_rng(real_vocab)
    logits = (3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    labels = rng.integers(0, 64, (2, 5)).astype(np.int32)
    labels[0, 0] = 63
    jlse, jll = jax.jit(jlabel_logprobs, static_argnums=2)(logits, labels, real_vocab)
    tlogits, tlabels = torch.from_numpy(logits), torch.from_numpy(labels)
    lse, ll = label_logprobs(tlogits, tlabels, real_vocab)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FP32)
    np.testing.assert_array_equal(ll.numpy(), np.asarray(jll))
    if real_vocab < 64:
        assert float(ll[0, 0]) == np.float32(-1e30)
        full = torch.logsumexp(torch.from_numpy(logits), -1)
        assert not torch.allclose(lse, full)
