"""The port's checkpoints: mirrors of ``tests/test_checkpoint.py`` (atomic
commit, hashing, torn writes, async) and a checkpoint written by either
package restored in the other, with identical manifests.

The layout is the reference's: ``manifest.json`` naming every leaf by the
path jax's ``tree_flatten_with_path`` prints, ``.npz`` shards split on
the leading axis, a sha256 per shard."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.optim import AdamW, OptState  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(16, 8, generator=g),
        "b": torch.arange(8.0),
        "nested": {"scale": torch.tensor(3.5), "emb": torch.ones(12, 4)},
    }


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _train_state(name="qwen2-1.5b"):
    """A tiny model's (params, OptState) after one moment update, so that
    every leaf is non-trivial."""
    cfg = configs.get_tiny(name)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW()
    state = opt.init(params)
    grads = tree_map(lambda p: torch.full_like(p, 0.5), params)
    upd, state = opt.update(grads, state, params, torch.tensor(1e-3))
    return params, state


# ----------------------------------------------------------------------
# mirrors of tests/test_checkpoint.py
# ----------------------------------------------------------------------
def test_save_restore_roundtrip(tmp_path):
    st = _state()
    save_checkpoint(tmp_path, 5, st, n_shards=3, extra={"stream_position": 42})
    got, extra = restore_checkpoint(tmp_path, st)
    assert extra["step"] == 5 and extra["stream_position"] == 42
    _equal(st, got)
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(got))


def test_latest_step_and_multiple(tmp_path):
    st = _state()
    save_checkpoint(tmp_path, 1, st)
    save_checkpoint(tmp_path, 7, st)
    assert latest_step(tmp_path) == 7


def test_corruption_detected(tmp_path):
    st = _state()
    p = save_checkpoint(tmp_path, 3, st)
    shard = next(p.glob("shard_*.npz"))
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(IOError, match="corrupt"):
        restore_checkpoint(tmp_path, st)


def test_torn_write_invisible(tmp_path):
    st = _state()
    save_checkpoint(tmp_path, 2, st)
    # a crashed writer leaves a tmp dir behind; latest_step must ignore it
    (tmp_path / "step_00000009.tmp-123").mkdir()
    assert latest_step(tmp_path) == 2


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(tmp_path, n_shards=2)
    st = _state()
    ck.save(10, st, extra={"stream_position": 3})
    st["b"].add_(1.0)  # the snapshot is a copy: later writes do not leak in
    ck.wait()
    assert ck.last_committed == 10
    got, extra = restore_checkpoint(tmp_path, st)
    assert extra["stream_position"] == 3
    np.testing.assert_array_equal(got["b"].numpy(), np.arange(8.0))


# ----------------------------------------------------------------------
# the port's own edges
# ----------------------------------------------------------------------
def test_paths_print_as_jax_does():
    params, state = _train_state()
    paths = [p for p, _ in tree_paths((params, state))]
    want = [
        "/".join(str(k) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(
            (
                tree_map(lambda t: t.numpy(), params),
                tuple(tree_map(lambda t: t.numpy(), x) for x in state),
            )
        )[0]
    ]
    # the NamedTuple's fields print as .m/.v/.step, the tuple above as [i]
    want = [w.replace("[1]/[0]", "[1]/.m").replace("[1]/[1]", "[1]/.v") for w in want]
    want = [w.replace("[1]/[2]", "[1]/.step") for w in want]
    assert paths == want
    assert paths[0] == "[0]/['embed']/['out']" and paths[-1] == "[1]/.step"


def test_restore_refuses_another_tree(tmp_path):
    save_checkpoint(tmp_path, 1, _state())
    other = dict(_state(), extra=torch.zeros(2))
    with pytest.raises(ValueError, match="holds leaves"):
        restore_checkpoint(tmp_path, other)


def test_bf16_leaf_raises(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        save_checkpoint(tmp_path, 1, {"w": torch.ones(2, dtype=torch.bfloat16)})


# ----------------------------------------------------------------------
# across the two packages
# ----------------------------------------------------------------------
def _jax_like(params, state: OptState):
    """The reference's (params, OptState) of the same shapes and dtypes."""
    jp = tree_map(lambda t: jax.numpy.zeros(t.shape, t.numpy().dtype), params)
    return jp, JAdamW().init(jp)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-1.2b"])
def test_port_checkpoint_restores_in_reference(tmp_path, name):
    params, state = _train_state(name)
    extra = {"stream_position": 9}
    save_checkpoint(tmp_path / "port", 4, (params, state), extra=extra)
    (jp, js), extra = jrestore(tmp_path / "port", _jax_like(params, state))
    assert extra == {"stream_position": 9, "step": 4}
    _equal((params, state), (jp, js))
    assert np.asarray(js.step).dtype == np.int32 and int(js.step) == 1
    # the reference writes the same manifest for the same state
    jsave(tmp_path / "ref", 4, (jp, js), extra={"stream_position": 9})

    def leaves(sub):
        path = tmp_path / sub / "step_00000004" / "manifest.json"
        return json.loads(path.read_text())["leaves"]

    assert leaves("port") == leaves("ref")


@pytest.mark.parametrize("name", ["qwen2-1.5b", "rwkv6-3b"])
def test_reference_checkpoint_restores_in_port(tmp_path, name):
    params, state = _train_state(name)
    jp, js = _jax_like(params, state)
    jp = tree_map(lambda t: jax.numpy.asarray(t.numpy() + 1.0), params)
    js = js._replace(
        m=tree_map(lambda t: jax.numpy.asarray(t.numpy() * 2.0), state.m),
        step=jax.numpy.int32(3),
    )
    jsave(tmp_path, 6, (jp, js), n_shards=3, extra={"stream_position": 11})
    (tp, ts), extra = restore_checkpoint(tmp_path, (params, state))
    assert extra == {"stream_position": 11, "step": 6}
    assert isinstance(ts, OptState) and ts.step.dtype == torch.int32
    _equal((jp, js), (tp, ts))
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves((tp, ts)))
