"""The port's logical sharding rules, meshes and sharded restore against
the reference's ``repro.sharding``.

* Rules: for all ten full configs at the (1, 1), 16x16 and 2x16x16
  meshes, the port's partition spec of every parameter and cache leaf
  equals the reference's ``PartitionSpec`` on ``jax.sharding.AbstractMesh``
  (no devices on either side), and so do the step bundle's train, serve
  and optimizer-state shardings.  The cases of
  ``tests/test_sharding_rules.py``, on the port.
* Meshes: 16x16 and 2x16x16 as ``DeviceMesh``es under torch's ``fake``
  backend in this one process.  Every parameter, cache and batch leaf's
  local shard shape (rank 0's, from ``distribute_tensor`` of a ``meta``
  tensor) equals the port's ``NamedSharding.shard_shape`` and, where every
  sharded dim divides its mesh axes, the reference's
  ``NamedSharding.shard_shape``.  Where one does not, DTensor splits as
  ``torch.chunk`` does and XLA would pad: those leaves are exactly the
  batch-1 caches of the long_500k cells (rwkv6-3b, zamba2-1.2b), listed
  in ``UNEVEN``.
* Checkpoint: ``tests/test_checkpoint.py::test_resharding_restore`` on
  the port: a 4-shard checkpoint restored with ``shardings=`` onto a
  one-rank (1, 1) mesh, every byte equal, from either package's writer.

Every process group a test starts is destroyed when it ends.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.launch.steps import build_steps as jbuild_steps  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro.sharding import batch_spec as jbatch_spec  # noqa: E402
from repro.sharding import make_rules as jmake_rules  # noqa: E402
from repro.sharding import tree_shardings as jtree_shardings  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.config import SHAPES, cell_is_applicable  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_local_mesh,
    make_production_mesh,
    production_mesh_shape,
)
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.launch.steps import build_steps  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    AbstractMesh,
    NamedSharding,
    activation_sharding,
    batch_spec,
    constrain,
    make_rules,
    resolve_axes,
    tree_shardings,
)
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
#: (arch, cell, leaf) whose local shard DTensor cuts unevenly: a batch of
#: one over the data axes (the long-context decode cells)
UNEVEN = {
    ("rwkv6-3b", "long_500k", leaf) for leaf in ("cm_last", "lengths", "tm_last", "wkv")
} | {
    ("zamba2-1.2b", "long_500k", leaf)
    for leaf in ("attn_k", "attn_v", "conv_g", "conv_x", "lengths", "ssm_g", "ssm_x")
}


def _jspecs(tree) -> list:
    """(path, spec as a tuple) of a tree of jax NamedShardings."""
    return [
        ("/".join(str(k) for k in p), tuple(s.spec))
        for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]
    ]


def _specs(tree) -> list:
    return [(p, s.spec) for p, s in tree_paths(tree)]


@pytest.fixture(scope="module")
def mesh11():
    return AbstractMesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_rules_equal_reference(arch, mesh):
    shape, names = MESHES[mesh]
    jm, tm = jbuild_model(jconfigs.get(arch)), build_model(configs.get(arch))
    jrules = jmake_rules(jconfigs.get(arch), JAbstractMesh(shape, names))
    rules = make_rules(configs.get(arch), AbstractMesh(shape, names))
    assert rules.table == jrules.table
    for which in ("param_specs", "cache"):
        if which == "param_specs":
            jspec, tspec = jm.param_specs(), tm.param_specs()
        else:
            jspec, tspec = jm.cache_specs(4, 64), tm.cache_specs(4, 64)
        want = _jspecs(jtree_shardings(jrules, jspec))
        got = _specs(tree_shardings(rules, tspec))
        assert got == want, (arch, mesh, which)
    assert batch_spec(rules) == tuple(jbatch_spec(jrules))


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_step_bundle_shardings_equal_reference(arch, mesh):
    """The train, serve and AdamW-state shardings of the step bundle; the
    serve rules replicate the weights over 'data' where they fit."""
    shape, names = MESHES[mesh]
    jb = jbuild_steps(jconfigs.get(arch), JAbstractMesh(shape, names))
    tb = build_steps(configs.get(arch), device="cpu", mesh=AbstractMesh(shape, names))
    assert tb.serve_rules.table == jb.serve_rules.table
    for field in ("param_shardings", "serve_param_shardings", "opt_shardings"):
        assert _specs(getattr(tb, field)) == _jspecs(getattr(jb, field)), field
    want = _jspecs(jb.cache_shardings(8, 128))
    assert _specs(tb.cache_shardings(8, 128)) == want


def test_attn_tp_auto(mesh11):
    # 48 heads on a 1-way model axis -> tp on (trivially divisible)
    rules = make_rules(configs.get("granite-34b"), mesh11)
    assert rules.pspec(("embed", "heads", None)) == ("data", "model")


def test_vocab_and_mlp_always_tp(mesh11):
    for arch in configs.ALL_ARCHS:
        rules = make_rules(configs.get(arch), mesh11)
        assert rules.pspec(("vocab", "embed")) == ("model", "data")
        assert resolve_axes(rules, ["mlp"]) == ("model",)


def test_no_double_axis_use():
    """A partition spec never uses one mesh axis on two dims."""
    for arch in configs.ALL_ARCHS:
        cfg = configs.get(arch)
        for shape, names in MESHES.values():
            rules = make_rules(cfg, AbstractMesh(shape, names))
            for leaf in tree_leaves(tree_shardings(rules, build_model(cfg).param_specs())):
                seen = []
                for part in leaf.spec:
                    for a in (part,) if isinstance(part, str) else (part or ()):
                        assert a not in seen, (arch, leaf.spec)
                        seen.append(a)


def test_cache_specs_have_shardings(mesh11):
    for arch in configs.ALL_ARCHS:
        cfg = configs.get(arch)
        sh = tree_shardings(make_rules(cfg, mesh11), build_model(cfg).cache_specs(4, 64))
        assert tree_leaves(sh)


def test_applicability_matrix():
    """40 cells: 32 applicable + 8 skips (long_500k on the quadratic archs)."""
    n_ok = n_skip = 0
    for arch in configs.ALL_ARCHS:
        cfg = configs.get(arch)
        for shape in SHAPES:
            ok, _ = cell_is_applicable(cfg, shape)
            if ok:
                n_ok += 1
            else:
                n_skip += 1
                assert shape.name == "long_500k" and not cfg.subquadratic
    assert n_ok == 32 and n_skip == 8


def test_placements_are_pod_major():
    from torch.distributed.tensor import Replicate, Shard

    rules = make_rules(configs.get("qwen2-1.5b"), production_mesh_shape(multi_pod=True))
    # 'embed' finds 'data' taken: an empty part, as the reference gives
    assert activation_sharding(rules, "batch", None, "embed").spec == (
        ("pod", "data"), None, ()
    )
    sh = activation_sharding(rules, "batch", "seq", None)
    assert sh.spec == (("pod", "data"),)
    assert sh.placements == (Shard(0), Shard(0), Replicate())
    # at every coordinate, even and uneven, the shard DTensor computes
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    for rows in (64, 33, 1):
        for coord in ((0, 0, 0), (0, 15, 3), (1, 0, 0), (1, 3, 7), (1, 15, 15)):
            want = _compute_local_shape_and_global_offset(
                (rows, 8, 4), (2, 16, 16), list(coord), sh.placements, skip_offset=True
            )[0]
            assert sh.shard_shape((rows, 8, 4), coordinate=coord) == want


def test_constrain_without_rules_is_identity():
    x = torch.randn(4, 8)
    assert constrain(None, x, "batch", "embed") is x


@contextlib.contextmanager
def _group():
    """Whatever process group the body starts is destroyed at its end."""
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_local_shard_shapes_under_fake_backend(multi_pod):
    from torch.distributed.tensor import distribute_tensor

    with _group():
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert dist.get_backend() == "fake"
        am = JAbstractMesh(tuple(mesh.shape), mesh.mesh_dim_names)
        uneven, n = set(), 0
        for arch in configs.ALL_ARCHS:
            cfg = configs.get(arch)
            bundle = build_steps(cfg, device="cpu", mesh=mesh)
            params, _ = bundle.abstract_state()
            trees = [("params", params, bundle.param_shardings)]
            for shape in SHAPES:
                if not cell_is_applicable(cfg, shape)[0]:
                    continue
                spec = input_specs(cfg, shape)
                if shape.kind == "decode":
                    sh = bundle.cache_shardings(shape.global_batch, shape.seq_len)
                    trees.append((shape.name, spec[0], sh))
                else:
                    trees.append((shape.name, spec, bundle.batch_sharding(spec)))
            for cell, tree, shardings in trees:
                for (path, a), (_, s) in zip(tree_paths(tree), tree_paths(shardings)):
                    assert a.device.type == "meta", path
                    local = distribute_tensor(a, mesh, list(s.placements)).to_local()
                    got = tuple(local.shape)
                    assert got == s.shard_shape(a.shape), (arch, cell, path)
                    n += 1
                    try:
                        want = JNamedSharding(am, P(*s.spec)).shard_shape(tuple(a.shape))
                    except ValueError:  # a sharded dim does not divide
                        uneven.add((arch, cell, path.strip("[]'")))
                        continue
                    assert got == tuple(want), (arch, cell, path)
        assert n == 275  # 191 parameter leaves + 84 cache and batch leaves
        assert uneven == UNEVEN


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(16, 8, generator=g),
        "b": torch.arange(8.0),
        "nested": {"scale": torch.tensor(3.5), "emb": torch.ones(12, 4)},
    }


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_resharding_restore(tmp_path, writer):
    """Saved with 4 shards, restored with ``shardings=`` onto this host's
    (1, 1) mesh as DTensors, every byte equal; the leaves split over both
    mesh axes where they have two dims."""
    st = _state()
    if writer == "port":
        save_checkpoint(tmp_path, 1, st, n_shards=4)
    else:
        jsave(tmp_path, 1, tree_map(lambda t: np.asarray(t), st), n_shards=4)
    with _group():
        mesh = make_local_mesh(device="cpu")
        sh = tree_map(
            lambda t: NamedSharding(mesh, ("data", "model")[: t.dim()]), st
        )
        got, extra = restore_checkpoint(tmp_path, st, shardings=sh)
        assert extra["step"] == 1
        placements = {p: s.placements for p, s in tree_paths(sh)}
        for (path, a), (_, b) in zip(tree_paths(st), tree_paths(got)):
            assert type(b).__name__ == "DTensor", path
            assert b.placements == placements[path]
            full = b.full_tensor()
            assert full.dtype == a.dtype and full.shape == a.shape, path
            assert full.numpy().tobytes() == a.numpy().tobytes(), path
