"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``.

* Arguments, every applicable cell of both production meshes (shapes
  only, no step run): rank 0's local bytes of the parameters, the AdamW
  state and the batch (train), the parameters and the batch (prefill),
  the serve parameters, the caches and the tokens (decode) equal the sum
  over the same leaves of the shard the reference's ``PartitionSpec``s
  give rank 0: each sharded dim split by the product of its mesh axes,
  rounded up as XLA pads (DTensor's rank 0 holds the same whole chunk).
* The tiny qwen2 and moonshot cells (train, prefill and decode at
  B = 8, S = 64) on an 8-rank ``(4, 2)`` mesh: the port's ``run_cell``
  under the ``fake`` backend against the reference's own ``_lower_cell``
  compiled in a subprocess with 8 forced host devices on an Auto-axis
  mesh the test builds (the reference's ``make_mesh`` gives Explicit
  axes, which its sharding constraints fail on under jax 0.9; ROADMAP
  Queue C).  Every dim divides there, so the argument bytes equal XLA's,
  and the output bytes equal XLA's less its 8-byte pointer per output
  buffer (the output tuple's table).  FLOPs per device fall within
  ``FLOP_BAND`` of XLA's: the port counts the matmul-class ops
  (``torch.utils.flop_counter``'s formulas), XLA every HLO instruction
  (elementwise ops and reductions too), so the port's count is at most
  XLA's and well below it where the tiny widths leave the elementwise
  work a large share (qwen2's train cell: 0.31).  Collective bytes are
  printed beside XLA's, not held equal: DTensor's collectives are not
  GSPMD's.
* The ring factors: ``collective_cost`` equals ``parse_collective_bytes``
  on a synthetic HLO line of each kind.
* ``model_flops`` by the reference's formulas (6 N D train, 2 N D
  prefill, 2 N B decode; the reference's ``n_active_params``) for every
  cell, and ``useful_fraction`` = model FLOPs per chip over FLOPs.
* FSDP: in the tiny dense train cell with remat off, the all-gathers
  over ``data`` are exactly one gather, at use, of every weight with an
  ``embed`` dim, in the compute dtype, with its TP shards kept.
* The CLI writes one JSON file per cell under ``--out``.

Every process group a test starts is destroyed when it ends.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.dryrun import parse_collective_bytes  # noqa: E402
from repro.launch.specs import input_specs as jinput_specs  # noqa: E402
from repro.launch.steps import build_steps as jbuild_steps  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.config import SHAPES, ShapeConfig, cell_is_applicable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

#: the port's FLOPs per device over XLA's, in the tiny cells
FLOP_BAND = (0.25, 1.05)
TINY = ("qwen2-1.5b", "moonshot-v1-16b-a3b")
KINDS = ("train", "prefill", "decode")
SUBPROCESS_TIMEOUT = 300


@contextlib.contextmanager
def _group():
    """Whatever process group the body starts is destroyed at its end."""
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _fake_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _tiny_shape(kind):
    return ShapeConfig(f"{kind}_tiny", 64, 8, kind)


def _ref_bytes(leaf, spec, sizes) -> int:
    """Bytes of rank 0's shard of ``leaf`` under PartitionSpec ``spec``."""
    shape = list(leaf.shape)
    for d, part in enumerate(spec):
        axes = (part,) if isinstance(part, str) else tuple(part or ())
        k = math.prod(sizes[a] for a in axes)
        shape[d] = -(-shape[d] // k)
    return math.prod(shape) * leaf.dtype.itemsize


def _ref_argument_bytes(arch, shape, mesh_shape, names) -> int:
    """The reference's per-rank argument bytes of one cell, from its own
    specs and shardings (``dryrun.py:_lower_cell``'s in-shardings)."""
    cfg = jconfigs.get(arch)
    b = jbuild_steps(cfg, JAbstractMesh(mesh_shape, names))
    sizes = dict(zip(names, mesh_shape))
    if shape.global_batch < sizes["data"] * sizes.get("pod", 1):
        b.rules.table["batch"] = None
        b.serve_rules.table["batch"] = None
    params, opt = b.abstract_state()
    if shape.kind == "decode":
        cache, tokens = jinput_specs(cfg, shape)
        pairs = [
            (params, b.serve_param_shardings),
            (cache, b.cache_shardings(shape.global_batch, shape.seq_len)),
            (tokens, b.batch_sharding(tokens)),
        ]
    else:
        batch = jinput_specs(cfg, shape)
        pairs = [(params, b.param_shardings), (batch, b.batch_sharding(batch))]
        if shape.kind == "train":
            pairs.insert(1, (opt, b.opt_shardings))
    total = 0
    for tree, sh in pairs:
        leaves = jax.tree_util.tree_leaves(tree)
        shs = jax.tree_util.tree_leaves(sh, is_leaf=lambda x: hasattr(x, "spec"))
        assert len(leaves) == len(shs)
        total += sum(_ref_bytes(a, tuple(s.spec), sizes) for a, s in zip(leaves, shs))
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_argument_bytes_equal_reference_specs(multi_pod):
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    n = 0
    with _group():
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch in configs.ALL_ARCHS:
            for shape in SHAPES:
                cfg = configs.get(arch)
                if not cell_is_applicable(cfg, shape)[0]:
                    continue
                _, args, _ = dryrun.cell_args(cfg, shape, mesh)
                got = dryrun._local_bytes(args)
                want = _ref_argument_bytes(arch, shape, mesh_shape, names)
                assert got == want, (arch, shape.name)
                n += 1
    assert n == 32


_REFERENCE = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    from jax.sharding import AxisType
    from repro import configs
    from repro.config import ShapeConfig
    from repro.launch.dryrun import _lower_cell, parse_collective_bytes

    mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = configs.get_tiny(arch).replace(attention_impl="xla", use_scan=False)
        for kind in ("train", "prefill", "decode"):
            compiled, _ = _lower_cell(cfg, ShapeConfig(kind + "_tiny", 64, 8, kind), mesh)
            mem = compiled.memory_analysis()
            ca = compiled.cost_analysis() or {}
            ca = ca[0] if isinstance(ca, list) else ca
            out[arch + "/" + kind] = dict(
                argument=mem.argument_size_in_bytes,
                output=mem.output_size_in_bytes,
                flops=float(ca.get("flops", 0.0)),
                collective=parse_collective_bytes(compiled.as_text())["total"],
            )
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def tiny_cells():
    """(the reference's XLA figures, the port's run_cell results and
    output leaf counts) of the tiny cells."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src_dir = str(Path(__file__).resolve().parent.parent / "src")
    env["PYTHONPATH"] = src_dir + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, ",".join(TINY)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    port = {}
    try:
        with _group():
            mesh = _fake_mesh((4, 2), ("data", "model"))
            for arch in TINY:
                for kind in KINDS:
                    shape = _tiny_shape(kind)
                    cfg = configs.get_tiny(arch)
                    res = dryrun.run_cell(arch, shape.name, False, cfg=cfg, shape=shape,
                                          mesh=mesh, probe_costs=True, verbose=False)
                    fn, args, _ = dryrun.cell_args(cfg.replace(attention_impl="xla"),
                                                   shape, mesh)
                    with torch.no_grad():
                        n_out = len(tree_leaves(fn(*args)))
                    port[f"{arch}/{kind}"] = (res, n_out)
        stdout, stderr = proc.communicate(timeout=SUBPROCESS_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    return json.loads(stdout.strip().splitlines()[-1]), port


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", TINY)
def test_tiny_cell_against_reference(tiny_cells, arch, kind):
    ref, port = tiny_cells
    want = ref[f"{arch}/{kind}"]
    res, n_out = port[f"{arch}/{kind}"]
    mem = res["memory_analysis"]
    assert mem["argument_size_in_bytes"] == want["argument"]
    assert mem["output_size_in_bytes"] + 8 * n_out == want["output"]
    ratio = res["roofline"]["flops"] / want["flops"]
    print(f"{arch}/{kind}: flops port/XLA {ratio:.3f}; collective bytes "
          f"port {res['roofline']['collective_bytes']:.0f} XLA {want['collective']}")
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio
    r = res["roofline"]
    assert r["model_flops_per_chip"] == r["model_flops"] / res["n_chips"]
    assert r["useful_fraction"] == r["model_flops"] / res["n_chips"] / r["flops"]
    assert r["compute_s"] == r["flops"] / dryrun.PEAK_FLOPS
    assert r["memory_s"] == r["bytes"] / dryrun.HBM_BW
    assert r["collective_s"] == r["collective_bytes"] / dryrun.LINK_BW
    assert set(res["unit_costs"]) == {1, 2}


_HLO = {
    "all-gather": "%a = f32[8,16]{1,0} all-gather(f32[2,16]{1,0} %p), "
                  "replica_groups=[2,4]<=[8], dimensions={0}",
    "all-reduce": "%a = bf16[4,32]{1,0} all-reduce(bf16[4,32]{1,0} %p), "
                  "replica_groups=[4,2]<=[8], to_apply=%add",
    "reduce-scatter": "%a = f32[3,16]{1,0} reduce-scatter(f32[12,16]{1,0} %p), "
                      "replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%add",
    "all-to-all": "%a = s32[6,10]{1,0} all-to-all(s32[6,10]{1,0} %p), "
                  "replica_groups=[4,2]<=[8], dimensions={0}",
    "collective-permute": "%a = f32[5,7]{1,0} collective-permute(f32[5,7]{1,0} %p), "
                          "source_target_pairs={{0,1},{1,0}}",
}


@pytest.mark.parametrize("kind", list(_HLO))
def test_ring_factors_equal_reference(kind):
    want = parse_collective_bytes(_HLO[kind])[kind]
    out = {"all-gather": 8 * 16 * 4, "all-reduce": 4 * 32 * 2, "reduce-scatter": 3 * 16 * 4,
           "all-to-all": 6 * 10 * 4, "collective-permute": 5 * 7 * 4}[kind]
    group = 4 if kind == "reduce-scatter" else 1
    assert dryrun.collective_cost(kind, out, group) == want


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_model_flops_reference_formula(arch, shape):
    s = next(x for x in SHAPES if x.name == shape)
    n = jconfigs.get(arch).n_active_params()
    want = {"train": 6 * n * s.global_batch * s.seq_len,
            "prefill": 2 * n * s.global_batch * s.seq_len,
            "decode": 2 * n * s.global_batch}[s.kind]
    assert dryrun.model_flops(configs.get(arch), s) == want


def test_fsdp_gathers_over_data_equal_specs():
    """Each weight with an ``embed`` dim is gathered over ``data`` once, at
    use, in the compute dtype (fp32 here), its other dims as the rules
    shard them: the reference's ``use_weight``.  Nothing else is gathered
    over ``data``."""
    from repro_torch.models.api import build_model
    from repro_torch.sharding import make_rules

    cfg = configs.get_tiny("qwen2-1.5b").replace(remat=False)
    with _group():
        mesh = _fake_mesh((4, 2), ("data", "model"))
        res = dryrun.run_cell("qwen2-1.5b", "train_tiny", False, cfg=cfg,
                              shape=_tiny_shape("train"), mesh=mesh,
                              probe_costs=True, verbose=False)
        rules = make_rules(cfg, mesh)
        want = 0
        for spec in tree_leaves(build_model(cfg).param_specs()):
            if "embed" not in spec.axes:
                continue
            axes = tuple(None if a == "embed" else a for a in spec.axes)
            want += 4 * math.prod(rules.sharding(axes).shard_shape(spec.shape))
    assert res["collective_detail"]["by_mesh_dim"]["all-gather@data"] == want


def test_cli_writes_one_file_per_cell(tmp_path):
    argv = ["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--mesh", "single",
            "--no-probe", "--out", str(tmp_path)]
    assert not dist.is_initialized()
    dryrun.main(argv)
    assert not dist.is_initialized()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["qwen2-1.5b__decode_32k__16-16.json"]
    res = json.loads((tmp_path / files[0]).read_text())
    assert set(res["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "alias_size_in_bytes", "generated_code_size_in_bytes",
    }
    assert res["hardware"]["peak_flops"] == 989e12
