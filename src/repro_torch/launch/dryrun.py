"""Multi-pod dry-run on ``meta`` DTensors under the ``fake`` backend: the
port of ``repro.launch.dryrun``.

For each (arch x shape x mesh) cell the dry-run:

1. builds the production mesh (16x16 single-pod, 2x16x16 two-pod) as a
   ``DeviceMesh`` over a process group of torch's ``fake`` backend in
   this one process (``launch/mesh.py``), which is rank 0;
2. makes the step's state -- parameters, AdamW state, batch, caches --
   as DTensors on the bundle's shardings, each made with
   ``DTensor.from_local`` from rank 0's local shard on the ``meta``
   device: the shapes, dtypes and placements a rank holds, nothing
   allocated (long_500k's batch of one is replicated first, as the
   reference's ``dryrun.py:135-139`` does);
3. runs the right step in full, on the plain routes (no kernel runs on
   ``meta``): ``train_4k`` the sharded train step with its backward and
   AdamW, ``prefill_32k`` the prefill, ``decode_32k``/``long_500k`` one
   decode step;
4. writes the reference's ``memory_analysis`` and ``roofline`` keys, per
   device (rank 0), from what the step dispatched.

Under a ``TorchDispatchMode`` that lets DTensor dispatch first and sees
the local ops it then runs on each rank's shards:

* ``argument_size_in_bytes`` / ``output_size_in_bytes``: the exact sums
  of rank 0's local shard bytes of the step's inputs and outputs;
  ``alias_size_in_bytes``: the outputs written in place into an input
  (the decode step's caches); ``temp_size_in_bytes``: the peak, over the
  step, of the local bytes alive that the step allocated, less the
  outputs' own (unaliased) bytes, so that argument + output - alias +
  temp is the step's predicted peak (the tracker counts each new
  storage an op returns, and drops it when its last tensor dies, as
  autograd's saved tensors and the caches keep them);
  ``generated_code_size_in_bytes`` null (nothing is compiled);
* ``flops``: ``torch.utils.flop_counter``'s formulas on the local
  shapes (around the DTensor ops it would count the global op);
* ``bytes``: every local op's input and output bytes, views excepted:
  eager PyTorch fuses nothing, so this is what it moves through HBM;
* ``collective_bytes``: the functional collectives the step dispatches
  (DTensor's redistributions, and the merges the models run
  themselves), charged by the reference's ring factors
  (:func:`collective_cost`, ``dryrun.py:81-87``): all-gather its output,
  all-reduce twice its output, reduce-scatter its input, all-to-all its
  output.  These are DTensor's collectives, not GSPMD's, and they are
  read from the dispatched ops, not parsed from HLO as the reference
  does (PyTorch has no HLO).  On a CPU mesh DTensor runs a ``Shard ->
  Shard`` redistribution as an all-gather and a chunk; it is charged
  here as the all-to-all NCCL would run.

The roofline terms use an NVIDIA H100 SXM's data-sheet figures in
place of the reference's TPU v5e constants (``dryrun.py:48-50``):
989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM3, and NVLink 4 at 450e9
B/s each way.  A 16-wide ``model`` axis spans two 8-GPU boards, whose
link is slower than NVLink, so ``collective_s`` is a lower bound there.

An eager run sees every layer, so the totals are counted at full depth
and the roofline needs no probe.  Unless ``--no-probe``, ``unit_costs``
still records the 1- and 2-unit runs of the reference's cost probes
(``_cfg_with_units``, ``_n_units``), and ``roofline`` notes whether
``base + n_units * delta`` agrees with the full count.

Results go to ``build/dryrun/<arch>__<shape>__<mesh>[_tag].json`` under
the repository (``--out`` elsewhere).

Usage:
  python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --summary   # a table of the saved cells
  ... [--remat-policy dots] [--no-seq-shard-cache] [--microbatches 4]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from .. import configs
from ..config import SHAPES, ArchConfig, ShapeConfig, cell_is_applicable, shape_by_name
from ..sharding import from_local, is_dtensor
from ..tree import tree_leaves, tree_map
from .mesh import make_production_mesh, production_mesh_shape
from .specs import input_specs
from .steps import build_steps

__all__ = [
    "PEAK_FLOPS",
    "HBM_BW",
    "LINK_BW",
    "RESULTS_DIR",
    "collective_cost",
    "CostMode",
    "cell_args",
    "lower_cell",
    "model_flops",
    "run_cell",
    "save_result",
    "summarize",
    "main",
]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# hardware model: NVIDIA H100 SXM (data sheet)
PEAK_FLOPS = 989e12  # dense bf16 FLOP/s per GPU
HBM_BW = 3.35e12  # B/s per GPU
LINK_BW = 450e9  # NVLink 4, B/s each way per GPU

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_cost(kind: str, out_bytes: int, group_size: int = 1) -> int:
    """Per-device link bytes of one collective, the reference's ring
    factors (``dryrun.py:81-87``) on its output's bytes: all-gather the
    output, all-reduce twice the output, reduce-scatter the output times
    the group (its whole input), all-to-all and collective-permute the
    output."""
    if kind == "all-reduce":
        return 2 * out_bytes
    if kind == "reduce-scatter":
        return out_bytes * group_size
    if kind in _COLLECTIVES:
        return out_bytes
    raise ValueError(f"unknown collective {kind!r}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: ops that move no bytes: allocations without a write, and aliases
_NO_TRAFFIC = ("aten::empty.memory_format", "aten::empty_strided", "aten::detach",
               "aten::alias", "aten::lift_fresh")
_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


class CostMode(TorchDispatchMode):
    """Counts the local ops of a DTensor program: FLOPs, bytes moved,
    collectives (by kind and mesh dim) and the live bytes of the
    storages they allocate.  An op with a DTensor among its arguments is
    left to DTensor (``NotImplemented``), whose local ops then come back
    here; ops off ``meta`` or on fake tensors (DTensor's own shape
    propagation, which runs the global op) pass uncounted."""

    def __init__(self, group_dims=None, arguments=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.group_dims = group_dims or {}  # group name -> mesh dim name
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0 for k in _COLLECTIVES}
        self.by_dim = {}  # (kind, mesh dim) -> bytes
        self.n_ops = 0
        self.n_collectives = 0
        self.live = 0
        self.peak = 0
        self._storages = {}  # storage key -> [bytes, live tensors]
        self._quiet = 0  # inside an all-to-all's CPU fallback
        # the step's inputs: an op that returns a view of one, or writes
        # one in place, allocates nothing
        self._external = {t.untyped_storage()._cdata for t in arguments}

    # -- live bytes ----------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        if key in self._external:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    # -- collectives ---------------------------------------------------
    def collective(self, kind: str, out: torch.Tensor, group_size: int, group) -> None:
        b = collective_cost(kind, _nbytes(out), group_size)
        self.collectives[kind] += b
        dim = self.group_dims.get(group, str(group))
        self.by_dim[(kind, dim)] = self.by_dim.get((kind, dim), 0) + b
        self.n_collectives += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        flat_out = [t for t in tree_leaves([out]) if isinstance(t, torch.Tensor)]
        # DTensor's shape propagation runs the global op on fake tensors
        if not any(t.device.type == "meta" for t in flat_out) or any(
            isinstance(t, FakeTensor) for t in flat_out
        ):
            return out
        for t in flat_out:
            if t.device.type == "meta":
                self.track(t)
        if self._quiet:
            return out
        name = func._schema.name
        if name.startswith("_c10d_functional::"):
            kind = _FUNCOL.get(name.split("::")[1])
            if kind is not None:
                group = args[-1]
                size = args[2] if kind == "reduce-scatter" else 1
                self.collective(kind, flat_out[0], size, group)
            return out
        self.n_ops += 1
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_TRAFFIC:
            ins = [a for a in tree_leaves(list(args)) if isinstance(a, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in flat_out)
        return out


class _AllToAll:
    """Charges DTensor's ``Shard -> Shard`` redistribution as the
    all-to-all NCCL runs, in place of the all-gather and chunk of the CPU
    fallback (whose ops pass uncounted)."""

    def __init__(self, mode: CostMode):
        self.mode = mode

    def __enter__(self):
        from torch.distributed.tensor import Shard

        self._orig = Shard._to_new_shard_dim
        mode, orig = self.mode, self._orig

        def to_new_shard_dim(self_, local_tensor, mesh, mesh_dim, *a, **kw):
            mode._quiet += 1
            try:
                out = orig(self_, local_tensor, mesh, mesh_dim, *a, **kw)
            finally:
                mode._quiet -= 1
            group = mesh.get_group(mesh_dim).group_name
            mode.collective("all-to-all", out, 1, group)
            return out

        Shard._to_new_shard_dim = to_new_shard_dim
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import Shard

        Shard._to_new_shard_dim = self._orig


def _cfg_with_units(cfg: ArchConfig, k: int) -> ArchConfig:
    """Config with k scan-units, unrolled (the reference's cost probes)."""
    if cfg.cross_attn_every:  # vlm: unit = one group of `period` layers
        return cfg.replace(n_layers=k * cfg.cross_attn_every, use_scan=False)
    if cfg.is_encdec:  # whisper: unit = 1 enc + 1 dec layer
        return cfg.replace(n_layers=k, enc_layers=k, use_scan=False)
    if cfg.shared_attn_every:  # zamba: unit = period mambas + shared block
        return cfg.replace(n_layers=k * cfg.shared_attn_every, use_scan=False)
    return cfg.replace(n_layers=k, use_scan=False)


def _n_units(cfg: ArchConfig) -> float:
    if cfg.cross_attn_every:
        return cfg.n_layers / cfg.cross_attn_every
    if cfg.is_encdec:
        return float(cfg.n_layers)
    if cfg.shared_attn_every:
        return cfg.n_layers / cfg.shared_attn_every
    return float(cfg.n_layers)


def _meta_dtensor(t: torch.Tensor, sharding):
    """The DTensor of ``t``'s global shape and dtype on ``sharding``,
    from rank 0's local shard on ``meta``."""
    local = torch.empty(sharding.shard_shape(t.shape), dtype=t.dtype, device="meta")
    return from_local(local, sharding, t.shape)


def _local_bytes(tree) -> int:
    return sum(
        _nbytes(t.to_local() if is_dtensor(t) else t)
        for t in tree_leaves(tree)
        if isinstance(t, torch.Tensor)
    )


def _mesh(multi_pod: bool):
    """The production mesh over a ``fake`` group of its size, started
    here (a group of another size is destroyed first)."""
    want = math.prod(production_mesh_shape(multi_pod=multi_pod).axis_sizes)
    if dist.is_initialized() and dist.get_world_size() != want:
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs no process group, or a fake one")
        dist.destroy_process_group()
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        am = production_mesh_shape(multi_pod=multi_pod)
        return init_device_mesh("cpu", am.axis_sizes, mesh_dim_names=am.axis_names)
    return make_production_mesh(multi_pod=multi_pod)


def cell_args(cfg: ArchConfig, shape: ShapeConfig, mesh, microbatches: int = 1):
    """One cell's step and its inputs as meta DTensors on the bundle's
    shardings: ``(fn, args, group names)``; ``fn(*args)`` runs the step."""
    bundle = build_steps(cfg, device="cpu", mesh=mesh, microbatches=microbatches)
    names = mesh.mesh_dim_names
    data_par = mesh.size(names.index("data")) * (
        mesh.size(names.index("pod")) if "pod" in names else 1
    )
    if shape.global_batch < data_par:
        # long_500k (B=1): batch can't shard; replicate it
        bundle.rules.table["batch"] = None
        bundle.serve_rules.table["batch"] = None
    params, opt = bundle.abstract_state()
    groups = {mesh.get_group(i).group_name: n for i, n in enumerate(names)}
    if shape.kind == "train":
        batch = input_specs(cfg, shape)
        args = (
            tree_map(_meta_dtensor, params, bundle.param_shardings),
            tree_map(_meta_dtensor, opt, bundle.opt_shardings),
            tree_map(_meta_dtensor, batch, bundle.batch_sharding(batch)),
        )
        return bundle.train_step, args, groups
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        args = (
            tree_map(_meta_dtensor, params, bundle.param_shardings),
            tree_map(_meta_dtensor, batch, bundle.batch_sharding(batch)),
        )
        return (lambda p, b: bundle.prefill_step(p, b, max_seq=shape.seq_len)), args, groups
    cache, tokens = input_specs(cfg, shape)
    csh = bundle.cache_shardings(shape.global_batch, shape.seq_len)
    tsh = bundle.batch_sharding({"tokens": tokens})["tokens"]
    args = (
        tree_map(_meta_dtensor, params, bundle.serve_param_shardings),
        tree_map(_meta_dtensor, cache, csh),
        _meta_dtensor(tokens, tsh),
    )
    return bundle.serve_step, args, groups


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, microbatches: int = 1):
    """Run one cell's step on meta DTensors under :class:`CostMode`;
    returns (mode, argument bytes, output bytes, the output bytes that
    alias an argument)."""
    fn, args, groups = cell_args(cfg, shape, mesh, microbatches)
    arg_bytes = _local_bytes(args)
    mode = CostMode(groups, [t.to_local() for t in tree_leaves(args)])
    with mode, _AllToAll(mode):
        out = fn(*args)
        out_bytes = _local_bytes(out)
        # outputs written in place into an input (the decode's caches)
        alias_bytes = _local_bytes(
            [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
             and (t.to_local() if is_dtensor(t) else t).untyped_storage()._cdata
             in mode._external]
        )
        del out
    return mode, arg_bytes, out_bytes, alias_bytes


def _costs(mode: CostMode) -> dict:
    coll = dict(mode.collectives)
    coll["total"] = sum(coll.values())
    coll["n_ops"] = mode.n_collectives
    coll["by_mesh_dim"] = {f"{k}@{d}": b for (k, d), b in sorted(mode.by_dim.items())}
    return {
        "flops": float(mode.flops),
        "bytes": float(mode.bytes),
        "collective_bytes": float(coll["total"]),
        "collective_detail": coll,
    }


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    overrides: dict | None = None,
    probe_costs: bool = True,
    microbatches: int = 1,
    tag: str = "",
    verbose: bool = True,
    cfg: ArchConfig | None = None,
    shape: ShapeConfig | None = None,
    mesh=None,
) -> dict:
    """One cell's result, the reference's keys.  ``cfg``, ``shape`` and
    ``mesh`` (a ``DeviceMesh``) replace the named config, shape and the
    production mesh when given (the tests' tiny cells)."""
    cfg = cfg or configs.get(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cfg = cfg.replace(attention_impl="xla")  # the plain routes: meta runs no kernel
    shape = shape or shape_by_name(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if mesh is not None:
        mesh_name = "x".join(str(s) for s in mesh.shape)
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why,
                "mesh": mesh_name, "tag": tag}

    mesh = mesh if mesh is not None else _mesh(multi_pod)
    n_chips = mesh.size()
    t0 = time.time()
    mode, arg_bytes, out_bytes, alias_bytes = lower_cell(cfg, shape, mesh, microbatches)
    step_s = time.time() - t0
    mem_d = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": max(0, mode.peak - (out_bytes - alias_bytes)),
        "alias_size_in_bytes": alias_bytes,
        "generated_code_size_in_bytes": None,
    }
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_chips": n_chips, "kind": shape.kind,
        "compile_seconds": round(step_s, 1),
        "memory_analysis": mem_d,
        "tag": tag, "overrides": overrides or {},
        "microbatches": microbatches,
        "hardware": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW,
                     "name": "NVIDIA H100 SXM (data sheet)"},
    }
    full = _costs(mode)
    r = {k: v for k, v in full.items() if k != "collective_detail"}
    # per-device step times
    r["compute_s"] = r["flops"] / PEAK_FLOPS
    r["memory_s"] = r["bytes"] / HBM_BW
    r["collective_s"] = r["collective_bytes"] / LINK_BW
    r["dominant"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: r[k])
    r["model_flops"] = float(model_flops(cfg, shape))
    r["model_flops_per_chip"] = r["model_flops"] / n_chips
    r["useful_fraction"] = r["model_flops"] / n_chips / max(r["flops"], 1.0)
    if probe_costs:
        costs = {k: _costs(lower_cell(_cfg_with_units(cfg, k), shape, mesh,
                                      microbatches)[0]) for k in (1, 2)}
        n_units = _n_units(cfg)
        for key in ("flops", "bytes", "collective_bytes"):
            delta = costs[2][key] - costs[1][key]
            base = costs[1][key] - delta
            r[key + "_per_unit"] = delta
            r[key + "_base"] = base
            r[key + "_extrapolated"] = base + n_units * delta
            r[key + "_extrapolation_agrees"] = math.isclose(
                base + n_units * delta, full[key], rel_tol=1e-6, abs_tol=1.0
            )
        result["unit_costs"] = costs
    result["roofline"] = r
    result["collective_detail"] = full["collective_detail"]
    result["wall_seconds"] = round(time.time() - t0, 1)
    if verbose:
        gb = (arg_bytes + out_bytes - alias_bytes + mem_d["temp_size_in_bytes"]) / 1e9
        print(
            f"[dryrun] {arch} x {shape_name} x {mesh_name} step={step_s:.1f}s"
            f" per-rank={gb:.3f}GB"
            f" compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s"
            f" coll={r['collective_s']:.3e}s dom={r['dominant']}"
            f" useful={r['useful_fraction']:.2f}",
            flush=True,
        )
    return result


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """6 N D for training, 2 N D for a prefill, 2 N B for a decode step
    (N the active parameters; the reference's formulas)."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2 * n_active * shape.global_batch * shape.seq_len
    return 2 * n_active * shape.global_batch


def save_result(res: dict, out_dir: Path = RESULTS_DIR) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = ("_" + res["tag"]) if res.get("tag") else ""
    name = f"{res['arch']}__{res['shape']}__{res['mesh'].replace('x', '-')}{tag}.json"
    p = out_dir / name
    p.write_text(json.dumps(res, indent=2, default=str))
    return p


def summarize(out_dir: Path = RESULTS_DIR) -> str:
    """A markdown table of the saved cells, one row per arch: for each
    shape the per-rank GB (argument + output - alias + temp) on 16x16 /
    2x16x16, the dominant term's initial (c, m or n: compute, memory,
    collective) and the useful fraction, and the step's seconds."""
    rows = {}
    for f in sorted(Path(out_dir).glob("*.json")):
        r = json.loads(f.read_text())
        if r.get("skipped") or r.get("tag"):
            continue
        m, f_ = r["memory_analysis"], r["roofline"]
        gb = (m["argument_size_in_bytes"] + m["output_size_in_bytes"]
              - m["alias_size_in_bytes"] + m["temp_size_in_bytes"]) / 1e9
        dom = {"compute_s": "c", "memory_s": "m", "collective_s": "n"}[f_["dominant"]]
        rows.setdefault(r["arch"], {}).setdefault(r["shape"], {})[r["mesh"]] = (
            f"{gb:.1f} {dom} {f_['useful_fraction']:.2f} {r['compile_seconds']:.0f}s"
        )
    shapes = [s.name for s in SHAPES]
    lines = ["| arch | " + " | ".join(shapes) + " |", "|---" * (len(shapes) + 1) + "|"]
    for arch in configs.ALL_ARCHS:
        cells = rows.get(arch, {})
        lines.append(
            f"| {arch} | "
            + " | ".join(
                " / ".join(cells.get(s, {}).get(mesh, "-") for mesh in ("16x16", "2x16x16"))
                for s in shapes
            )
            + " |"
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="all (arch x shape) cells")
    ap.add_argument("--no-probe", action="store_true", help="skip the unit-cost probes")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--remat-policy", default=None, choices=["full", "dots", "none"])
    ap.add_argument("--no-seq-shard-cache", action="store_true")
    ap.add_argument("--attention-block-k", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=None, help=f"results directory (default {RESULTS_DIR})")
    ap.add_argument("--summary", action="store_true",
                    help="print a table of the results saved under --out; run nothing")
    args = ap.parse_args(argv)
    out_dir = Path(args.out) if args.out else RESULTS_DIR
    if args.summary:
        print(summarize(out_dir))
        return

    overrides = {}
    if args.remat_policy:
        overrides["remat_policy"] = args.remat_policy
    if args.no_seq_shard_cache:
        overrides["seq_shard_cache"] = False
    if args.attention_block_k:
        overrides["attention_block_k"] = args.attention_block_k
    if args.capacity_factor:
        overrides["capacity_factor"] = args.capacity_factor

    archs = configs.ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = [(a, s, mp) for mp in meshes for a in archs for s in shapes]

    failures = []
    for a, s, mp in cells:
        if args.skip_existing:
            mesh_tag = "2-16-16" if mp else "16-16"
            tag = ("_" + args.tag) if args.tag else ""
            if (out_dir / f"{a}__{s}__{mesh_tag}{tag}.json").exists():
                continue
        try:
            res = run_cell(
                a, s, mp, overrides=overrides or None,
                probe_costs=not args.no_probe,
                microbatches=args.microbatches, tag=args.tag,
            )
            save_result(res, out_dir)
            if res.get("skipped"):
                print(f"[dryrun] {a} x {s} SKIPPED: {res['skipped']}", flush=True)
        except Exception as e:  # noqa: BLE001 -- record and continue
            failures.append((a, s, mp, repr(e)))
            print(f"[dryrun] FAIL {a} x {s} multi={mp}: {e!r}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"[dryrun] {len(failures)} failures", flush=True)
        sys.exit(1)
    print("[dryrun] all cells OK", flush=True)


if __name__ == "__main__":
    main()
