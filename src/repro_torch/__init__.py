"""COREC on PyTorch and CUDA: the port of :mod:`repro` to one H100.

The JAX package ``repro`` stays the reference; this package grows
beside it slice by slice.  It imports ``torch`` and never ``jax``, and
nothing of ``repro``: what it shares with the reference (policy table,
sweep request, traffic constants) it keeps as its own copy.

Layout:
  compat.py            device resolution (CUDA unless the caller asks
                       for the CPU; no silent fallback) and the lane
                       axis' process group (make_mesh, lane_mesh,
                       device_count, resolve_shards)
  distributed.py       run_ranks: W ranks of one function in W processes
                       over torch.distributed (a free port, a deadline)
  kernels/ref.py       plain PyTorch versions of every kernel
  kernels/csrc/*.cu    hand-written CUDA C++ for sm_90a
  kernels/_build.py    nvcc -> shared library -> ctypes, at first use
  kernels/{doneprefix,rmsnorm,flash_attention,decode_attention}.py
                       the kernels' ctypes wrappers
  kernels/ops.py       dispatch: kernel on CUDA tensors, plain on CPU
  core/policy.py       the five vectorized policies by name
  core/torchplane.py   the claim-compacted lane engine
  core/sweep.py        SweepRequest -> run_sweep -> SweepResult
  core/shard.py        the lane axis split over a process group's ranks
                       (shards=N), gathered back in the reference's order
  sharding.py          logical-axis sharding rules -> partition specs and
                       DTensor placements (DeviceMesh or AbstractMesh)
  core/{atomics,ring,baseline}.py  the host-side COREC ring (own copies)
  config.py, configs/  ArchConfig and the ten configurations (own copies),
                       and the port's own granite-4.0-h-small
  models/              the dense decoder (spec, layers, transformer),
                       params_from_reference, build_model
  serving/             EngineConfig / InferenceEngine behind COREC or
                       RSS ingestion (request, scheduler: own copies)
  tree.py              pytree helpers in jax's leaf order and paths
  optim/               AdamW, the cosine / WSD schedules, and the int8
                       pod all-reduce with error feedback
  launch/              build_steps (train, prefill, serve steps on one
                       device, or sharded on DTensors over a DeviceMesh
                       by the reference's shardings; abstract_state), the
                       production meshes (under torch's fake backend
                       without a cluster), the meta input specs, the
                       dry-run (every cell on meta DTensors), and the
                       training and serving launchers
  train/               Trainer: data ring, step (on a mesh too),
                       checkpoints, restart
  checkpoint/          atomic, hashed checkpoints in the reference's layout
  data/, runtime/      the data pipeline, the straggler and failure
                       detectors and the elastic mesh plan (own copies)
"""

__all__ = [
    "checkpoint",
    "compat",
    "config",
    "configs",
    "core",
    "data",
    "distributed",
    "kernels",
    "launch",
    "models",
    "optim",
    "runtime",
    "serving",
    "sharding",
    "train",
    "tree",
]
