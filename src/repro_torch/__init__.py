"""COREC on PyTorch and CUDA: the port of :mod:`repro` to one H100.

The JAX package ``repro`` stays the reference; this package grows
beside it slice by slice.  It imports ``torch`` and never ``jax``, and
nothing of ``repro``: what it shares with the reference (policy table,
sweep request, traffic constants) it keeps as its own copy.

Layout:
  compat.py            device resolution (CUDA unless the caller asks
                       for the CPU; no silent fallback)
  kernels/ref.py       plain PyTorch versions of every kernel
  kernels/csrc/*.cu    hand-written CUDA C++ for sm_90a
  kernels/_build.py    nvcc -> shared library -> ctypes, at first use
  kernels/{doneprefix,rmsnorm,flash_attention,decode_attention}.py
                       the kernels' ctypes wrappers
  kernels/ops.py       dispatch: kernel on CUDA tensors, plain on CPU
  core/policy.py       the five vectorized policies by name
  core/torchplane.py   the claim-compacted lane engine
  core/sweep.py        SweepRequest -> run_sweep -> SweepResult
  core/{atomics,ring,baseline}.py  the host-side COREC ring (own copies)
  config.py, configs/  ArchConfig and the ten configurations (own copies)
  models/              the dense decoder (spec, layers, transformer),
                       params_from_reference, build_model
  serving/             EngineConfig / InferenceEngine behind COREC or
                       RSS ingestion (request, scheduler: own copies)
"""

__all__ = ["compat", "config", "configs", "core", "kernels", "models", "serving"]
