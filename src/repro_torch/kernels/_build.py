"""Build the CUDA sources under ``csrc/`` into shared libraries.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its
own with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the
root of the checkout (listed in ``.gitignore``), then loads with
``ctypes``.  No PyTorch headers are included, so a source builds in
seconds.  The library's file name carries a digest of its source, of
the shared device helpers in ``csrc/common.cuh`` and of the flags, so
an edited source or header is rebuilt and a stale library is never
loaded.  :func:`build` starts one ``nvcc`` per missing source, all at
once, and waits for all of them; a failed build raises with nvcc's
stderr.  Nothing is built when this module is imported.

:func:`count_launch` adds one to a wrapper's ``launches`` under a lock:
the serving engine launches kernels from its prefill worker threads
and its decode thread at once, and ``+=`` on an attribute is not atomic.

:func:`refuse_grad` is the check every wrapper with floating inputs makes
first: a kernel writes its output through a raw pointer, so the output
carries no ``grad_fn``, and a launch under grad mode on an input that
requires a gradient would cut the autograd graph without an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "SOURCES",
    "BUILD_DIR",
    "build",
    "load",
    "build_log",
    "count_launch",
    "refuse_grad",
]

CSRC = Path(__file__).resolve().parent / "csrc"
#: device helpers that every source including them shares
COMMON = CSRC / "common.cuh"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: every CUDA source of the port, by library name
SOURCES = {
    name: CSRC / f"{name}.cu"
    for name in (
        "done_prefix",
        "done_prefix_batch",
        "rmsnorm",
        "flash_attention",
        "decode_attention",
        "rwkv6",
        "ssd",
    )
}
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_loaded: dict = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (PATH, or {home}/bin)")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    digest.update(COMMON.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """nvcc's stderr of the last build of ``name`` (ptxas register and
    shared-memory report), or '' when it was not built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=None) -> dict:
    """Compile every named source (default: all) that has no current
    library, one ``nvcc`` each, in parallel.  Returns name -> path."""
    names = list(SOURCES if names is None else names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
            procs[n] = (
                tmp,
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
                ),
            )
        errors = []
        for n, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {SOURCES[n].name}:\n{out}{err}")
                tmp.unlink(missing_ok=True)
                continue
            paths[n].with_suffix(".log").write_text(out + err)
            os.replace(tmp, paths[n])  # atomic: concurrent builders agree
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
    return lib


def count_launch(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel (thread-safe)."""
    with _count_lock:
        wrapper.launches += 1


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad mode is on and a floating tensor among ``tensors``
    requires a gradient: the kernel has no backward (see the module
    docstring).  Nothing switches to the plain version on its own."""
    if not torch.is_grad_enabled():
        return
    if any(
        isinstance(t, torch.Tensor) and t.is_floating_point() and t.requires_grad
        for t in tensors
    ):
        raise RuntimeError(
            f"{what}: a CUDA kernel has no backward, and an input requires a "
            "gradient; train on the plain versions (attention_impl='xla' in "
            "the ArchConfig, impl='plain' in kernels.ops), or call under "
            "torch.no_grad()"
        )
