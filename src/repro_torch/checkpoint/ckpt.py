"""Atomic, hashed, sharded checkpoints: the port of ``repro.checkpoint.ckpt``
with the reference's on-disk layout, so a checkpoint that either package
writes restores in the other.

Layout (per step)::

    <dir>/step_000420.tmp-<nonce>/      # written here first
        manifest.json                   # step, extra (stream position),
                                        # leaf paths, shapes, dtypes,
                                        # shard files and their sha256
        shard_00000.npz ... shard_N.npz # leaves, split by leading dim
    <dir>/step_000420/                  # atomic rename = commit

* **atomic commit**: a checkpoint exists completely or not at all (tmp
  dir + ``os.replace``); torn writes are invisible to ``latest_step``.
* **content hashes**: every shard carries a sha256; restore verifies.
* **leaf paths**: each leaf is named as jax's ``tree_flatten_with_path``
  prints it (``"[0]/['embed']/['tok']"``, ``"[1]/.m/['embed']/['tok']"``,
  ``"[1]/.step"`` for ``(params, OptState)``), in jax's order.
* **async**: ``AsyncCheckpointer`` copies the state to host memory on
  the training thread and writes it on a background thread.

Tensors go to numpy as ``detach().cpu().numpy()``; numpy has no
bfloat16, so a bf16 leaf raises (the training state holds fp32 and
int32 only).  Restore puts each leaf on the device of the matching leaf
of ``like`` (numpy arrays stay numpy).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_map, tree_paths, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "AsyncCheckpointer"]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("checkpoint: numpy has no bfloat16; save fp32 leaves")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(
    directory: str | Path,
    step: int,
    state: Any,
    n_shards: int = 4,
    extra: Optional[Dict] = None,
) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    nonce = os.getpid() * 1000 + int(time.time() * 1000) % 1000
    tmp = directory / f"step_{step:08d}.tmp-{nonce}"
    final = directory / f"step_{step:08d}"
    tmp.mkdir(parents=True)

    flat = tree_paths(state)
    arrays = [_to_numpy(x) for _, x in flat]

    manifest = {
        "step": step,
        "extra": extra or {},
        "n_shards": n_shards,
        "leaves": [
            {"path": p, "shape": list(a.shape), "dtype": str(a.dtype)}
            for (p, _), a in zip(flat, arrays)
        ],
        "shards": [],
    }
    for s in range(n_shards):
        payload = {}
        for i, a in enumerate(arrays):
            if a.ndim == 0:
                if s == 0:
                    payload[f"leaf{i}"] = a
                continue
            n = a.shape[0]
            lo = s * n // n_shards
            hi = (s + 1) * n // n_shards
            if hi > lo:
                payload[f"leaf{i}"] = a[lo:hi]
        fname = tmp / f"shard_{s:05d}.npz"
        np.savez(fname, **payload)
        h = hashlib.sha256(fname.read_bytes()).hexdigest()
        manifest["shards"].append({"file": fname.name, "sha256": h})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    os.replace(tmp, final)  # atomic commit
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in directory.iterdir()
        if p.is_dir() and p.name.startswith("step_") and ".tmp" not in p.name
    ]
    return max(steps) if steps else None


def _like_leaf(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.device)
    return arr


def restore_checkpoint(
    directory: str | Path,
    like: Any,
    step: Optional[int] = None,
    shardings: Any = None,
    verify: bool = True,
) -> Tuple[Any, Dict]:
    """Reassemble the leaves of ``step`` (default: the latest) into the
    structure of ``like``, whose leaf paths must equal the manifest's.
    ``shardings`` (a tree of ``repro_torch.sharding.NamedSharding`` of
    ``like``'s structure, over a ``DeviceMesh`` of any size) places each
    leaf as a DTensor on its mesh instead: the mesh need not be the one
    the checkpoint was saved from.  Returns (state, extra with
    ``"step"``)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if verify:
        for sh in manifest["shards"]:
            name = sh["file"]
            if hashlib.sha256((d / name).read_bytes()).hexdigest() != sh["sha256"]:
                raise IOError(f"checkpoint shard corrupt: {name}")
    flat = tree_paths(like)
    saved = [meta["path"] for meta in manifest["leaves"]]
    if [p for p, _ in flat] != saved:
        raise ValueError(
            f"checkpoint at step {step} holds leaves {saved}, the state to "
            f"restore into has {[p for p, _ in flat]}"
        )
    shards = [np.load(d / sh["file"]) for sh in manifest["shards"]]
    leaves = []
    for i, ((_, like_leaf), meta) in enumerate(zip(flat, manifest["leaves"])):
        key = f"leaf{i}"
        if len(meta["shape"]) == 0:
            arr = shards[0][key]
        else:
            arr = np.concatenate([sh[key] for sh in shards if key in sh.files], axis=0)
        leaves.append(_like_leaf(arr, like_leaf))
    state = tree_unflatten(like, leaves)
    if shardings is not None:
        state = tree_map(_place, state, shardings)
    return state, manifest["extra"] | {"step": manifest["step"]}


def _place(leaf, sharding):
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
    return sharding.distribute(t.to(sharding.mesh.device_type))


class AsyncCheckpointer:
    """Snapshot on the caller thread, write on a background thread."""

    def __init__(self, directory: str | Path, n_shards: int = 4):
        self.directory = Path(directory)
        self.n_shards = n_shards
        self._thread: Optional[threading.Thread] = None
        self.last_committed: Optional[int] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        self.wait()  # one outstanding save at a time (double buffering)
        # a copy: a CPU tensor's numpy view would share its storage
        snapshot = tree_map(lambda x: np.array(_to_numpy(x)), state)

        def _write():
            try:
                save_checkpoint(self.directory, step, snapshot, self.n_shards, extra)
                self.last_committed = step
            except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
