"""Tiny stand-ins of the cells for the CPU tests: each cell's own files
with the port's tiny configuration of the same family (fp32, plain
routes) and traffic and engine cut to match, so that a run takes a few
seconds.

A cell's stand-in is ``bench/tiny/<cell>.json``: ``traffic`` and
``engine`` (keys that replace the cell's), ``warmup_prompts`` and
``sample`` (the requests the reference judges).  A later cell adds its
own file there.
"""

from __future__ import annotations

import dataclasses
import json

from bench import spec

__all__ = ["tiny_cell", "TINY_SECONDS"]

#: a tiny run's window: long enough that a closed loop's clients are
#: answered and send again inside it on a loaded test machine
TINY_SECONDS = 3.0

_load_cell = spec.load_cell  # the files' own, whatever a test patches in


def tiny_cell(name: str) -> tuple:
    """(BENCHMARK.json's entry, the cut workload, the cut configuration)."""
    from repro_torch.configs import get_tiny

    entry, cell, config = _load_cell(name)
    cell = json.loads(json.dumps(cell))
    t = json.loads((spec.BENCH / "tiny" / f"{name}.json").read_text())
    cell["traffic"].update(t["traffic"])
    cell["engine"].update(t["engine"])
    cell["warmup_prompts"] = t["warmup_prompts"]
    cell["check"]["sample"] = t["sample"]
    cfg = dataclasses.asdict(get_tiny(config["registry"]))
    if cfg.get("n_experts"):  # drop-free, as the cell's configuration is
        cfg["capacity_factor"] = cfg["n_experts"] / cfg["top_k"]
    return entry, cell, dict(config, config=cfg)
