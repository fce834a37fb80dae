"""Tiny stand-ins of the cells for the CPU tests: each cell's own files
with the port's tiny configuration of the same family (fp32, plain
routes) and traffic and engine cut to match, so that a run takes a few
seconds."""

from __future__ import annotations

import dataclasses
import json

from bench import spec

__all__ = ["tiny_cell", "TINY", "TINY_SECONDS"]

#: a tiny run's window: long enough that a closed loop's clients are
#: answered and send again inside it on a loaded test machine
TINY_SECONDS = 3.0

_load_cell = spec.load_cell  # the files' own, whatever a test patches in

#: per cell: the traffic, engine and warm-up of its tiny stand-in
TINY = {
    "qwen2-1.5b.docqa": {
        "traffic": {
            "rate_per_s": 20.0,
            "prompt": {"dist": "loguniform", "min": 8, "max": 64},
            "new_tokens": 4,
        },
        "engine": {"n_slots": 8, "max_seq": 80},
        "warmup_prompts": [64, 8],
        "sample": 4,
    },
    "grok-1-314b.chat": {
        "traffic": {
            "clients": 4,
            "ramp_s": 0.2,
            "prompt": {"dist": "uniform", "min": 4, "max": 16},
            "new_tokens": 4,
        },
        "engine": {"n_slots": 4, "max_seq": 32},
        "warmup_prompts": [16, 4],
        "sample": 4,
    },
}


def tiny_cell(name: str) -> tuple:
    """(BENCHMARK.json's entry, the cut workload, the cut configuration)."""
    from repro_torch.configs import get_tiny

    entry, cell, config = _load_cell(name)
    cell = json.loads(json.dumps(cell))
    t = TINY[name]
    cell["traffic"].update(t["traffic"])
    cell["engine"].update(t["engine"])
    cell["warmup_prompts"] = t["warmup_prompts"]
    cell["check"]["sample"] = t["sample"]
    cfg = dataclasses.asdict(get_tiny(config["registry"]))
    if cfg.get("n_experts"):  # drop-free, as the cell's configuration is
        cfg["capacity_factor"] = cfg["n_experts"] / cfg["top_k"]
    return entry, cell, dict(config, config=cfg)
