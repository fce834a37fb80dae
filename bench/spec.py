"""Where the harness finds what a cell is made of, by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics;
each cell's file is ``bench/workloads/<cell>.json``, its configuration
``bench/configs/<config>.json``, its driver ``bench/drivers/<driver>.py``
and each metric's reader ``bench/metrics/<metric>.py``.  A
configuration's plain reference is the module of ``bench/reference/``
that its ``"reference"`` key names (``decoder`` where the key is
absent), which may declare the weight rules of the leaves its family
adds (``bench/weights.py``), and each cell's CPU stand-in for the tests
is ``bench/tiny/<cell>.json`` (``bench/testing.py``).  A later cell,
configuration, reference, stand-in, driver or metric is a file added
beside these; nothing here names one.

``bench/parked.json`` holds, in ``BENCHMARK.json``'s form, the entries
of cells taken out of the benchmark whose files stay: the harness still
runs and tests them by name, and a cell comes back with its entries
moved into ``BENCHMARK.json``.  Lookups read ``BENCHMARK.json`` first.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = [
    "BENCH",
    "PARKED",
    "ROOT",
    "Metric",
    "entries",
    "load_cell",
    "load_driver",
    "load_module",
    "load_reference",
    "metrics_for",
]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PARKED = BENCH / "parked.json"


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    read: object  # record -> float | None


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The module in ``path``, imported under a name of its own (metric
    names hold dots, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entries(benchmark: Path = ROOT / "BENCHMARK.json") -> dict:
    """``benchmark``'s entries, each list followed by the parked ones."""
    bench = _json(benchmark)
    parked = _json(PARKED) if PARKED.exists() else {}
    for key, more in parked.items():
        bench[key] = bench.get(key, []) + more
    return bench


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> tuple:
    """(BENCHMARK.json's entry of the cell, or the parked one, its
    workload file, its configuration file)."""
    bench = entries(benchmark)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    cell = _json(BENCH / "workloads" / f"{name}.json")
    config = _json(BENCH / "configs" / (entry["config"] + ".json"))
    return entry, cell, config


def load_reference(config: dict):
    """The plain reference module of a loaded configuration: the module
    ``bench.reference.<name>`` that its ``"reference"`` key names
    (``decoder`` without the key).  It exposes
    ``logits(params, cfg, tokens, start, linear)`` with
    ``bench/reference/decoder.py``'s meaning and units, and may declare
    ``WEIGHT_RULES`` (``bench/weights.py``)."""
    name = config.get("reference", "decoder")
    return importlib.import_module("bench.reference." + name)


def _reader(metric: str):
    return load_module(BENCH / "metrics" / (metric + ".py")).read


def load_driver(cell: dict):
    """The driver module a workload file names."""
    return load_module(BENCH / "drivers" / (cell["driver"] + ".py"))


def metrics_for(
    name: str, trace: bool, benchmark: Path = ROOT / "BENCHMARK.json"
) -> list:
    """The metrics a run of cell ``name`` reports: its end-to-end ones
    without ``--trace``, its per-layer ones with it.  A metric with a
    ``workloads`` list belongs to those cells; a per-layer one without
    it, to every cell that reports the metric it moves."""
    bench = entries(benchmark)

    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if trace:
        moved = {m["name"] for m in e2e}
        chosen = [m for m in bench["per_layer"] if listed(m) and m["moves"] in moved]
    else:
        chosen = e2e
    return [
        Metric(m["name"], m["unit"], _reader(m["name"])) for m in chosen
    ]
