"""Run one benchmark cell once and print its result as the last line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's files are found by name (see
``bench/spec.py``); its driver runs the program and returns a record,
from which each metric's reader takes its number: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
a trace ``breakdown``, and last ``checks``: each number compared beside
its limit, which the last lines of standard error repeat).

Exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), where the program cannot be imported,
and where JAX, flax or the JAX package ``repro`` are loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: top-level module names the process may not hold: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`BANNED`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in BANNED)


def result_line(record: dict, metrics: list, device: dict, trace: bool) -> dict:
    """The result object, ``checks`` last."""
    values = {}
    for m in metrics:
        v = m.read(record)
        if v is not None:
            values[m.name] = {"value": float(v), "unit": m.unit}
    out = {
        "correct": bool(record["correct"]),
        "attempted": int(record["attempted"]),
        "failed": int(record["failed"]),
        "metrics": values,
        "device": device,
    }
    tr = record.get("trace")
    if trace and tr:
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr["device_ops"]],
            "idle_gaps": [[n, s] for n, s in tr["idle_gaps"]],
        }
    out["checks"] = record["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from bench import spec

    entry, cell, config = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        chips = entry["chips"]
        print(f"needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    metrics = spec.metrics_for(args.workload, bool(args.trace))
    driver = spec.load_driver(cell)
    record = driver.run(
        cell, config, args.seed, args.seconds, bool(args.trace), t_start=T_START
    )
    found = banned_modules()
    if found:
        print("JAX or the JAX package is loaded: " + ", ".join(found), file=sys.stderr)
        return 3
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": entry["chips"],
        "memory_peak_bytes": int(record["memory_peak_bytes"]),
    }
    if args.trace and record.get("trace"):
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
    out = result_line(record, metrics, device, bool(args.trace))
    late = record.get("late", {})
    print(json.dumps({"generator_late_s": late, "judged": record.get("judged")}))
    for name, c in record["checks"].items():
        value, limit = c["value"], c["limit"]
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
