"""Find an open-loop cell's knee on the chip: the highest offered rate
at which the ingestion backlog does not grow over the window.

    python3 bench/knee.py --workload <cell> --rates 2 4 6 --seconds 20 [--seed n]

Each rate is one run of the cell through its driver (the reference is
skipped: this sweep sets a rate, it does not judge answers).  A run's
backlog grows where the queue wait of the window's last quarter of
requests (by due time) exceeds that of its first quarter by more than
``--grow`` seconds at the median.  Prints one JSON line per rate.  The
benchmark's own runs never run this; its result is the ``rate_per_s``
written into the cell's file.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

import numpy as np  # noqa: E402

from bench import spec  # noqa: E402


def backlog(record: dict) -> dict:
    """Queue-wait medians of the first and last quarter of the window's
    requests, by due time, and the window's TTFT percentiles."""
    rows = [r for r in record["requests"] if r["in_window"]]
    rows.sort(key=lambda r: r["due"])
    q = max(1, len(rows) // 4)
    wait = [
        None if r["prefill_start"] is None else r["prefill_start"] - r["due"]
        for r in rows
    ]
    done = [w for w in wait if w is not None]
    ttft = [r["first_token"] - r["due"] for r in rows if r["first_token"] is not None]
    first = [w for w in wait[:q] if w is not None]
    last = [w if w is not None else float("inf") for w in wait[-q:]]
    return {
        "n": len(rows),
        "started": len(done),
        "wait_first_q50_s": float(np.median(first)) if first else None,
        "wait_last_q50_s": float(np.median(last)),
        "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else None,
        "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--grow", type=float, default=0.25)
    args = ap.parse_args(argv)
    _, cell, config = spec.load_cell(args.workload)
    driver = spec.load_driver(cell)
    for rate in args.rates:
        c = json.loads(json.dumps(cell))
        c["traffic"]["rate_per_s"] = rate
        c["check"]["sample"] = 0
        t = time.perf_counter()
        rec = driver.run(c, config, args.seed, args.seconds, False)
        b = backlog(rec)
        grows = b["wait_last_q50_s"] - (b["wait_first_q50_s"] or 0.0) > args.grow
        print(json.dumps({"rate_per_s": rate, **b, "grows": grows,
                          "run_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
