"""The control of ``correct``: the configuration's reference computed
in fp8, the nearest precision below the configurations' bf16, put in
the program's place, has to fail a cell's limits.

    python3 bench/control.py --workload <cell> --seconds 30 --seeds 1 2 3

For each seed one run of the cell (a short window at the cell's own
load, the reference judging its sample as in every run), then, on the
same sample, the tokens that the fp8 reference puts first at each
served position, judged by the fp32 reference.  Prints, per seed, the
program's numbers and the control's beside the cell's limits, and
whether the control passed them (it must not).  The benchmark's own
runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

from bench import spec  # noqa: E402
from bench.reference.judge import gap_stats  # noqa: E402
from bench.weights import make_params, rules_of  # noqa: E402


def control_readings(
    workload: str, seed: int, seconds: float, device: str = "cuda"
) -> dict:
    """One seed: the program's compared numbers, the control's, and the
    cell's limits."""
    from repro_torch.config import ArchConfig
    from repro_torch.models.api import build_model

    _, cell, config = spec.load_cell(workload)
    driver = spec.load_driver(cell)
    rec = driver.run(cell, config, seed, seconds, False, device=device)
    cfg = ArchConfig(**config["config"])
    dev, dtype = torch.device(device), getattr(torch, cfg.dtype)
    reference = spec.load_reference(config)
    params = make_params(build_model(cfg), seed, dev, dtype, rules_of(reference))
    ctl = gap_stats(reference, params, config["config"], rec["sample"], control=True)
    ctl = driver.compared(ctl)
    prog = driver.compared(rec["judged"])
    limits = cell["check"]["limits"]
    passed = all(ctl[k] is not None and ctl[k] <= v for k, v in limits.items())
    return {"seed": seed, "program": prog, "program_correct": rec["correct"],
            "control": ctl, "limits": limits, "control_passes": passed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        r = control_readings(args.workload, seed, args.seconds)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
