"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

The port's own copy of ``repro.launch.serve``: runs the
continuous-batching engine (COREC or RSS ingestion) over a synthetic
request stream and prints TTFT / completion-latency stats.  The
reference's flags plus ``--device`` (default ``cuda``; ``--device cpu``
serves on the CPU with the kernels' plain versions) and the train
launcher's ``--tiny`` / ``--full``.  It serves the reduced config of the
chosen arch (``--tiny``, the default) with ``max_seq=64``, as the
reference does; ``--full`` serves the published one, at random weights.

The reduced attention configs have heads of 16, and the card's attention
kernels take heads of 32, 64 or 128: on the card they need ``--full``
(the launcher says so before it builds anything).
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import configs
from ..kernels.flash_attention import HEAD_DIMS
from ..serving import EngineConfig, InferenceEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=configs.ALL_ARCHS)
    ap.add_argument("--policy", default="corec", choices=["corec", "rss"])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=None, help="req/s (open loop)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--tiny", action="store_true", default=True,
                    help="serve the reduced config (the default)")
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = configs.get_tiny(args.arch) if args.tiny else configs.get(args.arch)
    if args.device == "cuda" and not cfg.rwkv and cfg.head_dim not in HEAD_DIMS:
        raise ValueError(
            f"{cfg.name} has heads of {cfg.head_dim}; the CUDA attention kernels "
            f"take {HEAD_DIMS}: serve it with --full, or on the CPU (--device cpu)"
        )
    ecfg = EngineConfig(n_slots=args.slots, max_seq=64, n_workers=args.workers,
                        policy=args.policy, eos_token=-1)
    eng = InferenceEngine(cfg, ecfg, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=list(rng.integers(2, cfg.vocab, 8)),
                max_new_tokens=args.new_tokens, session=int(rng.integers(0, 8)))
        for i in range(args.requests)
    ]
    res = eng.run(reqs, rate=args.rate)
    ttft = np.array([r.ttft for r in res])
    lat = np.array([r.latency for r in res])
    print(f"[serve] {cfg.name} policy={args.policy} device={eng.device}: "
          f"{len(res)}/{len(reqs)} done")
    ttft_p99 = np.percentile(ttft, 99) * 1e3
    lat_p99 = np.percentile(lat, 99) * 1e3
    print(f"  ttft   mean={ttft.mean() * 1e3:.1f}ms p99={ttft_p99:.1f}ms")
    print(f"  latency mean={lat.mean() * 1e3:.1f}ms p99={lat_p99:.1f}ms")
    return res


if __name__ == "__main__":
    main()
