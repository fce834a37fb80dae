"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The reference's flags (``repro.launch.train``) plus ``--device``
(default ``cuda``; ``--device cpu`` trains on the CPU).  ``--tiny`` (the
default) trains the reduced config of the chosen arch, ``--full`` the
published one.
"""

from __future__ import annotations

import argparse

from .. import configs
from ..train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=configs.ALL_ARCHS)
    ap.add_argument(
        "--tiny",
        action="store_true",
        default=True,
        help="use the reduced smoke config (the default)",
    )
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = configs.get_tiny(args.arch) if args.tiny else configs.get(args.arch)
    # Training runs the plain routes.  The reference's "auto" resolves to
    # its XLA routes off the TPU (repro/kernels/ops.py:58-61), and the
    # port's CUDA kernels have no backward: each refuses an input that
    # requires a gradient (kernels/_build.refuse_grad).
    cfg = cfg.replace(attention_impl="xla")
    # minicpm trains with WSD per its paper
    schedule = "wsd" if args.arch == "minicpm-2b" else args.schedule
    tcfg = TrainerConfig(
        batch=args.batch,
        seq=args.seq,
        steps=args.steps,
        lr=args.lr,
        schedule=schedule,
        microbatches=args.microbatches,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    out = trainer.run()
    losses = out["losses"]
    print(
        f"[train] {cfg.name}: {len(losses)} steps, "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f}"
    )
    return out


if __name__ == "__main__":
    main()
