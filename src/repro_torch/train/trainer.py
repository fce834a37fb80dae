"""The training loop: the port of ``repro.train.trainer``.

Wires the substrates together as the reference does: the COREC prefetch
ring (``data.CorecDataPipeline``) feeds batches, the step is
``build_steps``' ``train_step`` (grad-accumulation aware), checkpoints
commit atomically off the critical path, the straggler detector watches
step times, and ``run`` resumes from (checkpoint step, stream position)
after a crash.

``device=`` names where the state lives (default: the card;
``device="cpu"`` runs the plain versions on the CPU).  ``mesh=`` (a
``DeviceMesh`` over the ranks of the running process group, as the
reference's ``Trainer(cfg, tcfg, mesh)`` takes it) runs the sharded
train step: the state is initialised on the device and distributed
onto the bundle's shardings, every rank draws the same batches, a
restart restores onto the shardings, and rank 0 alone writes the
checkpoints, gathered whole.  Without a mesh the trainer runs on one
device.  The trainer runs the configuration it is given: on the card a
config whose ``attention_impl`` leaves the kernels on (``"auto"``)
raises from the kernels' grad guard at the first step, and
``launch/train.py`` names the plain routes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..compat import resolve_device
from ..config import ArchConfig
from ..data import CorecDataPipeline, SyntheticLMSource
from ..launch.steps import build_steps, gather_state, place_state
from ..optim import AdamW, cosine_schedule, wsd_schedule
from ..runtime.straggler import StragglerDetector
from ..tree import tree_map

__all__ = ["Trainer", "TrainerConfig"]


@dataclass
class TrainerConfig:
    batch: int = 8
    seq: int = 32
    steps: int = 20
    lr: float = 3e-4
    warmup: int = 10
    schedule: str = "cosine"  # cosine | wsd
    checkpoint_every: int = 10
    checkpoint_dir: Optional[str] = None
    microbatches: int = 1
    ring_size: int = 16
    n_producers: int = 2
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, device=None, mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.mesh = mesh
        sched = (
            wsd_schedule(tcfg.lr, tcfg.warmup, tcfg.steps // 2, tcfg.steps // 4)
            if tcfg.schedule == "wsd"
            else cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)
        )
        self.bundle = build_steps(
            cfg,
            lr_fn=sched,
            optimizer=AdamW(),
            microbatches=tcfg.microbatches,
            device=self.device,
            mesh=mesh,
        )
        self.source = SyntheticLMSource(cfg.vocab, tcfg.batch, tcfg.seq, tcfg.seed)
        self.ckpt = (
            AsyncCheckpointer(tcfg.checkpoint_dir) if tcfg.checkpoint_dir else None
        )
        # on a mesh every rank restores, rank 0 alone writes
        self._writes = mesh is None or torch.distributed.get_rank() == 0
        self.straggler = StragglerDetector()
        self.metrics_log: List[Dict] = []

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None):
        """(fp32 master params, AdamW state) on the trainer's device.  The
        params are the model's ``init`` drawn from ``generator`` on its
        device (default: seed 0 on the CPU), then moved: the same numbers
        whichever device trains, as the reference's ``PRNGKey(0)`` gives
        on every backend."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = self.bundle.model.init(generator, device=generator.device)
        params = tree_map(lambda p: p.to(self.device), params)
        opt = self.bundle.optimizer.init(params)
        if self.mesh is not None:
            return place_state(self.bundle, params, opt)
        return params, opt

    def _maybe_restore(self):
        if self.ckpt is None or latest_step(self.ckpt.directory) is None:
            return None
        params, opt = self.init_state()
        sh = None
        if self.mesh is not None:
            sh = (self.bundle.param_shardings, self.bundle.opt_shardings)
        (params, opt), extra = restore_checkpoint(
            self.ckpt.directory, (params, opt), shardings=sh
        )
        return params, opt, extra.get("stream_position", 0), extra["step"]

    # ------------------------------------------------------------------
    def run(self, crash_at: Optional[int] = None) -> Dict[str, Any]:
        """Train; ``crash_at`` raises mid-run to exercise restart.  Returns
        the losses of the steps this run took, the final params and
        optimizer state, and the per-step log (step, loss, seconds)."""
        restored = self._maybe_restore()
        if restored is not None:
            params, opt, stream_pos, start_step = restored
        else:
            params, opt = self.init_state()
            stream_pos, start_step = 0, 0

        pipe = CorecDataPipeline(
            self.source,
            ring_size=self.tcfg.ring_size,
            n_producers=self.tcfg.n_producers,
            start_index=stream_pos,
        )
        pipe.start()
        losses = []
        try:
            for step in range(start_step, self.tcfg.steps):
                t0 = time.perf_counter()
                raw = pipe.next_batch()
                if raw is None:
                    raise RuntimeError("data pipeline starved")
                batch = {"tokens": raw["tokens"], "labels": raw["labels"]}
                params, opt, metrics = self.bundle.train_step(params, opt, batch)
                loss = float(metrics["loss"])  # waits for the step
                losses.append(loss)
                dt = time.perf_counter() - t0
                self.straggler.observe(0, dt)
                self.metrics_log.append({"step": step, "loss": loss, "sec": dt})
                if (
                    self.ckpt is not None
                    and (step + 1) % self.tcfg.checkpoint_every == 0
                ):
                    state = (params, opt)
                    if self.mesh is not None:  # a collective: every rank
                        state = gather_state(state)
                    if self._writes:
                        self.ckpt.save(
                            step + 1, state,
                            extra={"stream_position": pipe.position()},
                        )
                if crash_at is not None and step + 1 >= crash_at:
                    raise RuntimeError(f"injected crash at step {step + 1}")
        finally:
            pipe.stop()
            if self.ckpt is not None:
                self.ckpt.wait()
        return {
            "losses": losses,
            "params": params,
            "opt": opt,
            "final_step": self.tcfg.steps,
            "metrics_log": list(self.metrics_log),
        }
