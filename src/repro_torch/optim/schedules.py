"""Learning-rate schedules, cosine and WSD (MiniCPM's warmup-stable-
decay): the port of ``repro.optim.schedules``.  Each returns a function
of the step that computes in 0-d fp32 tensors, as the reference's does
in ``jnp.float32``, on the step's device when it is a tensor."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "wsd_schedule"]


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``."""

    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def wsd_schedule(
    peak_lr: float, warmup: int, stable: int, decay: int, floor: float = 0.01
):
    """Warm-up -> flat -> linear decay to ``floor * peak_lr``.

    MiniCPM (arXiv:2404.06395) trains with WSD so checkpoints in the stable
    phase can branch into decayed 'deliverables' at any time.
    """

    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup, 1)
        t_decay = step - (warmup + stable)
        dec = peak_lr * torch.clamp(1.0 - t_decay / max(decay, 1), floor, 1.0)
        out = torch.where(step < warmup, warm, torch.full_like(step, peak_lr))
        return torch.where(t_decay > 0, dec, out)

    return lr
