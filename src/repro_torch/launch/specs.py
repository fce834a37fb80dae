"""Input stand-ins for every (arch x shape) cell: the port of
``repro.launch.specs``.

``input_specs`` returns the trees a step takes, as tensors on the
``meta`` device: the right shapes and dtypes, nothing allocated.  The
modality frontends are stubs, as in the reference: VLM cells get patch
embeddings, audio cells frame embeddings, already in d_model.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..config import ArchConfig, ShapeConfig
from ..models.api import build_model
from ..models.spec import abstract_params

__all__ = ["train_batch_specs", "prefill_batch_specs", "decode_input_specs",
           "input_specs"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _meta((B, S), torch.int32),
        "labels": _meta((B, S), torch.int32),
    }
    dt = getattr(torch, cfg.dtype)
    if cfg.cross_attn_every:
        batch["image_embeds"] = _meta((B, cfg.n_image_tokens, cfg.d_model), dt)
    if cfg.is_encdec:
        batch["audio_embeds"] = _meta((B, cfg.enc_len, cfg.d_model), dt)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    batch = train_batch_specs(cfg, shape)
    del batch["labels"]
    return batch


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[Any, Any]:
    """(cache stand-ins, tokens) for serve_step."""
    model = build_model(cfg)
    cache = abstract_params(model.cache_specs(shape.global_batch, shape.seq_len))
    return cache, _meta((shape.global_batch, 1), torch.int32)


def input_specs(cfg: ArchConfig, shape: ShapeConfig):
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_batch_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
