"""Model construction dispatch: ArchConfig -> model object.

Ported: the dense decoder (``transformer.DecoderLM``).  The other
families raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them; so do the MoE and VLM configurations of the decoder.
"""

from __future__ import annotations

from ..config import ArchConfig
from .transformer import DecoderLM

__all__ = ["build_model"]


def build_model(cfg: ArchConfig) -> DecoderLM:
    if cfg.rwkv:
        raise NotImplementedError(
            f"{cfg.name}: the RWKV6 model is not ported yet: ROADMAP.md "
            "Queue A, item 2"
        )
    if cfg.ssm_state > 0 and cfg.shared_attn_every > 0:
        raise NotImplementedError(
            f"{cfg.name}: the Zamba model is not ported yet: ROADMAP.md "
            "Queue A, item 3"
        )
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the Whisper model is not ported yet: ROADMAP.md "
            "Queue A, item 3"
        )
    return DecoderLM(cfg)
