"""Model construction dispatch: ArchConfig -> model object.

Ported: the dense decoder (``transformer.DecoderLM``), RWKV6
(``rwkv.Rwkv6LM``) and the Zamba2 hybrid (``zamba.ZambaLM``).  Whisper
raises ``NotImplementedError`` naming the ROADMAP.md item that ports
it; so do the MoE and VLM configurations of the decoder.
"""

from __future__ import annotations

from typing import Union

from ..config import ArchConfig
from .rwkv import Rwkv6LM
from .transformer import DecoderLM
from .zamba import ZambaLM

__all__ = ["build_model"]


def build_model(cfg: ArchConfig) -> Union[DecoderLM, Rwkv6LM, ZambaLM]:
    if cfg.rwkv:
        return Rwkv6LM(cfg)
    if cfg.ssm_state > 0 and cfg.shared_attn_every > 0:
        return ZambaLM(cfg)
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the Whisper model is not ported yet: ROADMAP.md "
            "Queue A, item 3"
        )
    return DecoderLM(cfg)
