"""Model construction dispatch: ArchConfig -> model object.

Every family of the repo's ten configurations is ported: the decoder
(``transformer.DecoderLM``: the dense stack, the MoE stack and the VLM's
cross-attention groups), RWKV6 (``rwkv.Rwkv6LM``), the Zamba2 hybrid
(``zamba.ZambaLM``) and Whisper (``whisper.EncDecLM``); beside them the
port's own granite-4.0-h pattern hybrid (``granite.GraniteHybridLM``,
chosen by ``attn_layer_ids``, which the ten leave empty).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

from ..config import ArchConfig
from .granite import GraniteHybridLM
from .rwkv import Rwkv6LM
from .transformer import DecoderLM
from .whisper import EncDecLM
from .zamba import ZambaLM

__all__ = ["build_model", "frontend_inputs"]


def build_model(
    cfg: ArchConfig,
) -> Union[DecoderLM, EncDecLM, GraniteHybridLM, Rwkv6LM, ZambaLM]:
    if cfg.is_pattern_hybrid:
        return GraniteHybridLM(cfg)
    if cfg.rwkv:
        return Rwkv6LM(cfg)
    if cfg.ssm_state > 0 and cfg.shared_attn_every > 0:
        return ZambaLM(cfg)
    if cfg.is_encdec:
        return EncDecLM(cfg)
    return DecoderLM(cfg)


def frontend_inputs(cfg: ArchConfig) -> Dict[str, Tuple[int, int]]:
    """The stubbed frontends' inputs a prefill batch carries beside the
    tokens, by key, each ``[B, *shape]`` in the compute dtype: the VLM's
    image embeddings, Whisper's audio frames; none for the others."""
    out = {}
    if cfg.cross_attn_every:
        out["image_embeds"] = (cfg.n_image_tokens, cfg.d_model)
    if cfg.is_encdec:
        out["audio_embeds"] = (cfg.enc_len, cfg.d_model)
    return out
