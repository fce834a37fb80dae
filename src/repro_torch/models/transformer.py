"""Decoder-only transformer, dense homogeneous stack: the port of
``repro.models.transformer.DecoderLM``.

Covers the dense GQA/MHA configurations (qwen2, qwen2.5, granite,
minicpm).  The layers are stacked ``[L, ...]`` leaves, as the reference
keeps them for ``lax.scan``; here a Python loop walks them.  The MoE
block and the VLM cross-attention groups are not ported (ROADMAP.md
Queue A, items 10 and 11), nor is the training loss (item 12).

API (the reference's, minus ``rules``):
  param_specs() / init(generator, device) / prepare(params)
  forward(params, tokens, collect_kv) -> (hidden, caches, aux)
  prefill(params, batch, max_seq) -> (cache, last_logits)
  decode_step(params, cache, tokens) -> (cache, logits)
  cache_specs(batch_size, seq_len) / init_cache(batch_size, seq_len, device)

Differences from the reference, none of which changes a value:

* ``decode_step`` writes the new token's K/V into the cache in place
  (the reference returns a new cache); the returned dict holds the
  same k/v tensors and new lengths.
* A cache write at a length past the cache clamps to the last
  position, as the reference's ``dynamic_update_slice`` does (an idle
  decode slot keeps stepping and its length passes ``max_seq``).
* ``prepare`` casts every weight but the norms' to the compute dtype
  once; prefill still rounds the norm weights to it (the reference's
  ``cast_tree``), decode passes them as stored (fp32), as the reference
  does.
* Each residual add is folded into the norm after it: a block's output
  travels to the next norm (or the final one) as ``delta``, and
  ``apply_add_norm`` returns the sum, bit for bit the reference's
  ``x + delta``, beside its norm; on the card one kernel launch does
  both.  Only layer 0's ``ln1`` runs plain.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import ArchConfig
from .base import LMBase, _stack, _unstack
from .layers import (
    apply_add_norm,
    attention_block,
    attention_decode_block,
    attn_specs,
    cast_tree,
    cdtype,
    decode_kv,
    embed_specs,
    embed_tokens,
    mlp_block,
    mlp_specs,
    norm_specs,
    rope_tables,
    unembed,
)
from .spec import ParamSpec

__all__ = ["DecoderLM"]


class DecoderLM(LMBase):
    """``prepare`` casts every weight but the norms' (decode reads those
    as stored, fp32)."""

    FP32_KEYS = ("ln1", "ln2", "final_norm")

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        if cfg.is_moe:
            raise NotImplementedError(
                f"{cfg.name}: the MoE block is not ported yet: ROADMAP.md "
                "Queue A, item 10"
            )
        if cfg.cross_attn_every:
            raise NotImplementedError(
                f"{cfg.name}: the VLM cross-attention groups are not ported "
                "yet: ROADMAP.md Queue A, item 11"
            )
        self.res_scale = (
            cfg.depth_scale / (cfg.n_layers**0.5) if cfg.depth_scale else 1.0
        )

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": norm_specs(cfg),
            "attn": attn_specs(cfg),
            "ln2": norm_specs(cfg),
            "mlp": mlp_specs(cfg),
        }

    def param_specs(self):
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            "final_norm": norm_specs(cfg),
            "layers": _stack(cfg.n_layers, self._layer_specs()),
        }

    # ------------------------------------------------------------------
    # forward (prefill)
    # ------------------------------------------------------------------
    def _self_layer(self, lp, x, delta, tables):
        """One layer on the residual ``x`` and the previous layer's
        output ``delta`` (None before the first), not yet added: returns
        the residual, this layer's MLP output, not yet added, and the
        K/V.  Each add goes into the norm after it (``apply_add_norm``)."""
        cfg = self.cfg
        x, h = apply_add_norm(lp["ln1"], x, delta, cfg)
        a, kv = attention_block(lp["attn"], h, cfg, tables)
        x, h2 = apply_add_norm(lp["ln2"], x, self._scaled(a), cfg)
        return x, self._scaled(mlp_block(lp["mlp"], h2, cfg)), kv

    def _scaled(self, y):
        return y if self.res_scale == 1.0 else self.res_scale * y

    def _forward(self, params, tokens, kv_out=None):
        """``params`` already through ``cast_tree``."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg)
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        kvs, delta = [], None
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x, delta, kv = self._self_layer(lp, x, delta, tables)
            if kv_out is not None:
                kv_out["k"][i, :, :S] = kv["k"]
                kv_out["v"][i, :, :S] = kv["v"]
            else:
                kvs.append(kv)
        _, x = apply_add_norm(params["final_norm"], x, delta, cfg)
        return x, kvs

    @torch.inference_mode()
    def forward(self, params, tokens, collect_kv: bool = False):
        """tokens [B, S] -> (hidden [B, S, d], caches-or-None, aux_loss)."""
        x, kvs = self._forward(cast_tree(params, cdtype(self.cfg)), tokens)
        caches = None
        if collect_kv:
            caches = {
                "k": torch.stack([kv["k"] for kv in kvs]),
                "v": torch.stack([kv["v"] for kv in kvs]),
            }
        return x, caches, torch.zeros((), device=x.device)

    # ------------------------------------------------------------------
    # serving: prefill + decode
    # ------------------------------------------------------------------
    def cache_specs(self, batch_size: int, seq_len: int) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        dt = cdtype(cfg)
        kv_shape = (cfg.n_layers, batch_size, seq_len, cfg.n_kv_heads, cfg.head_dim)
        kv_axes = (None, "batch", "cache_seq", "cache_heads", None)
        return {
            "k": ParamSpec(kv_shape, kv_axes, "zeros", dtype=dt),
            "v": ParamSpec(kv_shape, kv_axes, "zeros", dtype=dt),
            "lengths": ParamSpec((batch_size,), ("batch",), "zeros", dtype=torch.int32),
        }

    @torch.inference_mode()
    def prefill(self, params, batch, max_seq: Optional[int] = None):
        """Full-sequence prefill; returns (cache padded to max_seq, last
        logits [B, V])."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_seq = max_seq or S
        if S > max_seq:
            raise ValueError(f"prompt of {S} tokens past max_seq={max_seq}")
        params = cast_tree(params, cdtype(self.cfg))
        cache = self.init_cache(B, max_seq, tokens.device)
        x, _ = self._forward(params, tokens, kv_out=cache)
        cache["lengths"].fill_(S)
        logits = unembed(params["embed"], x[:, -1:], self.cfg)
        return cache, logits[:, 0]

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens):
        """tokens [B, 1] -> (cache', logits [B, V]).  Appends one token,
        writing its K/V into ``cache`` in place."""
        cfg = self.cfg
        lengths = cache["lengths"]
        k_all, v_all = cache["k"], cache["v"]
        B, S = k_all.shape[1], k_all.shape[2]
        x = embed_tokens(params["embed"], tokens, cfg)
        new_len = lengths + 1
        # dynamic_update_slice clamps the start into the cache
        pos = lengths.clamp(0, S - 1).long()
        rows = torch.arange(B, device=lengths.device)
        tables = rope_tables(lengths[:, None], cfg.head_dim, cfg.rope_theta)
        delta = None  # a block's output, added by the next norm
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            kc, vc = k_all[i], v_all[i]
            x, h = apply_add_norm(lp["ln1"], x, delta, cfg)
            k_new, v_new = decode_kv(lp["attn"], h, cfg, tables)
            kc[rows, pos] = k_new[:, 0]
            vc[rows, pos] = v_new[:, 0]
            a = attention_decode_block(lp["attn"], h, kc, vc, new_len, cfg, tables)
            x, h2 = apply_add_norm(lp["ln2"], x, self._scaled(a), cfg)
            delta = self._scaled(mlp_block(lp["mlp"], h2, cfg))
        _, x = apply_add_norm(params["final_norm"], x, delta, cfg)
        logits = unembed(params["embed"], x, cfg)
        return dict(cache, lengths=new_len), logits[:, 0]
