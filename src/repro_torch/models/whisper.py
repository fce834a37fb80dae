"""Whisper-style encoder-decoder backbone (audio family): the port of
``repro.models.whisper.EncDecLM``.

As in the reference, the conv/mel frontend is a stub: the batch carries
precomputed frame embeddings ``audio_embeds`` [B, enc_len, d_model].
Pre-LN LayerNorm with bias, ungated GELU MLPs, MHA.  The encoder's
self-attention is non-causal over learned positions (``enc_pos``); each
decoder layer runs causal self-attention with RoPE (the reference's
recorded deviation from Whisper's learned decoder positions), then
cross-attention on the encoder output, then the MLP.  Attention goes
through the port's kernels: flash attention in prefill (non-causal for
the encoder and the cross-attention), decode attention over the self
cache and over the read-only cross cache.  The LayerNorm is plain
PyTorch, as the reference's is plain XLA, so no residual add is folded
into a norm here.

API as ``transformer.DecoderLM``'s, with the audio:
  encode(params, audio_embeds) -> encoder output [B, enc_len, d]
  forward(params, tokens, audio_embeds, collect_kv)
      -> (hidden, (k, v, cross_k, cross_v) stacked per layer, or None)
  loss(params, batch) -> (ce, {"ce": ce}), the mean cross-entropy of
      ``labels``, the batch carrying ``tokens`` and ``audio_embeds``;
      differentiable on the plain routes, each encoder and decoder layer
      under ``_remat`` as the reference's ``scan_stack`` runs them
  prefill(params, batch, max_seq), the batch carrying ``audio_embeds``
  decode_step(params, cache, tokens)

The reference's two cast points are kept: prefill rounds every leaf to
the compute dtype (``cast_tree``), the LayerNorm weights and biases
included; decode reads those as stored (fp32, ``FP32_KEYS``), and
``prepare`` casts every other weight once.  ``decode_step`` writes the
new token's K/V into the self cache in place, clamped to the last
position past ``max_seq`` as the reference's ``dynamic_update_slice``
does; prefill writes the cross cache once and decode only reads it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ArchConfig
from .base import LMBase, _stack, _unstack
from .layers import (
    apply_norm,
    attention_block,
    attention_decode_block,
    attn_specs,
    cache_prefix,
    cache_write,
    cast_tree,
    cdtype,
    cross_attention_decode,
    decode_kv,
    embed_specs,
    embed_tokens,
    mlp_block,
    mlp_specs,
    norm_specs,
    rope_tables,
    unembed,
)
from ..sharding import constrain, local_device, serving_region, sharded_region
from .spec import ParamSpec

__all__ = ["EncDecLM"]


class EncDecLM(LMBase):
    FP32_KEYS = ("ln1", "ln2", "ln3", "final_norm")

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        if not (cfg.enc_layers > 0 and cfg.enc_len > 0):
            raise ValueError(f"{cfg.name}: not an encoder-decoder configuration")

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _enc_layer_specs(self):
        cfg = self.cfg
        return {
            "ln1": norm_specs(cfg, "ln"),
            "attn": attn_specs(cfg),
            "ln2": norm_specs(cfg, "ln"),
            "mlp": mlp_specs(cfg, gated=False),
        }

    def _dec_layer_specs(self):
        cfg = self.cfg
        return {
            "ln1": norm_specs(cfg, "ln"),
            "self_attn": attn_specs(cfg),
            "ln2": norm_specs(cfg, "ln"),
            "cross_attn": attn_specs(cfg, cross=True),
            "ln3": norm_specs(cfg, "ln"),
            "mlp": mlp_specs(cfg, gated=False),
        }

    def param_specs(self):
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            "enc_pos": ParamSpec(
                (cfg.enc_len, cfg.d_model), (None, "embed"), scale=0.01
            ),
            "enc_layers": _stack(cfg.enc_layers, self._enc_layer_specs()),
            "enc_norm": norm_specs(cfg, "ln"),
            "dec_layers": _stack(cfg.n_layers, self._dec_layer_specs()),
            "final_norm": norm_specs(cfg, "ln"),
        }

    # ------------------------------------------------------------------
    # encoder + decoder (prefill)
    # ------------------------------------------------------------------
    def encode(self, params, audio_embeds: torch.Tensor, rules=None) -> torch.Tensor:
        """audio_embeds [B, enc_len, d] -> the encoder output, in the
        compute dtype, with the weights as given (``forward`` rounds them
        first, as the reference's does); each layer under ``_remat``."""
        cfg = self.cfg
        dt = cdtype(cfg)
        # the positions laid out as the frames are: their embed dim
        # gathered over data (the reference adds them as stored)
        pos = constrain(rules, params["enc_pos"].to(dt), "enc_seq", None)
        x = audio_embeds.to(dt) + pos
        for lp in _unstack(params["enc_layers"], cfg.enc_layers):
            x = self._remat(self._enc_layer, lp, x, rules)
        return apply_norm(params["enc_norm"], x, cfg, rules)

    def _enc_layer(self, lp, x, rules=None):
        cfg = self.cfg
        h = apply_norm(lp["ln1"], x, cfg, rules)
        a, _ = attention_block(lp["attn"], h, cfg, None, causal=False, rules=rules)
        x = x + a
        h2 = apply_norm(lp["ln2"], x, cfg, rules)
        return x + mlp_block(lp["mlp"], h2, cfg, rules)

    def _dec_layer(self, lp, x, enc, tables, rules=None):
        """One decoder layer -> (x, self K/V, cross K/V)."""
        cfg = self.cfg
        h = apply_norm(lp["ln1"], x, cfg, rules)
        a, kv = attention_block(lp["self_attn"], h, cfg, tables, rules=rules)
        x = x + a
        h2 = apply_norm(lp["ln2"], x, cfg, rules)
        c, ckv = attention_block(
            lp["cross_attn"], h2, cfg, None, causal=False, memory=enc, rules=rules
        )
        x = x + c
        x = x + mlp_block(lp["mlp"], apply_norm(lp["ln3"], x, cfg, rules), cfg, rules)
        return x, kv, ckv

    def _forward(self, params, tokens, audio_embeds, kv_out, rules=None):
        """``params`` already through ``cast_tree``.  Unless ``kv_out`` is
        None, each layer's self K/V go into ``kv_out["k"/"v"][i, :, :S]``
        and its cross K/V into ``kv_out["cross_k"/"cross_v"][i]``."""
        cfg = self.cfg
        enc = self.encode(params, audio_embeds, rules)
        x = embed_tokens(params["embed"], tokens, cfg, rules)
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        cross = ("batch", None, "cache_heads", None)
        for i, lp in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
            x, kv, ckv = self._remat(self._dec_layer, lp, x, enc, tables, rules)
            if kv_out is not None:
                cache_prefix(kv_out["k"][i], kv["k"], rules)
                cache_prefix(kv_out["v"][i], kv["v"], rules)
                kv_out["cross_k"][i] = constrain(rules, ckv["k"], *cross)
                kv_out["cross_v"][i] = constrain(rules, ckv["v"], *cross)
        return apply_norm(params["final_norm"], x, cfg, rules)

    def forward(self, params, tokens, audio_embeds, collect_kv: bool = False):
        """tokens [B, S], audio_embeds [B, enc_len, d] -> (hidden [B, S, d],
        (k, v, cross_k, cross_v) stacked over the layers, or None)."""
        caches = self.init_cache(*tokens.shape, tokens.device) if collect_kv else None
        params = cast_tree(params, cdtype(self.cfg))
        x = self._forward(params, tokens, audio_embeds, caches)
        if caches is None:
            return x, None
        return x, tuple(caches[k] for k in ("k", "v", "cross_k", "cross_v"))

    def loss(self, params, batch, rules=None):
        """The mean cross-entropy of ``batch["labels"]`` (the reference's
        ``whisper.py:136-142``): (ce, {"ce": ce})."""
        with sharded_region(rules):
            params = cast_tree(params, cdtype(self.cfg))
            x = self._forward(params, batch["tokens"], batch["audio_embeds"], None, rules)
            return self._mean_ce(params, x, batch["labels"], rules)

    # ------------------------------------------------------------------
    # serving: prefill + decode
    # ------------------------------------------------------------------
    def cache_specs(self, batch_size: int, seq_len: int):
        cfg = self.cfg
        dt = cdtype(cfg)
        L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        kv_axes = (None, "batch", "cache_seq", "cache_heads", None)
        cross_axes = (None, "batch", None, "cache_heads", None)
        kv_shape = (L, batch_size, seq_len, Hkv, dh)
        cross_shape = (L, batch_size, cfg.enc_len, Hkv, dh)
        return {
            "k": ParamSpec(kv_shape, kv_axes, "zeros", dtype=dt),
            "v": ParamSpec(kv_shape, kv_axes, "zeros", dtype=dt),
            "cross_k": ParamSpec(cross_shape, cross_axes, "zeros", dtype=dt),
            "cross_v": ParamSpec(cross_shape, cross_axes, "zeros", dtype=dt),
            "lengths": ParamSpec((batch_size,), ("batch",), "zeros", dtype=torch.int32),
        }

    @torch.inference_mode()
    def prefill(self, params, batch, rules=None, max_seq: Optional[int] = None):
        """Encoder + full-sequence decoder; returns (cache, its self K/V
        padded to max_seq, and the last logits [B, V])."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_seq = max_seq or S
        if S > max_seq:
            raise ValueError(f"prompt of {S} tokens past max_seq={max_seq}")
        with serving_region(rules):
            params = cast_tree(params, cdtype(self.cfg))
            cache = self.init_cache(B, max_seq, local_device(tokens), rules)
            x = self._forward(params, tokens, batch["audio_embeds"], cache, rules)
            cache["lengths"].fill_(S)
            logits = unembed(params["embed"], x[:, -1:], self.cfg, rules)
            return cache, logits[:, 0]

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens, rules=None):
        """tokens [B, 1] -> (cache', logits [B, V]).  Appends one token,
        writing its self K/V into ``cache`` in place; the cross cache is
        read over its full length."""
        with serving_region(rules):
            return self._decode_step(params, cache, tokens, rules)

    def _decode_step(self, params, cache, tokens, rules):
        cfg = self.cfg
        lengths = cache["lengths"]
        k_all, v_all = cache["k"], cache["v"]
        B, S = k_all.shape[1], k_all.shape[2]
        x = embed_tokens(params["embed"], tokens, cfg, rules)
        new_len = lengths + 1
        # dynamic_update_slice clamps the start into the cache
        pos = lengths.clamp(0, S - 1).long()
        rows = torch.arange(B, device=lengths.device)
        tables = rope_tables(lengths[:, None], cfg.head_dim, cfg.rope_theta)
        enc_len = cache["cross_k"].shape[2]
        mem_len = torch.full_like(lengths, enc_len)
        for i, lp in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
            kc, vc = k_all[i], v_all[i]
            h = apply_norm(lp["ln1"], x, cfg, rules)
            k_new, v_new = decode_kv(lp["self_attn"], h, cfg, tables, rules)
            cache_write(kc, pos, k_new[:, 0], rules, rows)
            cache_write(vc, pos, v_new[:, 0], rules, rows)
            x = x + attention_decode_block(
                lp["self_attn"], h, kc, vc, new_len, cfg, tables, rules
            )
            h2 = apply_norm(lp["ln2"], x, cfg, rules)
            x = x + cross_attention_decode(
                lp["cross_attn"], h2, cache["cross_k"][i], cache["cross_v"][i],
                mem_len, cfg, rules,
            )
            h3 = apply_norm(lp["ln3"], x, cfg, rules)
            x = x + mlp_block(lp["mlp"], h3, cfg, rules)
        x = apply_norm(params["final_norm"], x, cfg, rules)
        logits = unembed(params["embed"], x, cfg, rules)
        return dict(cache, lengths=new_len), logits[:, 0]
