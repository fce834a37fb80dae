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
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..compat import resolve_device
from ..config import ArchConfig
from .layers import (
    apply_norm,
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
from .spec import ParamSpec, init_params, spec_map

__all__ = ["DecoderLM"]


def _stack(n: int, specs):
    """Prepend a layer dim to every leaf of a spec tree."""
    return spec_map(
        lambda s: ParamSpec((n,) + s.shape, (None,) + s.axes, s.init, s.scale, s.dtype),
        specs,
    )


def _unstack(tree, n: int):
    """A stacked ``[L, ...]`` tree -> L per-layer trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return torch.unbind(tree, 0)


class DecoderLM(nn.Module):
    """Parameters travel as an argument (a nested dict of tensors, the
    reference's pytree), so one module serves fp32 masters and prepared
    trees alike; the module itself holds only the config."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
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
        self.cfg = cfg
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

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        """fp32 master parameters on ``device`` (default: the card), drawn
        from ``generator`` (default: seed 0 on that device)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return init_params(self.param_specs(), generator, dev)

    def prepare(self, params):
        """The tree to run: every leaf but the norm weights cast to the
        compute dtype, once (the values ``use_weight`` and ``cast_tree``
        give at each use).  Norm weights stay as stored: decode uses
        them so, prefill rounds them per call as the reference does."""
        dt = cdtype(self.cfg)

        def go(tree, in_norm=False):
            if isinstance(tree, dict):
                return {
                    k: go(v, in_norm or k in ("ln1", "ln2", "final_norm"))
                    for k, v in tree.items()
                }
            if in_norm or not tree.is_floating_point():
                return tree
            return tree.to(dt)

        return go(params)

    # ------------------------------------------------------------------
    # forward (prefill)
    # ------------------------------------------------------------------
    def _self_layer(self, lp, x, tables):
        cfg = self.cfg
        h = apply_norm(lp["ln1"], x, cfg)
        a, kv = attention_block(lp["attn"], h, cfg, tables)
        x = x + self._scaled(a)
        h2 = apply_norm(lp["ln2"], x, cfg)
        x = x + self._scaled(mlp_block(lp["mlp"], h2, cfg))
        return x, kv

    def _scaled(self, y):
        return y if self.res_scale == 1.0 else self.res_scale * y

    def _forward(self, params, tokens, kv_out=None):
        """``params`` already through ``cast_tree``."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg)
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        kvs = []
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x, kv = self._self_layer(lp, x, tables)
            if kv_out is not None:
                kv_out["k"][i, :, :S] = kv["k"]
                kv_out["v"][i, :, :S] = kv["v"]
            else:
                kvs.append(kv)
        x = apply_norm(params["final_norm"], x, cfg)
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

    def init_cache(self, batch_size: int, seq_len: int, device) -> Dict[str, Any]:
        """An empty cache of :meth:`cache_specs` on ``device``."""
        return spec_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
            self.cache_specs(batch_size, seq_len),
        )

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
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            kc, vc = k_all[i], v_all[i]
            h = apply_norm(lp["ln1"], x, cfg)
            k_new, v_new = decode_kv(lp["attn"], h, cfg, tables)
            kc[rows, pos] = k_new[:, 0]
            vc[rows, pos] = v_new[:, 0]
            a = attention_decode_block(lp["attn"], h, kc, vc, new_len, cfg, tables)
            x = x + self._scaled(a)
            h2 = apply_norm(lp["ln2"], x, cfg)
            x = x + self._scaled(mlp_block(lp["mlp"], h2, cfg))
        x = apply_norm(params["final_norm"], x, cfg)
        logits = unembed(params["embed"], x, cfg)
        return dict(cache, lengths=new_len), logits[:, 0]
