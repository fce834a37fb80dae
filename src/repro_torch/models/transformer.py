"""Decoder-only transformer: the port of
``repro.models.transformer.DecoderLM``.

Covers the dense GQA/MHA configurations (qwen2, qwen2.5, granite,
minicpm), the MoE configurations (grok-1, moonshot: each layer's MLP
is ``layers.moe_block``, whose load-balancing aux loss ``forward`` sums
over the layers) and the VLM's period/group stack (llama-3.2-vision:
``cross_attn_every = P``, so ``n_layers / P`` groups of P - 1
self-attention layers and one cross-attention layer on the image
embeddings, non-causal and without RoPE, whose K/V prefill writes into
a read-only cross cache ``[G, B, n_image_tokens, Hkv, dh]``).  The
layers are stacked ``[L, ...]`` (VLM: ``[G, P - 1, ...]`` and
``[G, ...]``) leaves, as the reference keeps them for ``lax.scan``;
here Python loops walk them in the reference's order.

API (the reference's; ``rules``, default None, lays the step out over
a mesh, see ``layers``):
  param_specs() / init(generator, device) / prepare(params)
  forward(params, tokens, image_embeds, collect_kv, rules) -> (hidden, caches, aux)
  loss(params, batch, rules) -> (total, {"ce", "aux", "zloss"}), the batch
      carrying ``tokens``, ``labels`` and optionally ``loss_mask`` (and
      the VLM's ``image_embeds``); ``forward`` and ``loss`` run under
      grad mode where the caller has it on (training: the plain routes,
      each self layer under ``_remat``, as the reference's ``scan_stack``
      wraps them; the cross layers plainly, as its group scan does)
  prefill(params, batch, rules, max_seq) -> (cache, last_logits) under
      inference mode, the VLM's batch carrying ``image_embeds``
      [B, n_image_tokens, d]
  decode_step(params, cache, tokens, rules) -> (cache, logits)
  cache_specs(batch_size, seq_len) / init_cache(batch_size, seq_len, device, rules)

Differences from the reference, none of which changes a value:

* ``decode_step`` writes the new token's K/V into the cache in place
  (the reference returns a new cache); the returned dict holds the
  same k/v tensors and new lengths.
* A cache write at a length past the cache clamps to the last
  position, as the reference's ``dynamic_update_slice`` does (an idle
  decode slot keeps stepping and its length passes ``max_seq``).
* ``prepare`` casts every weight but the norms' and the MoE router's
  to the compute dtype once; prefill still rounds those to it (the
  reference's ``cast_tree``; the router is then upcast to fp32 again),
  decode passes them as stored (fp32), as the reference does.
* Each residual add is folded into the norm after it: a block's output
  travels to the next norm (or the final one) as ``delta``, and
  ``apply_add_norm`` returns the sum, bit for bit the reference's
  ``x + delta``, beside its norm; on the card one kernel launch does
  both.  The chain runs through the VLM's cross layers too.  Only
  layer 0's ``ln1`` runs plain.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import tracing
from ..config import ArchConfig
from .base import LMBase, _stack, _unstack
from .layers import (
    apply_add_norm,
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
    moe_block,
    moe_specs,
    norm_specs,
    rope_tables,
    unembed,
)
from ..sharding import constrain, local_device, serving_region, sharded_region
from .spec import ParamSpec

__all__ = ["DecoderLM"]


class DecoderLM(LMBase):
    """``prepare`` casts every weight but the norms' and the MoE router's
    (decode reads those as stored, fp32).

    An MoE decode step routes all of its B slots as one group of B
    tokens (the reference's semantics): an expert's capacity comes from
    B, and which assignments it drops depends on what the other slots
    hold, so a request's tokens after its first depend on the requests
    decoded beside it.  Setting ``moe_stats`` to a dict of 0-d int64
    tensors ``{"kept", "assigned"}`` on the device makes every decode
    step add its MoE assignment counts to it (``layers.moe_block``).

    While a profiler records, each layer of a decode step is two inner
    spans (``repro_torch.tracing.inner_span``, buffered without a
    profiler range): ``attn`` (its first norm and attention) and ``moe``
    or ``ffn`` (its second norm and MoE block or MLP), each with the
    layer's place in the stack as ``layer``; a ``moe`` span holds the
    block's own three.  Prefill and training record none."""

    FP32_KEYS = ("ln1", "ln2", "final_norm", "router")

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        self.moe_stats = None
        self.period = cfg.cross_attn_every  # 0: the homogeneous stack
        if self.period:
            if cfg.n_layers % self.period:
                raise ValueError(
                    f"{cfg.name}: {cfg.n_layers} layers are not whole groups "
                    f"of {self.period}"
                )
            self.n_groups = cfg.n_layers // self.period
        self.res_scale = (
            cfg.depth_scale / (cfg.n_layers**0.5) if cfg.depth_scale else 1.0
        )

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        s = {
            "ln1": norm_specs(cfg),
            "attn": attn_specs(cfg),
            "ln2": norm_specs(cfg),
        }
        if cfg.is_moe:
            s["moe"] = moe_specs(cfg)
        else:
            s["mlp"] = mlp_specs(cfg)
        return s

    def _cross_layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": norm_specs(cfg),
            "attn": attn_specs(cfg, cross=True),
            "ln2": norm_specs(cfg),
            "mlp": mlp_specs(cfg),
        }

    def param_specs(self):
        cfg = self.cfg
        specs: Dict[str, Any] = {
            "embed": embed_specs(cfg),
            "final_norm": norm_specs(cfg),
        }
        if self.period:
            inner = _stack(self.period - 1, self._layer_specs())
            specs["groups"] = {
                "self": _stack(self.n_groups, inner),
                "cross": _stack(self.n_groups, self._cross_layer_specs()),
            }
        else:
            specs["layers"] = _stack(cfg.n_layers, self._layer_specs())
        return specs

    def _stack_walk(self, params):
        """The layers in the reference's order: ``("self", lp, idx)`` with
        ``idx`` the layer's index into the self K/V cache (``i``, or
        ``(g, j)`` in the VLM's 6-D cache), and after each VLM group's
        P - 1 self layers ``("cross", lp, g)``."""
        if not self.period:
            for i, lp in enumerate(_unstack(params["layers"], self.cfg.n_layers)):
                yield "self", lp, i
            return
        for g, gp in enumerate(_unstack(params["groups"], self.n_groups)):
            for j, lp in enumerate(_unstack(gp["self"], self.period - 1)):
                yield "self", lp, (g, j)
            yield "cross", gp["cross"], g

    # ------------------------------------------------------------------
    # forward (prefill)
    # ------------------------------------------------------------------
    def _self_layer(self, lp, x, delta, tables, rules=None):
        """One layer on the residual ``x`` and the previous layer's
        output ``delta`` (None before the first), not yet added: returns
        the residual, this layer's MLP (or MoE) output, not yet added,
        the K/V and the MoE aux loss (None for a dense MLP).  Each add
        goes into the norm after it (``apply_add_norm``)."""
        cfg = self.cfg
        x, h = apply_add_norm(lp["ln1"], x, delta, cfg, rules)
        a, kv = attention_block(lp["attn"], h, cfg, tables, rules=rules)
        x, h2 = apply_add_norm(lp["ln2"], x, self._scaled(a), cfg, rules)
        m, aux = self._ffn(lp, h2, rules=rules)
        return x, self._scaled(m), kv, aux

    def _ffn(self, lp, h, stats=None, rules=None, spans=False):
        """The layer's MLP, or its MoE block: (output, aux or None).
        ``spans``: the MoE block records its inner spans."""
        if "moe" in lp:
            return moe_block(lp["moe"], h, self.cfg, stats, rules, spans)
        return mlp_block(lp["mlp"], h, self.cfg, rules), None

    def _cross_layer(self, lp, x, delta, memory, rules=None):
        """A VLM cross layer, as :meth:`_self_layer`: attention on the
        memory, non-causal and without RoPE; returns its K/V."""
        cfg = self.cfg
        x, h = apply_add_norm(lp["ln1"], x, delta, cfg, rules)
        a, kv = attention_block(
            lp["attn"], h, cfg, None, causal=False, memory=memory, rules=rules
        )
        x, h2 = apply_add_norm(lp["ln2"], x, self._scaled(a), cfg, rules)
        return x, self._scaled(mlp_block(lp["mlp"], h2, cfg, rules)), kv

    def _scaled(self, y):
        return y if self.res_scale == 1.0 else self.res_scale * y

    def _forward(self, params, tokens, image_embeds, kv_out, rules=None):
        """``params`` already through ``cast_tree``.  Unless ``kv_out`` is
        None, each self layer's K/V go into ``kv_out["k"/"v"][idx, :, :S]``
        and each cross layer's into ``kv_out["cross_k"/"cross_v"][g]``.
        Returns the final hidden states and the sum of the layers' MoE
        aux losses (0 for a dense stack), in fp32."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg, rules)
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        mem = image_embeds.to(cdtype(cfg)) if self.period else None
        delta, auxes = None, []
        for kind, lp, idx in self._stack_walk(params):
            if kind == "self":
                x, delta, kv, aux = self._remat(
                    self._self_layer, lp, x, delta, tables, rules
                )
                if aux is not None:
                    auxes.append(aux)
                if kv_out is not None:
                    cache_prefix(kv_out["k"][idx], kv["k"], rules)
                    cache_prefix(kv_out["v"][idx], kv["v"], rules)
            else:
                x, delta, kv = self._cross_layer(lp, x, delta, mem, rules)
                if kv_out is not None:
                    cross = ("batch", None, "cache_heads", None)
                    kv_out["cross_k"][idx] = constrain(rules, kv["k"], *cross)
                    kv_out["cross_v"][idx] = constrain(rules, kv["v"], *cross)
        _, x = apply_add_norm(params["final_norm"], x, delta, cfg, rules)
        if not auxes:
            return x, torch.zeros((), device=x.device)
        return x, torch.stack(auxes).sum()

    def forward(self, params, tokens, image_embeds=None, collect_kv: bool = False):
        """tokens [B, S] (and the VLM's image_embeds [B, n_image_tokens,
        d]) -> (hidden [B, S, d], caches-or-None, aux_loss)."""
        caches = self.init_cache(*tokens.shape, tokens.device) if collect_kv else None
        params = cast_tree(params, cdtype(self.cfg))
        x, aux = self._forward(params, tokens, image_embeds, caches)
        if caches is not None:
            del caches["lengths"]
        return x, caches, aux

    def loss(self, params, batch, rules=None):
        """The training loss (the reference's ``transformer.py:221-234``),
        differentiable on the plain routes: masked mean cross-entropy over the
        real vocabulary, plus ``1e-4`` times the masked mean of
        logsumexp squared (z-loss) and ``0.01`` times the MoE aux loss.
        ``loss_mask`` defaults to ones.  Returns (total, {"ce", "aux",
        "zloss"}), fp32 scalars."""
        with sharded_region(rules):
            return self._loss(params, batch, rules)

    def _loss(self, params, batch, rules):
        params = cast_tree(params, cdtype(self.cfg))
        x, aux = self._forward(params, batch["tokens"], batch.get("image_embeds"),
                               None, rules)
        lse, ll = self._label_logprobs(params, x, batch["labels"], rules)
        mask = batch.get("loss_mask")
        mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
        denom = mask.sum().clamp_min(1.0)
        ce = torch.sum((lse - ll) * mask) / denom
        zloss = 1e-4 * torch.sum(lse.square() * mask) / denom
        total = ce + zloss + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "zloss": zloss}

    # ------------------------------------------------------------------
    # serving: prefill + decode
    # ------------------------------------------------------------------
    def cache_specs(self, batch_size: int, seq_len: int) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        dt = cdtype(cfg)
        Hkv, dh = cfg.n_kv_heads, cfg.head_dim
        kv_axes = (None, "batch", "cache_seq", "cache_heads", None)
        if self.period:
            kv_shape = (self.n_groups, self.period - 1, batch_size, seq_len, Hkv, dh)
            kv_axes = (None,) + kv_axes
            cross_shape = (self.n_groups, batch_size, cfg.n_image_tokens, Hkv, dh)
            cross_axes = (None, "batch", None, "cache_heads", None)
            specs = {
                "cross_k": ParamSpec(cross_shape, cross_axes, "zeros", dtype=dt),
                "cross_v": ParamSpec(cross_shape, cross_axes, "zeros", dtype=dt),
            }
        else:
            kv_shape = (cfg.n_layers, batch_size, seq_len, Hkv, dh)
            specs = {}
        return {
            "k": ParamSpec(kv_shape, kv_axes, "zeros", dtype=dt),
            "v": ParamSpec(kv_shape, kv_axes, "zeros", dtype=dt),
            **specs,
            "lengths": ParamSpec((batch_size,), ("batch",), "zeros", dtype=torch.int32),
        }

    @torch.inference_mode()
    def prefill(self, params, batch, rules=None, max_seq: Optional[int] = None):
        """Full-sequence prefill; returns (cache padded to max_seq, last
        logits [B, V])."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_seq = max_seq or S
        if S > max_seq:
            raise ValueError(f"prompt of {S} tokens past max_seq={max_seq}")
        with serving_region(rules):
            params = cast_tree(params, cdtype(self.cfg))
            cache = self.init_cache(B, max_seq, local_device(tokens), rules)
            x, _ = self._forward(params, tokens, batch.get("image_embeds"), cache, rules)
            cache["lengths"].fill_(S)
            logits = unembed(params["embed"], x[:, -1:], self.cfg, rules)
            return cache, logits[:, 0]

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens, rules=None):
        """tokens [B, 1] -> (cache', logits [B, V]).  Appends one token,
        writing its K/V into ``cache`` in place; the VLM's cross cache is
        read over its full length."""
        with serving_region(rules):
            return self._decode_step(params, cache, tokens, rules)

    def _decode_step(self, params, cache, tokens, rules):
        cfg = self.cfg
        lengths = cache["lengths"]
        k_all, v_all = cache["k"], cache["v"]
        B, S = k_all.shape[-4], k_all.shape[-3]
        x = embed_tokens(params["embed"], tokens, cfg, rules)
        new_len = lengths + 1
        # dynamic_update_slice clamps the start into the cache
        pos = lengths.clamp(0, S - 1).long()
        rows = torch.arange(B, device=lengths.device)
        tables = rope_tables(lengths[:, None], cfg.head_dim, cfg.rope_theta)
        if self.period:
            n_img = cache["cross_k"].shape[2]
            mem_len = torch.full_like(lengths, n_img)
        delta = None  # a block's output, added by the next norm
        for n, (kind, lp, idx) in enumerate(self._stack_walk(params)):
            with tracing.inner_span("attn", layer=n):
                x, h = apply_add_norm(lp["ln1"], x, delta, cfg, rules)
                if kind == "self":
                    kc, vc = k_all[idx], v_all[idx]
                    k_new, v_new = decode_kv(lp["attn"], h, cfg, tables, rules)
                    cache_write(kc, pos, k_new[:, 0], rules, rows)
                    cache_write(vc, pos, v_new[:, 0], rules, rows)
                    a = attention_decode_block(
                        lp["attn"], h, kc, vc, new_len, cfg, tables, rules
                    )
                else:
                    ck, cv = cache["cross_k"][idx], cache["cross_v"][idx]
                    a = cross_attention_decode(
                        lp["attn"], h, ck, cv, mem_len, cfg, rules
                    )
            with tracing.inner_span("moe" if "moe" in lp else "ffn", layer=n):
                x, h2 = apply_add_norm(lp["ln2"], x, self._scaled(a), cfg, rules)
                stats = None if rules else self.moe_stats
                ffn = self._ffn(lp, h2, stats, rules, spans=True)[0]  # aux dropped
                delta = self._scaled(ffn)
        _, x = apply_add_norm(params["final_norm"], x, delta, cfg, rules)
        logits = unembed(params["embed"], x, cfg, rules)
        return dict(cache, lengths=new_len), logits[:, 0]
