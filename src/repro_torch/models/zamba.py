"""Zamba2-style hybrid, a Mamba2 (SSD) backbone with one shared
attention block: the port of ``repro.models.zamba.ZambaLM``.

* ``n_layers`` Mamba2 blocks (the mixer ``mamba.Mamba2Mixer``, shared
  with ``granite.py``): in_proj -> causal depthwise conv of width
  4 over (x, B, C) -> SiLU -> the SSD chunk scan
  (:func:`repro_torch.kernels.ops.ssd`, the CUDA kernel on the card, in
  prefill and, with one token, in decode, as the reference's
  ``_mamba_step`` does) -> gated RMSNorm (normalise, then gate) -> out_proj.
* Every ``shared_attn_every`` layers ONE weight-shared attention + MLP
  block runs on ``concat([hidden, initial embedding])`` (2 d_model wide)
  with per-invocation LoRA adapters on the query and the FFN input; its
  output is added to the residual stream.  Each invocation owns a KV
  cache in decode.  Attention, decode attention and RMSNorm go through
  the port's kernels.
* The stack is ``n_groups`` x ``period`` Mamba blocks, each group ended
  by the shared block, then ``n_extra`` Mamba blocks (``mamba_x``).

API as ``transformer.DecoderLM``'s; ``loss`` returns the mean
cross-entropy alone, as the reference's does.  The reference's two cast points
are kept: prefill rounds every leaf to the compute dtype first
(``cast_tree``); decode uses the stored leaves, so ``A_log``, ``D``,
``dt_bias``, the gated-norm weight and the norms stay fp32 there.
``prepare`` casts every other weight once.  ``decode_step`` writes the
new states and K/V into the cache in place, the K/V write clamped to
the last position past ``max_seq`` as the reference's
``dynamic_update_slice`` does.  Each Mamba block's output and the
shared block's MLP output are added by the norm after them
(``apply_add_norm``: the sum bit for bit the reference's, one kernel
launch on the card); the residual is summed eagerly only where the
shared block concatenates it with the embedding, and ``x + a`` stays
eager there too.  The first Mamba norm and the shared block's two run
plain.

With ``rules`` (``layers``' docstring) the weights go through
``use_weight`` at the reference's sites, and the shared block's LoRA
adapters too, gathered over ``data`` at use (the reference leaves their
layout to GSPMD); the SSD scan runs under ``local`` over each rank's
(batch, ``ssm_heads``) shard, and the shared block's attention as
``layers``' blocks run it.  Its one set of weights serves every
invocation, each with its own adapters and KV cache, as in the
reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import ArchConfig
from .base import LMBase, _stack, _unstack
from .layers import (
    _KV,
    _Q,
    _attend,
    _decode_attend,
    _out,
    _proj,
    apply_add_norm,
    apply_norm,
    apply_rope,
    cache_prefix,
    cache_write,
    cast_tree,
    cdtype,
    embed_specs,
    embed_tokens,
    norm_specs,
    rope_tables,
    unembed,
)
from ..sharding import (
    constrain,
    local_device,
    serving_region,
    sharded_region,
    use_weight,
)
from .mamba import CONV_AXES, SSM_AXES, Mamba2Mixer
from .spec import ParamSpec

__all__ = ["ZambaLM"]


class ZambaLM(LMBase):
    FP32_KEYS = ("ln", "ln1", "ln2", "final_norm", "A_log", "D", "dt_bias", "gn_w")

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        if not (cfg.ssm_state > 0 and cfg.shared_attn_every > 0):
            raise ValueError(f"{cfg.name}: not a Zamba configuration")
        self.mixer = Mamba2Mixer(cfg)
        self.period = cfg.shared_attn_every
        self.n_groups = cfg.n_layers // self.period
        self.n_extra = cfg.n_layers - self.n_groups * self.period

    # ------------------------------------------------------------------
    def _mamba_specs(self):
        return {"ln": norm_specs(self.cfg), **self.mixer.specs()}

    def _shared_specs(self):
        cfg = self.cfg
        d, ff = cfg.d_model, cfg.d_ff
        dh, Hh, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        return {
            "ln1": norm_specs(cfg.replace(d_model=2 * d)),
            "wq": ParamSpec((2 * d, Hh, dh), ("embed", "heads", None)),
            "wk": ParamSpec((2 * d, Hkv, dh), ("embed", "kv_heads", None)),
            "wv": ParamSpec((2 * d, Hkv, dh), ("embed", "kv_heads", None)),
            "wo": ParamSpec((Hh, dh, d), ("heads", None, "embed")),
            "ln2": norm_specs(cfg.replace(d_model=2 * d)),
            "w1": ParamSpec((2 * d, ff), ("embed", "mlp")),
            "w3": ParamSpec((2 * d, ff), ("embed", "mlp")),
            "w2": ParamSpec((ff, d), ("mlp", "embed")),
        }

    def _lora_specs(self):
        """Per-invocation adapters (stacked over n_groups)."""
        cfg = self.cfg
        d, r = cfg.d_model, cfg.shared_lora_rank
        Hh, dh = cfg.n_heads, cfg.head_dim
        return {
            "q_a": ParamSpec((2 * d, r), ("embed", None), scale=0.01),
            "q_b": ParamSpec((r, Hh * dh), (None, "heads"), scale=0.01),
            "m_a": ParamSpec((2 * d, r), ("embed", None), scale=0.01),
            "m_b": ParamSpec((r, cfg.d_ff), (None, "mlp"), scale=0.01),
        }

    def param_specs(self):
        specs = {
            "embed": embed_specs(self.cfg),
            "mamba_g": _stack(self.n_groups, _stack(self.period, self._mamba_specs())),
            "shared": self._shared_specs(),
            "lora": _stack(self.n_groups, self._lora_specs()),
            "final_norm": norm_specs(self.cfg),
        }
        if self.n_extra:
            specs["mamba_x"] = _stack(self.n_extra, self._mamba_specs())
        return specs

    # ------------------------------------------------------------------
    # Mamba2 block (the mixer: ``mamba.Mamba2Mixer``)
    # ------------------------------------------------------------------
    def _mamba_block(self, lp, x, delta, dt, rules=None):
        """Full-sequence Mamba block on the residual ``x`` plus the
        previous block's output ``delta`` (None: nothing pending), the
        add folded into the block's norm -> (the residual x + delta, the
        block's output, not yet added, ssm state, conv state of the last
        K - 1 conv inputs)."""
        x, h = apply_add_norm(lp["ln"], x, delta, self.cfg, rules)
        out, new_ssm, conv = self.mixer.forward(lp, h, dt, rules)
        return x, out, new_ssm, conv

    def _mamba_step(self, lp, x, delta, conv_state, ssm_state, dt, rules=None):
        """Single-token Mamba block on ``x + delta``, as
        :meth:`_mamba_block`: -> (the residual, the block's output, not
        yet added, conv state, ssm state).  conv_state: [B, K-1,
        conv_dim]."""
        x, h = apply_add_norm(lp["ln"], x, delta, self.cfg, rules)
        out, conv, new_ssm = self.mixer.step(lp, h, conv_state, ssm_state, dt, rules)
        return x, out, conv, new_ssm

    # ------------------------------------------------------------------
    # Shared attention block
    # ------------------------------------------------------------------
    def _shared_in(self, sp, lora, x, emb0, dt, rules=None):
        """The block's input ``u = [x, emb0]``, its ln1 output h, and q
        (with the invocation's LoRA), k, v before RoPE."""
        u = torch.cat([x, emb0], dim=-1)
        h = apply_norm(sp["ln1"], u, self.cfg, rules)
        q = _proj(h, sp["wq"], dt, rules, _Q)
        qa = use_weight(rules, lora["q_a"], (None, None), dt)
        q = q + ((h @ qa) @ use_weight(rules, lora["q_b"], (None, "heads"), dt)).reshape(
            q.shape
        )
        k, v = _proj(h, sp["wk"], dt, rules, _KV), _proj(h, sp["wv"], dt, rules, _KV)
        return u, q, k, v

    def _shared_mlp(self, sp, lora, u, dt, rules=None):
        h2 = apply_norm(sp["ln2"], u, self.cfg, rules)
        m = h2 @ use_weight(rules, sp["w1"], (None, "mlp"), dt)
        ma = use_weight(rules, lora["m_a"], (None, None), dt)
        m = m + (h2 @ ma) @ use_weight(rules, lora["m_b"], (None, "mlp"), dt)
        m = F.silu(m) * (h2 @ use_weight(rules, sp["w3"], (None, "mlp"), dt))
        return m @ use_weight(rules, sp["w2"], ("mlp", None), dt)

    def _shared_block(self, sp, lora, x, emb0, dt, tables, rules=None):
        """-> (x + a, the MLP's output, not yet added, k, v): the
        reference's ``x + a + mlp`` with its second add left to the
        next norm."""
        u, q, k, v = self._shared_in(sp, lora, x, emb0, dt, rules)
        q, k = apply_rope(q, tables), apply_rope(k, tables)
        o = _attend(q, k, v, True, self.cfg, rules)
        a = _out(o, sp["wo"], dt, rules)
        return x + a, self._shared_mlp(sp, lora, u, dt, rules), k, v

    def _shared_step(self, sp, lora, x, emb0, kc, vc, lengths, dt, tables,
                     rules=None):
        """One token; writes its K/V into ``kc``/``vc`` at ``lengths``
        (clamped into the cache)."""
        u, q, k, v = self._shared_in(sp, lora, x, emb0, dt, rules)
        q, k = apply_rope(q, tables), apply_rope(k, tables)
        B_, S = kc.shape[0], kc.shape[1]
        pos = lengths.clamp(0, S - 1).long()
        rows = None if rules else torch.arange(B_, device=lengths.device)
        cache_write(kc, pos, k[:, 0], rules, rows)
        cache_write(vc, pos, v[:, 0], rules, rows)
        o = _decode_attend(q[:, 0], kc, vc, lengths + 1, self.cfg, rules)
        a = _out(o, sp["wo"], dt, rules)[:, None, :]
        return x + a, self._shared_mlp(sp, lora, u, dt, rules)

    # ------------------------------------------------------------------
    def _forward(self, params, tokens, cache=None, rules=None):
        """``params`` already through ``cast_tree``.  With ``cache`` (of
        :meth:`cache_specs`), the states and K/V are written into it."""
        cfg = self.cfg
        dt = cdtype(cfg)
        emb0 = embed_tokens(params["embed"], tokens, cfg, rules)
        x = emb0
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        groups = _unstack(params["mamba_g"], self.n_groups)
        loras = _unstack(params["lora"], self.n_groups)
        delta = None  # a block's output, added by the next norm
        for g, (gp, lora) in enumerate(zip(groups, loras)):
            for j, lp in enumerate(_unstack(gp, self.period)):
                x, delta, ssm, conv = self._remat(
                    self._mamba_block, lp, x, delta, dt, rules
                )
                if cache is not None:
                    cache["ssm_g"][g, j] = constrain(rules, ssm, *SSM_AXES)
                    cache["conv_g"][g, j] = constrain(rules, conv, *CONV_AXES)
            # the shared block reads the sum through its concatenation
            x = x + delta
            x, delta, k, v = self._shared_block(
                params["shared"], lora, x, emb0, dt, tables, rules
            )
            if cache is not None:
                cache_prefix(cache["attn_k"][g], k, rules)
                cache_prefix(cache["attn_v"][g], v, rules)
        for j, lp in enumerate(_unstack(params.get("mamba_x", {}), self.n_extra)):
            x, delta, ssm, conv = self._remat(self._mamba_block, lp, x, delta, dt, rules)
            if cache is not None:
                cache["ssm_x"][j] = constrain(rules, ssm, *SSM_AXES)
                cache["conv_x"][j] = constrain(rules, conv, *CONV_AXES)
        return apply_add_norm(params["final_norm"], x, delta, cfg, rules)[1]

    def forward(self, params, tokens, collect_state: bool = False):
        """tokens [B, S] -> (hidden [B, S, d], (ssm, conv, k, v) of the
        groups, (ssm, conv) of the extra layers), the states None unless
        ``collect_state``, as the reference returns them."""
        B, S = tokens.shape
        cache = self.init_cache(B, S, tokens.device) if collect_state else None
        x = self._forward(cast_tree(params, cdtype(self.cfg)), tokens, cache=cache)
        if cache is None:
            return x, None, None
        ys = tuple(cache[k] for k in ("ssm_g", "conv_g", "attn_k", "attn_v"))
        ys_x = (cache["ssm_x"], cache["conv_x"]) if self.n_extra else None
        return x, ys, ys_x

    def loss(self, params, batch, rules=None):
        """The mean cross-entropy of ``batch["labels"]`` (the reference's
        ``zamba.py:311-317``): (ce, {"ce": ce}); each Mamba block under
        ``_remat`` and the shared block plainly, as the reference's
        scans run them."""
        with sharded_region(rules):
            params = cast_tree(params, cdtype(self.cfg))
            x = self._forward(params, batch["tokens"], rules=rules)
            return self._mean_ce(params, x, batch["labels"], rules)

    # ------------------------------------------------------------------
    def cache_specs(self, batch_size: int, seq_len: int):
        cfg = self.cfg
        dt = cdtype(cfg)
        Gn, Pd = self.n_groups, self.period
        Hkv, dh = cfg.n_kv_heads, cfg.head_dim
        kv = ParamSpec(
            (Gn, batch_size, seq_len, Hkv, dh),
            (None, "batch", "cache_seq", "cache_heads", None),
            "zeros",
            dtype=dt,
        )
        ssm_g, conv_g = self.mixer.state_specs((Gn, Pd), batch_size, dt)
        specs = {
            "ssm_g": ssm_g,
            "conv_g": conv_g,
            "attn_k": kv,
            "attn_v": kv,
            "lengths": ParamSpec((batch_size,), ("batch",), "zeros", dtype=torch.int32),
        }
        if self.n_extra:
            specs["ssm_x"], specs["conv_x"] = self.mixer.state_specs(
                (self.n_extra,), batch_size, dt
            )
        return specs

    @torch.inference_mode()
    def prefill(self, params, batch, rules=None, max_seq: Optional[int] = None):
        """Full-sequence prefill -> (cache with K/V padded to max_seq,
        last logits [B, V])."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_seq = max_seq or S
        if S > max_seq:
            raise ValueError(f"prompt of {S} tokens past max_seq={max_seq}")
        with serving_region(rules):
            params = cast_tree(params, cdtype(self.cfg))
            cache = self.init_cache(B, max_seq, local_device(tokens), rules)
            x = self._forward(params, tokens, cache=cache, rules=rules)
            cache["lengths"].fill_(S)
            logits = unembed(params["embed"], x[:, -1:], self.cfg, rules)
            return cache, logits[:, 0]

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens, rules=None):
        """tokens [B, 1] -> (cache', logits [B, V]), states and K/V
        written in place."""
        with serving_region(rules):
            return self._decode_step(params, cache, tokens, rules)

    def _decode_step(self, params, cache, tokens, rules):
        cfg = self.cfg
        dt = cdtype(cfg)
        emb0 = embed_tokens(params["embed"], tokens, cfg, rules)
        x = emb0
        lengths = cache["lengths"]
        tables = rope_tables(lengths[:, None], cfg.head_dim, cfg.rope_theta)
        groups = _unstack(params["mamba_g"], self.n_groups)
        loras = _unstack(params["lora"], self.n_groups)
        ssm_g, conv_g = cache["ssm_g"], cache["conv_g"]
        delta = None  # a block's output, added by the next norm
        for g, (gp, lora) in enumerate(zip(groups, loras)):
            for j, lp in enumerate(_unstack(gp, self.period)):
                x, delta, conv, ssm = self._mamba_step(
                    lp, x, delta, conv_g[g, j], ssm_g[g, j], dt, rules
                )
                ssm_g[g, j] = constrain(rules, ssm, *SSM_AXES)
                conv_g[g, j] = constrain(rules, conv, *CONV_AXES)
            x = x + delta  # read through the shared block's concatenation
            x, delta = self._shared_step(
                params["shared"],
                lora,
                x,
                emb0,
                cache["attn_k"][g],
                cache["attn_v"][g],
                lengths,
                dt,
                tables,
                rules,
            )
        for j, lp in enumerate(_unstack(params.get("mamba_x", {}), self.n_extra)):
            conv, ssm = cache["conv_x"][j], cache["ssm_x"][j]
            x, delta, conv, ssm = self._mamba_step(lp, x, delta, conv, ssm, dt, rules)
            cache["ssm_x"][j] = constrain(rules, ssm, *SSM_AXES)
            cache["conv_x"][j] = constrain(rules, conv, *CONV_AXES)
        _, x = apply_add_norm(params["final_norm"], x, delta, cfg, rules)
        logits = unembed(params["embed"], x, cfg, rules)
        return dict(cache, lengths=lengths + 1), logits[:, 0]
