"""RWKV6 "Finch", attention-free with a data-dependent decay: the port
of ``repro.models.rwkv.Rwkv6LM``.

Per layer a time-mix block (token-shift ddlerp mixing, LoRA-modulated
per-channel decay w, bonus u, the WKV recurrence, per-head GroupNorm,
silu(g) gate) and a channel-mix block (token shift, squared-ReLU FFN
with a receptance gate).  The WKV recurrence runs through
:func:`repro_torch.kernels.ops.rwkv6` in prefill (the CUDA kernel on the
card) and :func:`~repro_torch.kernels.ops.rwkv6_step` in decode.  The
decode state is O(1) per layer: the ``[H, N, N]`` fp32 WKV state and
the two token-shift vectors.

API as ``transformer.DecoderLM``'s; ``loss`` returns the mean
cross-entropy alone, as the reference's does.  The reference's two cast points
are kept: prefill rounds every leaf to the compute dtype first
(``cast_tree``, ``rwkv.py:181-182``); decode uses the stored leaves and
casts at use, so ``u``, ``w_base``, ``w_lora_b`` and the GroupNorm
affine stay fp32 there (``rwkv.py:277-283``).  ``prepare`` casts every
other weight once.  ``decode_step`` writes the new state into the cache
in place (the reference returns a new cache): the same values.  Each
residual add is folded into the norm after it (``apply_add_norm``: the
sum bit for bit the reference's, one kernel launch on the card); the
token shifts keep the norms' outputs, as the reference's do.

With ``rules`` (``layers``' docstring) the weights go through
``use_weight`` at the reference's 14 sites, and the LoRA weights of the
mixing and the decay too, gathered whole at use (the reference leaves
their layout to GSPMD; DTensor would otherwise shard their small
products over ``model`` and fail to split them by head); the WKV scan
runs under ``local`` over each rank's (batch, ``rwkv_heads``) shard.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import ArchConfig
from ..kernels import ops
from .base import LMBase, _stack, _unstack
from .layers import (
    apply_add_norm,
    cast_tree,
    cdtype,
    embed_specs,
    embed_tokens,
    norm_specs,
    ops_impl,
    unembed,
)
from ..sharding import (
    constrain,
    local,
    local_device,
    serving_region,
    sharded_region,
    sharded_zeros,
    use_weight,
)
from .spec import ParamSpec

__all__ = ["Rwkv6LM"]

_HEADS = ("batch", None, "rwkv_heads", None)  # [B, T, H, N]
_STATE = ("batch", "rwkv_heads", None, None)  # [B, H, N, N]

_LORA_MIX = 32  # rank of the ddlerp mixing LoRA
_LORA_W = 64  # rank of the decay LoRA


class Rwkv6LM(LMBase):
    FP32_KEYS = ("ln", "final_norm", "u", "w_base", "w_lora_b", "gn_w", "gn_b")

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        if not cfg.rwkv:
            raise ValueError(f"{cfg.name}: not an RWKV configuration")
        self.N = 64  # rwkv6 head size
        if cfg.d_model % self.N:
            raise ValueError(f"{cfg.name}: d_model {cfg.d_model} not a multiple of 64")
        self.H = cfg.d_model // self.N

    # ------------------------------------------------------------------
    def _layer_specs(self):
        cfg = self.cfg
        d, ff = cfg.d_model, cfg.d_ff
        H, N, r = self.H, self.N, _LORA_MIX
        tm = {
            "ln": norm_specs(cfg),
            "mu_x": ParamSpec((d,), (None,), "zeros"),
            "mu": ParamSpec((5, d), (None, None), "zeros"),  # r,k,v,g,w
            "lora_a": ParamSpec((d, 5 * r), ("embed", None), scale=0.01),
            "lora_b": ParamSpec((5, r, d), (None, None, "embed"), scale=0.01),
            "wr": ParamSpec((d, d), ("embed", "rwkv_heads")),
            "wk": ParamSpec((d, d), ("embed", "rwkv_heads")),
            "wv": ParamSpec((d, d), ("embed", "rwkv_heads")),
            "wg": ParamSpec((d, d), ("embed", "rwkv_heads")),
            "w_base": ParamSpec((d,), (None,), "constant", scale=-2.0),
            "w_lora_a": ParamSpec((d, _LORA_W), ("embed", None), scale=0.01),
            "w_lora_b": ParamSpec((_LORA_W, d), (None, "embed"), scale=0.01),
            "u": ParamSpec((H, N), (None, None), scale=0.1),
            "gn_w": ParamSpec((d,), (None,), "ones"),
            "gn_b": ParamSpec((d,), (None,), "zeros"),
            "wo": ParamSpec((d, d), ("rwkv_heads", "embed")),
        }
        cm = {
            "ln": norm_specs(cfg),
            "mu_k": ParamSpec((d,), (None,), "zeros"),
            "mu_r": ParamSpec((d,), (None,), "zeros"),
            "wk": ParamSpec((d, ff), ("embed", "mlp")),
            "wv": ParamSpec((ff, d), ("mlp", "embed")),
            "wr": ParamSpec((d, d), ("embed", None)),
        }
        return {"tm": tm, "cm": cm}

    def param_specs(self):
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            "layers": _stack(cfg.n_layers, self._layer_specs()),
            "final_norm": norm_specs(cfg),
        }

    # ------------------------------------------------------------------
    def _ddlerp(self, p, x, xs, dt, rules=None):
        """Data-dependent lerp producing the 5 mixed inputs (r,k,v,g,w)."""
        dx = xs - x
        xxx = x + dx * p["mu_x"].to(dt)
        low = torch.tanh(xxx @ use_weight(rules, p["lora_a"], (None, None), dt))
        B, T = x.shape[0], x.shape[1]
        low = low.reshape(B, T, 5, _LORA_MIX)
        lora_b = use_weight(rules, p["lora_b"], (None, None, None), dt)
        dyn = torch.einsum("btir,ird->btid", low, lora_b)
        mix = p["mu"].to(dt)[None, None] + dyn  # [B, T, 5, d]
        return x[:, :, None, :] + dx[:, :, None, :] * mix

    def _rkvgw(self, p, x, xs, dt, rules=None):
        """r, k, v (``[B, T, d]``), the gate g and the fp32 decay w."""
        m = self._ddlerp(p, x, xs, dt, rules)
        xr, xk, xv, xg, xw = m.unbind(2)
        ax = (None, "rwkv_heads")
        r = xr @ use_weight(rules, p["wr"], ax, dt)
        k = xk @ use_weight(rules, p["wk"], ax, dt)
        v = xv @ use_weight(rules, p["wv"], ax, dt)
        g = F.silu(xg @ use_weight(rules, p["wg"], ax, dt))
        lora = torch.tanh(xw @ use_weight(rules, p["w_lora_a"], (None, None), dt))
        w_lora_b = use_weight(rules, p["w_lora_b"], (None, None), torch.float32)
        w_raw = p["w_base"].float() + lora.float() @ w_lora_b
        w = torch.exp(-torch.exp(torch.clamp(w_raw, -8.0, 4.0)))
        return r, k, v, g, w

    def _group_norm_out(self, p, o, g, dt, rules=None):
        """Per-head GroupNorm (eps 64e-5) in fp32, the gate, then wo."""
        of = o.float()
        mu = of.mean(-1, keepdim=True)
        var = of.var(-1, keepdim=True, correction=0)
        of = (of - mu) * torch.rsqrt(var + 64e-5)
        of = of.reshape(*g.shape) * p["gn_w"].float() + p["gn_b"].float()
        return (of.to(dt) * g) @ use_weight(rules, p["wo"], ("rwkv_heads", None), dt)

    def _time_mix(self, p, x, xs, state, dt, rules=None):
        B, T, _ = x.shape
        H, N = self.H, self.N
        r, k, v, g, w = self._rkvgw(p, x, xs, dt, rules)
        scan = local(
            rules,
            lambda *a: ops.rwkv6(*a, chunk=self.cfg.rwkv_chunk, impl=ops_impl(self.cfg)),
            [_HEADS, _STATE],
            (_HEADS,) * 4 + (("rwkv_heads", None), _STATE),
        )
        o, new_state = scan(
            r.reshape(B, T, H, N),
            k.reshape(B, T, H, N),
            v.reshape(B, T, H, N),
            w.reshape(B, T, H, N),
            p["u"].float(),
            state,
        )
        return self._group_norm_out(p, o, g, dt, rules), new_state

    def _time_mix_step(self, p, x, xs, state, dt, rules=None):
        """Single-token time mix (decode)."""
        B = x.shape[0]
        H, N = self.H, self.N
        r, k, v, g, w = self._rkvgw(p, x, xs, dt, rules)
        step = local(
            rules, ops.rwkv6_step, [_STATE[:3], _STATE],
            (_STATE[:3],) * 4 + (("rwkv_heads", None), _STATE),
        )
        o, new_state = step(
            r.reshape(B, H, N),
            k.reshape(B, H, N),
            v.reshape(B, H, N),
            w.reshape(B, H, N),
            p["u"].float(),
            state,
        )
        return self._group_norm_out(p, o, g, dt, rules), new_state

    def _channel_mix(self, p, x, xs, dt, rules=None):
        dx = xs - x
        xk = x + dx * p["mu_k"].to(dt)
        xr = x + dx * p["mu_r"].to(dt)
        k = torch.square(F.relu(xk @ use_weight(rules, p["wk"], (None, "mlp"), dt)))
        kv = k @ use_weight(rules, p["wv"], ("mlp", None), dt)
        return torch.sigmoid(xr @ use_weight(rules, p["wr"], (None, None), dt)) * kv

    @staticmethod
    def _shift(x, last):
        """Token shift: ``[last, x_0 .. x_{T-2}]``; last: [B, 1, d]."""
        return torch.cat([last, x[:, :-1]], dim=1)

    def _forward(self, params, tokens, rules=None):
        """``params`` already through ``cast_tree``.  Returns the final
        hidden states and each layer's (wkv state, last ln1 output,
        last ln2 output)."""
        cfg = self.cfg
        dt = cdtype(cfg)
        x = embed_tokens(params["embed"], tokens, cfg, rules)
        B = tokens.shape[0]
        dev = local_device(x)
        z_state = sharded_zeros(rules, (B, self.H, self.N, self.N), _STATE,
                                torch.float32, dev)
        z_last = sharded_zeros(rules, (B, 1, cfg.d_model), ("batch", None, None), dt, dev)
        states, delta = [], None  # delta: a block's output, added by the next norm
        for lp in _unstack(params["layers"], cfg.n_layers):
            x, delta, state = self._remat(
                self._layer, lp, x, delta, z_state, z_last, rules
            )
            states.append(state)
        return apply_add_norm(params["final_norm"], x, delta, cfg, rules)[1], states

    def _layer(self, lp, x, delta, z_state, z_last, rules=None):
        """One layer on the residual ``x`` plus the previous layer's
        output ``delta``: -> (the residual, this layer's channel-mix
        output, not yet added, (wkv state, last ln1 output, last ln2
        output))."""
        cfg = self.cfg
        dt = cdtype(cfg)
        x, h = apply_add_norm(lp["tm"]["ln"], x, delta, cfg, rules)
        a, wkv = self._time_mix(lp["tm"], h, self._shift(h, z_last), z_state, dt, rules)
        x, h2 = apply_add_norm(lp["cm"]["ln"], x, a, cfg, rules)
        delta = self._channel_mix(lp["cm"], h2, self._shift(h2, z_last), dt, rules)
        return x, delta, (wkv, h[:, -1:], h2[:, -1:])

    def forward(self, params, tokens, collect_state: bool = False):
        """tokens [B, T] -> (hidden [B, T, d], (wkv, tm_last, cm_last)
        stacked over layers, or None)."""
        x, states = self._forward(cast_tree(params, cdtype(self.cfg)), tokens)
        if not collect_state:
            return x, None
        return x, tuple(torch.stack(s) for s in zip(*states))

    def loss(self, params, batch, rules=None):
        """The mean cross-entropy of ``batch["labels"]`` (the reference's
        ``rwkv.py:195-201``): (ce, {"ce": ce}); each layer under
        ``_remat``, as the reference's ``scan_stack`` runs it."""
        with sharded_region(rules):
            params = cast_tree(params, cdtype(self.cfg))
            x, _ = self._forward(params, batch["tokens"], rules)
            return self._mean_ce(params, x, batch["labels"], rules)

    # ------------------------------------------------------------------
    def cache_specs(self, batch_size: int, seq_len: int):
        """O(1) state: ``seq_len`` only bounds the step counter."""
        cfg = self.cfg
        dt = cdtype(cfg)
        L, d = cfg.n_layers, cfg.d_model
        last = ParamSpec(
            (L, batch_size, 1, d), (None, "batch", None, None), "zeros", dtype=dt
        )
        return {
            "wkv": ParamSpec(
                (L, batch_size, self.H, self.N, self.N),
                (None, "batch", "rwkv_heads", None, None),
                "zeros",
                dtype=torch.float32,
            ),
            "tm_last": last,
            "cm_last": last,
            "lengths": ParamSpec((batch_size,), ("batch",), "zeros", dtype=torch.int32),
        }

    @torch.inference_mode()
    def prefill(self, params, batch, rules=None, max_seq: Optional[int] = None):
        """Full-sequence prefill -> (cache, last logits [B, V]).  The
        state does not grow with the prompt, so ``max_seq`` bounds
        nothing here (the reference ignores it too)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        with serving_region(rules):
            params = cast_tree(params, cdtype(self.cfg))
            x, states = self._forward(params, tokens, rules)
            wkv, tm_last, cm_last = (torch.stack(s) for s in zip(*states))
            last = (None, "batch", None, None)
            cache = {
                "wkv": constrain(rules, wkv, None, *_STATE),
                "tm_last": constrain(rules, tm_last, *last),
                "cm_last": constrain(rules, cm_last, *last),
                "lengths": torch.full_like(tokens[:, 0], S, dtype=torch.int32),
            }
            logits = unembed(params["embed"], x[:, -1:], self.cfg, rules)
            return cache, logits[:, 0]

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens, rules=None):
        """tokens [B, 1] -> (cache', logits [B, V]), the state updated in
        place."""
        with serving_region(rules):
            return self._decode_step(params, cache, tokens, rules)

    def _decode_step(self, params, cache, tokens, rules):
        cfg = self.cfg
        dt = cdtype(cfg)
        x = embed_tokens(params["embed"], tokens, cfg, rules)
        wkv, tm_last, cm_last = cache["wkv"], cache["tm_last"], cache["cm_last"]
        last = ("batch", None, None)
        delta = None  # a block's output, added by the next norm
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x, h = apply_add_norm(lp["tm"]["ln"], x, delta, cfg, rules)
            a, wkv_new = self._time_mix_step(lp["tm"], h, tm_last[i], wkv[i], dt, rules)
            x, h2 = apply_add_norm(lp["cm"]["ln"], x, a, cfg, rules)
            delta = self._channel_mix(lp["cm"], h2, cm_last[i], dt, rules)
            wkv[i] = constrain(rules, wkv_new, *_STATE)
            # the token shifts keep the norms' outputs
            tm_last[i] = constrain(rules, h, *last)
            cm_last[i] = constrain(rules, h2, *last)
        _, x = apply_add_norm(params["final_norm"], x, delta, cfg, rules)
        logits = unembed(params["embed"], x, cfg, rules)
        return dict(cache, lengths=cache["lengths"] + 1), logits[:, 0]
