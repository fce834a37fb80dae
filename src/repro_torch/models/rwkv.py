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
from .spec import ParamSpec

__all__ = ["Rwkv6LM"]

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
    def _ddlerp(self, p, x, xs, dt):
        """Data-dependent lerp producing the 5 mixed inputs (r,k,v,g,w)."""
        dx = xs - x
        xxx = x + dx * p["mu_x"].to(dt)
        low = torch.tanh(xxx @ p["lora_a"].to(dt))
        B, T = x.shape[0], x.shape[1]
        low = low.reshape(B, T, 5, _LORA_MIX)
        dyn = torch.einsum("btir,ird->btid", low, p["lora_b"].to(dt))
        mix = p["mu"].to(dt)[None, None] + dyn  # [B, T, 5, d]
        return x[:, :, None, :] + dx[:, :, None, :] * mix

    def _rkvgw(self, p, x, xs, dt):
        """r, k, v (``[B, T, d]``), the gate g and the fp32 decay w."""
        m = self._ddlerp(p, x, xs, dt)
        xr, xk, xv, xg, xw = m.unbind(2)
        r = xr @ p["wr"].to(dt)
        k = xk @ p["wk"].to(dt)
        v = xv @ p["wv"].to(dt)
        g = F.silu(xg @ p["wg"].to(dt))
        lora = torch.tanh(xw @ p["w_lora_a"].to(dt))
        w_raw = p["w_base"].float() + lora.float() @ p["w_lora_b"].float()
        w = torch.exp(-torch.exp(torch.clamp(w_raw, -8.0, 4.0)))
        return r, k, v, g, w

    def _group_norm_out(self, p, o, g, dt):
        """Per-head GroupNorm (eps 64e-5) in fp32, the gate, then wo."""
        of = o.float()
        mu = of.mean(-1, keepdim=True)
        var = of.var(-1, keepdim=True, correction=0)
        of = (of - mu) * torch.rsqrt(var + 64e-5)
        of = of.reshape(*g.shape) * p["gn_w"].float() + p["gn_b"].float()
        return (of.to(dt) * g) @ p["wo"].to(dt)

    def _time_mix(self, p, x, xs, state, dt):
        B, T, _ = x.shape
        H, N = self.H, self.N
        r, k, v, g, w = self._rkvgw(p, x, xs, dt)
        o, new_state = ops.rwkv6(
            r.reshape(B, T, H, N),
            k.reshape(B, T, H, N),
            v.reshape(B, T, H, N),
            w.reshape(B, T, H, N),
            p["u"].float(),
            state,
            chunk=self.cfg.rwkv_chunk,
            impl=ops_impl(self.cfg),
        )
        return self._group_norm_out(p, o, g, dt), new_state

    def _time_mix_step(self, p, x, xs, state, dt):
        """Single-token time mix (decode)."""
        B = x.shape[0]
        H, N = self.H, self.N
        r, k, v, g, w = self._rkvgw(p, x, xs, dt)
        o, new_state = ops.rwkv6_step(
            r.reshape(B, H, N),
            k.reshape(B, H, N),
            v.reshape(B, H, N),
            w.reshape(B, H, N),
            p["u"].float(),
            state,
        )
        return self._group_norm_out(p, o, g, dt), new_state

    def _channel_mix(self, p, x, xs, dt):
        dx = xs - x
        xk = x + dx * p["mu_k"].to(dt)
        xr = x + dx * p["mu_r"].to(dt)
        k = torch.square(F.relu(xk @ p["wk"].to(dt)))
        kv = k @ p["wv"].to(dt)
        return torch.sigmoid(xr @ p["wr"].to(dt)) * kv

    @staticmethod
    def _shift(x, last):
        """Token shift: ``[last, x_0 .. x_{T-2}]``; last: [B, 1, d]."""
        return torch.cat([last, x[:, :-1]], dim=1)

    def _forward(self, params, tokens):
        """``params`` already through ``cast_tree``.  Returns the final
        hidden states and each layer's (wkv state, last ln1 output,
        last ln2 output)."""
        cfg = self.cfg
        dt = cdtype(cfg)
        x = embed_tokens(params["embed"], tokens, cfg)
        B = tokens.shape[0]
        z_state = torch.zeros(B, self.H, self.N, self.N, device=x.device)
        z_last = torch.zeros(B, 1, cfg.d_model, dtype=dt, device=x.device)
        states, delta = [], None  # delta: a block's output, added by the next norm
        for lp in _unstack(params["layers"], cfg.n_layers):
            x, delta, state = self._remat(self._layer, lp, x, delta, z_state, z_last)
            states.append(state)
        return apply_add_norm(params["final_norm"], x, delta, cfg)[1], states

    def _layer(self, lp, x, delta, z_state, z_last):
        """One layer on the residual ``x`` plus the previous layer's
        output ``delta``: -> (the residual, this layer's channel-mix
        output, not yet added, (wkv state, last ln1 output, last ln2
        output))."""
        cfg = self.cfg
        dt = cdtype(cfg)
        x, h = apply_add_norm(lp["tm"]["ln"], x, delta, cfg)
        a, wkv = self._time_mix(lp["tm"], h, self._shift(h, z_last), z_state, dt)
        x, h2 = apply_add_norm(lp["cm"]["ln"], x, a, cfg)
        delta = self._channel_mix(lp["cm"], h2, self._shift(h2, z_last), dt)
        return x, delta, (wkv, h[:, -1:], h2[:, -1:])

    def forward(self, params, tokens, collect_state: bool = False):
        """tokens [B, T] -> (hidden [B, T, d], (wkv, tm_last, cm_last)
        stacked over layers, or None)."""
        x, states = self._forward(cast_tree(params, cdtype(self.cfg)), tokens)
        if not collect_state:
            return x, None
        return x, tuple(torch.stack(s) for s in zip(*states))

    def loss(self, params, batch):
        """The mean cross-entropy of ``batch["labels"]`` (the reference's
        ``rwkv.py:195-201``): (ce, {"ce": ce}); each layer under
        ``_remat``, as the reference's ``scan_stack`` runs it."""
        x, _ = self.forward(params, batch["tokens"])
        return self._mean_ce(params, x, batch["labels"])

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
    def prefill(self, params, batch, max_seq: Optional[int] = None):
        """Full-sequence prefill -> (cache, last logits [B, V]).  The
        state does not grow with the prompt, so ``max_seq`` bounds
        nothing here (the reference ignores it too)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        params = cast_tree(params, cdtype(self.cfg))
        x, states = self._forward(params, tokens)
        wkv, tm_last, cm_last = (torch.stack(s) for s in zip(*states))
        cache = {
            "wkv": wkv,
            "tm_last": tm_last,
            "cm_last": cm_last,
            "lengths": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
        }
        logits = unembed(params["embed"], x[:, -1:], self.cfg)
        return cache, logits[:, 0]

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens):
        """tokens [B, 1] -> (cache', logits [B, V]), the state updated in
        place."""
        cfg = self.cfg
        dt = cdtype(cfg)
        x = embed_tokens(params["embed"], tokens, cfg)
        wkv, tm_last, cm_last = cache["wkv"], cache["tm_last"], cache["cm_last"]
        delta = None  # a block's output, added by the next norm
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x, h = apply_add_norm(lp["tm"]["ln"], x, delta, cfg)
            a, wkv_new = self._time_mix_step(lp["tm"], h, tm_last[i], wkv[i], dt)
            x, h2 = apply_add_norm(lp["cm"]["ln"], x, a, cfg)
            delta = self._channel_mix(lp["cm"], h2, cm_last[i], dt)
            wkv[i] = wkv_new
            tm_last[i] = h  # the token shifts keep the norms' outputs
            cm_last[i] = h2
        _, x = apply_add_norm(params["final_norm"], x, delta, cfg)
        logits = unembed(params["embed"], x, cfg)
        return dict(cache, lengths=cache["lengths"] + 1), logits[:, 0]
