"""The Mamba-2 mixer the port's hybrids share (``zamba.ZambaLM``,
``granite.GraniteHybridLM``): in_proj -> [z | xBC | dt], a causal
depthwise conv of width 4 with bias over xBC, SiLU, the SSD scan
(:func:`repro_torch.kernels.ops.ssd`: the CUDA kernel on the card, in
prefill and, with one token, in decode), the D skip, the gated RMSNorm
over the whole inner width, out_proj.

The gated norm comes in two orders: zamba2's normalises and then gates,
``(rms(y) w) silu(z)``; granite-4.0-h's (``cfg.mamba_gate_first``) gates
and then normalises, ``rms(y silu(z)) w``; both in fp32, cast to the
compute dtype after the weight.

A mixer holds the config's widths alone; its weights come per call as
the layer's leaves (``specs()``'s keys; other keys of the layer, such as
its norm, are ignored).  With ``rules`` the scan runs under ``local``
over each rank's (batch, ``ssm_heads``) shard, the weights go through
``use_weight`` and the states through ``constrain``, as ``zamba.py``'s
docstring sets out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ArchConfig
from ..kernels import ops
from ..sharding import constrain, local, local_device, sharded_zeros, use_weight
from .layers import ops_impl
from .spec import ParamSpec

__all__ = ["Mamba2Mixer", "CONV_K", "SSM_AXES", "CONV_AXES"]

SSM_AXES = ("batch", "ssm_heads", None, None)  # [B, H, P, N]
CONV_AXES = ("batch", None, "ssm_inner")  # [B, K - 1, conv_dim]

CONV_K = 4  # mamba short-conv window


class Mamba2Mixer:
    """The widths of one Mamba-2 mixer of ``cfg``: ``d_in`` inner width,
    ``H`` heads of ``P``, one B/C group of state width ``N``."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.d_in = cfg.ssm_expand * cfg.d_model
        self.P = cfg.ssm_head_dim
        if self.d_in % self.P:
            raise ValueError(f"{cfg.name}: d_inner {self.d_in} not a multiple of P")
        self.H = self.d_in // self.P  # ssm heads
        self.G = 1  # B/C groups
        self.N = cfg.ssm_state
        self.conv_dim = self.d_in + 2 * self.G * self.N

    def specs(self):
        """The mixer's leaves (zamba2's initialiser: conv at 0.2, A_log 0,
        D 1, dt_bias -1, the gated norm's weight 1)."""
        d, d_in, H, G, N = self.cfg.d_model, self.d_in, self.H, self.G, self.N
        return {
            "in_proj": ParamSpec((d, 2 * d_in + 2 * G * N + H), ("embed", "ssm_inner")),
            "conv_w": ParamSpec((CONV_K, self.conv_dim), (None, "ssm_inner"), scale=0.2),
            "conv_b": ParamSpec((self.conv_dim,), ("ssm_inner",), "zeros"),
            "A_log": ParamSpec((H,), ("ssm_heads",), "constant", scale=0.0),
            "D": ParamSpec((H,), ("ssm_heads",), "ones"),
            "dt_bias": ParamSpec((H,), ("ssm_heads",), "constant", scale=-1.0),
            "gn_w": ParamSpec((d_in,), ("ssm_inner",), "ones"),
            "out_proj": ParamSpec((d_in, d), ("ssm_inner", "embed")),
        }

    def state_specs(self, lead: tuple, batch_size: int, conv_dtype):
        """(ssm, conv) cache specs with the leading layer dims ``lead``:
        ``[*lead, B, H, P, N]`` fp32 and ``[*lead, B, K - 1, conv_dim]``."""
        none = (None,) * len(lead)
        ssm = ParamSpec(
            lead + (batch_size, self.H, self.P, self.N),
            none + SSM_AXES,
            "zeros",
            dtype=torch.float32,
        )
        conv = ParamSpec(
            lead + (batch_size, CONV_K - 1, self.conv_dim),
            none + CONV_AXES,
            "zeros",
            dtype=conv_dtype,
        )
        return ssm, conv

    # ------------------------------------------------------------------
    def proj(self, lp, x, dt, rules=None):
        zxbcdt = x @ use_weight(rules, lp["in_proj"], (None, "ssm_inner"), dt)
        d_in, cd = self.d_in, self.conv_dim
        z, conv_in = zxbcdt[..., :d_in], zxbcdt[..., d_in : d_in + cd]
        return z, conv_in, zxbcdt[..., d_in + cd :]

    def conv(self, lp, window, T, dt):
        """Depthwise causal conv of width K over ``window`` [B, T+K-1, c]."""
        w = lp["conv_w"].to(dt)
        out = sum(window[:, i : i + T] * w[i] for i in range(CONV_K))
        return F.silu(out + lp["conv_b"].to(dt))

    def post(self, lp, conv_out, dt_raw, z, ssm_state, dt, rules=None):
        """The scan from ``ssm_state``, the gated norm and out_proj ->
        (output, new ssm state)."""
        cfg = self.cfg
        B_, T = conv_out.shape[0], conv_out.shape[1]
        d_in, G, N, H, P = self.d_in, self.G, self.N, self.H, self.P
        xc = conv_out[..., :d_in]
        Bm = conv_out[..., d_in : d_in + G * N].reshape(B_, T, G, N)
        Cm = conv_out[..., d_in + G * N :].reshape(B_, T, G, N)
        dtv = F.softplus(dt_raw.float() + lp["dt_bias"].float())
        A = -torch.exp(lp["A_log"].float())
        heads, bc = ("batch", None, "ssm_heads", None), ("batch", None, None, None)
        scan = local(
            rules,
            lambda *a: ops.ssd(*a, chunk=cfg.ssd_chunk, impl=ops_impl(cfg)),
            [heads, SSM_AXES],
            (heads, heads[:3], ("ssm_heads",), bc, bc, ("ssm_heads",), SSM_AXES),
        )
        y, new_state = scan(
            xc.reshape(B_, T, H, P),
            dtv,
            A,
            Bm,
            Cm,
            lp["D"].float(),
            ssm_state,
        )
        # gated RMSNorm (the mamba2 norm), fp32
        yf = y.reshape(B_, T, d_in).float()
        if cfg.mamba_gate_first:
            yf = yf * F.silu(z.float())
            yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + cfg.norm_eps)
            y = (yf * lp["gn_w"].float()).to(dt)
        else:
            yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + cfg.norm_eps)
            y = (yf * lp["gn_w"].float()).to(dt) * F.silu(z)
        return y @ use_weight(rules, lp["out_proj"], ("ssm_inner", None), dt), new_state

    def forward(self, lp, h, dt, rules=None):
        """The mixer over a whole sequence ``h`` [B, T, d] (normed), from
        zero states -> (output, ssm state, conv state of the last K - 1
        conv inputs)."""
        z, conv_in, dt_raw = self.proj(lp, h, dt, rules)
        B_, T = h.shape[0], h.shape[1]
        dev = local_device(h)
        ssm0 = sharded_zeros(rules, (B_, self.H, self.P, self.N), SSM_AXES,
                             torch.float32, dev)
        pad = sharded_zeros(rules, (B_, CONV_K - 1, self.conv_dim), CONV_AXES,
                            conv_in.dtype, dev)
        ci = torch.cat([pad, constrain(rules, conv_in, *CONV_AXES)], dim=1)
        conv_out = self.conv(lp, ci, T, dt)
        out, new_ssm = self.post(lp, conv_out, dt_raw, z, ssm0, dt, rules)
        return out, new_ssm, ci[:, -(CONV_K - 1) :]

    def step(self, lp, h, conv_state, ssm_state, dt, rules=None):
        """The mixer on one token ``h`` [B, 1, d] (normed) -> (output, conv
        state, ssm state).  conv_state: [B, K-1, conv_dim]."""
        z, conv_in, dt_raw = self.proj(lp, h, dt, rules)
        conv_in = constrain(rules, conv_in, *CONV_AXES)
        window = torch.cat([conv_state.to(conv_in.dtype), conv_in], dim=1)
        conv_out = self.conv(lp, window, 1, dt)
        out, new_ssm = self.post(lp, conv_out, dt_raw, z, ssm_state, dt, rules)
        return out, window[:, 1:], new_ssm
