"""Dense transformer building blocks: the port of ``repro.models.layers``.

Blocks take parameters as nested dicts of tensors (the reference's
pytree, leaf for leaf) and the compute dtype from the ``ArchConfig``.
Attention and RMSNorm dispatch through :mod:`repro_torch.kernels.ops`.
The reference's sharding constraints (``rules``) have no counterpart on
one card and are left out; the MoE block is not ported (ROADMAP.md
Queue A, item 10).

Weights are cast to the compute dtype at use, as the reference's
``use_weight`` does.  The cast is a no-op for a tree that went through
``DecoderLM.prepare`` (every weight but the norms' cast once, at load),
which gives the same values without re-reading fp32 masters per step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ArchConfig
from ..kernels import ops
from .spec import ParamSpec

__all__ = [
    "cdtype",
    "ops_impl",
    "cast_tree",
    "rope",
    "rope_tables",
    "apply_rope",
    "norm_specs",
    "apply_norm",
    "apply_add_norm",
    "attn_specs",
    "attention_block",
    "attention_decode_block",
    "decode_kv",
    "mlp_specs",
    "mlp_block",
    "embed_specs",
    "embed_tokens",
    "unembed",
]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
#: the reference's attention_impl names -> the port's ops impl
_IMPLS = {"auto": "auto", "pallas": "cuda", "xla": "plain", "naive": "plain"}


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def ops_impl(cfg: ArchConfig) -> str:
    """``cfg.attention_impl`` as an ops ``impl``: ``"auto"`` stays,
    ``"pallas"`` (the reference's kernel route) insists on the CUDA
    kernel, and the reference's plain routes ``"xla"``/``"naive"`` ask
    for the plain PyTorch version by name."""
    try:
        return _IMPLS[cfg.attention_impl]
    except KeyError:
        raise ValueError(
            f"unknown attention_impl {cfg.attention_impl!r}; expected one of "
            f"{sorted(_IMPLS)}"
        ) from None


def cast_tree(params, dt: torch.dtype):
    """Every floating leaf in the compute dtype (the reference's
    ``cast_tree`` at the top of ``forward``); a no-op per leaf already
    in it."""
    if isinstance(params, dict):
        return {k: cast_tree(v, dt) for k, v in params.items()}
    return params.to(dt) if params.is_floating_point() else params


def _w(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return w.to(dt)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """(cos, sin) of the rotary angles for ``positions`` ([B, S] or [S])
    and head dim ``dim``, each [B, S, 1, dim] with the half-dim table
    twice and the sine's first half negated, so that :func:`apply_rope`
    is two products and a sum.  A decoder computes them once per call
    and shares them across layers and between q and k."""
    half = dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(theta, exps)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs  # [B, S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (
        torch.cat([cos, cos], dim=-1)[:, :, None, :],
        torch.cat([-sin, sin], dim=-1)[:, :, None, :],
    )


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """x: [B, S, H, D].  ``[x1 cos - x2 sin, x2 cos + x1 sin]`` in fp32,
    cast back to x's dtype -- the reference's arithmetic (a - b equals
    a + (-b) exactly)."""
    cos, sin = tables
    half = x.shape[-1] // 2
    xf = x.float()
    swapped = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + swapped * sin).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D] (D even), positions: [B, S] or [S]."""
    return apply_rope(x, rope_tables(positions.to(x.device), x.shape[-1], theta))


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def norm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    return {"w": ParamSpec((cfg.d_model,), (None,), init="ones")}


def _norm_impl(cfg: ArchConfig) -> str:
    """The reference's rule (``layers.py:119-120``): the plain version
    only where the config names a plain route, else ``"auto"``."""
    return "plain" if cfg.attention_impl in ("xla", "naive") else "auto"


def apply_norm(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """RMSNorm with the weight as stored."""
    return ops.rmsnorm(x, p["w"], eps=cfg.norm_eps, impl=_norm_impl(cfg))


def apply_add_norm(
    p: Dict[str, Any],
    x: torch.Tensor,  # the residual stream
    delta: Optional[torch.Tensor],  # a block's output not yet added to it
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it: ``(s, RMSNorm(s))`` with
    ``s = x + delta`` the new residual, one kernel launch on the card
    (``ops.add_rmsnorm``).  With ``delta`` None, ``(x, apply_norm(x))``.
    The models hand a block's output on as ``delta`` instead of adding
    it, so that the next norm folds the add in; the values are the
    reference's, which adds first and normalises the sum."""
    if delta is None:
        return x, apply_norm(p, x, cfg)
    return ops.add_rmsnorm(x, delta, p["w"], eps=cfg.norm_eps, impl=_norm_impl(cfg))


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------
def attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, dh, H, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    s = {
        "wq": ParamSpec((d, H, dh), ("embed", "heads", None)),
        "wk": ParamSpec((d, Hkv, dh), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, Hkv, dh), ("embed", "kv_heads", None)),
        "wo": ParamSpec((H, dh, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, dh), ("heads", None), init="zeros")
        s["bk"] = ParamSpec((Hkv, dh), ("kv_heads", None), init="zeros")
        s["bv"] = ParamSpec((Hkv, dh), ("kv_heads", None), init="zeros")
    return s


def _proj(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return torch.matmul(x, _w(w, dt).reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o: torch.Tensor, wo: torch.Tensor, dt) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul over the flattened heads."""
    h, k, d = wo.shape
    return torch.matmul(o.flatten(-2), _w(wo, dt).reshape(h * k, d))


def _qkv(p, x: torch.Tensor, dt):
    q, k, v = _proj(x, p["wq"], dt), _proj(x, p["wk"], dt), _proj(x, p["wv"], dt)
    if "bq" in p:
        q = q + _w(p["bq"], dt)
        k = k + _w(p["bk"], dt)
        v = v + _w(p["bv"], dt)
    return q, k, v


def attention_block(
    p: Dict[str, Any],
    x: torch.Tensor,  # [B, S, d]
    cfg: ArchConfig,
    tables,  # rope_tables of the positions, shared by the layers
    causal: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence self-attention (prefill).  Returns (out, kv) where kv
    holds the roped K/V for the cache."""
    dt = cdtype(cfg)
    q, k, v = _qkv(p, x, dt)
    q = apply_rope(q, tables)
    k = apply_rope(k, tables)
    o = ops.attention(q, k, v, causal=causal, impl=ops_impl(cfg))
    return _out(o, p["wo"], dt), {"k": k, "v": v}


def attention_decode_block(
    p: Dict[str, Any],
    x: torch.Tensor,  # [B, 1, d], the new token
    k_cache: torch.Tensor,  # [B, S, Hkv, dh], this token already written
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid length INCLUDING the new token
    cfg: ArchConfig,
    tables,  # rope_tables at lengths - 1, shared by the layers
) -> torch.Tensor:  # [B, 1, d]
    dt = cdtype(cfg)
    q = _proj(x, p["wq"], dt)
    if "bq" in p:
        q = q + _w(p["bq"], dt)
    q = apply_rope(q, tables)
    o = ops.decode_attention(q[:, 0], k_cache, v_cache, lengths, impl=ops_impl(cfg))
    return _out(o, p["wo"], dt)[:, None, :]


def decode_kv(p, x: torch.Tensor, cfg: ArchConfig, tables):
    """K/V for the new token (decode): [B, 1, Hkv, dh] each, K roped by
    ``tables`` (:func:`rope_tables` at the token's position)."""
    dt = cdtype(cfg)
    k, v = _proj(x, p["wk"], dt), _proj(x, p["wv"], dt)
    if "bk" in p:
        k = k + _w(p["bk"], dt)
        v = v + _w(p["bv"], dt)
    return apply_rope(k, tables), v


# ----------------------------------------------------------------------
# Dense MLP (gated SwiGLU or plain GELU)
# ----------------------------------------------------------------------
def mlp_specs(cfg: ArchConfig, gated: bool = True) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    s = {
        "w1": ParamSpec((d, ff), ("embed", "mlp")),
        "w2": ParamSpec((ff, d), ("mlp", "embed")),
    }
    if gated:
        s["w3"] = ParamSpec((d, ff), ("embed", "mlp"))
    return s


def mlp_block(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = cdtype(cfg)
    h = torch.matmul(x, _w(p["w1"], dt))
    if "w3" in p:
        h = F.silu(h) * torch.matmul(x, _w(p["w3"], dt))
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return torch.matmul(h, _w(p["w2"], dt))


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------
def embed_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    V, d = cfg.vocab_padded(), cfg.d_model
    s = {"tok": ParamSpec((V, d), ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        s["out"] = ParamSpec((d, V), ("embed", "vocab"), scale=0.02)
    return s


def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Gather the rows, then cast: never the whole table per call."""
    return p["tok"][tokens].to(cdtype(cfg))


def unembed(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits over the padded vocabulary (``vocab_padded()``), in the
    compute dtype, as the reference returns them (padded ids unmasked)."""
    dt = cdtype(cfg)
    if "out" in p:
        return torch.matmul(x, _w(p["out"], dt))
    return torch.matmul(x, _w(p["tok"], dt).t())
