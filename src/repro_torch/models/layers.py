"""Transformer building blocks: the port of ``repro.models.layers``.

Blocks take parameters as nested dicts of tensors (the reference's
pytree, leaf for leaf) and the compute dtype from the ``ArchConfig``.
Attention and RMSNorm dispatch through :mod:`repro_torch.kernels.ops`;
the LayerNorm (Whisper's) and the MoE block's routing, dispatch and
expert products are plain PyTorch, as the reference's are plain XLA.
Every block takes the reference's ``rules`` (``repro_torch.sharding``;
None, the default, on one device).  With rules the parameters and the
batch are DTensors: weights go through ``use_weight`` and activations
through ``constrain`` at the reference's call sites, with its logical
axes, and the work that stays within a shard runs under
``sharding.local`` on plain tensors: the norms over rows, attention over
its (batch, head) shard, the decode attention over its cache shard (the
partial softmaxes of a sequence-sharded cache merged by three small
all-reduces over its axis), the cache writes, and the MoE routing,
dispatch and combine within a token group.  Without rules each block is
the one-device code, unchanged.

Weights are cast to the compute dtype at use, as the reference's
``use_weight`` does.  The cast is a no-op for a tree that went through
``DecoderLM.prepare`` (every weight but the norms' cast once, at load),
which gives the same values without re-reading fp32 masters per step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from ..config import ArchConfig
from ..kernels import ops
from ..sharding import (
    constrain,
    from_local,
    local,
    mesh_dims,
    shard_offset,
    use_weight,
)
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
    "cross_attention_decode",
    "decode_kv",
    "mlp_specs",
    "gelu_tanh",
    "mlp_block",
    "moe_specs",
    "moe_groups",
    "moe_capacity",
    "top_k",
    "MoePlan",
    "moe_route",
    "moe_block",
    "embed_specs",
    "label_logprobs",
    "embed_tokens",
    "unembed",
    "cache_prefix",
    "cache_write",
]

#: a row-wise activation [B, S, d]
ROW = ("batch", "seq", None)

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
def norm_specs(cfg: ArchConfig, kind: str = "rms") -> Dict[str, ParamSpec]:
    """RMSNorm's weight; ``kind="ln"`` (LayerNorm) adds a zero bias."""
    s = {"w": ParamSpec((cfg.d_model,), (None,), init="ones")}
    if kind == "ln":
        s["b"] = ParamSpec((cfg.d_model,), (None,), init="zeros")
    return s


def _norm_impl(cfg: ArchConfig) -> str:
    """The reference's rule (``layers.py:119-120``): the plain version
    only where the config names a plain route, else ``"auto"``."""
    return "plain" if cfg.attention_impl in ("xla", "naive") else "auto"


def apply_norm(
    p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig, rules=None
) -> torch.Tensor:
    """RMSNorm with the weight as stored; LayerNorm where ``p`` has a bias
    (the reference's ``layers.py:112-118``, plain PyTorch: the fp32 mean
    and biased variance, ``(x - mu) rsqrt(var + eps) w + b`` in fp32 with
    the weight and bias as given, cast back to x's dtype).  With rules,
    on each rank's rows."""
    if rules is not None:
        keys = tuple(p)
        f = local(
            rules,
            lambda x_, *ws: apply_norm(dict(zip(keys, ws)), x_, cfg),
            ROW,
            (ROW,) + ((None,),) * len(keys),
        )
        return f(x, *p.values())
    if "b" in p:
        xc = x.float()
        xc = xc - xc.mean(-1, keepdim=True)
        y = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + cfg.norm_eps)
        return (y * p["w"].float() + p["b"].float()).to(x.dtype)
    return ops.rmsnorm(x, p["w"], eps=cfg.norm_eps, impl=_norm_impl(cfg))


def apply_add_norm(
    p: Dict[str, Any],
    x: torch.Tensor,  # the residual stream
    delta: Optional[torch.Tensor],  # a block's output not yet added to it
    cfg: ArchConfig,
    rules=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it: ``(s, RMSNorm(s))`` with
    ``s = x + delta`` the new residual, one kernel launch on the card
    (``ops.add_rmsnorm``).  With ``delta`` None, ``(x, apply_norm(x))``.
    The models hand a block's output on as ``delta`` instead of adding
    it, so that the next norm folds the add in; the values are the
    reference's, which adds first and normalises the sum.  With rules, on
    each rank's rows."""
    if delta is None:
        return x, apply_norm(p, x, cfg, rules)
    if rules is not None:
        return local(
            rules,
            lambda x_, d_, w_: apply_add_norm({"w": w_}, x_, d_, cfg),
            [ROW, ROW],
            (ROW, ROW, (None,)),
        )(x, delta, p["w"])
    return ops.add_rmsnorm(x, delta, p["w"], eps=cfg.norm_eps, impl=_norm_impl(cfg))


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------
def attn_specs(
    cfg: ArchConfig, cross: bool = False, d_in: Optional[int] = None
) -> Dict[str, ParamSpec]:
    """q from a ``d_in``-wide input (default d_model); k and v from the
    same input, or from the d_model-wide memory when ``cross``."""
    d = d_in if d_in is not None else cfg.d_model
    d_kv = cfg.d_model if cross else d
    dh, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    s = {
        "wq": ParamSpec((d, H, dh), ("embed", "heads", None)),
        "wk": ParamSpec((d_kv, Hkv, dh), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d_kv, Hkv, dh), ("embed", "kv_heads", None)),
        "wo": ParamSpec((H, dh, cfg.d_model), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, dh), ("heads", None), init="zeros")
        s["bk"] = ParamSpec((Hkv, dh), ("kv_heads", None), init="zeros")
        s["bv"] = ParamSpec((Hkv, dh), ("kv_heads", None), init="zeros")
    return s


def _proj(x: torch.Tensor, w: torch.Tensor, dt, rules=None, axes=(None, None, None)):
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads;
    with rules the weight laid out by ``axes`` at use."""
    d, h, k = w.shape
    w = use_weight(rules, w, axes, dt)
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o: torch.Tensor, wo: torch.Tensor, dt, rules=None) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul over the flattened heads."""
    h, k, d = wo.shape
    wo = use_weight(rules, wo, ("heads", None, None), dt)
    return torch.matmul(o.flatten(-2), wo.reshape(h * k, d))


_Q = (None, "heads", None)
_KV = (None, "kv_heads", None)


def _qkv(p, x: torch.Tensor, mem: torch.Tensor, dt, rules=None):
    """q from ``x``, k and v from ``mem`` (``x`` itself for self-attention)."""
    q = _proj(x, p["wq"], dt, rules, _Q)
    k, v = _proj(mem, p["wk"], dt, rules, _KV), _proj(mem, p["wv"], dt, rules, _KV)
    if "bq" in p:
        q = q + _w(p["bq"], dt)
        k = k + _w(p["bk"], dt)
        v = v + _w(p["bv"], dt)
    return q, k, v


def _attend(q, k, v, causal: bool, cfg: ArchConfig, rules=None):
    """``ops.attention``; with rules on each rank's (batch, head) shard.
    Where the query heads shard and the KV heads do not, K/V are
    repeated to one per query head first, so each shard holds the KV
    heads its query heads read."""
    fn = lambda q_, k_, v_: ops.attention(q_, k_, v_, causal=causal, impl=ops_impl(cfg))
    if rules is None:
        return fn(q, k, v)
    qa = ("batch", "seq", "heads", None)
    ka = ("batch", "seq", "kv_heads", None)
    if rules.pspec(qa) != rules.pspec(ka):  # heads on model, kv_heads not
        G = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
        ka = qa
    return local(rules, fn, qa, (qa, ka, ka))(q, k, v)


def attention_block(
    p: Dict[str, Any],
    x: torch.Tensor,  # [B, S, d]
    cfg: ArchConfig,
    tables,  # rope_tables of the positions, shared by the layers; None: no RoPE
    causal: bool = True,
    memory: Optional[torch.Tensor] = None,  # cross-attention source [B, Sk, d]
    rules=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (prefill): self-attention, or with
    ``memory`` cross-attention whose K/V come from the memory.  Returns
    (out, kv) where kv holds the K/V for the cache, roped when ``tables``
    is given and there is no memory (the reference's ``use_rope and
    memory is None``)."""
    dt = cdtype(cfg)
    q, k, v = _qkv(p, x, x if memory is None else memory, dt, rules)
    if tables is not None and memory is None:
        q = apply_rope(q, tables)
        k = apply_rope(k, tables)
    q = constrain(rules, q, "batch", "seq", "heads", None)
    k = constrain(rules, k, "batch", "seq", "kv_heads", None)
    o = _attend(q, k, v, causal, cfg, rules)
    return _out(o, p["wo"], dt, rules), {"k": k, "v": v}


_CACHE = ("batch", "cache_seq", "cache_heads", None)


def _decode_merged(q, kc, vc, lengths, offset: int, groups):
    """One-token attention over this rank's keys at positions
    ``offset ..`` of a sequence-sharded cache, merged over the ranks of
    ``groups`` (the mesh dims the cache's sequence shards over): each
    rank's running max, sum and unnormalised output, as the reference's
    softmax computes them in fp32, combined by an all-reduce of each."""
    import torch.distributed._functional_collectives as funcol

    B, H, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    qg = (q.float() * D**-0.5).reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kc.float())
    pos = torch.arange(S, device=q.device) + offset
    s = s.masked_fill(~(pos[None] < lengths[:, None])[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", e, vc.float())
    for g in groups:
        den, o = funcol.all_reduce(den, "sum", g), funcol.all_reduce(o, "sum", g)
    return (o / den).reshape(B, H, D).to(q.dtype)


def _kernel_route(cfg: ArchConfig, t: torch.Tensor) -> bool:
    """Whether ``ops`` runs its CUDA kernel on ``t`` under the config's
    ``attention_impl``."""
    return ops.selects_kernel(ops_impl(cfg), t)


def _decode_attend(q, kc, vc, lengths, cfg: ArchConfig, rules=None, seq="cache_seq"):
    """``ops.decode_attention`` of q [B, H, dh] over a cache [B, S, Hkv,
    dh]; with rules on each rank's (batch, ``seq``, cache-head) shard of
    the cache, the query's heads sliced to the ones that read it.  Over a
    sequence-sharded cache the plain route merges the shards' partial
    softmaxes (:func:`_decode_merged`); the kernel reads a whole
    sequence, so for it the cache's sequence shards are gathered first
    (an all-gather of the layer's cache each step: ROADMAP Queue C)."""
    fn = lambda q_, k_, v_, n_: ops.decode_attention(q_, k_, v_, n_, impl=ops_impl(cfg))
    if rules is None:
        return fn(q, kc, vc, lengths)
    if mesh_dims(rules, seq) and _kernel_route(cfg, kc):
        kc = constrain(rules, kc, "batch", None, "cache_heads", None)
        vc = constrain(rules, vc, "batch", None, "cache_heads", None)
        seq = None
    S, Hkv = kc.shape[1], kc.shape[2]
    G = q.shape[1] // Hkv
    groups = [(rules.mesh, i) for i in mesh_dims(rules, seq)]
    s_off = shard_offset(rules, seq, S)
    h_off = shard_offset(rules, "cache_heads", Hkv)
    ca = ("batch", seq, "cache_heads", None)

    def run(q_, k_, v_, n_):
        q_ = q_[:, h_off * G : (h_off + k_.shape[2]) * G]
        if groups:
            return _decode_merged(q_, k_, v_, n_, s_off, groups)
        return fn(q_, k_, v_, n_)

    qa = ("batch", "cache_heads", None)
    return local(rules, run, qa, (("batch", None, None), ca, ca, ("batch",)))(
        q, kc, vc, lengths
    )


def cache_write(cache, pos, new, rules=None, rows=None) -> torch.Tensor:
    """``cache[rows, pos] = new`` for a cache [B, S, Hkv, dh], the new
    token's K or V [B, Hkv, dh] and ``rows`` ``arange(B)`` (the caller's,
    shared by the layers), in place; returns the cache.  With rules on
    each rank's cache shard, where only the rank holding position
    ``pos[b]`` of a sequence-sharded cache changes it."""
    if rules is None:
        cache[rows, pos] = new
        return cache
    S = cache.shape[1]
    off = shard_offset(rules, "cache_seq", S)

    def run(c, p_, n):
        loc = p_.long() - off
        hit = (loc >= 0) & (loc < c.shape[1])
        loc = loc.clamp(0, c.shape[1] - 1)
        rows = torch.arange(c.shape[0], device=c.device)
        c[rows, loc] = torch.where(hit[:, None, None], n, c[rows, loc])
        return c

    return local(rules, run, _CACHE, (_CACHE, ("batch",), ("batch", "cache_heads", None)))(
        cache, pos, new
    )


def cache_prefix(cache, kv, rules=None) -> None:
    """``cache[:, :S] = kv`` for a cache [B, max_seq, Hkv, dh] and a
    prompt's K or V [B, S, Hkv, dh], in place; with rules each rank
    writes the positions its cache shard holds."""
    S = kv.shape[1]
    if rules is None:
        cache[:, :S] = kv
        return
    off = shard_offset(rules, "cache_seq", cache.shape[1])

    def run(c, k):
        n = max(0, min(S - off, c.shape[1]))
        c[:, :n] = k[:, off : off + n]
        return c

    local(rules, run, _CACHE, (_CACHE, ("batch", None, "cache_heads", None)))(cache, kv)


def attention_decode_block(
    p: Dict[str, Any],
    x: torch.Tensor,  # [B, 1, d], the new token
    k_cache: torch.Tensor,  # [B, S, Hkv, dh], this token already written
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid length INCLUDING the new token
    cfg: ArchConfig,
    tables,  # rope_tables at lengths - 1, shared by the layers
    rules=None,
) -> torch.Tensor:  # [B, 1, d]
    dt = cdtype(cfg)
    q = _proj(x, p["wq"], dt, rules, _Q)
    if "bq" in p:
        q = q + _w(p["bq"], dt)
    q = apply_rope(q, tables)
    o = _decode_attend(q[:, 0], k_cache, v_cache, lengths, cfg, rules)
    return _out(o, p["wo"], dt, rules)[:, None, :]


def cross_attention_decode(
    p: Dict[str, Any],
    x: torch.Tensor,  # [B, 1, d], the new token
    k_mem: torch.Tensor,  # [B, Sm, Hkv, dh], the memory's K/V from prefill
    v_mem: torch.Tensor,
    mem_len: torch.Tensor,  # [B] int32, every entry Sm: the whole memory
    cfg: ArchConfig,
    rules=None,
) -> torch.Tensor:  # [B, 1, d]
    """Cross-attention of one token over the read-only memory cache: q
    from the token (no bias, no RoPE, as the reference's decode writes
    it: ``whisper.py:201-214``, ``transformer.py:343-357``), one-token
    attention over the memory's full length, then ``wo``."""
    dt = cdtype(cfg)
    q = _proj(x, p["wq"], dt, rules, _Q)
    o = _decode_attend(q[:, 0], k_mem, v_mem, mem_len, cfg, rules, seq=None)
    return _out(o, p["wo"], dt, rules)[:, None, :]


def decode_kv(p, x: torch.Tensor, cfg: ArchConfig, tables, rules=None):
    """K/V for the new token (decode): [B, 1, Hkv, dh] each, K roped by
    ``tables`` (:func:`rope_tables` at the token's position)."""
    dt = cdtype(cfg)
    k, v = _proj(x, p["wk"], dt, rules, _KV), _proj(x, p["wv"], dt, rules, _KV)
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


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default, the tanh form) as the reference
    computes it: op for op in x's dtype, its constants rounded to that
    dtype, ``x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 x^3))))``.
    In bf16 this equals the reference bit for bit, where ``F.gelu``
    (fp32 inside, one rounding, exact constants) differs on ~40% of
    elements.  The constants travel as Python floats (no device copy)."""

    def c(v):  # v rounded to x's dtype
        return float(torch.tensor(v, dtype=x.dtype))

    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * x**3)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp_block(p, x: torch.Tensor, cfg: ArchConfig, rules=None) -> torch.Tensor:
    dt = cdtype(cfg)
    h = torch.matmul(x, use_weight(rules, p["w1"], (None, "mlp"), dt))
    if "w3" in p:
        h = F.silu(h) * torch.matmul(x, use_weight(rules, p["w3"], (None, "mlp"), dt))
    else:
        h = gelu_tanh(h)
    h = constrain(rules, h, "batch", "seq", "mlp")
    return torch.matmul(h, use_weight(rules, p["w2"], ("mlp", None), dt))


# ----------------------------------------------------------------------
# MoE (top-k, capacity-based sort dispatch within token groups)
# ----------------------------------------------------------------------
def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, E), ("embed", None), scale=0.02),
        "w1": ParamSpec((E, d, ff), ("experts", "embed", "expert_mlp")),
        "w3": ParamSpec((E, d, ff), ("experts", "embed", "expert_mlp")),
        "w2": ParamSpec((E, ff, d), ("experts", "expert_mlp", "embed")),
    }


def moe_groups(T: int, group_size: int) -> int:
    """The reference's group count: ``T // group_size`` (at least 1),
    lowered until it divides T."""
    G = max(1, T // group_size)
    while T % G:
        G -= 1
    return G


def moe_capacity(Tg: int, cfg: ArchConfig) -> int:
    """Slots per expert and group: ``Tg k / E cf`` in Python floats,
    truncated, at least 1 (the reference's ``layers.py:319``).  Where
    ``cf k >= E`` the capacity is never below ``Tg``, so that such a
    configuration drops nothing: at 72 experts, top-10 and ``cf`` 7.2 the
    float product rounds to ``Tg - 1`` for 183 group sizes up to 8,192
    (61, 122, 235, ...).  Where the formula gives ``Tg`` or more, as at
    every other configuration here, nothing changes."""
    cap = max(1, int(Tg * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    if cfg.capacity_factor * cfg.top_k >= cfg.n_experts:
        return max(cap, Tg)
    return cap


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` on the last axis: the k largest, ties lowest index
    first (the first k of a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(x, stable=True, dim=-1, descending=True)
    return vals[..., :k], idx[..., :k]


@dataclass
class MoePlan:
    """Where :func:`moe_route` sends each of a group's ``Tg k``
    assignments, token-major (token t's j-th choice at ``t k + j``):
    expert ``idx``, rank ``slot`` among that expert's assignments in the
    group (their stable sort by expert), kept when ``slot < cap``; the
    normalised fp32 ``gate``; the load-balancing ``aux`` over all tokens."""

    idx: torch.Tensor  # [G, Tg * k] int64
    slot: torch.Tensor  # [G, Tg * k] int64
    keep: torch.Tensor  # [G, Tg * k] bool
    gate: torch.Tensor  # [G, Tg * k] fp32
    cap: int
    aux: torch.Tensor  # fp32 scalar
    probs: torch.Tensor  # [G, Tg, E] fp32, the router's softmax
    counts: torch.Tensor  # [G, E] int64, assignments per expert, kept or not


def moe_route(router: torch.Tensor, xg: torch.Tensor, cfg: ArchConfig) -> MoePlan:
    """The reference's routing (``layers.py:303-336``) for tokens
    ``xg`` [G, Tg, d]: fp32 router logits and softmax, top-k with its
    gates renormalised, the Switch aux loss ``E sum_e f_e p_e`` (every
    top-k choice counted, dropped or not), and each group's stable sort
    by expert, whose rank past ``cap`` drops an assignment."""
    G, Tg, _ = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = torch.matmul(xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_k, idx_k = top_k(probs, k)  # [G, Tg, k]
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp_min(1e-9)
    eidx = idx_k.reshape(G, Tg * k)
    counts = torch.zeros(G, E, dtype=torch.int64, device=xg.device)
    counts.scatter_add_(1, eidx, torch.ones_like(eidx))
    # no bincount: on the card it reads the largest id back to the host
    frac = counts.sum(0).float() / (G * Tg * k)
    aux = E * torch.sum(probs.mean((0, 1)) * frac)
    sorted_e, order = torch.sort(eidx, stable=True, dim=1)
    starts = counts.cumsum(1) - counts
    ranks = torch.arange(Tg * k, device=xg.device) - starts.gather(1, sorted_e)
    slot = torch.empty_like(ranks).scatter_(1, order, ranks)  # token-major
    cap = moe_capacity(Tg, cfg)
    return MoePlan(
        eidx, slot, slot < cap, gate_k.reshape(G, Tg * k), cap, aux, probs, counts
    )


def _moe_dispatch(router, xg, cfg: ArchConfig, stats=None):
    """Route and dispatch token groups xg [G, Tg, d]: the buffer [G, E,
    cap, d] of kept assignments in the compute dtype, the flat buffer row
    of each assignment (``E cap``, the spare row: dropped), its gate
    times its keep, and the plan.  With ``stats``, the kept and routed
    assignment counts are added to it."""
    dt = cdtype(cfg)
    G, Tg, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    plan = moe_route(router, xg, cfg)
    cap = plan.cap
    if stats is not None:
        stats["kept"] += plan.keep.sum()
        stats["assigned"] += plan.keep.numel()
    row = torch.where(plan.keep, plan.idx * cap + plan.slot, E * cap)
    buf = torch.zeros(G, E * cap + 1, d, dtype=dt, device=xg.device)
    # kept rows are distinct; only the spare row takes several writes
    src = xg.to(dt).repeat_interleave(k, dim=1)  # [G, Tg * k, d]
    buf.scatter_(1, row[..., None].expand(-1, -1, d), src)
    gk = plan.gate.to(dt) * plan.keep.to(dt)
    return buf[:, : E * cap].reshape(G, E, cap, d), row, gk, plan


def _moe_combine(out_e, row, gk, idx, k: int):
    """Each token's kept expert outputs [G, E, cap, d] (the spare row
    reads 0), scaled by their gates and summed in ascending expert order
    from 0: y [G, Tg, d]."""
    G, E, cap, d = out_e.shape
    flat = torch.cat([out_e.reshape(G, E * cap, d), out_e.new_zeros(G, 1, d)], dim=1)
    y_asg = flat.gather(1, row[..., None].expand(-1, -1, d)) * gk[..., None]
    Tg = row.shape[1] // k
    by_expert = idx.reshape(G, Tg, k).argsort(dim=-1)
    y_asg = y_asg.reshape(G, Tg, k, d).gather(2, by_expert[..., None].expand(-1, -1, -1, d))
    y = torch.zeros(G, Tg, d, dtype=out_e.dtype, device=out_e.device)
    for j in range(k):
        y = y + y_asg[:, :, j]
    return y


def moe_block(
    p, x: torch.Tensor, cfg: ArchConfig, stats=None, rules=None, spans=False
):
    """Top-k MoE with group-local dispatch (the reference's
    ``moe_block``, ``layers.py:279-365``): returns ``(y, aux)``.

    Each group's kept assignments fill an ``[E, cap, d]`` buffer; every
    expert's SwiGLU FFN runs on its whole buffer, empty slots included
    (one batched matmul per weight); each token then sums its kept
    outputs, each scaled by its gate, in the compute dtype.  A dropped
    assignment is routed to a spare buffer row that no expert reads and
    combines as 0: the reference's out-of-bounds expert id ``E``, which
    its scatter drops and its gather fills with 0.  A token's sum runs in
    the reference's scatter-add order (ascending expert id from 0), as a
    loop over its k choices, never an atomic add: the card gives the same
    bits on every run.  With ``stats`` (a dict of 0-d int64 tensors
    ``"kept"`` and ``"assigned"`` on x's device), the kept and routed
    assignment counts are added to it on the device, without a sync.

    With rules (and no ``stats``), the reference's constraints: the
    groups over ``batch`` where their count divides its shards (else
    every rank routes every group, as a group must see all of its
    tokens), routing, dispatch and combine local to a rank's groups, the
    expert FFNs on the buffer with the experts' TP/EP weights, and the
    aux loss from the groups' summed router probabilities and counts.

    With ``spans`` (the decode step's), while a profiler records, three
    inner spans (``repro_torch.tracing.inner_span``): ``moe.route``
    (routing and dispatch into the buffer), ``moe.experts`` (the expert
    FFNs) and ``moe.combine``."""
    part = tracing.inner_span if spans else tracing.no_span
    dt = cdtype(cfg)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = moe_groups(T, cfg.moe_group_size)
    ga = None
    if rules is not None:
        shards = math.prod(rules.mesh.size(i) for i in mesh_dims(rules, "batch"))
        ga = "batch" if G % shards == 0 else None
    with part("moe.route"):
        xg = constrain(rules, x.reshape(G, T // G, d), ga, None, None)
        if rules is None:
            buf, row, gk, plan = _moe_dispatch(p["router"], xg, cfg, stats)
            idx, aux = plan.idx, plan.aux
        else:
            def dispatch(xg_, r_):
                buf, row, gk, plan = _moe_dispatch(r_, xg_, cfg)
                return buf, row, gk, plan.idx, plan.probs.sum(1), plan.counts.float()

            buf, row, gk, idx, psum, counts = local(
                rules,
                dispatch,
                [(ga, None, None, None)] + [(ga, None)] * 5,
                ((ga, None, None), (None, None)),
            )(xg, p["router"].float())
            aux = E * torch.sum((psum.sum(0) / T) * (counts.sum(0) / (T * k)))
        buf = constrain(rules, buf, ga, "experts", None, None)
    with part("moe.experts"):
        cap = buf.shape[2]
        h_in = buf.transpose(0, 1).reshape(E, G * cap, d)
        w1 = use_weight(rules, p["w1"], ("experts", None, "expert_mlp"), dt)
        w3 = use_weight(rules, p["w3"], ("experts", None, "expert_mlp"), dt)
        h = F.silu(torch.matmul(h_in, w1)) * torch.matmul(h_in, w3)
        h = constrain(rules, h.reshape(E, G, cap, -1).transpose(0, 1),
                      ga, "experts", None, "expert_mlp")
        h = h.transpose(0, 1).reshape(E, G * cap, -1)
        w2 = use_weight(rules, p["w2"], ("experts", "expert_mlp", None), dt)
        out_e = torch.matmul(h, w2).reshape(E, G, cap, d).transpose(0, 1)
        out_e = constrain(rules, out_e, ga, None, None, None)
    with part("moe.combine"):
        y = local(
            rules,
            lambda o_, r_, g_, i_: _moe_combine(o_, r_, g_, i_, k),
            (ga, None, None),
            ((ga, None, None, None), (ga, None), (ga, None), (ga, None)),
        )(out_e, row, gk, idx)
        y = constrain(rules, y, ga, None, None)
    return y.reshape(B, S, d), aux


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------
def embed_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    V, d = cfg.vocab_padded(), cfg.d_model
    s = {"tok": ParamSpec((V, d), ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        s["out"] = ParamSpec((d, V), ("embed", "vocab"), scale=0.02)
    return s


def label_logprobs(
    logits_f32: torch.Tensor, labels: torch.Tensor, real_vocab: int, rules=None
):
    """(logsumexp, label logit) per position (the reference's
    ``layers.py:379-394``): the padded vocabulary tail masked at -1e30
    out of the logsumexp, the label's logit by a where-reduction.  With
    rules, :class:`_VocabParallelLogprobs`."""
    if rules is not None:
        return _VocabParallelLogprobs.apply(logits_f32, labels, real_vocab, rules)
    V = logits_f32.shape[-1]
    iota = torch.arange(V, device=logits_f32.device)
    if V != real_vocab:
        logits_f32 = torch.where(iota < real_vocab, logits_f32, -1e30)
    lse = torch.logsumexp(logits_f32, dim=-1)
    hit = iota == labels[..., None].to(iota.dtype)
    ll = torch.where(hit, logits_f32, 0.0).sum(-1)
    return lse, ll


class _VocabParallelLogprobs(torch.autograd.Function):
    """:func:`label_logprobs` of DTensor logits laid out by (batch, seq,
    vocab), on each rank's vocab shard: the shard's max, sum of
    exponentials and label logit, merged by an all-reduce (max, sum,
    sum) over the mesh dims ``vocab`` shards over -- the reference's
    shard-local where-reduction and its one all-reduce per token.  The
    results are laid out by (batch, seq).  The backward is local:
    ``g_lse softmax(x) + g_ll onehot(label)`` on the logits' own
    layout (left to DTensor, the broadcast gradients come back sharded
    over the batch twice and gather the logits)."""

    @staticmethod
    def forward(ctx, logits, labels, real_vocab, rules):
        import torch.distributed._functional_collectives as funcol

        V = logits.shape[-1]
        groups = [(rules.mesh, i) for i in mesh_dims(rules, "vocab")]
        off = shard_offset(rules, "vocab", V)
        x = logits.to_local()
        lab = constrain(rules, labels, "batch", "seq").to_local()
        iota = torch.arange(x.shape[-1], device=x.device) + off
        if V != real_vocab:
            x = torch.where(iota < real_vocab, x, -1e30)
        m = x.amax(-1, keepdim=True)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        s = torch.exp(x - m).sum(-1, keepdim=True)
        hit = iota == lab[..., None].to(iota.dtype)
        ll = torch.where(hit, x, 0.0).sum(-1)
        for g in groups:
            s, ll = funcol.all_reduce(s, "sum", g), funcol.all_reduce(ll, "sum", g)
        lse = (m + torch.log(s))[..., 0]
        out = rules.sharding(("batch", "seq"))
        ctx.save_for_backward(x, lse, hit)
        ctx.layout = (logits.device_mesh, logits.placements, logits.shape, logits.stride())
        ctx.out = out
        wrap = lambda t: from_local(t, out, labels.shape)  # noqa: E731
        return wrap(lse), wrap(ll)

    @staticmethod
    def backward(ctx, g_lse, g_ll):
        from torch.distributed.tensor import DTensor

        x, lse, hit = ctx.saved_tensors
        pl = list(ctx.out.placements)
        g = torch.zeros_like(x)
        if g_lse is not None:
            gl = g_lse.redistribute(ctx.out.mesh, pl).to_local()
            g = g + gl[..., None] * torch.exp(x - lse[..., None])
        if g_ll is not None:
            gh = g_ll.redistribute(ctx.out.mesh, pl).to_local()
            g = g + torch.where(hit, gh[..., None], 0.0)
        mesh, placements, shape, stride = ctx.layout
        grad = DTensor.from_local(g, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)
        return grad, None, None, None


def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig, rules=None) -> torch.Tensor:
    """Gather the rows, then cast: never the whole table per call.  With
    rules the reference's order: the table cast and gathered over
    ``data`` at use (its vocab shards stay), the lookup, the result
    pinned to (batch, seq, None)."""
    if rules is None:
        return p["tok"][tokens].to(cdtype(cfg))
    tab = use_weight(rules, p["tok"], ("vocab", None), cdtype(cfg))
    return constrain(rules, F.embedding(tokens, tab), *ROW)


def unembed(p, x: torch.Tensor, cfg: ArchConfig, rules=None) -> torch.Tensor:
    """Logits over the padded vocabulary (``vocab_padded()``), in the
    compute dtype, as the reference returns them (padded ids unmasked)."""
    dt = cdtype(cfg)
    x = constrain(rules, x, *ROW)
    if "out" in p:
        logits = torch.matmul(x, use_weight(rules, p["out"], (None, "vocab"), dt))
    else:
        logits = torch.matmul(x, use_weight(rules, p["tok"], ("vocab", None), dt).t())
    return constrain(rules, logits, "batch", "seq", "vocab")
