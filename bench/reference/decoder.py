"""The plain reference of the served decoders: dense (qwen2) and top-k
MoE (grok-1) stacks, one sequence at a time, in fp32 with TF32 off.

Written from the equations, not from the program: token embedding; per
layer RMSNorm (``x rsqrt(mean(x^2) + eps) w``), grouped-query causal
attention with rotary embeddings (the half-split rotation, frequencies
``theta^(-i/half)``) and optional QKV bias, a residual add, RMSNorm,
then a SwiGLU MLP (``(silu(h W1) * (h W3)) W2``) or a top-k mixture of
SwiGLU experts (fp32 router softmax, the k largest probabilities, ties
to the lower expert, renormalised over the k, no capacity limit), a
residual add; a final RMSNorm and the output head (the token table's
transpose where the embeddings are tied), over the padded vocabulary
as the weights hold it.

It reads the weights it is given (the benchmark's draws) and recomputes
everything else, the KV caches included, from the prompt and the fed
tokens.  ``linear`` selects how the matrix products of the projections,
the FFNs and the head are computed: :func:`fp32` (the reference) or
:func:`fp8` (the control: e4m3 operands with a scale per row of the
activations and per output column of the weights, accumulated in
fp32).  Attention's products, the norms and the softmaxes stay fp32.
"""

from __future__ import annotations

import torch

__all__ = ["fp32", "fp8", "logits", "ATTN_BLOCK"]

#: queries per block of the attention's score matrix
ATTN_BLOCK = 1024
_FP8_MAX = 448.0


def fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in fp32: x [T, K], w [K, N] (any float dtype)."""
    return x.float() @ w.float()


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands rounded to fp8 e4m3 (per row of x,
    per column of w), the product accumulated in fp32."""
    return _q8(x.float(), -1) @ _q8(w.float(), 0)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, D] at positions 0..T-1."""
    T, _, D = x.shape
    half = D // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal GQA softmax attention, q [T, H, D], k/v [T, Hkv, D]."""
    T, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)  # [H, T, D]
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, T, ATTN_BLOCK):
        b = min(T, a + ATTN_BLOCK)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) * D**-0.5
        keys = torch.arange(b, device=q.device)
        mask = keys[None, :] > keys[a:b, None]
        s = s.masked_fill(mask, float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, dim=-1), v[:, :b])
    return out


def _swiglu(h, w1, w3, w2, linear) -> torch.Tensor:
    return linear(torch.nn.functional.silu(linear(h, w1)) * linear(h, w3), w2)


def _moe(h, p, l: int, cfg: dict, linear) -> torch.Tensor:
    probs = torch.softmax(h @ p["router"][l].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg["top_k"]
    gate, idx = vals[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(cfg["n_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            out = _swiglu(h[rows], p["w1"][l, e], p["w3"][l, e], p["w2"][l, e], linear)
            y.index_add_(0, rows, gate[rows, slot, None] * out)
    return y


def _layer(x, p, l: int, cfg: dict, linear) -> torch.Tensor:
    T, d = x.shape
    H, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
    D = cfg.get("d_head") or d // H
    eps, a = cfg["norm_eps"], p["attn"]
    h = _rms(x, p["ln1"]["w"][l], eps)
    q = linear(h, a["wq"][l].reshape(d, H * D)).view(T, H, D)
    k = linear(h, a["wk"][l].reshape(d, Hkv * D)).view(T, Hkv, D)
    v = linear(h, a["wv"][l].reshape(d, Hkv * D)).view(T, Hkv, D)
    if "bq" in a:
        q, k, v = q + a["bq"][l].float(), k + a["bk"][l].float(), v + a["bv"][l].float()
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    o = _attention(q, k, v).reshape(T, H * D)
    x = x + linear(o, a["wo"][l].reshape(H * D, d))
    h = _rms(x, p["ln2"]["w"][l], eps)
    if "moe" in p:
        return x + _moe(h, p["moe"], l, cfg, linear)
    m = p["mlp"]
    return x + _swiglu(h, m["w1"][l], m["w3"][l], m["w2"][l], linear)


@torch.inference_mode()
def logits(params: dict, cfg: dict, tokens, start: int, linear=fp32) -> torch.Tensor:
    """fp32 logits [len(tokens) - start, padded vocab] at positions
    ``start ..`` of the sequence ``tokens``, each the next-token logits
    after reading the tokens up to it."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        emb = params["embed"]
        ids = torch.as_tensor(list(tokens), dtype=torch.long, device=emb["tok"].device)
        x = emb["tok"][ids].float()
        for l in range(cfg["n_layers"]):
            x = _layer(x, params["layers"], l, cfg, linear)
        x = _rms(x[start:], params["final_norm"]["w"], cfg["norm_eps"])
        head = emb["out"] if "out" in emb else emb["tok"].t()
        return linear(x, head)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
