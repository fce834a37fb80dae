"""The plain reference of granite-4.0-h (hf ``granitemoehybrid``): a
pattern of Mamba-2 and NoPE attention layers, each followed by a
mixture of experts with a shared expert; one sequence at a time, in
fp32 with TF32 off.

Written from the published equations, not from the program.  The token
embedding times ``embedding_multiplier``; per layer, with r the
``residual_multiplier``::

    x = x + r * mixer(rms(x))
    x = x + r * (moe(rms(x)) + shared(rms(x)))

where ``rms(x) = x rsqrt(mean(x^2) + eps) w`` and the mixer is

* at the places ``attn_layer_ids``: grouped-query causal attention
  without bias and without any position encoding, the scores ``q k``
  times ``attention_scale`` (``1 / sqrt(d_head)`` where None), computed
  in query blocks (``decoder.ATTN_BLOCK``);
* elsewhere Mamba-2: ``in_proj`` to ``[z | xBC | dt]``; a depthwise
  causal conv of width 4 with bias over xBC (the sequence left-padded
  with zeros), then SiLU; xBC split into x (heads of P), B and C (one
  group of width N); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
  the state space recurrence as a **sequential scan** over the tokens,
  from a zero state, ``S_t = exp(A dt_t) S_{t-1} + dt_t x_t B_t^T``,
  ``y_t = S_t C_t + D x_t``; the gated RMSNorm over the whole inner
  width with the gate first, ``rms(y silu(z)) w``; ``out_proj``;

and the MoE is ``decoder``'s (the router's fp32 softmax, its k largest
probabilities, ties to the lower expert, renormalised over the k: the
softmax over the top-k logits; no capacity limit) plus a SwiGLU shared
expert.  Then a final RMSNorm and the tied head (the token table's
transpose), the logits divided by ``logits_scaling``, over the padded
vocabulary as the weights hold it.  The layers' leaves are read in the
port's layout (``mamba`` and ``attn`` stacks, in layer order within
each).

``linear`` computes the matrix products of the weights, as in
``decoder``: attention's q/k/v/o, in_proj and out_proj, the experts and
the head; the conv, the scan, the norms, attention's scores and the
router stay fp32.

:data:`WEIGHT_RULES` draws the family's leaves: the token table at
``1 / (12 sqrt(4096))``, so that the embedding times granite's multiplier
of 12 enters the stream at the shared rule's ``1 / sqrt(d_model)`` (at
the shared rule's own scale the embedded token, twelve times larger,
would lead the tied head to put the current token first at nearly every
position, in any precision); the matrices at their fan-in; the conv at
its fan-in of 4 taps; ``A_log`` and ``dt_bias``
about offsets that put each head's per-token decay ``exp(A dt)`` well
inside (0, 1), some heads keeping their state across a whole prompt of
a thousand tokens and others forgetting in tens; ``D`` about 1 and the
gated norm's weight ``1 + 0.1 N(0, 1)``, as the other norms', so that a
stale state, a dropped skip or a dropped norm weight shows in the logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .decoder import ATTN_BLOCK, _moe, _rms, _swiglu, fp8, fp32

__all__ = ["logits", "WEIGHT_RULES", "fp32", "fp8"]

#: the conv's window
CONV_K = 4

WEIGHT_RULES = {
    "fan_in": {"in_proj": (-2,), "out_proj": (-2,), "conv_w": (-2,)},
    "std": {"tok": 1 / (12 * 4096**0.5), "conv_b": 0.1, "A_log": 1.0, "D": 0.1,
            "dt_bias": 1.0, "gn_w": 0.1},
    # A about -1 (e^-2 .. e^2 across heads), dt about softplus(dt - 4):
    # A dt from about -1e-3 to -1 a token
    "offset": {"A_log": 0.0, "D": 1.0, "dt_bias": -4.0, "gn_w": 1.0},
    "fp32": ("A_log", "D", "dt_bias", "gn_w"),
}


def _attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal GQA softmax attention, q [T, H, D], k/v [T, Hkv, D]."""
    T, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)  # [H, T, D]
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, T, ATTN_BLOCK):
        b = min(T, a + ATTN_BLOCK)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) * scale
        keys = torch.arange(b, device=q.device)
        s = s.masked_fill(keys[None, :] > keys[a:b, None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, dim=-1), v[:, :b])
    return out


def _attn_mixer(h, p, l: int, cfg: dict, linear) -> torch.Tensor:
    T, d = h.shape
    H, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
    D = cfg.get("d_head") or d // H
    q = linear(h, p["wq"][l].reshape(d, H * D)).view(T, H, D)
    k = linear(h, p["wk"][l].reshape(d, Hkv * D)).view(T, Hkv, D)
    v = linear(h, p["wv"][l].reshape(d, Hkv * D)).view(T, Hkv, D)
    scale = cfg.get("attention_scale") or D**-0.5
    o = _attention(q, k, v, scale).reshape(T, H * D)
    return linear(o, p["wo"][l].reshape(H * D, d))


def _mamba_mixer(h, p, l: int, cfg: dict, linear) -> torch.Tensor:
    T, d = h.shape
    d_in = cfg["ssm_expand"] * d
    P, N = cfg["ssm_head_dim"], cfg["ssm_state"]
    H = d_in // P
    zxbcdt = linear(h, p["in_proj"][l])
    z, xbc, dt = zxbcdt.split([d_in, d_in + 2 * N, H], dim=-1)
    w, b = p["conv_w"][l].float(), p["conv_b"][l].float()  # [K, c], [c]
    padded = torch.cat([xbc.new_zeros(CONV_K - 1, xbc.shape[1]), xbc])
    xbc = F.silu(sum(padded[i : i + T] * w[i] for i in range(CONV_K)) + b)
    x, Bm, Cm = xbc.split([d_in, N, N], dim=-1)
    x = x.reshape(T, H, P)
    dt = F.softplus(dt + p["dt_bias"][l].float())  # [T, H]
    A = -torch.exp(p["A_log"][l].float())
    D = p["D"][l].float()
    S = h.new_zeros(H, P, N)
    y = torch.empty_like(x)
    for t in range(T):
        S = torch.exp(A * dt[t])[:, None, None] * S + (
            (dt[t][:, None] * x[t])[:, :, None] * Bm[t][None, None, :]
        )
        y[t] = S @ Cm[t] + D[:, None] * x[t]
    g = y.reshape(T, d_in) * F.silu(z)  # the gate first
    g = _rms(g, p["gn_w"][l], cfg["norm_eps"])
    return linear(g, p["out_proj"][l])


def _ffn(h, p, l: int, cfg: dict, linear) -> torch.Tensor:
    y = _moe(h, p["moe"], l, cfg, linear)
    if "shared" in p:
        s = p["shared"]
        y = y + _swiglu(h, s["w1"][l], s["w3"][l], s["w2"][l], linear)
    return y


@torch.inference_mode()
def logits(params: dict, cfg: dict, tokens, start: int, linear=fp32) -> torch.Tensor:
    """fp32 logits [len(tokens) - start, padded vocab] at positions
    ``start ..`` of the sequence ``tokens``, each the next-token logits
    after reading the tokens up to it, divided by ``logits_scaling``."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        emb = params["embed"]
        ids = torch.as_tensor(list(tokens), dtype=torch.long, device=emb["tok"].device)
        x = emb["tok"][ids].float() * cfg["embedding_multiplier"]
        r, eps = cfg["residual_multiplier"], cfg["norm_eps"]
        attn_ids = list(cfg["attn_layer_ids"])
        for n in range(cfg["n_layers"]):
            if n in attn_ids:
                p, l = params["attn"], attn_ids.index(n)
                mixer = _attn_mixer(_rms(x, p["ln1"]["w"][l], eps), p["attn"], l, cfg, linear)
            else:
                p, l = params["mamba"], n - sum(a < n for a in attn_ids)
                mixer = _mamba_mixer(_rms(x, p["ln1"]["w"][l], eps), p, l, cfg, linear)
            x = x + r * mixer
            x = x + r * _ffn(_rms(x, p["ln2"]["w"][l], eps), p, l, cfg, linear)
        x = _rms(x[start:], params["final_norm"]["w"], eps)
        head = emb["out"] if "out" in emb else emb["tok"].t()
        return linear(x, head) / cfg["logits_scaling"]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
