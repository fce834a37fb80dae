"""The yardstick: operations and bytes from shapes, and the H100's peaks.

Counts come from the configuration file's sizes alone (no code of the
program runs here), so a change to the program cannot move them.  The
arithmetic follows ``chip_smoke.py``'s ``decode_step_bytes`` (every
weight a decode step reads, read once; the token table only in the
rows it gathers; each KV cache over its valid positions) and its
attention bounds (each input byte read once, each output byte written
once).  Operations count 2 per multiply-add and only the useful work:
an MoE token's ``top_k`` experts, the causal half of the attention
products, the real vocabulary.
"""

from __future__ import annotations

__all__ = [
    "PEAK_BF16_FLOPS",
    "PEAK_HBM_BYTES",
    "roofline_s",
    "prefill_flops",
    "flash_attention_cost",
    "decode_attention_cost",
    "decode_step_cost",
    "kv_bytes_per_token",
]

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: bytes of a bf16 element
BF16 = 2


def roofline_s(flops: float, nbytes: float) -> tuple:
    """(least seconds on the chip, the bound that sets it)."""
    tf, tb = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (tf, "flops") if tf >= tb else (tb, "bytes")


def _dims(cfg: dict) -> tuple:
    dh = cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]
    return cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], dh


def kv_bytes_per_token(cfg: dict) -> int:
    """K and V of one token over every layer, bf16."""
    _, _, hkv, dh = _dims(cfg)
    return cfg["n_layers"] * 2 * hkv * dh * BF16


def _ffn_flops_per_token(cfg: dict) -> int:
    d, ff = cfg["d_model"], cfg["d_ff"]
    if cfg.get("n_experts", 0):
        return 2 * d * cfg["n_experts"] + cfg["top_k"] * 3 * 2 * d * ff
    return 3 * 2 * d * ff


def _proj_flops_per_token(cfg: dict) -> int:
    d, h, hkv, dh = _dims(cfg)
    return 2 * d * (h + 2 * hkv) * dh + 2 * h * dh * d


def prefill_flops(cfg: dict, S: int) -> int:
    """A prefill of one S-token prompt: every layer's projections and FFN
    over S tokens, the causal attention products, and the last token's
    logits over the real vocabulary."""
    d, h, _, dh = _dims(cfg)
    per_layer = S * (_proj_flops_per_token(cfg) + _ffn_flops_per_token(cfg))
    per_layer += 2 * h * dh * S * (S + 1)  # QK^T and PV over i >= j pairs
    return cfg["n_layers"] * per_layer + 2 * d * cfg["vocab"]


def flash_attention_cost(cfg: dict, S: int) -> tuple:
    """(flops, bytes) of one causal flash-attention call over S tokens:
    q, k, v read once, the output written once."""
    _, h, hkv, dh = _dims(cfg)
    flops = 2 * h * dh * S * (S + 1)
    nbytes = S * (2 * h + 2 * hkv) * dh * BF16
    return flops, nbytes


def decode_attention_cost(cfg: dict, keys) -> tuple:
    """(flops, bytes) of one decode-attention call (one layer) whose
    slots read ``keys`` positions each: their K and V, the queries and
    the outputs."""
    _, h, hkv, dh = _dims(cfg)
    n = sum(keys)
    flops = 2 * 2 * h * dh * n
    nbytes = 2 * hkv * dh * BF16 * n + 2 * len(keys) * h * dh * BF16
    return flops, nbytes


def _layer_weight_bytes(cfg: dict, experts_read: int) -> int:
    d, h, hkv, dh = _dims(cfg)
    attn = (d * (h + 2 * hkv) * dh + h * dh * d) * BF16
    if cfg.get("qkv_bias"):
        attn += (h + 2 * hkv) * dh * BF16
    norms = 2 * d * 4
    if cfg.get("n_experts", 0):
        ffn = experts_read * 3 * d * cfg["d_ff"] * BF16 + d * cfg["n_experts"] * 4
    else:
        ffn = 3 * d * cfg["d_ff"] * BF16
    return attn + norms + ffn


def decode_step_cost(cfg: dict, keys) -> tuple:
    """(flops, bytes) of one decode step over the slots that hold a
    request, slot b attending over ``keys[b]`` positions: the useful
    operations, and every weight read once (an MoE layer's experts as
    many as the step's assignments can reach), the gathered token rows,
    the output head, each KV cache over its valid positions, the new
    K/V written."""
    d, _, hkv, dh = _dims(cfg)
    B, L, V = len(keys), cfg["n_layers"], cfg["vocab"]
    attn_f, attn_b = decode_attention_cost(cfg, keys)
    flops = L * (B * (_proj_flops_per_token(cfg) + _ffn_flops_per_token(cfg)) + attn_f)
    flops += B * 2 * d * V
    experts = min(cfg.get("n_experts", 0), B * cfg.get("top_k", 0))
    nbytes = L * (_layer_weight_bytes(cfg, experts) + 2 * hkv * dh * BF16 * sum(keys))
    nbytes += L * B * 2 * hkv * dh * BF16  # the new K/V
    nbytes += B * d * BF16 + d * V * BF16 + d * 4  # token rows, head, final norm
    return flops, nbytes
