"""The yardstick of a Mamba-2 / attention pattern hybrid with MoE FFNs
(granite-4.0-h, ``bench/reference/granite_hybrid.py``): operations and
bytes of a decode step and of one SSD decode call, from the
configuration file's sizes alone, at ``bench/cost.py``'s peaks.

As in ``cost.py``, every weight a decode step reads is read once (an
MoE layer's experts as many as the step's assignments can reach,
``min(E, k B)``), the token table only in the rows it gathers and once
more as the tied head, each KV cache over its valid positions; beside
them each active slot's fp32 SSM state and its conv state, read and
written.  Operations count 2 per multiply-add and only the useful work:
a token's ``top_k`` experts and the shared one, the attention products
over the valid positions, the real vocabulary; the SSD step counts 3
multiply-adds a state element (the decay, the input, the output).
"""

from __future__ import annotations

from bench.cost import BF16

__all__ = ["ssd_decode_bytes", "decode_step_cost"]

FP32 = 4
#: the conv's window
CONV_K = 4


def _mamba_dims(cfg: dict) -> tuple:
    """(inner width, heads, head dim P, state width N, conv width)."""
    d_in = cfg["ssm_expand"] * cfg["d_model"]
    P, N = cfg["ssm_head_dim"], cfg["ssm_state"]
    return d_in, d_in // P, P, N, d_in + 2 * N


def _layers(cfg: dict) -> tuple:
    """(Mamba layers, attention layers)."""
    n_attn = len(cfg["attn_layer_ids"])
    return cfg["n_layers"] - n_attn, n_attn


def ssd_decode_bytes(cfg: dict, slots: int) -> int:
    """One SSD decode call over ``slots`` slots: each slot's fp32 state
    read and written, its x, B and C (bf16) and dt (fp32) read, y (bf16)
    written."""
    _, H, P, N, _ = _mamba_dims(cfg)
    per_slot = 2 * H * P * N * FP32 + (2 * H * P + 2 * N) * BF16 + H * FP32
    return slots * per_slot


def _dims(cfg: dict) -> tuple:
    dh = cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]
    return cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], dh


def _mamba_weight_bytes(cfg: dict) -> int:
    d = cfg["d_model"]
    d_in, H, _, _, conv = _mamba_dims(cfg)
    matrices = (d * (d_in + conv + H) + d_in * d + CONV_K * conv + conv) * BF16
    return matrices + (3 * H + d_in) * FP32  # A_log, D, dt_bias, gated norm


def _attn_weight_bytes(cfg: dict) -> int:
    d, h, hkv, dh = _dims(cfg)
    return (d * (h + 2 * hkv) * dh + h * dh * d) * BF16


def _ffn_weight_bytes(cfg: dict, experts_read: int) -> int:
    d, ff, E = cfg["d_model"], cfg["d_ff"], cfg["n_experts"]
    shared = 3 * d * cfg.get("shared_ff", 0) * BF16
    return experts_read * 3 * d * ff * BF16 + d * E * FP32 + shared


def _mamba_flops_per_token(cfg: dict) -> int:
    d = cfg["d_model"]
    d_in, H, P, N, conv = _mamba_dims(cfg)
    proj = 2 * d * (d_in + conv + H) + 2 * d_in * d
    return proj + 2 * CONV_K * conv + 3 * 2 * H * P * N


def _attn_flops_per_token(cfg: dict) -> int:
    d, h, hkv, dh = _dims(cfg)
    return 2 * d * (h + 2 * hkv) * dh + 2 * h * dh * d


def _ffn_flops_per_token(cfg: dict) -> int:
    d, ff, E = cfg["d_model"], cfg["d_ff"], cfg["n_experts"]
    return 2 * d * E + cfg["top_k"] * 3 * 2 * d * ff + 3 * 2 * d * cfg.get("shared_ff", 0)


def decode_step_cost(cfg: dict, keys) -> tuple:
    """(flops, bytes) of one decode step over the slots that hold a
    request, slot b's attention reading ``keys[b]`` positions."""
    d, h, hkv, dh = _dims(cfg)
    B, L, V = len(keys), cfg["n_layers"], cfg["vocab"]
    n_mamba, n_attn = _layers(cfg)
    _, _, _, _, conv = _mamba_dims(cfg)
    n_keys = sum(keys)
    flops = B * (n_mamba * _mamba_flops_per_token(cfg) + n_attn * _attn_flops_per_token(cfg))
    flops += n_attn * 2 * 2 * h * dh * n_keys  # QK^T and PV over the valid keys
    flops += B * L * _ffn_flops_per_token(cfg) + B * 2 * d * V
    experts = min(cfg["n_experts"], B * cfg["top_k"])
    nbytes = n_mamba * _mamba_weight_bytes(cfg) + n_attn * _attn_weight_bytes(cfg)
    nbytes += L * (_ffn_weight_bytes(cfg, experts) + 2 * d * FP32)  # and two norms
    nbytes += n_mamba * (ssd_decode_bytes(cfg, B) + B * 2 * (CONV_K - 1) * conv * BF16)
    nbytes += n_attn * 2 * hkv * dh * BF16 * (n_keys + B)  # K/V read, the new written
    nbytes += B * d * BF16 + d * V * BF16 + d * FP32  # token rows, tied head, final norm
    return flops, nbytes
