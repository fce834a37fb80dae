"""Architecture and shape configuration system.

``ArchConfig`` is the single source of truth for a model architecture;
one instance per assigned architecture lives in ``repro/configs/<id>.py``
(exact paper/HF values) together with a ``tiny()`` reduction of the same
family for CPU smoke tests.

``ShapeConfig`` describes one assigned input-shape cell (train / prefill /
decode / long-context-decode).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shape_by_name"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    d_head: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 4096  # tokens per local dispatch group
    # VLM (cross-attention image layers)
    cross_attn_every: int = 0  # every k-th layer is a cross-attn layer
    n_image_tokens: int = 0
    # audio (encoder-decoder); n_layers counts DECODER layers
    enc_layers: int = 0
    enc_len: int = 0
    # SSM / hybrid
    rwkv: bool = False
    ssm_state: int = 0  # Mamba2 d_state
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_every: int = 0  # Zamba2: shared attn block period
    shared_lora_rank: int = 64
    # depth-scaled residual (MiniCPM / muP-style)
    depth_scale: float = 0.0  # 0 = off; else residual *= depth_scale/sqrt(L)
    # numerics / runtime
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"  # full | dots | none
    use_scan: bool = True  # False: unroll layer loops (dry-run cost probes)
    attention_impl: str = "auto"  # auto | pallas | xla | naive
    attention_block_k: int = 512
    rwkv_chunk: int = 32
    ssd_chunk: int = 64
    # sharding behaviour (resolved by repro/sharding.py)
    attn_tp: Optional[bool] = None  # None = auto (heads % model_size == 0)
    expert_parallel: Optional[bool] = None  # None = auto
    seq_shard_cache: bool = True  # SP over the KV cache seq dim

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.rwkv

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear attention)."""
        return self.rwkv or self.ssm_state > 0

    def vocab_padded(self, multiple: int = 256) -> int:
        return _round_up(self.vocab, multiple)

    def n_params(self) -> int:
        """Total parameter count (embedding + layers), analytic."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_padded()
        dh = self.head_dim
        H, Hkv = self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * H * dh + 2 * d * Hkv * dh + H * dh * d
        mlp = 3 * d * ff
        per_layer = 0
        if self.rwkv:
            # rwkv6: r,k,v,g,o projections + lora decays + channel mix
            per_layer = 5 * d * d + 2 * d * int(3.5 * d) + 2 * d * 64
        elif self.ssm_state > 0 and self.shared_attn_every > 0:
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state) + d_in * d + d_in * 2
            per_layer = mamba
            n_shared = max(1, self.n_layers // self.shared_attn_every)
            shared = (2 * d) * H * dh + 2 * d * Hkv * dh + H * dh * d + 3 * d * ff
            lora = n_shared * 4 * d * self.shared_lora_rank
            return emb + self.n_layers * per_layer + shared + lora
        elif self.is_moe:
            per_layer = attn + self.n_experts * mlp + d * self.n_experts
        else:
            per_layer = attn + mlp
        n = emb + self.n_layers * per_layer
        if self.is_encdec:
            # encoder layers + decoder cross-attn
            enc = self.enc_layers * (attn + mlp)
            cross = self.n_layers * (d * H * dh + 2 * d * Hkv * dh + H * dh * d)
            n += enc + cross
        return n

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.is_moe:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        dh = self.head_dim
        H, Hkv = self.n_heads, self.n_kv_heads
        emb = self.vocab_padded() * d * (1 if self.tie_embeddings else 2)
        attn = d * H * dh + 2 * d * Hkv * dh + H * dh * d
        mlp_active = 3 * d * ff * self.top_k
        return emb + self.n_layers * (attn + mlp_active + d * self.n_experts)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")


def cell_is_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The assignment's skip rules (documented in DESIGN.md section 5)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "long_500k requires sub-quadratic attention (SSM/hybrid only)"
    return True, ""
