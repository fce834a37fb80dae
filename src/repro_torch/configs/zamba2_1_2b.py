"""zamba2-1.2b [hybrid] — 38L d_model=2048 Mamba2 (d_state=64) + shared
attention block (32H MHA) every 6 layers, d_ff=8192.
[arXiv:2411.15242; hf]

Runs long_500k: SSD state is O(1), only 6 shared-attn KV caches grow.
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
    shared_lora_rank=64,
)

TINY = CONFIG.replace(
    name="zamba2-tiny", n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, ssm_state=16, ssm_head_dim=16, shared_attn_every=2,
    shared_lora_rank=8, dtype="float32", ssd_chunk=8,
)
