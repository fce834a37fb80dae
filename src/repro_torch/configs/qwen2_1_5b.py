"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; GQA with QKV bias.  [arXiv:2407.10671; hf]

Sharding note: 12 heads don't divide the 16-way model axis -> MLP-only TP
(attention weights replicated on 'model', sharded on 'data'/FSDP).
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
)

TINY = CONFIG.replace(
    name="qwen2-tiny", n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
    d_ff=96, vocab=512, dtype="float32",
)
