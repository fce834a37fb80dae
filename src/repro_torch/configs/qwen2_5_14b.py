"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064; GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]

Sharding note: 40 heads don't divide 16 -> MLP-only TP (see DESIGN.md).
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
)

TINY = CONFIG.replace(
    name="qwen2.5-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, dtype="float32",
)
