"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attention-free, 40 wkv heads
of 64) d_ff=8960 vocab=65536; data-dependent decay.  [arXiv:2404.05892; hf]

Owns the long_500k shape (O(1) recurrent state).
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    rwkv=True,
)

TINY = CONFIG.replace(
    name="rwkv6-tiny", n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=256, vocab=512, dtype="float32", rwkv_chunk=8,
)
