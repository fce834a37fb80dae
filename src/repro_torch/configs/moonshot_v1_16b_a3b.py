"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]

Sharding note: 64 experts divide the 16-way model axis -> expert
parallelism (4 experts/chip); per-expert d_ff=1408 stays unsharded.
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    n_experts=64,
    top_k=6,
)

# capacity_factor >= E/k: drop-free tiny variant (see grok config note).
TINY = CONFIG.replace(
    name="moonshot-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512, n_experts=8, top_k=3, dtype="float32",
    capacity_factor=3.0,
)
