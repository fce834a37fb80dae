"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]

Sharding note: 8 experts < 16-way model axis, so EP is off and the
per-expert FFN dim takes TP ('expert_mlp' -> 'model'); weights are
additionally FSDP-sharded on 'embed' -> 'data' (see repro/sharding.py).
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
)

# capacity_factor >= E/k makes the tiny variant drop-free so the
# prefill+decode path matches the full forward bit-for-bit in tests.
TINY = CONFIG.replace(
    name="grok-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, n_experts=4, top_k=2, dtype="float32",
    capacity_factor=2.5,
)
