"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; cross-attn image layers (every 5th layer), vision
frontend STUBBED (input_specs supplies patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=5,
    n_image_tokens=1600,
    rope_theta=500_000.0,
)

TINY = CONFIG.replace(
    name="llama-vision-tiny", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, cross_attn_every=2, n_image_tokens=16, dtype="float32",
)
