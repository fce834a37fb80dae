"""minicpm-2b [dense] — 40L d_model=2304 36H (MHA kv=36) d_ff=5760
vocab=122753 (padded to 122880 for sharding); WSD schedule lives in
repro/optim; depth-scaled residuals (mu-P style).  [arXiv:2404.06395; hf]
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    depth_scale=1.4,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="minicpm-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=509, dtype="float32",
)
