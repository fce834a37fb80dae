"""whisper-large-v3 [audio] — 32L (enc) + 32L (dec), d_model=1280 20H (MHA)
d_ff=5120 vocab=51866; enc-dec with conv frontend STUBBED to 1500 frame
embeddings.  [arXiv:2212.04356; unverified]
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    enc_layers=32,
    enc_len=1500,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="whisper-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=509, enc_layers=2, enc_len=12, dtype="float32",
)
