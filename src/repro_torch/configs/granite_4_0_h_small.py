"""granite-4.0-h-small [hybrid] — 40L d_model=4096: 36 Mamba-2 layers
(128 heads of 64, d_state 128, one B/C group, conv 4) and 4 GQA
attention layers (32/8 heads of 128, no bias, NoPE, scores scaled by
1/128) at 5, 15, 25, 35; every layer's FFN 72 SwiGLU experts of 768,
top-10, plus a shared SwiGLU of 1536; embedding x12, residual x0.22,
logits /16, tied vocabulary 100352.
[hf:ibm-granite/granite-4.0-h-small config.json]

The port's configuration alone (outside ``ALL_ARCHS``, the JAX
package's ten): 32.21 B parameters, 8.80 B active.  ``intermediate_size``
768 is read as one expert's width; ``capacity_factor`` 7.2 = E / k, with
``layers.moe_capacity`` never below a group's tokens there: no
assignment is dropped.
"""

from ..config import ArchConfig

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab=100352,
    tie_embeddings=True,
    rope_theta=10000.0,  # published; never read (NoPE)
    norm_eps=1e-5,
    n_experts=72,
    top_k=10,
    capacity_factor=7.2,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_layer_ids=(5, 15, 25, 35),
    shared_ff=1536,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_scale=0.0078125,
    logits_scaling=16.0,
    mamba_gate_first=True,
)

# every mechanism at a CPU size: both layer kinds, N != P, GQA, the
# shared expert, the published multipliers, the attention scale 1 / d_head
# (logits / 4, not 16: a tiny model's logits are small enough)
TINY = CONFIG.replace(
    name="granite-h-tiny", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=512, n_experts=8, top_k=3, capacity_factor=8 / 3,
    ssm_state=24, ssm_head_dim=16, attn_layer_ids=(2,), shared_ff=48,
    attention_scale=1 / 16, logits_scaling=4.0, dtype="float32", ssd_chunk=8,
)
