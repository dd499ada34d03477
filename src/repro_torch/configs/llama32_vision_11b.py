"""llama-3.2-vision-11b — dense GQA with cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

40L, d_model=4096, 32 heads (GQA kv=8, head_dim=128), d_ff=14336,
vocab=128256.  Every 5th layer cross-attends to vision-encoder states; the
vision frontend is a stub: a sample brings 1600 precomputed patch
embeddings (``encoder_states``).  9.8 B params, 18.2 GiB bf16: one card
at full width and depth.
"""

from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    n_layers=40,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    pattern=("attn", "attn", "attn", "attn", "xattn"),
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              rope_theta=500000.0),
    n_encoder_tokens=1600,
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    name="llama-3.2-vision-11b-smoke", n_layers=5, d_model=64, d_ff=128,
    vocab_size=256, n_encoder_tokens=16,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
)
