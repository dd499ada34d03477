"""granite-8b — llama-arch dense GQA code model [arXiv:2405.04324].

36L, d_model=4096, 32 heads (GQA kv=8, head_dim=128), d_ff=14336,
vocab=49152, tied embeddings, rope_theta 1e7.  Plain attention (no
window, no softcap) + dense SwiGLU FFN; 8.05 B params, 16.1 GB in bf16.
"""

from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    n_layers=36,
    d_model=4096,
    d_ff=14336,
    vocab_size=49152,
    pattern=("attn",),
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              rope_theta=10000000.0),
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    name="granite-8b-smoke", n_layers=2, d_model=64, d_ff=128, vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
)
