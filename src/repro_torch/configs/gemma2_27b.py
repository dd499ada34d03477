"""gemma2-27b — dense GQA, local/global alternating + softcaps [arXiv:2408.00118].

46L, d_model=4608, 32 heads (GQA kv=16, head_dim=128), d_ff=36864,
vocab=256000.  Sliding window 4096 on local layers; attention softcap 50,
final-logit softcap 30.  27.2 B params, 54.5 GB in bf16: one 80 GB card.
"""

from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    d_ff=36864,
    vocab_size=256000,
    pattern=("attn_local", "attn_global"),
    attention=AttentionConfig(n_heads=32, n_kv_heads=16, head_dim=128,
                              window=4096, logit_softcap=50.0,
                              rope_theta=10000.0),
    final_logit_softcap=30.0,
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    name="gemma2-27b-smoke", n_layers=2, d_model=64, d_ff=128, vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16, window=8,
                              logit_softcap=50.0),
)
