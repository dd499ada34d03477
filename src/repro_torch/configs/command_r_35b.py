"""command-r-35b — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

40L, d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=22528,
vocab=256000, tied embeddings, rope_theta 8e6.  Plain attention + dense
SwiGLU FFN; 30.3 B params, 60.6 GB in bf16: more than one 80 GB card holds
beside its f32 init transient, so the card runs it at reduced depth.
"""

from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    n_layers=40,
    d_model=8192,
    d_ff=22528,
    vocab_size=256000,
    pattern=("attn",),
    attention=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                              rope_theta=8000000.0),
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    name="command-r-35b-smoke", n_layers=2, d_model=64, d_ff=128,
    vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
)
