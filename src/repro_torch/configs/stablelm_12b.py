"""stablelm-12b — dense GQA decoder [hf:stabilityai/stablelm-2-1_6b family].

40L, d_model=5120, 32 heads (GQA kv=8, head_dim=160), d_ff=13824,
vocab=100352, untied head.  Plain attention + dense SwiGLU FFN; 12.1 B
params, 24.3 GB in bf16.
"""

from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    d_ff=13824,
    vocab_size=100352,
    pattern=("attn",),
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=160,
                              rope_theta=10000.0),
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    name="stablelm-12b-smoke", n_layers=2, d_model=64, d_ff=128,
    vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
)
