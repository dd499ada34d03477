"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L, d_model=2048, 32 heads (MHA: kv=32, head_dim=64), d_ff=8192,
vocab=2048 (one EnCodec codebook; the tokens arrive as a single
interleaved stream, the multi-codebook delay pattern is left to the
frontend).  Plain attention + dense SwiGLU FFN; 3.2 B params, 6.5 GB in
bf16.  With vocab 2048 ≈ d_model the dense head is already cheap.
"""

from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab_size=2048,
    pattern=("attn",),
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=64),
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    name="musicgen-large-smoke", n_layers=2, d_model=64, d_ff=128,
    vocab_size=64,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16),
)
