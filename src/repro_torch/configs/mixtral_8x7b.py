"""mixtral-8x7b — MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088].

32L, d_model=4096, 32 heads (GQA kv=8, head_dim=128), expert d_ff=14336,
vocab=32000, SWA window 4096.  46.7 B params, 87.0 GiB in bf16: more than
one 80 GB card holds, so the card runs it at full width and reduced depth.
"""

from repro_torch.models.config import AttentionConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32,
    d_model=4096,
    d_ff=14336,            # unused (all layers MoE); kept for reference
    vocab_size=32000,
    pattern=("attn",),
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              window=4096, rope_theta=1000000.0),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    moe_every=1,
    subquadratic=True,     # SWA ⇒ bounded decode memory
)

SMOKE = CONFIG.scaled(
    name="mixtral-8x7b-smoke", n_layers=2, d_model=64, d_ff=128,
    vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16, window=8),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
)
