"""jamba-v0.1-52b — Mamba+attention 1:7 hybrid with MoE [arXiv:2403.19887].

32L, d_model=4096; each period of 8 layers has one attention layer
(position 3, no RoPE) and seven Mamba layers; MoE (16 experts, top-2,
expert d_ff=14336) on every second layer.  51.6 B params, 96.1 GiB in
bf16: the card runs it at full width and reduced depth.
"""

from repro_torch.models.config import (AttentionConfig, MambaConfig,
                                       MoEConfig, ModelConfig)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    pattern=("mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba", "mamba"),
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              use_rope=False),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    moe_every=2,
    subquadratic=True,
)

SMOKE = CONFIG.scaled(
    name="jamba-v0.1-52b-smoke", n_layers=8, d_model=64, d_ff=128,
    vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              use_rope=False),
    mamba=MambaConfig(d_state=4, d_conv=2, expand=2),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
)
