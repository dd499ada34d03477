"""deepseek-v3-671b — MLA + 256-expert MoE (1 shared, top-8) [arXiv:2412.19437].

61L, d_model=7168, 128 heads MLA (q_lora=1536, kv_lora=512, nope=128,
rope=64, v=128), 3 dense prologue layers (d_ff=18432) then MoE with expert
d_ff=2048, vocab=129280.  The decode cache keeps the MLA latent (512 + 64
values a position).  The card serves it at full width and reduced depth:
the 3 prologue layers and 2 MoE layers are 26.6 B params, 49.6 GiB bf16.
"""

from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    d_ff=18432,            # dense prologue FFN width
    vocab_size=129280,
    pattern=("mla",),
    mla=MLAConfig(n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, group_size=512),
    moe_every=1,
    n_dense_prologue=3,
    subquadratic=True,     # MLA latent cache
)

SMOKE = CONFIG.scaled(
    name="deepseek-v3-671b-smoke", n_layers=3, d_model=64, d_ff=128,
    vocab_size=256, n_dense_prologue=1,
    mla=MLAConfig(n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared_experts=1),
)
