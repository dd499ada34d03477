"""rwkv6-1.6b — Finch, attention-free with data-dependent decay [arXiv:2404.05892].

24L, d_model=2048, d_ff=7168, vocab=65536.  Constant-size recurrent state
(B, H, 64, 64).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    n_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab_size=65536,
    pattern=("rwkv",),
    subquadratic=True,
)

SMOKE = CONFIG.scaled(
    name="rwkv6-1.6b-smoke", n_layers=2, d_model=64, d_ff=128, vocab_size=256,
)
