"""Model, attention, MLA, MoE, Mamba and sketch-head configuration, and
the analytic parameter count.

Own copy of the JAX package's ``models/config.py`` dataclasses: the fields,
names and defaults are the same, so a ``SketchHeadConfig`` round-trips
through a head archive between the two packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


#: The block kinds the port runs: rwkv's time-mix + channel-mix, and the
#: Mamba-1 mixer, causal self-attention (GQA, optional window and
#: softcap), Multi-head Latent Attention or cross-attention to encoder
#: states, each followed by a dense SwiGLU or an MoE FFN.  Every kind of
#: the JAX package's registry.
PORTED_KINDS = ("rwkv", "mamba", "attn", "attn_local", "attn_global", "mla",
                "xattn")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: Optional[int] = None          # sliding-window size (SWA); None=full
    logit_softcap: Optional[float] = None  # gemma2-style attn-score softcap
    rope_theta: float = 10000.0
    use_rope: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # Routing-group size (tokens compete for capacity within a group).
    group_size: int = 2048


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class SketchHeadConfig:
    """Representer-Sketch LM head (the paper's technique)."""
    n_rows: int = 64       # L
    n_buckets: int = 16    # R
    k: int = 2
    proj_dim: int = 64     # d' of the asymmetric transform
    bandwidth: float = 4.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A decoder backbone: ``n_dense_prologue`` layers of kind
    ``pattern[0]`` with a dense FFN, then ``pattern`` repeated
    ``n_periods`` times.

    rwkv's channel-mix is its FFN; the other kinds are followed by a dense
    SwiGLU FFN or, on the layers :meth:`ffn_kind` names, the MoE FFN of
    ``moe``.  ``n_encoder_tokens`` is the number of (stub) encoder states a
    sample brings for its ``xattn`` layers.
    """
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...]
    attention: Optional[AttentionConfig] = None
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    moe_every: int = 0          # every k-th layer has the MoE FFN (0: none)
    final_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    n_encoder_tokens: int = 0   # encoder states a sample brings (xattn)
    sketch_head: Optional[SketchHeadConfig] = None
    subquadratic: bool = False
    n_dense_prologue: int = 0   # leading layers of kind pattern[0], dense FFN

    def __post_init__(self):
        if (self.n_layers - self.n_dense_prologue) % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} minus "
                             f"prologue {self.n_dense_prologue} not divisible "
                             f"by pattern length {len(self.pattern)}")
        unported = set(self.pattern) - set(PORTED_KINDS)
        if unported:
            raise ValueError(f"{self.name}: block kinds {sorted(unported)} "
                             f"are not ported; ported: {list(PORTED_KINDS)}")

    @property
    def n_periods(self) -> int:
        return (self.n_layers - self.n_dense_prologue) // len(self.pattern)

    def layer_kind(self, layer_idx: int) -> str:
        """The block kind of layer ``layer_idx`` (prologue layers first)."""
        if layer_idx < self.n_dense_prologue:
            return self.pattern[0]
        return self.pattern[(layer_idx - self.n_dense_prologue)
                            % len(self.pattern)]

    def ffn_kind(self, layer_idx: int) -> str:
        """'moe' or 'dense' for the FFN following block ``layer_idx``
        (a prologue layer's is dense)."""
        if layer_idx < self.n_dense_prologue:
            return "dense"
        if self.moe is None or self.moe_every == 0:
            return "dense"
        if self.moe_every == 1:
            return "moe"
        return ("moe" if layer_idx % self.moe_every == self.moe_every - 1
                else "dense")

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embedding, blocks, head), as the JAX
    package counts it."""
    d = cfg.d_model
    total = cfg.vocab_size * d                      # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d                 # head
    for j in range(cfg.n_layers):
        kind = cfg.layer_kind(j)
        if kind in ("attn", "attn_local", "attn_global", "xattn"):
            a = cfg.attention
            total += d * a.n_heads * a.head_dim                 # q
            total += 2 * d * a.n_kv_heads * a.head_dim          # k, v
            total += a.n_heads * a.head_dim * d                 # o
        elif kind == "mla":
            m = cfg.mla
            total += d * m.q_lora_rank + m.q_lora_rank * m.n_heads * m.qk_head_dim
            total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            total += m.kv_lora_rank * m.n_heads * (m.qk_nope_head_dim
                                                   + m.v_head_dim)
            total += m.n_heads * m.v_head_dim * d
        elif kind == "mamba":
            mb = cfg.mamba
            d_in = mb.expand * d
            dt_rank = mb.dt_rank or -(-d // 16)
            total += d * 2 * d_in                       # in_proj
            total += d_in * mb.d_conv                   # conv
            total += d_in * (dt_rank + 2 * mb.d_state)  # x_proj
            total += dt_rank * d_in + d_in              # dt_proj
            total += 2 * d_in * mb.d_state              # A (log) and D terms
            total += d_in * d                           # out_proj
        elif kind == "rwkv":
            total += 5 * d * d + 2 * 64 * d + 12 * d    # time-mix
            total += 2 * d * cfg.d_ff + d * d           # channel-mix
        if kind != "rwkv":           # rwkv's channel-mix is its FFN
            if cfg.ffn_kind(j) == "moe":
                mo = cfg.moe
                total += d * mo.n_experts               # router
                total += ((mo.n_experts + mo.n_shared_experts) * 3 * d
                          * mo.d_ff_expert)
            else:
                total += 3 * d * cfg.d_ff               # SwiGLU
        total += 2 * d                                  # norms
    return total + d                                    # final norm


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token: an MoE layer's top_k and shared
    experts only, as the JAX package counts them."""
    if cfg.moe is None or cfg.moe_every == 0:
        return param_count(cfg)
    mo = cfg.moe
    n_moe_layers = sum(1 for j in range(cfg.n_layers)
                       if cfg.ffn_kind(j) == "moe")
    inactive = (n_moe_layers * (mo.n_experts - mo.top_k) * 3 * cfg.d_model
                * mo.d_ff_expert)
    return param_count(cfg) - inactive
