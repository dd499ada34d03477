"""Model, attention, MoE, Mamba and sketch-head configuration, limited to
the ported block kinds (``rwkv``, ``mamba``, ``attn``, ``attn_local``,
``attn_global``).

Own copy of the JAX package's ``models/config.py`` dataclasses: the fields,
names and defaults are the same, so a ``SketchHeadConfig`` round-trips
through a head archive between the two packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


#: The block kinds the port runs: rwkv's time-mix + channel-mix, and the
#: Mamba-1 mixer or causal self-attention (GQA, optional window and
#: softcap), each followed by a dense SwiGLU or an MoE FFN.
PORTED_KINDS = ("rwkv", "mamba", "attn", "attn_local", "attn_global")


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
    """A decoder backbone: ``pattern`` repeated ``n_periods`` times.

    Only the :data:`PORTED_KINDS` are ported; rwkv's channel-mix is its
    FFN, the other kinds are followed by a dense SwiGLU FFN or, on the
    layers :meth:`ffn_kind` names, the MoE FFN of ``moe``.
    """
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...]
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    moe_every: int = 0          # every k-th layer has the MoE FFN (0: none)
    final_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    sketch_head: Optional[SketchHeadConfig] = None
    subquadratic: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not "
                             f"divisible by pattern length {len(self.pattern)}")
        unported = set(self.pattern) - set(PORTED_KINDS)
        if unported:
            raise ValueError(f"{self.name}: block kinds {sorted(unported)} "
                             f"are not ported; ported: {list(PORTED_KINDS)}")

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    def ffn_kind(self, layer_idx: int) -> str:
        """'moe' or 'dense' for the FFN following block ``layer_idx``."""
        if self.moe is None or self.moe_every == 0:
            return "dense"
        if self.moe_every == 1:
            return "moe"
        return ("moe" if layer_idx % self.moe_every == self.moe_every - 1
                else "dense")

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)
