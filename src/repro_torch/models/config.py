"""Model, attention and sketch-head configuration, limited to the ported
block kinds (``rwkv``, ``attn``, ``attn_local``, ``attn_global``).

Own copy of the JAX package's ``models/config.py`` dataclasses: the fields,
names and defaults are the same, so a ``SketchHeadConfig`` round-trips
through a head archive between the two packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


#: The block kinds the port runs: rwkv's time-mix + channel-mix, and causal
#: self-attention (GQA, optional window and softcap) + a dense SwiGLU FFN.
PORTED_KINDS = ("rwkv", "attn", "attn_local", "attn_global")


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
    FFN, the attention kinds are followed by a dense SwiGLU FFN.
    """
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...]
    attention: Optional[AttentionConfig] = None
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

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)
