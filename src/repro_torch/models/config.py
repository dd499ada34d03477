"""Model and sketch-head configuration, limited to what the rwkv pattern uses.

Own copy of the JAX package's ``models/config.py`` dataclasses: the fields,
names and defaults are the same, so a ``SketchHeadConfig`` round-trips
through a head archive between the two packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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

    Only the ``"rwkv"`` block kind is ported; its channel-mix is its FFN.
    """
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...]
    final_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    sketch_head: Optional[SketchHeadConfig] = None
    subquadratic: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not "
                             f"divisible by pattern length {len(self.pattern)}")
        unported = set(self.pattern) - {"rwkv"}
        if unported:
            raise ValueError(f"{self.name}: block kinds {sorted(unported)} "
                             "are not ported; only 'rwkv' is")

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)
