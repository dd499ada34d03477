"""Sampler: the decode-time sampling policy.  Greedy only in this slice.

Seeded sampling (temperature, top-k, top-p) replays the JAX package's
threefry key chain and comes with a later slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Sampler:
    """The sampling policy.  ``temperature == 0`` is greedy argmax.

    Raises:
      ValueError: on a negative temperature.
      NotImplementedError: on ``temperature > 0`` (seeded sampling is a
        later slice of the port).
    """

    temperature: float = 0.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.temperature > 0:
            raise NotImplementedError(
                "repro_torch samples greedily only; temperature/top-k/top-p "
                "sampling needs the threefry key-chain port, a later slice")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(B,) int64 token ids: the first maximum of each row of the (B, V)
        logits, as ``jnp.argmax`` picks it."""
        return torch.argmax(logits, dim=-1)

    def describe(self) -> str:
        return "greedy"
