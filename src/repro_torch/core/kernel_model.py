"""The weighted kernel representation  f_K(q) = Σ_j α_j · K(Aᵀq, x_j).

The paper's §3.3/§3.4 object: a learnable weighted LSH-kernel sum with

* ``points``  x_j ∈ R^{d'} — M anchor points in the projected space,
* ``alphas``  α_j ∈ R^C    — per-point weights (one per output channel),
* ``proj``    A ∈ R^{d×d'} — the asymmetric transform applied to queries.

Training evaluates the smooth closed-form L2-LSH collision kernel so
gradients flow (plain PyTorch, autograd); deployment freezes the function
into a :class:`RepresenterSketch` (hash + gather + median of means).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core.lsh import L2LSH, LSHConfig
from repro_torch.core.sketch import RepresenterSketch, SketchConfig


@dataclasses.dataclass(frozen=True)
class KernelModelConfig:
    in_dim: int          # d  — raw feature dimensionality
    proj_dim: int        # d' — asymmetric projected dimensionality
    n_points: int        # M  — number of anchor points (M << N)
    n_outputs: int       # C
    bandwidth: float = 1.0
    k: int = 1           # concatenation depth used at sketch time


class KernelModel:
    """Differentiable weighted LSH-kernel sum + its frozen sketch form."""

    def __init__(self, config: KernelModelConfig):
        self.config = config
        # A one-row bank defines the kernel's shape for training; the sketch
        # draws L independent rows at freeze time.
        self._kernel_lsh = L2LSH(LSHConfig(
            n_rows=1, n_buckets=2, k=config.k, dim=config.proj_dim,
            bandwidth=config.bandwidth))

    def init(self, generator: torch.Generator) -> dict:
        """Points, alphas and proj drawn from ``generator`` in that order
        (JAX splits its key three ways), on the generator's device."""
        c = self.config
        dev = generator.device

        def normal(shape):
            return torch.randn(shape, generator=generator, device=dev,
                               dtype=torch.float32)

        return {"points": 0.1 * normal((c.n_points, c.proj_dim)),
                "alphas": 0.01 * normal((c.n_points, c.n_outputs)),
                "proj": normal((c.in_dim, c.proj_dim)) / math.sqrt(c.in_dim)}

    def transform(self, params: dict, q: torch.Tensor) -> torch.Tensor:
        """Asymmetric query transform  T(q) = Aᵀq."""
        return q @ params["proj"]

    def apply(self, params: dict, q: torch.Tensor) -> torch.Tensor:
        """Smooth forward pass (B, d) → (B, C) through the closed-form
        collision probability: the function the sketch estimates."""
        tq = self.transform(params, q)
        pts = params["points"]
        sq = (torch.sum(tq * tq, -1)[:, None] - 2.0 * tq @ pts.T
              + torch.sum(pts ** 2, -1)[None, :])
        dist = torch.sqrt(torch.clamp(sq, min=1e-12))
        return self._kernel_lsh.collision_probability(dist) @ params["alphas"]

    def sketch_config(self, n_rows: int, n_buckets: int,
                      n_groups: int = 8) -> SketchConfig:
        c = self.config
        return SketchConfig(n_rows=n_rows, n_buckets=n_buckets, k=c.k,
                            dim=c.proj_dim, n_outputs=c.n_outputs,
                            bandwidth=c.bandwidth, lsh_kind="l2",
                            n_groups=n_groups)

    def freeze(self, generator: torch.Generator, params: dict, n_rows: int,
               n_buckets: int, n_groups: int = 8
               ) -> Tuple[RepresenterSketch, dict]:
        """The deployment sketch of the learned (points, alphas): hash params
        from ``generator``, then the points folded in."""
        sk = RepresenterSketch(self.sketch_config(n_rows, n_buckets, n_groups))
        state = sk.init(generator)
        return sk, sk.build_streaming(state, params["points"],
                                      params["alphas"])

    # -- cost accounting (paper §4.3 formulas) -------------------------------

    def sketch_memory_params(self, n_rows: int, n_buckets: int) -> int:
        """Stored parameter count: array (C·L·R) + projection (d·d')."""
        c = self.config
        return c.n_outputs * n_rows * n_buckets + c.in_dim * c.proj_dim

    def sketch_flops(self, n_rows: int, n_buckets: int) -> int:
        """Paper's FLOP model per query: 2·d·p + p·K·L/3 + L·C (K·L sparse
        Achlioptas hashes touching p/3 nonzeros each)."""
        c = self.config
        return int(2 * c.in_dim * c.proj_dim + c.proj_dim * c.k * n_rows / 3
                   + n_rows * c.n_outputs)


def mlp_memory_params(layer_sizes: Tuple[int, ...]) -> int:
    """Dense-MLP parameter count (weights + biases) for the NN baseline."""
    return sum(a * b + b for a, b in zip(layer_sizes[:-1], layer_sizes[1:]))


def mlp_flops(layer_sizes: Tuple[int, ...]) -> int:
    """Per-query multiply-accumulate FLOPs of the dense MLP baseline."""
    return int(sum(2 * a * b for a, b in zip(layer_sizes[:-1],
                                             layer_sizes[1:])))
