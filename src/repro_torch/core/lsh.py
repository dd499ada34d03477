"""Locality-sensitive hash families of the Representer Sketch.

* :class:`L2LSH` — p-stable Euclidean LSH (Datar et al.):
  ``h(x) = floor((w·x + b) / r)`` with ``w ~ N(0, I)``, ``b ~ U[0, r)``;
  its collision probability is the paper's universal L2-LSH kernel.
* :class:`SRPLSH` — sign random projections (angular kernel).
* :class:`AchlioptasL2LSH` — L2 LSH with the sparse ``sqrt(3)·{−1, 0, +1}``
  projection of the paper's inference-time hash.

The K sub-hash codes of each of the L rows fold into one bucket index in
``[0, R)`` with a row-salted Carter–Wegman mix.  Bit-for-bit the JAX
package's ``core/lsh.py``: the mix constants, the golden-ratio row salt and
the fold order are the same, so a bank frozen by either package hashes to
the same buckets in both.  The L2 families hash through the ``lsh_hash``
kernel wrapper (the CUDA kernel for a CUDA tensor, its plain version for a
CPU one); SRP stays plain, as in JAX.

``params(generator)`` draws from one ``torch.Generator`` in a fixed order
(``w``, then ``b``) where JAX splits its key in two; the draws differ from
``jax.random``'s, so tests carry JAX's params across instead.

torch has no ``>>`` on uint32 CPU tensors, so the uint32 mix runs in int64
with ``& 0xFFFFFFFF`` after every step; the products stay below 2**63.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

MASK32 = 0xFFFFFFFF
MIX_A = 1103515245
MIX_B = 0x45D9F3B
GOLDEN = 0x9E3779B9


def row_salts(n_rows: int, start: int = 0, device=None) -> torch.Tensor:
    """Fold salts of sketch rows ``start .. start + n_rows - 1`` as uint32
    values held in an int64 tensor: ``row * 0x9E3779B9 mod 2**32``.  The
    salt is a function of the *global* row, so a row shard of a head
    (the sharded decode path) passes its first row as ``start``."""
    rows = torch.arange(start, start + n_rows, dtype=torch.int64,
                        device=device)
    return (rows * GOLDEN) & MASK32


def _fold_subhashes(codes: torch.Tensor, n_buckets: int,
                    salt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold ``(..., L, K)`` integer sub-hash codes into ``(..., L)`` int32
    bucket indices.  ``salt`` ((L,) uint32 values) overrides
    ``row_salts(L)``."""
    codes = codes.to(torch.int64) & MASK32        # int32 → its uint32 bits
    n_rows, k = codes.shape[-2], codes.shape[-1]
    if salt is None:
        salt = row_salts(n_rows, device=codes.device)
    acc = salt.to(torch.int64).expand(codes.shape[:-1])
    for i in range(k):
        acc = (acc * MIX_A + codes[..., i] + (i * 97 + 13)) & MASK32
        acc = acc ^ (acc >> 16)
        acc = (acc * MIX_B) & MASK32
        acc = acc ^ (acc >> 16)
    return (acc % n_buckets).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    """Static shape of a concatenated LSH bank: L rows, R buckets, K
    sub-hashes of dimension ``dim``, quantization width ``bandwidth``."""
    n_rows: int
    n_buckets: int
    k: int
    dim: int
    bandwidth: float = 1.0


class L2LSH:
    """p-stable Euclidean LSH (Datar et al.), the paper's universal kernel."""

    def __init__(self, config: LSHConfig):
        self.config = config

    def params(self, generator: torch.Generator) -> dict:
        """Hash params drawn from ``generator`` on its device."""
        c = self.config
        dev = generator.device
        w = torch.randn((c.n_rows, c.k, c.dim), generator=generator,
                        device=dev, dtype=torch.float32)
        b = torch.rand((c.n_rows, c.k), generator=generator, device=dev,
                       dtype=torch.float32) * c.bandwidth
        return {"w": w, "b": b}

    def subhash(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Raw int32 sub-hash codes ``(..., L, K)``."""
        proj = torch.einsum("...d,lkd->...lk", x, params["w"])
        return torch.floor((proj + params["b"]) / self.config.bandwidth
                           ).to(torch.int32)

    def hash(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Bucket indices ``(..., L)`` int32 of points ``x`` (..., d'),
        through the ``lsh_hash`` kernel wrapper."""
        from repro_torch.kernels.lsh_hash.ops import lsh_hash

        c = self.config
        flat = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
        idx = lsh_hash(flat, params["w"], params["b"], bandwidth=c.bandwidth,
                       n_buckets=c.n_buckets)
        return idx.reshape(*x.shape[:-1], c.n_rows)

    def collision_probability(self, dist: torch.Tensor) -> torch.Tensor:
        """L2-LSH kernel: P[h(x) = h(y)] at distance c = ||x − y||₂,
        ``p(c) = 1 − 2·Φ(−r/c) − 2c/(√(2π)·r)·(1 − exp(−r²/(2c²)))``, to the
        K-th power (independent concatenation); differentiable."""
        c = torch.clamp(dist, min=1e-9)
        t = self.config.bandwidth / c
        phi = 0.5 * (1.0 + torch.erf(-t / math.sqrt(2.0)))
        p1 = 1.0 - 2.0 * phi - (2.0 / (math.sqrt(2.0 * math.pi) * t)) * (
            1.0 - torch.exp(-(t * t) / 2.0))
        p1 = torch.where(dist <= 1e-9, torch.ones_like(p1), p1)
        return torch.clamp(p1, 0.0, 1.0) ** self.config.k


class SRPLSH:
    """Sign random projection LSH; collision probability ``(1 − θ/π)^K``."""

    def __init__(self, config: LSHConfig):
        self.config = config

    def params(self, generator: torch.Generator) -> dict:
        c = self.config
        return {"w": torch.randn((c.n_rows, c.k, c.dim), generator=generator,
                                 device=generator.device,
                                 dtype=torch.float32)}

    def subhash(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        proj = torch.einsum("...d,lkd->...lk", x, params["w"])
        return (proj >= 0).to(torch.int32)

    def hash(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """K sign bits packed into the bucket index when ``2^K <= R``,
        folded otherwise."""
        c = self.config
        bits = self.subhash(params, x)
        if 2 ** c.k <= c.n_buckets:
            weights = 2 ** torch.arange(c.k, device=x.device, dtype=torch.int32)
            return (bits * weights).sum(dim=-1, dtype=torch.int32)
        return _fold_subhashes(bits, c.n_buckets)

    def collision_probability(self, cos_sim: torch.Tensor) -> torch.Tensor:
        theta = torch.arccos(torch.clamp(cos_sim, -1.0, 1.0))
        return (1.0 - theta / math.pi) ** self.config.k


class AchlioptasL2LSH(L2LSH):
    """L2 LSH whose projection entries are ``sqrt(3)·{+1, 0, −1}`` with
    probabilities ``{1/6, 2/3, 1/6}`` (Achlioptas); the collision
    probability is approximately the Gaussian one for d ≳ 30."""

    def params(self, generator: torch.Generator) -> dict:
        c = self.config
        dev = generator.device
        u = torch.rand((c.n_rows, c.k, c.dim), generator=generator, device=dev)
        w = math.sqrt(3.0) * ((u < 1.0 / 6.0).to(torch.float32)
                              - (u > 5.0 / 6.0).to(torch.float32))
        b = torch.rand((c.n_rows, c.k), generator=generator, device=dev,
                       dtype=torch.float32) * c.bandwidth
        return {"w": w, "b": b}


def make_lsh(kind: str, config: LSHConfig):
    """The LSH family ``kind`` (``"l2"``, ``"srp"`` or ``"achlioptas"``)."""
    if kind == "l2":
        return L2LSH(config)
    if kind == "srp":
        return SRPLSH(config)
    if kind == "achlioptas":
        return AchlioptasL2LSH(config)
    raise ValueError(f"unknown LSH kind: {kind}")
