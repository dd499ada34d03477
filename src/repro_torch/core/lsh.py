"""p-stable (L2) LSH bank of the Representer-Sketch head.

``h(x) = floor((w·x + b) / r)`` with ``w ~ N(0, I)``, ``b ~ U[0, r)``; the
K sub-hash codes of each of the L rows fold into one bucket index in
``[0, R)`` with a row-salted Carter–Wegman mix.  Bit-for-bit the JAX
package's ``core/lsh.py``: the mix constants, the golden-ratio row salt and
the fold order are the same, so a bank frozen by either package hashes to
the same buckets in both.

torch has no ``>>`` on uint32 CPU tensors, so the uint32 mix runs in int64
with ``& 0xFFFFFFFF`` after every step; the products stay below 2**63.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

MASK32 = 0xFFFFFFFF
MIX_A = 1103515245
MIX_B = 0x45D9F3B
GOLDEN = 0x9E3779B9


def row_salts(n_rows: int, device=None) -> torch.Tensor:
    """Fold salts of sketch rows ``0 .. n_rows-1`` as uint32 values held in
    an int64 tensor: ``row * 0x9E3779B9 mod 2**32``."""
    rows = torch.arange(n_rows, dtype=torch.int64, device=device)
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
        return _fold_subhashes(self.subhash(params, x), self.config.n_buckets)
