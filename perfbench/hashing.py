"""The sketched head's L2-LSH bucket indices, as the paper defines them.

``h(x) = floor((w·x + b) / r)`` per sub-hash, the K codes of a row folded
with a row-salted Carter–Wegman mix into a bucket in [0, R).  The mix
constants, the golden-ratio salt of row l and the fold order are those of
the head format the program serves, so that counts built here index the
same buckets.  Plain PyTorch; uint32 words are held in int64 with a mask
after every step.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
MIX_A = 1103515245
MIX_B = 0x45D9F3B
GOLDEN = 0x9E3779B9


def fold(codes: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(..., L, K) integer codes → (..., L) bucket indices (int64)."""
    codes = codes.to(torch.int64) & MASK32
    n_rows, k = codes.shape[-2], codes.shape[-1]
    rows = torch.arange(n_rows, dtype=torch.int64, device=codes.device)
    acc = ((rows * GOLDEN) & MASK32).expand(codes.shape[:-1])
    for i in range(k):
        acc = (acc * MIX_A + codes[..., i] + (i * 97 + 13)) & MASK32
        acc = acc ^ (acc >> 16)
        acc = (acc * MIX_B) & MASK32
        acc = acc ^ (acc >> 16)
    return acc % n_buckets


def bucket_indices(q: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   bandwidth: float, n_buckets: int) -> torch.Tensor:
    """(N, d') points against an (L, K, d') bank with offsets (L, K) →
    (N, L) bucket indices, computed in f32."""
    proj = torch.einsum("nd,lkd->nlk", q.to(torch.float32), w)
    codes = torch.floor((proj + b) / bandwidth).to(torch.int64)
    return fold(codes, n_buckets)
