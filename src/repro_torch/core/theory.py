"""Closed-form error-bound calculators for Theorems 1–2 (a copy of the JAX
package's ``core/theory.py`` on torch tensors).

Used by the tests (an empirical error must respect the bound) and to size
(L, R, K, g) for a target error budget — the paper's relation between
sketch memory and estimation error (§3.4 Memory Requirement).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def mom_error_bound(sigma: float, n_rows: int, delta: float) -> float:
    """Lemma 1 / Theorem 2:  |Z − μ| ≤ 6·σ/√L·√log(1/δ)  w.p. 1−δ."""
    return 6.0 * sigma / math.sqrt(n_rows) * math.sqrt(math.log(1.0 / delta))


def variance_bound(alphas: torch.Tensor,
                   sqrt_kernels: torch.Tensor) -> torch.Tensor:
    """Theorem 1 variance bound:  var ≤ (Σ_i α_i √K(x_i,q))²  per query.

    Args:
      alphas: (M,) or (M, C) weights.
      sqrt_kernels: (B, M) values of √K(x_i, q).
    Returns (B,) or (B, C).
    """
    return (sqrt_kernels @ alphas) ** 2


def rows_for_error(sigma: float, eps: float, delta: float) -> int:
    """Invert Theorem 2: minimum L so the MoM error ≤ eps w.p. 1−δ."""
    return int(math.ceil((6.0 * sigma / eps) ** 2 * math.log(1.0 / delta)))


def mom_groups(delta: float) -> int:
    """Lemma 1's group count g = 8·log(1/δ) (rounded up, min 1)."""
    return max(1, int(math.ceil(8.0 * math.log(1.0 / delta))))


def size_sketch(sigma: float, eps: float, delta: float, n_buckets: int,
                n_outputs: int) -> Tuple[int, int]:
    """Return (L, memory_floats) meeting the (eps, delta) target."""
    n_rows = rows_for_error(sigma, eps, delta)
    return n_rows, n_outputs * n_rows * n_buckets
