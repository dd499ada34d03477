"""The parity rules that hold the port against its references.

* Hash indices: two f32 implementations of ``floor((q·w + b) / r)`` may sum
  in different orders, so an index may differ only where one of its K
  exact values ``(q·w + b) / r`` lies within the f32 forward-error bound
  of an integer.  The bound of a dot product of n terms in any summation
  order is ``γ_n = n·u / (1 - n·u)`` (u = 2⁻²⁴) times the sum of the
  terms' magnitudes; the transform ``q = h·A`` adds d terms to the chain
  and ``+ b`` and ``/ r`` one rounding each.  :func:`check_hash_indices`
  asserts this for every mismatch.
* Logits: a mean of the same L f32 terms summed in two orders differs by
  at most ``2·(γ_L + 2u)·max|term|`` (:func:`gather_atol`).
* Sketch folds (``race_update``): a count plus the sum of M weights is a
  sum of M + 1 f32 terms, within ``γ_{M+1}·(|count| + Σ_m |α[m, v]|)`` of
  its exact value in any order (:func:`race_update_tol`); the kernel is
  held to that bound per element against the plain version.
* Sketch queries (``race_query``): each group mean is a sum of m = ⌊L/g⌋
  f32 reads divided by m; two orders of the sum and one division each
  differ by at most ``2·(γ_m + 2u)·Σ_group |read| / m``.  The median is
  1-Lipschitz in the max-norm over the g means, and its midpoint
  ``(lo + hi)·0.5`` adds one rounding on each side, ``2u·max_g |mean|``;
  :func:`race_query_tol` is the sum, per (query, class).
* The bf16 backbone against another implementation of it (the JAX
  package's compiled forward, or the same model on another device): bf16
  keeps 8 bits (one ulp is 2⁻⁸ relative), each layer rounds a dozen times,
  and the other side may skip or reorder some of those roundings (XLA
  keeps excess precision inside fusions; cuBLAS sums in other orders), so
  the two differ by a few ulps that add up over the layers.
  :func:`bf16_backbone_errors` measures the difference; the limits are
  2⁻⁵ (8 ulps) relative in norm and 2⁻⁴ of the largest magnitude at any
  element.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

U32 = 2.0 ** -24          # unit roundoff of f32


def _gamma(n: int) -> float:
    return n * U32 / (1.0 - n * U32)


def hash_boundary_tol(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      bandwidth: float, proj: Optional[torch.Tensor] = None):
    """``(t, tol)``: the exact sub-hash values ``t = (q·w + b) / r`` (B, L, K)
    in float64 and the f32 forward-error bound ``tol`` of each.

    ``x`` is the query q (B, d'), or with ``proj`` the hidden h (B, d) and
    ``q = h·proj``."""
    x64 = x.to(torch.float64)
    w64, b64 = w.to(torch.float64), b.to(torch.float64)
    n = w.shape[-1] + 2
    if proj is None:
        q, qabs = x64, x64.abs()
    else:
        p64 = proj.to(torch.float64)
        q, qabs = x64 @ p64, x64.abs() @ p64.abs()
        n += proj.shape[0]
    t = (torch.einsum("bd,lkd->blk", q, w64) + b64) / bandwidth
    mag = (torch.einsum("bd,lkd->blk", qabs, w64.abs()) + b64.abs()) / bandwidth
    return t, _gamma(n) * mag


def check_hash_indices(got: torch.Tensor, want: torch.Tensor, x, w, b,
                       bandwidth: float, proj=None) -> int:
    """Assert the boundary rule for every index where ``got != want``
    (both (B, L)); returns the number of mismatches."""
    mismatch = (got.long() != want.long()).cpu()
    n_bad = int(mismatch.sum())
    if not n_bad:
        return 0
    t, tol = hash_boundary_tol(x, w, b, bandwidth, proj)
    dist = (t - torch.round(t)).abs()
    near = (dist <= tol).any(dim=-1).cpu()            # (B, L)
    unexplained = mismatch & ~near
    if bool(unexplained.any()):
        bb, ll = (int(i) for i in unexplained.nonzero()[0])
        raise AssertionError(
            f"{int(unexplained.sum())} of {n_bad} mismatched hash indices "
            f"are not at a floor() boundary; first at (b={bb}, l={ll}): "
            f"got {int(got[bb, ll])}, want {int(want[bb, ll])}, "
            f"t={t[bb, ll].tolist()}, distance to an integer "
            f"{dist[bb, ll].tolist()} > bound {tol[bb, ll].tolist()}")
    return n_bad


def gather_atol(n_rows: int, max_abs_term: float) -> float:
    """Largest difference of two f32 means of the same ``n_rows`` terms,
    each at most ``max_abs_term`` in magnitude, summed in any orders."""
    return 2.0 * (_gamma(n_rows) + 2.0 * U32) * max_abs_term


def race_update_tol(counts: torch.Tensor, alphas: torch.Tensor,
                    class_axis: int) -> torch.Tensor:
    """Per-element tolerance of a fold of (M, C) weights ``alphas`` into
    ``counts``: ``γ_{M+1}·(|count| + Σ_m |α[m, c]|)``, the class ``c`` on
    ``class_axis`` of ``counts`` (-1 for a head's (L, R, V) counts, 0 for a
    (C, L, R) sketch)."""
    n_points = alphas.shape[0]
    mass = alphas.to(torch.float64).abs().sum(dim=0)
    shape = [1] * counts.dim()
    shape[class_axis] = -1
    return _gamma(n_points + 1) * (counts.to(torch.float64).abs()
                                   + mass.reshape(shape))


def race_query_tol(sketch: torch.Tensor, idx: torch.Tensor,
                   n_groups: int) -> torch.Tensor:
    """(B, C) float64 tolerance of a median-of-means estimate from the
    (C, L, R) ``sketch`` at the (B, L) indices ``idx``:
    ``max_g 2·(γ_m + 2u)·Σ_group |read| / m + 2u·max_g |mean|`` with
    m = ⌊L / n_groups⌋ (NaN where m = 0: the estimate itself is NaN)."""
    s = sketch.to(torch.float64)
    rows = torch.arange(s.shape[1], device=s.device)
    reads = s[:, rows, idx.long()].permute(1, 0, 2)          # (B, C, L)
    m = reads.shape[-1] // n_groups
    grouped = reads[..., : n_groups * m].reshape(*reads.shape[:-1],
                                                 n_groups, m)
    mag = grouped.abs().sum(dim=-1) / m                       # (B, C, g)
    return (2.0 * (_gamma(m) + 2.0 * U32) * mag.amax(dim=-1)
            + 2.0 * U32 * grouped.mean(dim=-1).abs().amax(dim=-1))


BF16_NORM_TOL = 2.0 ** -5
BF16_MAX_TOL = 2.0 ** -4


def bf16_backbone_errors(got, want) -> Tuple[float, float]:
    """``(relative error in norm, largest error / largest |want|)``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            float(np.abs(got - want).max() / np.abs(want).max()))


def assert_bf16_backbone_close(got, want) -> None:
    """Raise unless ``got`` meets the bf16 backbone rule against ``want``."""
    norm_err, max_err = bf16_backbone_errors(got, want)
    if not (norm_err <= BF16_NORM_TOL and max_err <= BF16_MAX_TOL):
        raise AssertionError(
            f"bf16 backbone outputs differ by {norm_err:.3g} in norm (limit "
            f"{BF16_NORM_TOL}) and {max_err:.3g} of the largest magnitude "
            f"(limit {BF16_MAX_TOL})")
