"""Weighted RACE sketch (the paper's §3.2) and median-of-means queries.

A sketch is an ``(L, R)`` float array per output channel, stored
``(C, L, R)`` for C classes or regression targets.

Construction (Algorithm 1)::

    S[c, l, h_l(x_i)] += alpha_i[c]      for every point, every row

through the ``race_update`` kernel wrapper (its (C, L, R) entry).

Query (Algorithm 2)::

    z_l = S[c, l, h_l(q)]                L row reads
    f_hat(q) = median of g group means   median of means

through the ``race_query`` kernel wrapper.  Both hash through
``L2LSH.hash`` (the ``lsh_hash`` wrapper) for the L2 families; the SRP hash
is plain torch, as in JAX.  On CPU tensors every wrapper runs its plain
version.  ``init`` draws the hash params from a ``torch.Generator`` (the
JAX package's ``init(key)`` from a key), so carried-across JAX states
(``repro_torch.convert.sketch_state_from_numpy``) are how both packages
query the same sketch.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.lsh import LSHConfig, make_lsh
from repro_torch.kernels.race_query.ops import mom_estimate, race_query
from repro_torch.kernels.race_update.ops import race_update

__all__ = ["SketchConfig", "RepresenterSketch", "mom_estimate"]


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    n_rows: int          # L
    n_buckets: int       # R
    k: int               # concatenation depth per row
    dim: int             # hashed dimensionality (d or d' post-projection)
    n_outputs: int = 1   # C — number of output channels (classes/targets)
    bandwidth: float = 1.0
    lsh_kind: str = "l2"
    n_groups: int = 8    # g for median-of-means

    @property
    def lsh_config(self) -> LSHConfig:
        return LSHConfig(n_rows=self.n_rows, n_buckets=self.n_buckets,
                         k=self.k, dim=self.dim, bandwidth=self.bandwidth)

    @property
    def memory_floats(self) -> int:
        """Number of stored floats — the paper's memory metric (§4.3)."""
        return self.n_outputs * self.n_rows * self.n_buckets


class RepresenterSketch:
    """Weighted RACE sketch with MoM queries."""

    def __init__(self, config: SketchConfig):
        self.config = config
        self.lsh = make_lsh(config.lsh_kind, config.lsh_config)

    def init(self, generator: torch.Generator) -> dict:
        """Hash params drawn from ``generator``, an empty (C, L, R) array and
        the inserted mass Σ_i α_i per channel, on the generator's device.

        ``mass`` serves the query's debias: the fold of K sub-hashes into R
        buckets collides unrelated points with probability 1/R, so
        E[S[h(q)]] = (1 − 1/R)·KDE + Σα/R."""
        c = self.config
        dev = generator.device
        return {"hash": self.lsh.params(generator),
                "array": torch.zeros((c.n_outputs, c.n_rows, c.n_buckets),
                                     dtype=torch.float32, device=dev),
                "mass": torch.zeros((c.n_outputs,), dtype=torch.float32,
                                    device=dev)}

    def build(self, state: dict, points: torch.Tensor,
              alphas: torch.Tensor) -> dict:
        """Insert ``points`` (M, d) with weights ``alphas`` (M, C) or (M,)."""
        idx = self.lsh.hash(state["hash"], points)                # (M, L)
        if alphas.dim() == 1:
            alphas = alphas[:, None]
        alphas = alphas.to(torch.float32).contiguous()
        return {"hash": state["hash"],
                "array": race_update(state["array"], idx.contiguous(), alphas),
                "mass": state["mass"] + alphas.sum(dim=0)}

    def build_streaming(self, state: dict, points: torch.Tensor,
                        alphas: torch.Tensor, chunk: int = 4096) -> dict:
        """:meth:`build` over chunks of ``chunk`` points (one hash and one
        fold each)."""
        out = state
        for start in range(0, points.shape[0], chunk):
            out = self.build(out, points[start:start + chunk],
                             alphas[start:start + chunk])
        return out

    def row_reads(self, state: dict, queries: torch.Tensor) -> torch.Tensor:
        """The raw ``(B, C, L)`` row reads ``S[c, l, h_l(q)]``."""
        idx = self.lsh.hash(state["hash"], queries).long()         # (B, L)
        arr = state["array"]
        rows = torch.arange(arr.shape[1], device=arr.device)
        return arr[:, rows, idx].permute(1, 0, 2)

    def debiased(self, state: dict) -> torch.Tensor:
        """The (C, L, R) array less the 1/R collision floor,
        ``(S − mass / R) / (1 − 1/R)`` element by element: the reference's
        expression on its gathered reads, applied once to the array.  The
        divisors are f32 tensors on the array's device so the card divides
        exactly (it multiplies by a reciprocal for a host scalar)."""
        arr = state["array"]
        r = self.config.n_buckets
        floor = state["mass"][:, None, None] / torch.tensor(
            float(r), dtype=torch.float32, device=arr.device)
        return (arr - floor) / torch.tensor(1.0 - 1.0 / r,
                                            dtype=torch.float32,
                                            device=arr.device)

    def query(self, state: dict, queries: torch.Tensor,
              mom: bool = True) -> torch.Tensor:
        """Estimate the weighted KDE for a batch of queries → (B, C).

        ``mom=True`` takes the median of ``n_groups`` group means;
        ``mom=False`` the plain mean over all L rows (one group)."""
        idx = self.lsh.hash(state["hash"], queries).contiguous()   # (B, L)
        return race_query(self.debiased(state), idx,
                          n_groups=self.config.n_groups if mom else 1)

    def exact_weighted_kde(self, points: torch.Tensor, alphas: torch.Tensor,
                           queries: torch.Tensor) -> torch.Tensor:
        """Exact ``Σ_i α_i K(q, x_i)`` with the closed-form collision
        kernel."""
        if alphas.dim() == 1:
            alphas = alphas[:, None]
        dist = torch.linalg.norm(queries[:, None, :] - points[None, :, :],
                                 dim=-1)
        return self.lsh.collision_probability(dist) @ alphas.to(torch.float32)
