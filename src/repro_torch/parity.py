"""The parity rules that hold the port against its references.

* Hash indices: two f32 implementations of ``floor((q·w + b) / r)`` may sum
  in different orders, so an index may differ only where one of its K
  exact values ``(q·w + b) / r`` lies within the f32 forward-error bound
  of an integer.  The bound of a dot product of n terms in any summation
  order is ``γ_n = n·u / (1 - n·u)`` (u = 2⁻²⁴) times the sum of the
  terms' magnitudes; the transform ``q = h·A`` adds d terms to the chain
  and ``+ b`` and ``/ r`` one rounding each.  :func:`check_hash_indices`
  asserts this for every mismatch.
* MoE routing: the f32 router logits ``x·R`` of two implementations may
  sum in different orders, each within ``γ_d·Σ_i |x_i·R_ie|`` of the exact
  value.  A top-k choice made on those logits can differ from the exact
  one only by swapping a chosen expert e for an unchosen f with
  ``l_e − l_f`` within ``γ_d·(M_e + M_f)``, so the exact k-th and
  (k+1)-th largest logits of that token lie within ``2·γ_d·max_e M_e``
  (:func:`check_router_choices`).
* Seeded sampling: the two packages draw the same keys, bits and uniforms
  bit for bit, but ``-log(-log(u))`` goes through each library's f32
  ``log`` (within an ulp or two, 2u relative for each): the Gumbel score
  ``g + l`` of each implementation is within ``E = 4u·(1 + |g| + |g + l|)``
  of its exact value (the first log's relative error passes to the second
  as an absolute one, the second rounds, and so does the sum).  A token
  may differ only where the two winners' exact scores are within
  ``2·(E_a + E_b)``.  A top-p cut may differ only where the mass before a
  token of the descending sort lies within ``2·(2·γ_V + 4u)`` of ``top_p``
  (each side's softmax within ``γ_V + 3u`` of each probability, its cumsum
  within ``γ_V``); :func:`top_p_near_cut` finds those rows and
  :func:`check_sampled_tokens` asserts the rule for every mismatch.
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
* Attention (``flash_attn``): two f32 evaluations of causal softmax
  attention, in any summation order and online or not, differ per output
  element by at most ``(2·ε + e^{2E} − 1)·Σ_k w_k·|v_k|`` (w the softmax
  weights).  E bounds the two score evaluations' difference over the row's
  live keys: ``2·γ_dh·Σ_d |q_d·k_d|`` for the dot products, plus the
  softcap's division, tanh (2 ulps) and product on each side.  ε is one
  evaluation's own relative error: exp (2 ulps, and u·|s − m| from the
  subtraction), the n-term sums of the denominator and of p·v (γ_n each),
  two products per 32-key tile of the online rescaling, and the final
  division.  A bf16 output adds one bf16 ulp for the two roundings
  (:func:`flash_attn_tol`).
* The same, where the kernel runs on the tensor cores (bf16 inputs).  Its
  products are exact (bf16 by bf16; p·v against the three bf16 terms of
  p·2¹⁶, whose sum is p exactly), but the wgmma's f32 accumulation is not
  IEEE: the model taken here is the coarsest reported for NVIDIA tensor
  cores (Fasi, Higham, Mikaitis & Pranesh, "Numerical behavior of NVIDIA
  tensor cores", PeerJ CS 2021): each block of g ≥ 4 products is added to
  the accumulator by aligning all g + 1 addends to the largest exponent
  with no guard bits, each cut toward zero, and cutting the normalised
  sum toward zero.  The g smaller addends lose under 2u·max each and the
  sum under 2u·|sum|, so a block is off by under δ = 2(g + 1)u of the sum
  of its addends' magnitudes, per product the most at g = 4: δ = 10u, four
  blocks per 16-product k-step, and a chain of N blocks within
  ``(1 + δ)^N − 1`` of the sum of the products' magnitudes.  The kernel's
  score is ``RN(dh^-0.5 · Σ_d q_d·k_d)`` (dh/4 blocks), where the reference
  rounds each ``q_d·dh^-0.5`` to f32 first: against the exact
  ``Σ_d qs_d·k_d`` it is off by ``((1 + u)·τ + 2u)/(1 − u)·Σ_d |qs_d·k_d|``
  with ``τ = (1 + δ)^{dh/4} − 1``, and the reference by ``γ_dh`` of the
  same sum.  With a softcap the kernel goes to s/softcap in one product,
  ``RN(Σ_d q_d·k_d · RN(dh^-0.5/softcap))``: the same two roundings as
  scaling and then dividing, which the score's and the softcap's terms
  count.  Its p·v adds three terms per live key, so the k-steps that hold
  the n live keys of a row, at most ⌈n/16⌉ + 1, make ``12·(⌈n/16⌉ + 1)``
  blocks over magnitudes at most ``(1 + 2⁻⁶)·Σ p·|v|``; the denominator
  stays an f32 sum on the CUDA cores (γ_n), and the rescaling counts two
  products per 16 keys (+ one).  The two evaluations' ε then differ, and
  the bound adds them.  Like the rest of these bounds it assumes no
  underflow or overflow.
* The attention backward (``flash_attn_bwd``): two f32 evaluations of
  ``(dq, dk, dv)`` from the same q, k, v, out, dout and lse, each against
  the exact value of its own formulas, to first order.  A score is off by
  ``e_s = γ_dh·Σ_d |qs_d·k_d|`` (qs = RN(q·dh^-0.5), the same on both
  sides), the softcap adds ``6u·|s_c|`` as in the forward's rule, and
  ``p = exp(s_c − lse)`` is then off by the relative ``e_p = e_s +
  u·|s_c − lse| + 3u`` (the subtraction, exp's 2 ulps).  ``dp = dout·v``
  and ``D = Σ dout·out`` are off by ``γ_dh`` of their magnitudes;
  ``ds_c = p·(dp − D)`` by ``p·(e_p·|dp − D| + e_dp + e_D + 2u·|dp − D|)``;
  the softcap's factor ``w = 1 − t²`` (``t = tanh(s/softcap)``, off by
  ``e_t = (e_s + u·|s|)/softcap·w + 2u·|t|``) by ``2|t|·e_t + 2u``.  Each
  gradient is a sum of n terms (n the keys of a row for dq, the group's
  queries for dk and dv): its error is the sum of its terms' errors times
  the other factor's magnitude, plus ``γ_n`` of the terms' magnitudes,
  plus one rounding for dq's final ``dh^-0.5``.  Two evaluations differ
  by at most twice that; a bf16 output adds one bf16 ulp of the larger
  magnitude (:func:`flash_attn_bwd_tol`).
* The same, where the backward kernel runs on the tensor cores (bf16
  inputs): the kernel's error under the accumulation model above plus the
  reference's f32 error.  Its score is the forward's, ``RN(dh^-0.5 · Σ_d
  q_d·k_d)`` over dh/4 blocks (the forward's score term), and ``dp = Σ_d
  dout_d·v_d`` a chain of dh/4 blocks of exact products, off by
  ``τ·Σ|dout·v|``; D, p, ds and the softcap's factor keep their CUDA-core
  terms.  dv, dk and dq add the exact products of the three bf16 terms of
  p·2¹⁶ or ds·2¹⁶ (magnitudes within (1 + 2⁻⁶) of |p| or |ds|), 12 blocks
  per 16-wide k-step: for dq the k-steps a query's block walks, at most
  ⌈n/16⌉ + 12 for its n live keys (its tiles hold at most 191 keys beside
  them); for dk and dv every k-step a key's block could walk, g·(⌈S/16⌉ +
  4) over the group's g query heads.  dk takes its dh^-0.5 after the sum
  (one rounding, and the reference's ``RN(q·dh^-0.5)`` differs from the
  exact product by u), and dq and dk their scale in one product with the
  2⁻¹⁶ (:func:`flash_attn_bwd_tol`'s ``tensor_cores``, its default for
  bf16 CUDA tensors).
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

import math
from typing import Optional, Tuple

import numpy as np
import torch

U32 = 2.0 ** -24          # unit roundoff of f32
_TC_BLOCK = 10.0 * U32    # δ: one tensor-core accumulation block (g = 4)


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


def router_tol(x: torch.Tensor, router: torch.Tensor):
    """``(logits, tol)``: the exact router logits of tokens x (..., d) in
    float64 and, per token (...,), ``2·γ_d·max_e Σ_i |x_i·R_ie|``."""
    x64, r64 = x.to(torch.float64), router.to(torch.float64)
    mag = x64.abs() @ r64.abs()
    return x64 @ r64, 2.0 * _gamma(x.shape[-1]) * mag.amax(dim=-1)


def check_router_choices(got: torch.Tensor, want: torch.Tensor,
                         x: torch.Tensor, router: torch.Tensor,
                         k: int) -> int:
    """Assert the routing rule for every token whose (..., E) expert mask
    differs between ``got`` and ``want`` (x: the router's input tokens
    (..., d)); returns the number of such tokens."""
    mismatch = (got.bool() != want.bool()).any(dim=-1).cpu()
    n_bad = int(mismatch.sum())
    if not n_bad:
        return 0
    logits, tol = router_tol(x, router)
    top = torch.topk(logits, k + 1, dim=-1).values
    gap = (top[..., k - 1] - top[..., k]).cpu()
    unexplained = mismatch & (gap > tol.cpu())
    if bool(unexplained.any()):
        i = tuple(int(v) for v in unexplained.nonzero()[0])
        raise AssertionError(
            f"{int(unexplained.sum())} of {n_bad} tokens routed differently "
            f"are not at a top-{k} tie; first at {i}: the k-th and (k+1)-th "
            f"logits {gap[i]:.6g} apart > bound {float(tol[i]):.3g}")
    return n_bad


def top_p_near_cut(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """(B,) bool: rows of the f32 logits (B, V) (the input of the top-p
    filter) where the mass before some token of the descending sort lies
    within ``2·(2·γ_V + 4u)`` of ``top_p``, so the two packages' nuclei may
    differ."""
    desc = torch.sort(logits.to(torch.float64), dim=-1,
                      descending=True).values
    p = torch.softmax(desc, dim=-1)
    before = torch.cumsum(p, dim=-1) - p
    tol = 2.0 * (2.0 * _gamma(logits.shape[-1]) + 4.0 * U32)
    return ((before - top_p).abs() <= tol).any(dim=-1)


def check_sampled_tokens(got: torch.Tensor, want: torch.Tensor,
                         logits: torch.Tensor, uniforms: torch.Tensor,
                         near_cut: Optional[torch.Tensor] = None) -> int:
    """Assert the sampling rule for every row where the (B,) tokens differ:
    ``logits`` are the categorical's (B, V) f32 input (after temperature
    and filters), ``uniforms`` the draw's (B, V) uniforms on [tiny, 1),
    ``near_cut`` the rows whose top-p nucleus may differ
    (:func:`top_p_near_cut`).  Returns the number of mismatched rows."""
    mismatch = (got.long() != want.long()).cpu()
    if near_cut is not None:
        mismatch &= ~near_cut.cpu()
    n_bad = int(mismatch.sum())
    if not n_bad:
        return 0
    g = -torch.log(-torch.log(uniforms.to(torch.float64)))
    s = g + logits.to(torch.float64)
    err = 4.0 * U32 * (1.0 + g.abs() + s.abs())
    rows = torch.arange(s.shape[0])
    a, b = got.long().cpu(), want.long().cpu()
    s, err = s.cpu(), err.cpu()
    gap = (s[rows, a] - s[rows, b]).abs()
    unexplained = mismatch & (gap > 2.0 * (err[rows, a] + err[rows, b]))
    if bool(unexplained.any()):
        r = int(unexplained.nonzero()[0])
        raise AssertionError(
            f"{int(unexplained.sum())} of {n_bad} sampled tokens differ "
            f"beyond the Gumbel rounding; first at row {r}: got {int(a[r])}, "
            f"want {int(b[r])}, scores {float(gap[r]):.6g} apart")
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


def flash_attn_tol(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int] = None,
                   softcap: Optional[float] = None, tile: int = 32,
                   chunk: int = 512,
                   tensor_cores: Optional[bool] = None) -> torch.Tensor:
    """(B, S, H, dh) float64 bound on the difference of two f32 evaluations
    of ``flash_attention(q, k, v, window=, softcap=)`` (the rule above),
    before any rounding to the output dtype.  ``tile`` is the kernel's key
    tile (one online rescaling per tile); queries go ``chunk`` rows at a
    time to bound the float64 temporaries.  ``tensor_cores``: one of the
    two is the kernel's tensor-core path, under the accumulation model
    above; by default where the kernel takes that path, for bf16 CUDA
    tensors (on the CPU the wrapper runs the plain version)."""
    if tensor_cores is None:
        tensor_cores = q.is_cuda and q.dtype == torch.bfloat16
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    # Both sides round q·dh^-0.5 to f32 the same way.
    qs = (q.to(torch.float32) * dh ** -0.5).to(torch.float64).reshape(
        b, s, hkv, h // hkv, dh)
    k64, v64 = k.to(torch.float64), v.to(torch.float64)
    dot = 2.0 * _gamma(dh)
    if tensor_cores:
        tau = math.expm1(dh / 4 * math.log1p(_TC_BLOCK))
        dot = _gamma(dh) + ((1.0 + U32) * tau + 2.0 * U32) / (1.0 - U32)
    pos = torch.arange(s, device=q.device)
    out = torch.empty((b, s, hkv, h // hkv, dh), dtype=torch.float64,
                      device=q.device)
    for q0 in range(0, s, chunk):
        qc = qs[:, q0:q0 + chunk]
        sc = torch.einsum("bqkgd,bskd->bkgqs", qc, k64)
        err = dot * torch.einsum("bqkgd,bskd->bkgqs", qc.abs(), k64.abs())
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
            err = err + 2.0 * 6.0 * U32 * sc.abs()
        qp = pos[q0:q0 + chunk, None]
        live = qp >= pos[None, :]
        if window is not None:
            live &= (qp - pos[None, :]) < window
        sc = sc.masked_fill(~live, float("-inf"))
        w = torch.softmax(sc, dim=-1)
        e_max = err.masked_fill(~live, 0.0).amax(dim=-1)
        span = (sc.amax(dim=-1, keepdim=True) - sc).masked_fill(
            ~live, 0.0).amax(dim=-1)
        n = live.sum(dim=-1).to(torch.float64)                  # (q,)
        tiles = torch.ceil(n / tile)
        gamma_n = n * U32 / (1.0 - n * U32)
        eps = (4.0 + span) * U32 + 2.0 * gamma_n + 2.0 * U32 * tiles + U32
        rel = 2.0 * eps + torch.expm1(2.0 * e_max)              # (b, kv, g, q)
        if tensor_cores:
            steps = torch.ceil(n / 16) + 1
            pv = (1.0 + 2.0 ** -6) * torch.expm1(12.0 * steps
                                                  * math.log1p(_TC_BLOCK))
            eps_tc = ((4.0 + span) * U32 + gamma_n + pv + 2.0 * U32 * steps
                      + U32)
            rel = eps + eps_tc + torch.expm1(2.0 * e_max)
        mass = torch.einsum("bkgqs,bskd->bqkgd", w, v64.abs())
        out[:, q0:q0 + chunk] = rel.permute(0, 3, 1, 2)[..., None] * mass
    return out.reshape(b, s, h, dh)


def flash_attn_lse_tol(q: torch.Tensor, k: torch.Tensor,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None, chunk: int = 512,
                       tensor_cores: Optional[bool] = None) -> torch.Tensor:
    """(B, H, S) float64 bound on the difference of two f32 evaluations of
    each row's log-sum-exp ``log Σ_k exp(s_c[q, k])`` over its live keys
    (the forward kernel's ``lse`` output).  Moving every score by at most
    E moves the lse by at most E (E as in :func:`flash_attn_tol`, with the
    kernel's tensor-core form by default for bf16 CUDA tensors); each side
    adds its n-term sum of exps (γ_n, exp's 2 ulps and the subtraction
    ``u·|s − m|``, relative), the log (2 ulps of |log l| ≤ log n) and the
    final ``m + log l`` (u·|lse|)."""
    if tensor_cores is None:
        tensor_cores = q.is_cuda and q.dtype == torch.bfloat16
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    qs = (q.to(torch.float32) * dh ** -0.5).to(torch.float64).reshape(
        b, s, hkv, h // hkv, dh)
    k64 = k.to(torch.float64)
    dot = 2.0 * _gamma(dh)
    if tensor_cores:
        tau = math.expm1(dh / 4 * math.log1p(_TC_BLOCK))
        dot = _gamma(dh) + ((1.0 + U32) * tau + 2.0 * U32) / (1.0 - U32)
    pos = torch.arange(s, device=q.device)
    out = torch.empty((b, hkv, h // hkv, s), dtype=torch.float64,
                      device=q.device)
    for q0 in range(0, s, chunk):
        qc = qs[:, q0:q0 + chunk]
        sc = torch.einsum("bqkgd,bskd->bkgqs", qc, k64)
        err = dot * torch.einsum("bqkgd,bskd->bkgqs", qc.abs(), k64.abs())
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
            err = err + 2.0 * 6.0 * U32 * sc.abs()
        qp = pos[q0:q0 + chunk, None]
        live = qp >= pos[None, :]
        if window is not None:
            live &= (qp - pos[None, :]) < window
        sc = sc.masked_fill(~live, float("-inf"))
        lse = torch.logsumexp(sc, dim=-1)
        e_max = err.masked_fill(~live, 0.0).amax(dim=-1)
        span = (sc.amax(dim=-1, keepdim=True) - sc).masked_fill(
            ~live, 0.0).amax(dim=-1)
        n = live.sum(dim=-1).to(torch.float64)
        gamma_n = n * U32 / (1.0 - n * U32)
        own = (gamma_n + (3.0 + span) * U32 + 2.0 * U32 * torch.log(n)
               + U32 * lse.abs())
        out[..., q0:q0 + chunk] = e_max + 2.0 * own
    return out.reshape(b, h, s)


def flash_attn_bwd_tol(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, dout: torch.Tensor,
                       lse: torch.Tensor, window: Optional[int] = None,
                       softcap: Optional[float] = None, chunk: int = 256,
                       tensor_cores: Optional[bool] = None):
    """``(tol_dq, tol_dk, tol_dv)``: float64 bounds, of q's, k's and v's
    shapes, on the difference of two f32 evaluations of the attention
    backward from these inputs (the rule above), before any rounding to
    the output dtype.  Queries go ``chunk`` rows at a time.
    ``tensor_cores``: one of the two is the kernel's tensor-core path,
    under the accumulation model above (the kernel's error plus the
    reference's); by default where the kernel takes that path, for bf16
    CUDA tensors (on the CPU the wrapper runs the plain version)."""
    if tensor_cores is None:
        tensor_cores = q.is_cuda and q.dtype == torch.bfloat16
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    f64, u = torch.float64, U32
    scale = dh ** -0.5
    qs = (q.to(torch.float32) * scale).to(f64).reshape(b, s, hkv, g, dh)
    k64, v64 = k.to(f64), v.to(f64)
    do = dout.to(f64).reshape(b, s, hkv, g, dh)
    o = out.to(f64).reshape(b, s, hkv, g, dh)
    lse64 = lse.to(f64).reshape(b, hkv, g, s)
    gam_dh = _gamma(dh)
    pos = torch.arange(s, device=q.device)
    tol_dq = torch.empty((b, s, hkv, g, dh), dtype=f64, device=q.device)
    tol_dk = torch.zeros((b, s, hkv, dh), dtype=f64, device=q.device)
    tol_dv = torch.zeros_like(tol_dk)
    gam_kv = _gamma(g * s)
    # The tensor-core side: score and dp chains of dh/4 blocks, the split
    # products' chains of 12 blocks a k-step.
    tau = math.expm1(dh / 4 * math.log1p(_TC_BLOCK))
    c_s_tc = ((1.0 + u) * tau + 2.0 * u) / (1.0 - u)
    split = 1.0 + 2.0 ** -6
    tau_kv = math.expm1(12 * g * (math.ceil(s / 16) + 4)
                        * math.log1p(_TC_BLOCK))
    c_k_tc = (split * (1.0 + u) * tau_kv + u) / (1.0 - u)
    if tensor_cores:
        tc_dq = torch.empty_like(tol_dq)
        tc_dk, tc_dv, dk_val = (torch.zeros_like(tol_dk) for _ in range(3))
    for q0 in range(0, s, chunk):
        sl = slice(q0, q0 + chunk)
        qc, doc, oc = qs[:, sl], do[:, sl], o[:, sl]
        sc = torch.einsum("bqkgd,bskd->bkgqs", qc, k64)
        s_mag = torch.einsum("bqkgd,bskd->bkgqs", qc.abs(), k64.abs())
        t = None
        if softcap:
            t = torch.tanh(sc / softcap)
            s_c = softcap * t
        else:
            s_c = sc
        qp = pos[sl, None]
        live = qp >= pos[None, :]
        if window is not None:
            live &= (qp - pos[None, :]) < window
        lse_c = lse64[..., sl, None]
        p = torch.exp(s_c - lse_c).masked_fill(~live, 0.0)
        dp = torch.einsum("bqkgd,bskd->bkgqs", doc, v64)
        dp_mag = torch.einsum("bqkgd,bskd->bkgqs", doc.abs(), v64.abs())
        d_row = (doc * oc).sum(-1).permute(0, 2, 3, 1)[..., None]
        e_d = gam_dh * (doc.abs() * oc.abs()).sum(-1).permute(
            0, 2, 3, 1)[..., None]
        x = dp - d_row
        ds_c = p * x
        ds = ds_c if t is None else ds_c * (1.0 - t * t)

        def errors(c_s, c_dp):
            """One evaluation's errors of p (relative) and of ds."""
            e_s = c_s * s_mag
            e_c = e_s if t is None else e_s + 6.0 * u * s_c.abs()
            e_p = e_c + u * (s_c - lse_c).abs() + 3.0 * u
            e_ds = p * (e_p * x.abs() + c_dp * dp_mag + e_d
                        + 2.0 * u * x.abs())
            if t is not None:
                w = 1.0 - t * t
                e_t = (e_s + u * sc.abs()) / softcap * w + 2.0 * u * t.abs()
                e_ds = (e_ds * w + ds_c.abs() * (2.0 * t.abs() * e_t
                                                 + 2.0 * u)
                        + u * ds.abs())
            return e_p, e_ds.masked_fill(~live, 0.0)

        n_k = live.sum(-1).to(f64)                             # (q,)
        gam_k = n_k * u / (1.0 - n_k * u)
        dq_mag = torch.einsum("bkgqs,bskd->bqkgd", ds.abs(), k64.abs())
        dq_val = torch.einsum("bkgqs,bskd->bqkgd", ds, k64).abs()
        dk_mag = torch.einsum("bkgqs,bqkgd->bskd", ds.abs(), qc.abs())
        dv_mag = torch.einsum("bkgqs,bqkgd->bskd", p, doc.abs())
        e_p, e_ds = errors(gam_dh, gam_dh)
        tol_dq[:, sl] = scale * (
            torch.einsum("bkgqs,bskd->bqkgd", e_ds, k64.abs())
            + gam_k[None, :, None, None, None] * dq_mag) + u * scale * dq_val
        tol_dk += torch.einsum("bkgqs,bqkgd->bskd", e_ds, qc.abs()) + (
            gam_kv * dk_mag)
        tol_dv += torch.einsum("bkgqs,bqkgd->bskd", p * e_p, doc.abs()) + (
            gam_kv * dv_mag)
        if tensor_cores:
            e_p, e_ds = errors(c_s_tc, tau)
            tau_q = torch.expm1(12.0 * (torch.ceil(n_k / 16) + 12)
                                * math.log1p(_TC_BLOCK))
            tc_dq[:, sl] = scale * (
                torch.einsum("bkgqs,bskd->bqkgd", e_ds, k64.abs())
                + split * tau_q[None, :, None, None, None] * dq_mag) + (
                u * scale * dq_val)
            tc_dk += torch.einsum("bkgqs,bqkgd->bskd", e_ds, qc.abs()) + (
                c_k_tc * dk_mag)
            dk_val += torch.einsum("bkgqs,bqkgd->bskd", ds, qc)
            tc_dv += torch.einsum("bkgqs,bqkgd->bskd", p * e_p,
                                  doc.abs()) + split * tau_kv * dv_mag
    if tensor_cores:
        return (tol_dq.reshape(b, s, h, dh) + tc_dq.reshape(b, s, h, dh),
                tol_dk + tc_dk + u * dk_val.abs(), tol_dv + tc_dv)
    return (2.0 * tol_dq.reshape(b, s, h, dh), 2.0 * tol_dk, 2.0 * tol_dv)


def _flash_out_err(got: torch.Tensor, want: torch.Tensor, tol: torch.Tensor):
    """``(|got − want|, tol + one bf16 ulp of the larger magnitude for bf16
    outputs)`` in float64."""
    g64, w64 = got.to(torch.float64), want.to(torch.float64)
    if got.dtype == torch.bfloat16:
        big = torch.maximum(g64.abs(), w64.abs()).clamp_min(1e-30)
        tol = tol + torch.exp2(torch.floor(torch.log2(big)) - 7)
    return (g64 - w64).abs(), tol


def flash_attn_tol_ratio(got: torch.Tensor, want: torch.Tensor,
                         tol: torch.Tensor) -> float:
    """The largest ``|got − want|`` over its bound, as
    :func:`assert_flash_attn_close` holds it (at most 1 where it passes)."""
    err, tol = _flash_out_err(got, want, tol)
    return float((err / tol).max())


def assert_flash_attn_close(got: torch.Tensor, want: torch.Tensor,
                            tol: torch.Tensor, name: str = "flash_attn"
                            ) -> float:
    """Raise unless ``|got − want| <= tol`` (+ one bf16 ulp of the larger
    magnitude for bf16 outputs) everywhere; returns the largest error."""
    g64, w64 = got.to(torch.float64), want.to(torch.float64)
    err, tol = _flash_out_err(got, want, tol)
    bad = err > tol
    if bool(bad.any()):
        i = tuple(int(x) for x in bad.nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond the bound; first "
            f"at {i}: got {float(g64[i])}, want {float(w64[i])}, bound "
            f"{float(tol[i])}; largest error {float(err.max())}")
    return float(err.max())


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
