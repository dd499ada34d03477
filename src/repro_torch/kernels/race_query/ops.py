"""RACE sketch query (Algorithm 2's row reads + median of means): kernel
wrapper and plain version.

``race_query`` runs the plain version for CPU tensors and launches
``csrc/race_query.cu`` for CUDA tensors (or raises);
``race_query.launches`` counts its launches; ``race_query_ordered_ref`` is
the kernel's summation order in plain PyTorch, equal to it bit for bit.
The median of an even number of group means is the average of the two
middle ones, ``(lo + hi) * 0.5``, as ``jnp.median`` computes it
(``torch.median`` would return the lower one), and any NaN mean makes the
estimate NaN, as in JAX.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_operand, stream_of


def mom_estimate(reads: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Median of means over the last axis: ``n_groups`` groups of
    ``⌊L / n_groups⌋`` consecutive reads (the tail dropped), each averaged,
    then the median of the group means (midpoint for an even count).  Fewer
    reads than groups give NaN, as a mean over no reads does."""
    n = reads.shape[-1] // n_groups
    grouped = reads[..., : n_groups * n].reshape(*reads.shape[:-1], n_groups, n)
    means = grouped.mean(dim=-1)
    srt = torch.sort(means, dim=-1).values
    lo, hi = srt[..., (n_groups - 1) // 2], srt[..., n_groups // 2]
    med = (lo + hi) * 0.5
    return torch.where(means.isnan().any(dim=-1),
                       torch.full_like(med, float("nan")), med)


def race_query_ref(sketch: torch.Tensor, idx: torch.Tensor,
                   n_groups: int) -> torch.Tensor:
    """Plain version: reads ``S[c, l, idx[b, l]]`` (B, C, L), then
    :func:`mom_estimate` → (B, C).  A bf16 sketch is promoted to f32 first
    (exact), as the kernel does."""
    s = sketch.to(torch.float32)
    rows = torch.arange(s.shape[1], device=s.device)
    reads = s[:, rows, idx.long()]                 # (C, B, L)
    return mom_estimate(reads.permute(1, 0, 2), n_groups)


def race_query_ordered_ref(sketch: torch.Tensor, idx: torch.Tensor,
                           n_groups: int) -> torch.Tensor:
    """The kernel's function exactly, in plain PyTorch: for each (query,
    channel, group), lane t of 32 sums the group's reads i ≡ t (mod 32) in
    increasing i from 0.0 in f32 (an index outside [0, R) reads nothing),
    the lanes' partials go through the xor tree of offsets 16, 8, 4, 2, 1
    (lane t adds lane t ^ off), the mean is the f32 quotient by m (round to
    nearest, as ``__fdiv_rn``), and the median of the group means is the
    midpoint ``(lo + hi) * 0.5`` (NaN if any mean is NaN).  Equal to the
    kernel bit for bit; :func:`race_query_ref` sums in torch's own order."""
    s = sketch.to(torch.float32)
    c, n_rows, n_buckets = s.shape
    b = idx.shape[0]
    m = n_rows // n_groups
    if m == 0:                                       # 0 / 0 in every group
        return torch.full((b, c), float("nan"), device=s.device)
    live = (idx >= 0) & (idx < n_buckets)
    rows = torch.arange(n_rows, device=s.device)
    reads = s[:, rows, torch.where(live, idx, 0).long()]          # (C, B, L)
    # Adding +0.0 leaves a partial that starts at +0.0 unchanged, so a
    # zero read is the kernel's skipped one; so is the padding to 32 lanes.
    reads = torch.where(live, reads, 0.0).permute(1, 0, 2)
    grouped = reads[..., : n_groups * m].reshape(b, c, n_groups, m)
    lanes = F.pad(grouped, (0, -m % 32)).reshape(b, c, n_groups, -1, 32)
    acc = torch.zeros((b, c, n_groups, 32), device=s.device)
    for k in range(lanes.shape[3]):
        acc = acc + lanes[:, :, :, k]
    lane = torch.arange(32, device=s.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    means = acc[..., 0] / torch.full_like(acc[..., 0], float(m))
    srt = torch.sort(means, dim=-1).values
    lo, hi = srt[..., (n_groups - 1) // 2], srt[..., n_groups // 2]
    med = (lo + hi) * 0.5
    return torch.where(means.isnan().any(dim=-1),
                       torch.full_like(med, float("nan")), med)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("race_query").race_query_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def race_query(sketch: torch.Tensor, idx: torch.Tensor, *,
               n_groups: int) -> torch.Tensor:
    """Median-of-means sketch estimate (B, C) f32.

    Args:
      sketch: (C, L, R) f32 or bf16 counts (bf16 is cast to f32 first).
      idx: (B, L) int32 bucket index of each query in each row, in [0, R)
        (the kernel reads an index outside it as a zero count, as the TPU
        kernel's one-hot does; the plain version raises).
      n_groups: g, the number of groups of the median of means (1 gives
        the plain mean over all L rows); 1 <= g <= 64 on the card.
    """
    if idx.device.type == "cpu":
        return race_query_ref(sketch, idx, n_groups)
    if idx.device.type != "cuda":
        raise ValueError(f"race_query runs on cpu or cuda, not {idx.device}")
    if not 1 <= n_groups <= 64:
        raise ValueError(f"race_query kernel takes 1 <= n_groups <= 64, got "
                         f"{n_groups}")
    if sketch.dtype == torch.bfloat16:
        sketch = sketch.to(torch.float32)
    c, n_rows, n_buckets = sketch.shape
    n_batch = idx.shape[0]
    check_operand("sketch", sketch, idx.device, torch.float32,
                  (c, n_rows, n_buckets))
    check_operand("idx", idx, idx.device, torch.int32, (n_batch, n_rows))
    out = torch.empty((n_batch, c), dtype=torch.float32, device=idx.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(idx.device):
        rc = _launcher()(sketch.data_ptr(), idx.data_ptr(), out.data_ptr(),
                         n_batch, c, n_rows, n_buckets, n_groups,
                         stream_of(idx.device))
    race_query.launches += 1
    _build.check_launch("race_query", rc)
    return out


race_query.launches = 0
