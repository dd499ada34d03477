"""RACE sketch update (Algorithm 1's weighted scatter-add): kernel wrapper
and plain versions.

Two entries run ``csrc/race_update.cu`` on CUDA tensors (or raise) and
their plain versions on CPU tensors:

* ``race_update(sketch, idx, alphas)`` — the JAX package's signature, a
  (C, L, R) sketch and (M, C) weights;
* ``race_update_counts(counts, idx, alphas)`` — the head's own (L, R, V)
  count layout with (M, V) weights, which ``refresh_head`` calls without
  moving V to the front and back.

Both return ``sketch + delta`` in a fresh tensor, or in ``out=`` when the
caller passes one it owns (``out`` may be the input itself: the kernel
reads each count once before its owner writes it).  ``race_update.launches``
counts the kernel's launches through either entry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_operand, stream_of

#: Most columns (classes) the kernel's grid covers: 65535 tiles of 128.
MAX_COLUMNS = 65535 * 128


def _onehot(idx: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(M, L, R) f32 one-hot of the bucket indices; an index outside
    [0, R) gives a row of zeros, as ``jax.nn.one_hot`` does."""
    r = torch.arange(n_buckets, device=idx.device)
    return (idx.long()[..., None] == r).to(torch.float32)


def race_update_ref(sketch: torch.Tensor, idx: torch.Tensor,
                    alphas: torch.Tensor) -> torch.Tensor:
    """Plain version, (C, L, R): ``sketch + einsum("mc,mlr->clr", α,
    onehot(idx))``."""
    onehot = _onehot(idx, sketch.shape[-1])
    return sketch + torch.einsum("mc,mlr->clr", alphas.to(torch.float32),
                                 onehot)


def race_update_counts_ref(counts: torch.Tensor, idx: torch.Tensor,
                           alphas: torch.Tensor) -> torch.Tensor:
    """Plain version, (L, R, V): ``counts + einsum("mlr,mv->lrv",
    onehot(idx), α)`` — ``freeze_head``'s sum over the new points."""
    onehot = _onehot(idx, counts.shape[1])
    return counts + torch.einsum("mlr,mv->lrv", onehot,
                                 alphas.to(torch.float32))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("race_update").race_update_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(counts, idx, alphas, out, n_rows, n_buckets, n_cols, strides):
    """Check the operands and launch the kernel over an (L, R, V) view of
    ``counts``/``out`` with element ``strides`` (sl, sr, sv)."""
    dev = idx.device
    n_points = idx.shape[0]
    check_operand("idx", idx, dev, torch.int32, (n_points, n_rows))
    check_operand("alphas", alphas, dev, torch.float32, (n_points, n_cols))
    check_operand("counts", counts, dev, torch.float32, tuple(counts.shape))
    if out is None:
        out = torch.empty_like(counts)
    check_operand("out", out, dev, torch.float32, tuple(counts.shape))
    if n_cols > MAX_COLUMNS:
        raise ValueError(f"race_update kernel takes at most {MAX_COLUMNS} "
                         f"columns, got {n_cols}")
    if counts.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = _launcher()(idx.data_ptr(), alphas.data_ptr(),
                         counts.data_ptr(), out.data_ptr(), n_points, n_rows,
                         n_buckets, n_cols, *strides, stream_of(dev))
    race_update.launches += 1
    _build.check_launch("race_update", rc)
    return out


def _device_of(idx: torch.Tensor) -> str:
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"race_update runs on cpu or cuda, not {idx.device}")
    return idx.device.type


def race_update(sketch: torch.Tensor, idx: torch.Tensor,
                alphas: torch.Tensor, *, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Accumulate weighted points into a (C, L, R) sketch; returns
    ``sketch + delta`` with ``delta[c, l, r] = Σ_m α[m, c]·[idx[m, l] = r]``.

    Args:
      sketch: (C, L, R) f32 counts.
      idx: (M, L) int32 bucket index of each point in each row.
      alphas: (M, C) f32 per-point weights.
      out: optional (C, L, R) f32 tensor the caller owns that receives the
        result (may be ``sketch``).
    """
    if _device_of(idx) == "cpu":
        res = race_update_ref(sketch, idx, alphas)
        return res if out is None else out.copy_(res)
    c, n_rows, n_buckets = sketch.shape
    return _launch(sketch, idx, alphas, out, n_rows, n_buckets, c,
                   (n_buckets, 1, n_rows * n_buckets))


def race_update_counts(counts: torch.Tensor, idx: torch.Tensor,
                       alphas: torch.Tensor, *,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accumulate weighted points into a head's (L, R, V) count array;
    returns ``counts + delta`` with ``delta[l, r, v] = Σ_m α[m, v]·
    [idx[m, l] = r]``.

    Args:
      counts: (L, R, V) f32 counts.
      idx: (M, L) int32 bucket index of each point in each row.
      alphas: (M, V) f32 per-point weights.
      out: optional (L, R, V) f32 tensor the caller owns that receives the
        result (may be ``counts``: the in-place fold).
    """
    if _device_of(idx) == "cpu":
        res = race_update_counts_ref(counts, idx, alphas)
        return res if out is None else out.copy_(res)
    n_rows, n_buckets, v = counts.shape
    return _launch(counts, idx, alphas, out, n_rows, n_buckets, v,
                   (n_buckets * v, v, 1))


race_update.launches = 0
