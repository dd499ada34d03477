"""L2-LSH bucket indices of a query batch: kernel wrapper and plain version.

``lsh_hash`` runs the plain version for CPU tensors and launches
``csrc/lsh_hash.cu`` for CUDA tensors (or raises); ``lsh_hash.launches``
counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.lsh import _fold_subhashes, row_salts
from repro_torch.kernels import _build
from repro_torch.kernels.common import (batch_entry, check_operand,
                                        from_local_block, local_block,
                                        operand_mesh, stream_of)
from repro_torch.sharding.rules import P


def lsh_hash_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 bandwidth: float, n_buckets: int,
                 row_start: int = 0) -> torch.Tensor:
    """Plain version: ``fold(floor((x·wᵀ + b) / r)) mod R`` → (B, L) int32.

    x (B, d') f32, w (L, K, d') f32, b (L, K) f32; the rows fold with the
    salts of global rows ``row_start ..`` (a row shard of a larger bank).
    """
    proj = torch.einsum("bd,lkd->blk", x, w)
    codes = torch.floor((proj + b) / bandwidth).to(torch.int32)
    return _fold_subhashes(codes, n_buckets,
                           row_salts(w.shape[0], row_start, x.device))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("lsh_hash").lsh_hash_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lsh_hash(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
             bandwidth: float, n_buckets: int) -> torch.Tensor:
    """Bucket indices (B, L) int32 of queries x (B, d') against an (L, K, d')
    bank with offsets b (L, K).  DTensor operands (a mesh's two-kernel
    head) hash this rank's batch block (over ``data`` where it divides)
    against the whole bank and come back as a DTensor."""
    mesh = operand_mesh(x, w)
    if mesh is not None:
        bspec = batch_entry(mesh, x.shape[0])
        out = lsh_hash(local_block(x, P(bspec), mesh),
                       local_block(w, P(), mesh), local_block(b, P(), mesh),
                       bandwidth=bandwidth, n_buckets=n_buckets)
        return from_local_block(out, P(bspec, None), mesh,
                                (x.shape[0], w.shape[0]))
    if x.device.type == "cpu":
        return lsh_hash_ref(x, w, b, bandwidth, n_buckets)
    if x.device.type != "cuda":
        raise ValueError(f"lsh_hash runs on cpu or cuda, not {x.device}")
    n_batch, dp = x.shape
    n_rows, k, _ = w.shape
    check_operand("x", x, x.device, torch.float32, (n_batch, dp))
    check_operand("w", w, x.device, torch.float32, (n_rows, k, dp))
    check_operand("b", b, x.device, torch.float32, (n_rows, k))
    out = torch.empty((n_batch, n_rows), dtype=torch.int32, device=x.device)
    if n_batch == 0 or n_rows == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _launcher()(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         out.data_ptr(), n_batch, dp, n_rows, k, n_buckets,
                         bandwidth, stream_of(x.device))
    lsh_hash.launches += 1
    _build.check_launch("lsh_hash", rc)
    return out


lsh_hash.launches = 0
