"""Fused sketched decode (transform → hash → gather): kernel wrapper and
plain version.

``fused_decode_logits`` runs the plain version for CPU tensors and
launches ``csrc/fused_decode.cu`` for CUDA tensors (or raises);
``fused_decode_logits.launches`` counts its launches.  On DTensors it
runs the row-sharded path: each rank of the mesh's model axis hashes and
gathers its own rows (``row_start``: the global-row salt input of the
kernel) and one all-reduce sums the partial means.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (QUANT_CODES, check_operand,
                                        operand_mesh, row_sharded_logits,
                                        select_tenant_rows, stream_of)
from repro_torch.kernels.lsh_hash.ops import lsh_hash_ref
from repro_torch.kernels.sketch_head.ops import check_sketch, sketch_head_ref
from repro_torch.sharding.ctx import replicated


def fused_decode_ref(hidden, proj, w, b, sketch, bandwidth: float,
                     n_buckets: int, scale=None, quant=None,
                     idx_out: Optional[torch.Tensor] = None,
                     row_start: int = 0) -> torch.Tensor:
    """Plain version: ``q = h·A``, ``idx = lsh_hash_ref(q)``, then
    ``sketch_head_ref`` → (B, V) f32.  ``idx_out`` ((B, L) int32), when
    given, receives the indices.  The rows are global rows ``row_start ..``
    of a larger head (their fold salts).  DTensor operands take the
    row-sharded path of :func:`fused_decode_logits`, each rank's rows
    through this plain version (a DTensor comes back)."""
    mesh = operand_mesh(hidden, proj, w, b, sketch, scale)
    if mesh is not None:
        return _row_sharded(fused_decode_ref, mesh, hidden, proj, w, b,
                            sketch, scale, bandwidth, n_buckets, quant,
                            idx_out)
    q = hidden.to(torch.float32) @ proj
    idx = lsh_hash_ref(q, w, b, bandwidth, n_buckets, row_start)
    if idx_out is not None:
        idx_out.copy_(idx)
    return sketch_head_ref(sketch, idx, scale, quant)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("fused_decode").fused_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_decode_logits(hidden: torch.Tensor, proj: torch.Tensor,
                        w: torch.Tensor, b: torch.Tensor,
                        sketch: torch.Tensor, *, bandwidth: float,
                        n_buckets: int, scale: Optional[torch.Tensor] = None,
                        quant: Optional[str] = None,
                        idx_out: Optional[torch.Tensor] = None,
                        tenant_ids: Optional[torch.Tensor] = None,
                        row_start: int = 0) -> torch.Tensor:
    """Sketched (B, V) f32 logits in one kernel: transform → hash → gather.

    Args:
      hidden: (B, d) f32 final backbone hiddens.
      proj: (d, d') asymmetric transform A.
      w / b: (L, K, d') / (L, K) L2-LSH bank.
      sketch: (L, R, V) f32 counts, or under ``quant`` the int8 carrier
        ((L, R, V) int8 / (⌈L/2⌉, R, V) packed int4 bytes).
      bandwidth / n_buckets: the LSH family's r and R.
      scale: (L, R) f32 per-row scales, given iff ``quant`` is.
      quant: ``None``, ``"int8"`` or ``"int4"``.
      idx_out: optional (B, L) int32 tensor that receives the bucket
        indices the kernel computed (for parity checks).
      tenant_ids: (B,) per-slot bank rows for the multi-tenant path.  Every
        head operand then carries a leading bank axis T — proj (T, d, d'),
        w (T, L, K, d'), b (T, L, K), sketch (T, …), scale (T, L, R) — and
        the unchanged single-tenant path runs over the full batch once per
        bank row (T launches on the card); row ``b`` is then taken from
        bank row ``tenant_ids[b]`` by ``select_tenant_rows``.
      row_start: the global index of ``w``'s first row: the rows fold
        with the salts of rows ``row_start ..`` (a row shard of a larger
        head); 0 for a whole head.

    DTensor operands (the rules' placements: the count rows and scales
    over a mesh's ``model`` axis, the hash params replicated; plain
    operands beside them are taken as replicated) take the row-sharded
    path: each rank of the model axis launches the kernel on its L/m rows
    with ``row_start`` its first global row, and one all-reduce over the
    model group sums the partial means scaled by (L/m)/L; the batch splits
    over ``data`` where it divides.  A DTensor comes back.  Where the axis
    does not divide L and the storage rows (an int4 shard must hold whole
    bytes), every rank launches on all rows.
    """
    if (scale is None) != (quant is None):
        raise ValueError("quant and scale must be passed together")
    if tenant_ids is not None:
        if idx_out is not None:
            raise ValueError("idx_out is not supported with tenant_ids")
        per_tenant = torch.stack([replicated(
            fused_decode_logits(
                hidden, proj[t], w[t], b[t], sketch[t], bandwidth=bandwidth,
                n_buckets=n_buckets, scale=None if scale is None else scale[t],
                quant=quant))
            for t in range(w.shape[0])])
        return select_tenant_rows(per_tenant, replicated(tenant_ids))
    mesh = operand_mesh(hidden, proj, w, b, sketch, scale)
    if mesh is not None:
        return _row_sharded(fused_decode_logits, mesh, hidden, proj, w, b,
                            sketch, scale, bandwidth, n_buckets, quant,
                            idx_out)
    if hidden.device.type == "cpu":
        return fused_decode_ref(hidden, proj, w, b, sketch, bandwidth,
                                n_buckets, scale, quant, idx_out, row_start)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_decode_logits runs on cpu or cuda, not "
                         f"{hidden.device}")
    dev = hidden.device
    n_batch, d = hidden.shape
    n_rows, k, dp = w.shape
    check_operand("hidden", hidden, dev, torch.float32, (n_batch, d))
    check_operand("proj", proj, dev, torch.float32, (d, dp))
    check_operand("w", w, dev, torch.float32, (n_rows, k, dp))
    check_operand("b", b, dev, torch.float32, (n_rows, k))
    check_sketch(sketch, scale, quant, n_rows, dev)
    if idx_out is not None:
        check_operand("idx_out", idx_out, dev, torch.int32,
                      (n_batch, n_rows))
    _, r, v = sketch.shape
    out = torch.empty((n_batch, v), dtype=torch.float32, device=dev)
    if n_batch == 0 or v == 0:
        return out
    with torch.cuda.device(dev):
        rc = _launcher()(
            hidden.data_ptr(), proj.data_ptr(), w.data_ptr(), b.data_ptr(),
            sketch.data_ptr(), None if scale is None else scale.data_ptr(),
            out.data_ptr(), None if idx_out is None else idx_out.data_ptr(),
            n_batch, d, dp, n_rows, k, n_buckets, v, bandwidth, row_start,
            QUANT_CODES[quant], stream_of(dev))
    fused_decode_logits.launches += 1
    _build.check_launch("fused_decode", rc)
    return out


fused_decode_logits.launches = 0


def _row_sharded(fn, mesh, hidden, proj, w, b, sketch, scale, bandwidth,
                 n_buckets, quant, idx_out):
    """``fn`` (the kernel wrapper or the plain version) on each rank's rows
    through ``row_sharded_logits``."""
    if idx_out is not None:
        raise ValueError("idx_out is not supported with mesh")

    def launch(h, ws, bs, sk, sc, pj, *, row_start):
        return fn(h, pj, ws, bs, sk, bandwidth=bandwidth,
                  n_buckets=n_buckets, scale=sc, quant=quant,
                  row_start=row_start)
    return row_sharded_logits(
        launch, mesh, hidden.shape[0], w.shape[0], sketch.shape[0], quant,
        sketch.shape[-1],
        [(hidden, "batch"), (w, "rows"), (b, "rows"), (sketch, "rows"),
         (scale, "rows"), (proj, "rep")])
