"""Sketched LM-head gather from precomputed bucket indices: kernel wrapper
and plain version.

``sketch_head_logits`` runs the plain version for CPU tensors and launches
``csrc/sketch_head.cu`` for CUDA tensors (or raises);
``sketch_head_logits.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (QUANT_CODES, check_operand,
                                        operand_mesh, row_sharded_logits,
                                        select_tenant_rows, stream_of,
                                        unpack_int4_rows)
from repro_torch.sharding.ctx import replicated


def dequantize_sketch_ref(sketch: torch.Tensor, scale: torch.Tensor,
                          quant: str) -> torch.Tensor:
    """Materialized (L, R, V) f32 counts from int8 / packed int4 storage."""
    if quant == "int4":
        sketch = unpack_int4_rows(sketch, scale.shape[0])
    return sketch.to(torch.float32) * scale[:, :, None]


def sketch_head_ref(sketch: torch.Tensor, idx: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    quant: Optional[str] = None) -> torch.Tensor:
    """Plain version: ``logits[b, v] = mean_l S[l, idx[b, l], v]`` → (B, V)
    f32, with integer counts dequantized first."""
    if quant is not None:
        sketch = dequantize_sketch_ref(sketch, scale, quant)
    n_rows = sketch.shape[0]
    rows = torch.arange(n_rows, device=sketch.device)
    reads = sketch[rows[None, :], idx.long()]          # (B, L, V)
    return reads.mean(dim=1)


def sketch_head_ordered_ref(sketch: torch.Tensor, idx: torch.Tensor,
                            scale: Optional[torch.Tensor] = None,
                            quant: Optional[str] = None) -> torch.Tensor:
    """The kernel's exact function: from acc = 0, for l = 0..L-1 in order
    ``acc = acc + t`` (f32) or ``acc = acc + (scale * t)`` (int8 / int4),
    each a separate op so that nothing contracts, then ``acc * (1/L)`` with
    1/L rounded in f32.  A row with an index outside [0, R) is NaN.  The
    tests and ``chip_smoke.py`` hold the kernel to it bit for bit; no
    served path calls it."""
    n_rows = idx.shape[1]
    n_buckets = sketch.shape[1]
    if quant == "int4":
        sketch = unpack_int4_rows(sketch, n_rows)
    idx = idx.long()
    ok = (idx >= 0) & (idx < n_buckets)
    bad = ~ok.all(dim=1)
    idx = torch.where(ok, idx, 0)
    acc = torch.zeros((idx.shape[0], sketch.shape[2]), dtype=torch.float32,
                      device=sketch.device)
    for l in range(n_rows):
        t = sketch[l, idx[:, l]].to(torch.float32)      # (B, V)
        if quant is not None:
            t = scale[l, idx[:, l]][:, None] * t
        acc = acc + t
    inv_l = (torch.ones((), dtype=torch.float32)
             / torch.tensor(float(n_rows), dtype=torch.float32))
    out = acc * inv_l.to(acc.device)
    return out.masked_fill(bad[:, None], float("nan"))


def _check_quant_args(scale, quant) -> None:
    if quant not in QUANT_CODES:
        raise ValueError(f"unknown quant mode {quant!r}; expected one of "
                         f"{tuple(QUANT_CODES)}")
    if (scale is None) != (quant is None):
        raise ValueError("quant and scale must be passed together "
                         f"(quant={quant!r}, scale is "
                         f"{'None' if scale is None else 'set'})")


def check_sketch(sketch: torch.Tensor, scale: Optional[torch.Tensor],
                 quant: Optional[str], n_rows: int, device) -> None:
    """Raise unless ``sketch``/``scale`` are the storage of an L-row head
    under ``quant`` on ``device``."""
    _check_quant_args(scale, quant)
    _, r, v = sketch.shape
    if quant is None:
        check_operand("sketch", sketch, device, torch.float32,
                      (n_rows, r, v))
        return
    l_store = (n_rows + 1) // 2 if quant == "int4" else n_rows
    check_operand("sketch", sketch, device, torch.int8, (l_store, r, v))
    check_operand("scale", scale, device, torch.float32, (n_rows, r))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("sketch_head").sketch_head_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sketch_head_logits(sketch: torch.Tensor, idx: torch.Tensor, *,
                       scale: Optional[torch.Tensor] = None,
                       quant: Optional[str] = None,
                       tenant_ids: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(B, V) f32 logit estimates: the row-mean over L of the sketch reads.

    Args:
      sketch: (L, R, V) f32 counts, or under ``quant`` the int8 carrier —
        (L, R, V) int8 or (⌈L/2⌉, R, V) packed int4 bytes.
      idx: (B, L) int32 bucket indices from ``lsh_hash``.  On the card a
        row with an index outside [0, R) comes back as NaN.
      scale: (L, R) f32 per-row scales, given iff ``quant`` is.
      quant: ``None``, ``"int8"`` or ``"int4"``.
      tenant_ids: (B,) per-slot bank rows for the multi-tenant path:
        ``sketch`` is then (T, …), ``scale`` (T, L, R) and ``idx`` (T, B, L),
        one full-batch index tensor from each bank row's own hash bank; the
        single-tenant gather runs once per bank row (T launches on the
        card) and row ``b`` is taken from bank row ``tenant_ids[b]``.

    DTensor operands take the row-sharded path: each rank of the mesh's
    model axis gathers its L/m rows (the count rows, scales and index
    columns over ``model``), and one all-reduce over the model group sums
    the partial means scaled by (L/m)/L; the batch splits over ``data``
    where it divides.  A DTensor comes back.  Where the axis does not
    divide L and the storage rows (an int4 shard must hold whole bytes),
    every rank gathers all rows.
    """
    if tenant_ids is not None:
        if idx.dim() != 3 or idx.shape[0] != sketch.shape[0]:
            raise ValueError(
                f"tenant_ids needs a (T, B, L) index stack matching the "
                f"(T, …) sketch bank; got idx {tuple(idx.shape)} vs sketch "
                f"{tuple(sketch.shape)}")
        per_tenant = torch.stack([replicated(
            sketch_head_logits(sketch[t], idx[t],
                               scale=None if scale is None else scale[t],
                               quant=quant))
            for t in range(sketch.shape[0])])
        return select_tenant_rows(per_tenant, replicated(tenant_ids))
    mesh = operand_mesh(sketch, idx, scale)
    if mesh is not None:
        _check_quant_args(scale, quant)

        def launch(ix, sk, sc, *, row_start):
            del row_start               # the indices carry the salts
            return sketch_head_logits(sk, ix, scale=sc, quant=quant)
        return row_sharded_logits(
            launch, mesh, idx.shape[0], idx.shape[1], sketch.shape[0], quant,
            sketch.shape[-1],
            [(idx, "batch_rows"), (sketch, "rows"), (scale, "rows")])
    if idx.device.type == "cpu":
        _check_quant_args(scale, quant)
        return sketch_head_ref(sketch, idx, scale, quant)
    if idx.device.type != "cuda":
        raise ValueError(f"sketch_head_logits runs on cpu or cuda, not "
                         f"{idx.device}")
    n_batch, n_rows = idx.shape
    check_operand("idx", idx, idx.device, torch.int32, (n_batch, n_rows))
    check_sketch(sketch, scale, quant, n_rows, idx.device)
    _, r, v = sketch.shape
    out = torch.empty((n_batch, v), dtype=torch.float32, device=idx.device)
    if n_batch == 0 or v == 0:
        return out
    with torch.cuda.device(idx.device):
        rc = _launcher()(idx.data_ptr(), sketch.data_ptr(),
                         None if scale is None else scale.data_ptr(),
                         out.data_ptr(), n_batch, n_rows, r, v,
                         QUANT_CODES[quant], stream_of(idx.device))
    sketch_head_logits.launches += 1
    _build.check_launch("sketch_head", rc)
    return out


sketch_head_logits.launches = 0
