"""Shared helpers of the sketch-head kernels and their plain versions."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def pad_axis(x: torch.Tensor, axis: int, multiple: int, value=0) -> torch.Tensor:
    """Pad ``axis`` of ``x`` with ``value`` up to the next multiple."""
    axis = axis % x.dim()
    size = x.shape[axis]
    target = round_up(size, multiple)
    if target == size:
        return x
    pads = [0, 0] * (x.dim() - 1 - axis) + [0, target - size]
    return F.pad(x, pads, value=value)


def select_tenant_rows(per_tenant: torch.Tensor,
                       tenant_ids: torch.Tensor) -> torch.Tensor:
    """Per-slot tenant gather: ``out[b] = per_tenant[tenant_ids[b], b]``.

    ``per_tenant`` is a (T, B, …) stack of full-batch outputs, one per bank
    row, each from the unchanged single-tenant path; ``tenant_ids`` the
    (B,) slot → bank-row binding.  The gather moves bits and never sums,
    so row ``b`` is bitwise what tenant ``tenant_ids[b]``'s head alone
    gives.
    """
    rows = torch.arange(per_tenant.shape[1], device=per_tenant.device)
    return per_tenant[tenant_ids.long(), rows]


def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """Pack int4-valued int8 rows pairwise along axis 0: (N, …) → (⌈N/2⌉, …).

    Byte ``i`` holds row ``2i`` in its low nibble and row ``2i+1`` in its
    high nibble (odd N gets a zero pad row) — the JAX package's storage
    layout, so packed archives are interchangeable.
    """
    if q.dtype != torch.int8:
        raise TypeError(f"pack_int4_rows takes int8, got {q.dtype}")
    q = pad_axis(q, 0, 2)
    lo = q[0::2].to(torch.int16) & 0x0F
    hi = q[1::2].to(torch.int16) & 0x0F
    # The packed byte as 0..255, then reinterpreted as signed int8.
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4_rows(packed: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows`: (⌈N/2⌉, …) bytes → (n_rows, …) int8.

    Each nibble is sign-extended with the ``(x << 4) >> 4`` arithmetic-shift
    trick, the same as the CUDA kernels' count read.
    """
    wide = packed.to(torch.int16)
    lo = ((wide << 12) >> 12).to(torch.int8)   # low nibble, sign-extended
    hi = (wide >> 4).to(torch.int8)            # high nibble (arithmetic)
    rows = torch.stack([lo, hi], dim=1).reshape(-1, *packed.shape[1:])
    return rows[:n_rows]


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel's raw pointer arguments assume."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


#: Count-array storage modes, and their codes in the CUDA launchers.
QUANT_CODES = {None: 0, "int8": 1, "int4": 2}
