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


# -- the mesh paths of the kernel wrappers ----------------------------------
#
# A kernel never sees a DTensor.  On a mesh a wrapper brings each operand to
# a placement (``local_block``), launches on the local blocks and wraps the
# result back (``from_local_block``): the port's counterpart of the JAX
# package's ``shard_map`` around a ``pallas_call``.


def operand_mesh(*xs):
    """The ``DeviceMesh`` of the first DTensor among ``xs`` (None where
    there is none): a wrapper given DTensors takes its mesh path."""
    from repro_torch.sharding.ctx import is_dtensor

    for x in xs:
        if is_dtensor(x):
            return x.device_mesh
    return None


def mesh_axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (1 without a mesh or that axis)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def local_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` laid out by ``spec`` on ``mesh``: a
    DTensor is redistributed to it, a plain tensor is taken as replicated
    (the same on every rank) and sliced."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding.rules import to_placements

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    placements = to_placements(spec, mesh)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    return x.to_local()


def from_local_block(x: torch.Tensor, spec, mesh, shape=None):
    """A DTensor of global ``shape`` (contiguous) from this rank's block
    ``x`` laid out by ``spec``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import to_placements

    return DTensor.from_local(x.contiguous(), mesh,
                              to_placements(spec, mesh),
                              run_check=False, shape=shape,
                              stride=None if shape is None
                              else torch.empty(shape, device="meta").stride())


def batch_entry(mesh, n_batch: int):
    """The batch axis's entry on a mesh: ``"data"`` when it divides the
    batch, else replicated (the JAX package's sharded head paths)."""
    dsize = mesh_axis_size(mesh, "data")
    return "data" if dsize > 1 and n_batch % dsize == 0 else None


def row_shardable(mesh, n_rows: int, l_store: int, quant) -> bool:
    """Whether a head's L rows split over ``mesh``'s model axis: the axis
    divides L and the storage rows, and an int4 shard holds whole bytes
    (``2 * l_store == L``)."""
    m = mesh_axis_size(mesh, "model")
    ok = m > 1 and n_rows % m == 0 and l_store % m == 0
    if quant == "int4":
        ok = ok and 2 * l_store == n_rows
    return ok


def row_sharded_logits(launch, mesh, n_batch: int, n_rows: int,
                       l_store: int, quant, v: int, operands):
    """(B, V) logits of a row-mean head on a mesh.

    ``operands`` are ``(tensor, layout)`` pairs, ``layout`` one of
    ``"batch"`` (dim 0 over ``data`` where it divides), ``"rows"`` (dim 0,
    the head's rows, over ``model``), ``"batch_rows"`` (a (B, L) index
    array: both) and ``"rep"`` (replicated); a None tensor stays None.
    Every rank of the model axis runs ``launch(*local blocks,
    row_start=)`` on its L/m rows, row_start its first global row, and the
    partial means, scaled by (L/m)/L, are summed by one all-reduce over the
    model group.  When the model axis does not split the rows, every rank
    launches on all of them.  Returns a DTensor, batch over ``data`` where
    it divides, replicated over ``model``."""
    import torch.distributed as dist

    from repro_torch.sharding.rules import P

    bspec = batch_entry(mesh, n_batch)
    split = row_shardable(mesh, n_rows, l_store, quant)
    rows = "model" if split else None
    specs = {"batch": P(bspec), "rows": P(rows), "batch_rows": P(bspec, rows),
             "rep": P()}
    local = [None if x is None else local_block(x, specs[layout], mesh)
             for x, layout in operands]
    l_shard = n_rows // mesh_axis_size(mesh, "model") if split else n_rows
    start = mesh.get_local_rank("model") * l_shard if split else 0
    part = launch(*local, row_start=start)
    if split:
        part = part * (l_shard / n_rows)
        dist.all_reduce(part, group=mesh.get_group("model"))
    return from_local_block(part, P(bspec, None), mesh, (n_batch, v))
