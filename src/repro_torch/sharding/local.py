"""In-place indexed writes that work on DTensors.

DTensor runs an in-place indexed write (``index_put_``, ``index_copy_``,
``index_fill_``) only when it needs no placement change, which a cache
sharded over its batch (slot) axis never satisfies.  These helpers do the
write on each rank's local block instead: the source is brought to the
destination's layout (``local_block``), the indices are mapped to the
rank's own rows, and nothing is gathered.  For a plain tensor each is the
plain op, so the single-device path keeps its bits.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.sharding.ctx import is_dtensor


def spec_of(x) -> tuple:
    """The partition spec of a DTensor: per tensor dim, None, a mesh axis
    name, or a tuple of names (major first)."""
    names = x.device_mesh.mesh_dim_names
    entries = [[] for _ in range(x.dim())]
    for i, p in enumerate(x.placements):
        if p.is_shard():
            entries[p.dim % x.dim()].append(names[i])
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in entries)


def _local(src, spec, mesh) -> torch.Tensor:
    from repro_torch.kernels.common import local_block
    from repro_torch.sharding.rules import P

    return local_block(src, P(*spec), mesh)


def _offset(x, dim: int) -> int:
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return offset[dim]


def put_rows_(dst: torch.Tensor, slot: torch.Tensor, src: torch.Tensor,
              dim: int = 0) -> None:
    """``dst[..., b, slot[b]] = src[..., b]`` for every row b: dims ``dim``
    (the rows) and ``dim + 1`` (the positions) of ``dst``; ``src`` is
    ``dst``'s shape without the position dim.  On a DTensor each rank
    writes its own rows' positions."""
    lead = (slice(None),) * dim
    if not is_dtensor(dst):
        bi = torch.arange(slot.shape[0], device=slot.device)
        dst[lead + (bi, slot)] = src
        return
    spec = spec_of(dst)
    mesh = dst.device_mesh
    local = dst.to_local()
    slot_l = _local(slot, spec[dim:dim + 1], mesh)
    src_l = _local(src, spec[:dim + 1] + spec[dim + 2:], mesh)
    bi = torch.arange(slot_l.shape[0], device=slot_l.device)
    local[lead + (bi, slot_l)] = src_l.to(local.dtype)


def index_copy_(dst: torch.Tensor, dim: int, index, src: torch.Tensor
                ) -> None:
    """``dst.index_copy_(dim, index, src)``.  On a DTensor sharded along
    ``dim`` each rank copies the entries of ``index`` it holds (``index``
    is then read on the host); along an unsharded dim every rank copies
    its block of ``src``."""
    if not is_dtensor(dst):
        dst.index_copy_(dim, torch.as_tensor(index, dtype=torch.int64,
                                             device=dst.device), src)
        return
    spec = spec_of(dst)
    mesh = dst.device_mesh
    local = dst.to_local()
    if spec[dim] is None:
        idx = torch.as_tensor(index, dtype=torch.int64, device=local.device)
        local.index_copy_(dim, idx, _local(src, spec, mesh).to(local.dtype))
        return
    lo, n = _offset(dst, dim), local.shape[dim]
    rows = [(i, int(s) - lo) for i, s in enumerate(_host(index))
            if lo <= int(s) < lo + n]
    if not rows:
        return
    src_l = _local(src, spec[:dim] + (None,) + spec[dim + 1:], mesh)
    pick, at = zip(*rows)
    dev = local.device
    local.index_copy_(dim, torch.tensor(at, device=dev),
                      src_l.index_select(dim, torch.tensor(pick, device=dev))
                      .to(local.dtype))


def index_fill_(dst: torch.Tensor, dim: int, index, value) -> None:
    """``dst.index_fill_(dim, index, value)``; on a DTensor each rank fills
    the entries of ``index`` it holds."""
    if not is_dtensor(dst):
        dst.index_fill_(dim, torch.as_tensor(index, dtype=torch.int64,
                                             device=dst.device), value)
        return
    local = dst.to_local()
    lo, n = _offset(dst, dim), local.shape[dim]
    at = [int(s) - lo for s in _host(index) if lo <= int(s) < lo + n]
    if at:
        local.index_fill_(dim, torch.tensor(at, device=local.device), value)


def put_(dst: torch.Tensor, index: Sequence, src: torch.Tensor) -> None:
    """``dst[index] = src`` for ``index`` = leading full slices, then index
    tensors on consecutive dims (one broadcast shape).  On a DTensor the
    indexed dims must be unsharded (the page axes of a paged arena): each
    rank writes its block of the trailing dims."""
    if not is_dtensor(dst):
        dst[tuple(index)] = src
        return
    spec = spec_of(dst)
    k = sum(1 for i in index if isinstance(i, slice))
    tensors = [i for i in index if not isinstance(i, slice)]
    n_idx = len(tensors)
    if any(e is not None for e in spec[k:k + n_idx]):
        raise ValueError(f"put_ indexes dims {k}..{k + n_idx - 1} of a "
                         f"DTensor sharded there ({spec})")
    bdim = torch.broadcast_shapes(*(t.shape for t in tensors))
    src_spec = spec[:k] + (None,) * len(bdim) + spec[k + n_idx:]
    local = dst.to_local()
    idx = tuple(t.to_local() if is_dtensor(t) else t for t in tensors)
    local[tuple(index[:k]) + idx] = _local(src, src_spec,
                                           dst.device_mesh).to(local.dtype)


def _host(index) -> list:
    if torch.is_tensor(index):
        return index.tolist()
    return list(index)


def new_zeros(like_x: torch.Tensor, shape, dtype=None, spec=None):
    """Zeros of ``shape`` on ``like_x``'s device: a plain tensor, or for a
    DTensor ``like_x`` a DTensor laid out by ``spec``."""
    dtype = dtype or like_x.dtype
    if not is_dtensor(like_x):
        return torch.zeros(shape, dtype=dtype, device=like_x.device)
    from repro_torch.launch.mesh import distribute

    return distribute(torch.zeros(shape, dtype=dtype, device=like_x.device),
                      spec, like_x.device_mesh)


def on_local_blocks(fn, args: Sequence, layouts: Sequence,
                    out_layouts: Sequence) -> tuple:
    """``fn(*args)`` on each rank's local blocks: the counterpart of the
    JAX package's ``shard_map`` around a computation that is independent
    over the batch and the heads (an attention or a recurrence core, a
    kernel launch).

    ``layouts`` names each arg's dims: ``b`` the batch (over ``data``
    where it divides, as ``kernels.common.batch_entry`` decides), ``h``
    the heads (over ``model`` where every head dim divides it), any other
    letter a dim kept whole on every rank; an arg whose layout is None is
    passed as it is.  DTensor args are redistributed to that layout, plain
    tensors taken as replicated.  ``fn`` returns a tuple laid out as
    ``out_layouts`` says, which comes back as DTensors of the global
    shapes; ``to_local`` and ``from_local`` carry autograd through."""
    from repro_torch.kernels.common import (batch_entry, from_local_block,
                                            local_block, mesh_axis_size,
                                            operand_mesh)
    from repro_torch.sharding.rules import P

    mesh = operand_mesh(*args)
    sizes = {c: [a.shape[i] for a, lay in zip(args, layouts) if lay
                 for i, ch in enumerate(lay) if ch == c] for c in "bh"}
    m = mesh_axis_size(mesh, "model")
    entry = {"b": batch_entry(mesh, sizes["b"][0]) if sizes["b"] else None,
             "h": "model" if all(n % m == 0 for n in sizes["h"]) else None}
    factor = {c: mesh_axis_size(mesh, e) if e else 1 for c, e in entry.items()}

    def spec(lay):
        return P(*(entry.get(c) for c in lay))

    local = [local_block(a, spec(lay), mesh) if lay else a
             for a, lay in zip(args, layouts)]
    outs = fn(*local)
    return tuple(from_local_block(o, spec(lay), mesh,
                                  tuple(n * factor.get(c, 1)
                                        for n, c in zip(o.shape, lay)))
                 for o, lay in zip(outs, out_layouts))
