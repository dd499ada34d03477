"""Activation-sharding context: logical-axis constraints inside model code.

Model code calls ``constrain(x, "dp", None, "tp", ...)`` with *logical*
axis names; inside :func:`activation_sharding` these map to the mesh axes

    "dp" → ("pod", "data")   (whatever data axes the mesh has)
    "tp" → "model"

and a DTensor is redistributed to that layout (the JAX package's
``with_sharding_constraint``): the FFN intermediate on TP shards,
activations on DP shards.  Outside a context, and for a plain tensor,
``constrain`` returns ``x`` as it is.  An axis that does not divide its
dimension is dropped per call, so one model code serves every mesh.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from contextlib import contextmanager

import torch

_state = threading.local()


@contextmanager
def activation_sharding(mesh):
    """Enable logical-axis activation constraints on ``mesh``."""
    axes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    dp = tuple(a for a in ("pod", "data") if a in axes)
    logical = {
        "dp": dp if len(dp) != 1 else dp[0],
        "tp": "model" if "model" in axes else None,
    }
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, axes, logical)
    try:
        yield
    finally:
        _state.ctx = prev


def recompute_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the forward runs as it
    is, the recompute under the activation context active now.  The
    recompute runs inside the backward, which for CUDA tensors runs on
    the autograd engine's device thread, where this thread's context is
    not set."""
    ctx = getattr(_state, "ctx", None)

    @contextmanager
    def restored():
        prev = getattr(_state, "ctx", None)
        _state.ctx = ctx
        try:
            yield
        finally:
            _state.ctx = prev

    return contextlib.nullcontext(), restored()


def active_mesh():
    """The mesh of the innermost active context, or None."""
    ctx = getattr(_state, "ctx", None)
    return None if ctx is None else ctx[0]


def _axis_size(axes: dict, entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(axes[n] for n in names)


def logical_axis_size(name: str) -> int:
    """Size of a logical axis ('dp'/'tp') in the active context (1 if
    none)."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return 1
    _, axes, logical = ctx
    return _axis_size(axes, logical.get(name))


def constrain(x, *logical_spec):
    """``x`` redistributed to the logical spec ('dp'/'tp'/None per dim).

    A no-op outside a context or for a plain tensor.  Drops any axis whose
    size does not divide its dimension."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.rules import P, to_placements

    _, axes, logical = ctx
    entries = []
    for dim, name in zip(x.shape, logical_spec):
        phys = logical.get(name) if name else None
        if phys is None or dim % _axis_size(axes, phys) != 0:
            entries.append(None)
        else:
            entries.append(phys)
    entries += [None] * (x.dim() - len(entries))
    placements = to_placements(P(*entries), x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for a plain
    tensor's caller)."""
    if isinstance(x, torch.Tensor) and type(x) is not torch.Tensor:
        from torch.distributed.tensor import DTensor
        return isinstance(x, DTensor)
    return False


def like(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``src`` in ``dst``'s layout, for an in-place write of ``src`` into
    ``dst`` (``copy_``, ``index_copy_``, ``index_put_``): redistributed to
    ``dst``'s placements when ``dst`` is a DTensor (a plain ``src`` is
    taken as replicated); ``src`` itself otherwise."""
    if not is_dtensor(dst):
        return src
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(src):
        src = DTensor.from_local(src, dst.device_mesh,
                                 [Replicate()] * dst.device_mesh.ndim,
                                 run_check=False)
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    return src


def settled(x):
    """``x``, whose gradient is brought to ``x``'s own layout before it
    flows back into the ops that made ``x`` (a plain tensor as it is).
    DTensor hands a gradient back in whatever layout its consumers left
    (a partial sum, a split over more mesh dims than x had), which the
    backward of a view, or of a redistribution from a masked partial,
    may not take."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def replicated(x):
    """A DTensor gathered to a full plain tensor on every rank (the logits
    before the sampler, so each rank draws the same token); a plain tensor
    as it is.  A DTensor sharded evenly over every dim of a mesh that is
    the whole process group comes back from one all-gather over the group
    (``full_tensor`` gathers mesh dim by mesh dim, each stage's output a
    collective of its own: on a mesh with ``pod`` the batch is gathered
    twice); any other by ``full_tensor``."""
    if not is_dtensor(x):
        return x
    out = _gathered_once(x)
    return x.full_tensor() if out is None else out


def _gathered_once(x):
    """``x``'s full tensor from one all-gather of its local blocks over
    the whole group, rearranged by its placements; None unless every mesh
    dim shards ``x`` evenly and the mesh is the whole group in rank
    order."""
    import torch.distributed as dist

    mesh, placements = x.device_mesh, x.placements
    if mesh.ndim < 2 or not all(p.is_shard() for p in placements):
        return None
    with torch._C._DisableTorchDispatch():     # the mesh's real rank map
        ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        return None
    local = x.to_local()
    dims = [p.dim % x.dim() for p in placements]
    split = [math.prod(mesh.size(i) for i, d in enumerate(dims) if d == t)
             for t in range(x.dim())]
    if any(g != n * k for g, n, k in zip(x.shape, local.shape, split)):
        return None
    c10d = torch.ops._c10d_functional
    blocks = c10d.wait_tensor(c10d.all_gather_into_tensor(
        local.contiguous(), dist.get_world_size(),
        dist.group.WORLD.group_name))
    blocks = blocks.view(*mesh.shape, *local.shape)
    # Each tensor dim: the mesh dims that split it (the first the major
    # split), then its local block.
    order = []
    for t in range(x.dim()):
        order += [i for i, d in enumerate(dims) if d == t] + [mesh.ndim + t]
    return blocks.permute(order).reshape(x.shape)


@contextmanager
def on_mesh(mesh):
    """SPMD compute on ``mesh``: :func:`activation_sharding`, and DTensor's
    implicit replication of plain tensors (tokens, positions, masks: the
    same on every rank).  Nothing without a mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor import DTensor

    # DTensor's own implicit_replication() resets the flag on exit, which
    # would end an enclosing context early; this restores it.
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        with activation_sharding(mesh):
            yield
    finally:
        dispatcher._allow_implicit_replication = prev


def serving_method(fn):
    """Run a method in ``serving(self.mesh)``: the decode loops' and the
    engine backend's operations."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with serving(self.mesh):
            return fn(self, *args, **kwargs)
    return run


@contextmanager
def serving(mesh):
    """The mode every serving path runs in: ``torch.inference_mode``
    without a mesh; on one, ``torch.no_grad`` (DTensor ops refuse
    inference tensors) inside :func:`on_mesh`."""
    if mesh is None:
        with torch.inference_mode():
            yield
        return
    with torch.no_grad(), on_mesh(mesh):
        yield
