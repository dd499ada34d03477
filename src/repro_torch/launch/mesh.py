"""Device meshes over ``torch.distributed`` and serving-state placement.

The port's mesh is a ``DeviceMesh`` with axes ``("data", "model")`` (or
``("pod", "data", "model")``) over the default process group.  It runs
SPMD: every rank runs the same program, as ``torchrun`` launches it
(``torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 2x2``),
and params, head arrays and caches are DTensors placed by
``sharding/rules.py``.  Nothing here initialises a process group: the
launcher (``torchrun``, a test's spawned ranks) does.
"""

from __future__ import annotations

import torch


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _world(spec) -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"mesh {spec!r} needs an initialised default process group "
            f"(run under torchrun, or call "
            f"torch.distributed.init_process_group first)")
    return dist.get_world_size()


def _init_mesh(spec, shape, names, device_type=None):
    from torch.distributed.device_mesh import init_device_mesh

    n = _world(spec)
    if n != torch.Size(shape).numel():
        raise ValueError(
            f"mesh {spec!r} needs {torch.Size(shape).numel()} ranks but the "
            f"process group has {n}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The 16×16 single-pod (256 ranks) or 2×16×16 two-pod (512 ranks)
    mesh over the initialised group; a function, so importing this module
    builds nothing."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init_mesh("x".join(map(str, shape)), shape, names, device_type)


def make_host_mesh(model: int = 1, device_type=None):
    """A ``(world // model, model)`` mesh over the initialised group's
    world."""
    n = _world(f"?x{model}")
    if n % model:
        raise ValueError(f"model axis {model} does not divide the process "
                         f"group's {n} ranks")
    return _init_mesh(f"{n // model}x{model}", (n // model, model),
                      ("data", "model"), device_type)


def parse_mesh(spec, device_type=None):
    """A serving mesh from a ``"<data>x<model>"`` spec.

    Args:
      spec: ``None`` (returned as is), a ``DeviceMesh`` (returned as is),
        or a string like ``"2x2"`` (data × model).
      device_type: ``"cuda"`` or ``"cpu"``; the card when one is present
        if omitted.

    Raises:
      ValueError: a malformed spec, no initialised process group, or a
        world size other than data·model; the message names the spec.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if spec is None or isinstance(spec, DeviceMesh):
        return spec
    try:
        data, model = (int(p) for p in str(spec).lower().split("x"))
    except ValueError:
        raise ValueError(
            f"mesh spec {spec!r} is not of the form '<data>x<model>' "
            f"(e.g. '2x2')") from None
    return _init_mesh(spec, (data, model), ("data", "model"), device_type)


def join_launcher_group(device: torch.device) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (NCCL for cards, gloo on the CPU) unless one is up, and
    return this rank's device (``cuda:LOCAL_RANK`` on cards).  Ranks other
    than 0 send their standard output to the null device, so that a CLI
    prints once."""
    import os
    import sys

    import torch.distributed as dist

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if dist.get_rank() != 0:
        sys.stdout = open(os.devnull, "w")
    return device


def distribute(x: torch.Tensor, spec, mesh):
    """``x`` as a DTensor on ``mesh`` with ``spec``'s placements (every
    rank passes the same full tensor; each keeps its shard)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.sharding.rules import to_placements

    placements = to_placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)


def distribute_tree(tree, specs, mesh, place=None):
    """Every tensor leaf of ``tree`` distributed by the matching spec of
    ``specs`` (a tree of the same structure; ``None`` preserved), each by
    ``place(leaf, spec, mesh)`` (:func:`distribute` by default)."""
    place = place or distribute
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh, place)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute_tree(v, s, mesh, place)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, list):
        return [distribute_tree(v, s, mesh, place)
                for v, s in zip(tree, specs)]
    return place(tree, specs, mesh)


def shard_like(x: torch.Tensor, spec, mesh):
    """A DTensor of ``x``'s global shape, dtype and device laid out by
    ``spec``, whose local block is a new empty tensor of this rank's shard
    shape: the dry run's placement of fake tensors, which
    :func:`distribute` cannot place (its replication broadcasts, and a
    fake group has no data to send)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.sharding.rules import to_placements

    placements = to_placements(spec, mesh)
    with unset_fake_temporarily():       # the mesh's own (real) coordinates
        shape, _ = compute_local_shape_and_global_offset(x.shape, mesh,
                                                         placements)
    local = torch.empty(shape, dtype=x.dtype, device=x.device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def gather_tree(tree, device):
    """Every DTensor leaf of ``tree`` as a full plain tensor on ``device``
    (the way back from a mesh to one device)."""
    from torch.distributed.tensor import DTensor

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather_tree(v, device) for v in tree))
    if isinstance(tree, list):
        return [gather_tree(v, device) for v in tree]
    if isinstance(tree, DTensor):
        return tree.full_tensor().to(device)
    return tree.to(device)


def place_serving_state(params, head, mesh):
    """``(params, head)`` placed on ``mesh`` by ``sharding/rules.py``: the
    backbone by ``params_shardings``, the head's frozen arrays (if any) by
    ``head_param_shardings`` (``params`` None: the head alone)."""
    from repro_torch.sharding.rules import (head_param_shardings,
                                            params_shardings)

    if params is not None:
        params = distribute_tree(params, params_shardings(params, mesh), mesh)
    if head.params is not None:
        head = head.with_params(distribute_tree(
            head.params, head_param_shardings(head.params, mesh), mesh))
    return params, head
