"""Checkpointing: per-host shard files, an async writer, a manifest, restart.

The JAX package's ``checkpoint/manager.py`` for torch trees (nested dicts,
lists, tuples and NamedTuples such as ``(params, AdamWState)``).  Layout,
one directory per step::

    ckpt_dir/
      step_000000100/
        shard_00000.npz        # this host's leaves, numpy, by key
        MANIFEST.json          # written LAST: marks the step complete

A leaf's key is JAX's ``keystr`` of its path in the same tree (``[0]``
for a sequence index, ``['name']`` for a dict key, ``.field`` for a
NamedTuple field), so a checkpoint the JAX package wrote restores here and
the other way round.  bf16 leaves are stored as their uint16 bits (npz
has no bfloat16), as the reference stores them.

Crash safety: the manifest is written only after the shard file is
renamed into place and fsync'd, so a step directory without one is
garbage and ``latest_step`` skips it.  ``save`` copies the leaves to host
numpy before it returns (the training loop goes on updating the device
tensors in place) and writes them on a thread; ``wait`` drains the
writers and raises the first error.  Old steps beyond ``keep`` are
removed after each write.  ``restore`` copies each stored leaf into the
template's own tensor, so a restart holds one copy of the state (the
musicgen-large state alone is about 42 GiB).

On a mesh (DTensor leaves, under an initialised process group) the
layout and the keys stay the same, so one checkpoint serves the JAX
package, the port off a mesh and the port on a mesh.  ``save`` gathers
each DTensor leaf to a full tensor (``sharding.ctx.replicated``, a
collective every rank calls, in the same leaf order) and copies it to the
host before the next leaf is gathered, so no device holds a second copy
of the state;
rank 0 alone keeps the host copies and writes the shard file and the
manifest, as the reference's host 0 does.  ``restore`` has each rank read
the file and copy only its own block of each leaf (by the leaf's
placements) into the template's local tensor.  ``wait`` and ``restore``
end in a barrier of every rank, so no rank reads a step that rank 0 is
still writing.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.ctx import is_dtensor, replicated


def _children(tree) -> List[Tuple[str, Any]]:
    """``(key entry, child)`` of one tree node, in JAX's flattening order
    (dict keys sorted), or [] for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_keys(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` of every tensor leaf (None subtrees have none)."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += flatten_with_keys(child, prefix + key)
    return out


def _host_items(tree, keep: bool = True) -> List[Tuple[str, np.ndarray]]:
    """``(key, host array)`` of every leaf, DTensors gathered first (every
    rank calls this); with ``keep`` False the gathers run and nothing is
    copied to the host (a rank that does not write)."""
    items = []
    for key, leaf in flatten_with_keys(tree):
        if not torch.is_tensor(leaf):
            raise TypeError(f"{key}: a checkpoint holds tensors, got "
                            f"{type(leaf).__name__}")
        leaf = replicated(leaf.detach())
        if not keep:
            continue
        if leaf.dtype == torch.bfloat16:
            bits = leaf.view(torch.int16).to("cpu", copy=True)
            arr = bits.numpy().view(np.uint16)
        else:
            arr = leaf.to("cpu", copy=True).numpy()
        items.append((key, arr))
    return items


def _own_block(arr: np.ndarray, leaf) -> Tuple[np.ndarray, torch.Tensor]:
    """This rank's block of the stored full ``arr`` and the tensor it goes
    into: a DTensor's local tensor, by its placements; else ``leaf``."""
    if not is_dtensor(leaf):
        return arr, leaf.detach()
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        leaf.shape, leaf.device_mesh, leaf.placements)
    block = arr[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return block, leaf.to_local().detach()


def _restore_leaf(key: str, arr: np.ndarray, leaf: torch.Tensor) -> None:
    """Copy the stored ``arr`` into the template ``leaf`` in place (into
    a DTensor's local tensor, its own block of ``arr``); raises on another
    shape or dtype."""
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"{key}: stored shape {arr.shape}, template "
                         f"{tuple(leaf.shape)}")
    arr, dst = _own_block(arr, leaf)
    if leaf.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "uiV":
            raise ValueError(f"{key}: stored {arr.dtype} for a bfloat16 leaf")
        src = torch.from_numpy(np.asarray(arr, order="C").view(np.int16))
        dst = dst.view(torch.int16)
    else:
        want = torch.empty((), dtype=leaf.dtype).numpy().dtype
        if arr.dtype != want:
            raise ValueError(f"{key}: stored {arr.dtype}, template {want}")
        src = torch.from_numpy(np.asarray(arr, order="C"))
    with torch.no_grad():
        dst.copy_(src)


def _group_rank() -> Tuple[int, int]:
    """(rank, world size) of the initialised default process group, or
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointManager:
    def __init__(self, directory: str, *, host_id: int = 0, n_hosts: int = 1,
                 keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.keep = keep
        self._pending: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        rank, self._world = _group_rank()
        self._writer = rank == 0

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot ``tree`` for ``step``: host copies now, the files on a
        thread (``blocking`` waits for them).  Under a process group every
        rank calls it; rank 0 writes."""
        items = _host_items(tree, keep=self._writer)
        if not self._writer:
            if blocking:
                self.wait()
            return

        def worker():
            try:
                self._write(step, items)
            except BaseException as e:  # surfaced on wait()
                with self._lock:
                    self._errors.append(e)

        t = threading.Thread(target=worker, daemon=True)
        with self._lock:
            self._pending.append(t)
        t.start()
        if blocking:
            self.wait()

    def _raise_errors(self) -> None:
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    def _write(self, step: int, items) -> None:
        step_dir = self.dir / f"step_{step:09d}"
        step_dir.mkdir(parents=True, exist_ok=True)
        shard = step_dir / f"shard_{self.host_id:05d}.npz"
        tmp = shard.with_suffix(".tmp")
        with open(tmp, "wb") as f:      # a file handle: np.savez can't rename
            np.savez(f, **{k: v for k, v in items})
        os.replace(tmp, shard)          # atomic rename
        with open(shard, "rb") as f:    # durable before the manifest
            os.fsync(f.fileno())
        if self.host_id == 0:
            manifest = step_dir / "MANIFEST.json"
            mtmp = manifest.with_suffix(".tmp")
            mtmp.write_text(json.dumps({
                "step": step,
                "n_hosts": self.n_hosts,
                "time": time.time(),
                "keys": [k for k, _ in items],
            }))
            os.replace(mtmp, manifest)
        self._gc()

    def wait(self) -> None:
        """Drain the writes, raise the first error; under a process group
        of several ranks every rank then waits at a barrier."""
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()
        if self._world > 1:
            import torch.distributed as dist

            dist.barrier()
        self._raise_errors()

    def _gc(self) -> None:
        steps = self.complete_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def complete_steps(self) -> List[int]:
        out = []
        for d in sorted(self.dir.glob("step_*")):
            if (d / "MANIFEST.json").exists():
                out.append(int(d.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """Restore into ``template``'s own tensors, leaf by leaf, so the
        device holds no second copy of the state (a DTensor leaf: its own
        block into its local tensor): another shape or dtype in the file
        raises (the leaves before it are then already overwritten).
        Returns (template, step)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        shard = self.dir / f"step_{step:09d}" / f"shard_{self.host_id:05d}.npz"
        items = flatten_with_keys(template)
        with np.load(shard) as data:
            missing = [k for k, _ in items if k not in data.files]
            if missing:
                raise KeyError(f"{shard}: no leaves {missing[:5]}")
            for key, leaf in items:     # the npz reads one leaf at a time
                _restore_leaf(key, data[key], leaf)
        return template, step
