"""Per-rank op analyzer: counts the ops one rank dispatches, not HLO.

The JAX package's ``launch/hlo_analysis.py`` parses a compiled,
SPMD-partitioned HLO module, whose shapes are each device's shards.  The
port has no compiled module: :func:`analyze` runs a step under a
``TorchDispatchMode`` and counts every aten op this rank dispatches, on
the local shapes it runs, once:

* **flops**: the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  any ``out_dtype``) at 2·M·N·K per product, plus the work that the
  hand-written kernels report through ``kernels/work.record`` (a kernel
  launched through ctypes is no aten op);
* **elementwise_flops**: the output elements of pointwise ops
  (``torch.Tag.pointwise``) and the input elements of reductions;
* **bytes_accessed**: the inputs plus the outputs of every op that does
  work, and the kernels' reported bytes; views, aliases and bare
  allocations count 0;
* **collective_bytes**: by kind (the reference's names: all-reduce,
  all-gather, reduce-scatter, all-to-all, plus broadcast), each the
  bytes of its result (an all-reduce's buffer), and their ``total``;
* **memory**: the step's arguments' bytes, the bytes of its outputs that
  alias no argument, and the peak of the bytes allocated while it runs
  (``temp_size_bytes``, the outputs included).

A DTensor op is never counted itself: the mode defers it to DTensor
(``NotImplemented``), whose dispatch then runs the local ops, the
collectives of a redistribution among them, back through the mode.
DTensor's sharding propagation, which also runs the global-shape op on
placeholders to learn its output's metadata, is no work of the rank and
is not counted.  So a step on fake tensors (``FakeTensorMode``) over a
fake process group counts what each rank of that group would run.

A chunk loop (``kernels/work.chunk_loop``: the WKV and Mamba scans) that
records no autograd graph is traced through its first two iterations and
its last, the second weighted by the trip count, as the reference's
analyzer weighs a scan's body (``weigh_loops``): its iterations run the
same ops at the same shapes (the first may differ in its carry, the last
may be padded), so every count equals the per-iteration trace's.  The
skipped iterations' outputs are allocated (uncounted) so that the peak
holds what the full loop holds.  A loop on real tensors runs every
iteration.

No ``bytes_bf16adj``: the port computes bf16 in bf16 (there is no f32
legalization, as on XLA's CPU backend), so its bytes are the true dtypes'.
"""

from __future__ import annotations

import math
import weakref
from collections import Counter, defaultdict
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import work

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
# The matmul family: the positions of the two factors among the args.
_MATMULS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2),
            "_scaled_mm": (0, 1)}
# Ops that allocate without touching memory, wait on a collective, or
# alias their input without saying so in their schema.
_NO_WORK = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "wait_tensor", "_unsafe_view"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or ``t``."""
    return getattr(t, "_local_tensor", t)


def _matmul_flops(name: str, args) -> int:
    """2·M·N·K of each product of a matmul-family op (batched: times B)."""
    i, j = _MATMULS[name]
    a, b = args[i].shape, args[j].shape
    return 2 * math.prod(a) * b[-1]


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input without writing it
    (a view)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _Counter(TorchDispatchMode):
    """The dispatch mode of :func:`analyze` (see the module docstring)."""

    def __init__(self, top_ops: int):
        super().__init__()
        self.dtensor = None
        if torch.distributed.is_available():
            from torch.distributed.tensor import DTensor
            self.dtensor = DTensor
        self.top_ops = top_ops
        self.flops = 0
        self.elementwise = 0
        self.bytes = 0
        self.coll: Dict[str, int] = defaultdict(int)
        self.n_ops = 0
        self.kernels: Counter = Counter()
        self.flop_items: List[Tuple[int, str, str]] = []
        self.propagating = 0        # inside DTensor's sharding propagation
        self.live = 0               # bytes of storages allocated in the step
        self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}

    def _totals(self) -> tuple:
        return (self.flops, self.elementwise, self.bytes, dict(self.coll),
                self.n_ops, Counter(self.kernels), len(self.flop_items))

    def loop(self, n: int, body: Callable, carry):
        """``kernels/work.chunk_loop``'s iterations, weighed: the first,
        the second and the last traced, the second counted n - 2 times
        (the first may differ in its carry: a plain zero state, say); the
        ones between stand in as uncounted allocations of the second's
        outputs.  A loop on real tensors (a calibration run) runs every
        iteration: its outputs are used."""
        from torch._subclasses.fake_tensor import is_fake

        if not is_fake(carry):
            return work.run_loop(n, body, carry)
        y, carry = body(0, carry)
        ys = [y]
        flops, elem, nbytes, coll, n_ops, kernels, n_items = self._totals()
        y, carry = body(1, carry)
        ys.append(y)
        w = n - 3
        self.flops += w * (self.flops - flops)
        self.elementwise += w * (self.elementwise - elem)
        self.bytes += w * (self.bytes - nbytes)
        for kind, v in list(self.coll.items()):
            self.coll[kind] += w * (v - coll.get(kind, 0))
        self.n_ops += w * (self.n_ops - n_ops)
        for name, v in list(self.kernels.items()):
            self.kernels[name] += w * (v - kernels.get(name, 0))
        self.flop_items += [(f * w, op, shapes) for f, op, shapes
                            in self.flop_items[n_items:]]
        self.propagating += 1
        try:
            stand_ins = [pytree.tree_map_only(torch.Tensor, torch.empty_like,
                                              y) for _ in range(w)]
        finally:
            self.propagating -= 1
        self._track([], [_local(t) for t in _tensors(stand_ins)])
        ys += stand_ins
        y, carry = body(n - 1, carry)
        ys.append(y)
        return ys, carry

    def kernel(self, name: str, n_bytes: int, n_ops: int) -> None:
        self.kernels[name] += 1
        self.flops += n_ops
        self.bytes += n_bytes
        if self.top_ops:
            self.flop_items.append((n_ops, f"kernel {name}", ""))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.dtensor is not None and any(
                issubclass(t, self.dtensor) for t in types):
            return NotImplemented           # DTensor runs the local ops
        out = func(*args, **kwargs)
        if not self.propagating:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        self.n_ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = func._opname
        if name in _MATMULS and func.namespace == "aten":
            f = _matmul_flops(name, args)
            self.flops += f
            if self.top_ops:
                self.flop_items.append(
                    (f, str(func), " x ".join(str(tuple(t.shape)) for t in ins)))
        tags = func.tags
        if torch.Tag.pointwise in tags:
            self.elementwise += sum(t.numel() for t in outs)
        elif getattr(torch.Tag, "reduction", None) in tags and ins:
            self.elementwise += ins[0].numel()
        kind = (_COLLECTIVES.get(name)
                if func.namespace in ("_c10d_functional", "c10d") else None)
        if kind is not None:
            self.coll[kind] += sum(_nbytes(t) for t in (outs or ins))
        if outs and name not in _NO_WORK and not _is_view(func):
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        self._track(ins, outs)

    def _track(self, ins, outs) -> None:
        """Count each output storage that is new (no input's) as live
        until it is freed."""
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._refs:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._refs[key] = weakref.ref(st, self._freer(key, n))

    def _freer(self, key: int, n: int):
        def freed(_ref):
            self.live -= n
            self._refs.pop(key, None)
        return freed


@contextmanager
def _outside_propagation(counter: _Counter):
    """Run DTensor's sharding propagation uncounted: its op strategies and
    the global-shape op it runs on placeholders to learn an output's
    metadata are no work of the rank (``counter.propagating``).  It runs
    outside any fake mode, as it would on real tensors: its strided-shard
    bookkeeping computes on small index tensors (and reads them back),
    which a fake tensor cannot do; its metadata op makes its own fake
    placeholders."""
    if not torch.distributed.is_available():
        yield
        return
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator

    def uncounted(fn):
        def run(*args, **kwargs):
            counter.propagating += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                counter.propagating -= 1
        return run

    names = ("propagate_op_sharding", "propagate_op_sharding_non_cached",
             "_propagate_tensor_meta_non_cached")
    own = {n: prop.__dict__[n] for n in names if n in prop.__dict__}
    for n in names:
        setattr(prop, n, uncounted(getattr(prop, n)))
    try:
        yield
    finally:
        for n in names:
            if n in own:
                setattr(prop, n, own[n])
            else:
                delattr(prop, n)


def _storage_bytes(tensors, exclude=()) -> int:
    """The bytes of the distinct storages of ``tensors`` (DTensors by
    their local shards), less those whose storage is in ``exclude``."""
    seen = set(exclude)
    total = 0
    for t in tensors:
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def analyze(fn: Callable, *args, top_ops: int = 0, weigh_loops: bool = True,
            **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and count what this rank dispatched
    (chunk loops weighed unless ``weigh_loops`` is False: then every
    iteration is traced).

    Returns the JAX package's keys, each per rank: ``flops``,
    ``elementwise_flops``, ``bytes_accessed``, ``collective_bytes`` (by
    kind and ``total``), ``n_ops`` (in place of ``n_computations``) and,
    with ``top_ops``, ``top_flop_ops`` (the ``top_ops`` largest
    ``(flops, op, operand shapes)``); then ``kernels`` (calls by kernel
    name), ``memory`` (``argument_size_bytes``, ``output_size_bytes``,
    ``temp_size_bytes``) and ``result``, what ``fn`` returned.
    """
    arg_tensors = _tensors((args, kwargs))
    arg_storages = {id(_local(t).untyped_storage()) for t in arg_tensors}
    counter = _Counter(top_ops)
    loops = (work.weighing_loops(counter.loop) if weigh_loops
             else nullcontext())
    with _outside_propagation(counter), work.recording(counter.kernel), \
            loops, counter:
        result = fn(*args, **kwargs)
    coll = dict(counter.coll)
    out = {
        "flops": counter.flops,
        "elementwise_flops": counter.elementwise,
        "bytes_accessed": counter.bytes,
        "collective_bytes": dict(coll, total=sum(coll.values())),
        "n_ops": counter.n_ops,
        "kernels": dict(counter.kernels),
        "memory": {
            "argument_size_bytes": _storage_bytes(arg_tensors),
            "output_size_bytes": _storage_bytes(_tensors(result),
                                                arg_storages),
            "temp_size_bytes": counter.peak,
        },
        "result": result,
    }
    if top_ops:
        out["top_flop_ops"] = sorted(counter.flop_items,
                                     key=lambda t: -t[0])[:top_ops]
    return out
