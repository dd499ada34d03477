"""AdamW with a cosine schedule, global-norm clipping and f32 master weights.

The JAX package's ``optim/adamw.py`` on torch trees (nested dicts and lists
of tensors, the params' own structure).  ``AdamWState`` holds ``step`` (a
0-d int32 tensor on the params' device: the schedule and the bias
corrections read it there, so a step needs no host sync), the moments
``mu``/``nu`` (f32, or bf16 in ``lean`` mode) and the f32 ``master`` copy
of the params (None in ``lean`` mode, where the params are updated in
their own dtype).

The arithmetic is the reference's, in f32: the clip scale
``min(1, grad_clip / (‖g‖ + 1e-9))``, ``m = b1·m + (1 − b1)·g``,
``v = b2·v + (1 − b2)·g²``, the bias corrections ``1 − b^step`` and
``p − lr·(m̂ / (√v̂ + eps) + wd·p)``; a new param takes its grad's dtype
(bf16 grads give bf16 params).  ``b ** step`` and the schedule's cosine
are f32 on both sides, and neither f32 ``pow`` nor XLA's ``cos`` is
correctly rounded, so the two packages agree to a few f32 ulps, not bit
for bit (``tests/test_torch_train.py`` states the bound).

Memory: the update runs in place on ``mu``, ``nu``, ``master`` and the
params (the reference donates all of them), a slice of
``CHUNK`` elements at a time, so its f32 temporaries are a few slices (a
stacked FFN leaf of 805 M elements would take 3.2 GB per f32 temporary).
Elementwise arithmetic gives the same bits in slices as whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.sharding.ctx import is_dtensor, like

#: Elements a slice of the in-place update (64 MiB of f32).
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # Memory-lean mode: bf16 moments and no f32 master (6 B a param of
    # state instead of 14), as the reference's 671B-class configs use.
    lean: bool = False
    # Microbatches a step (gradient accumulation).
    grad_accum: int = 1


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the params' device
    mu: Any
    nu: Any
    master: Any             # f32 copy of the params, or None (lean)


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists,
    tuples; None leaves stay None)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *leaves) for leaves in zip(*trees))
    if t0 is None:
        return None
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensor leaves of a tree, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def init_adamw(params, lean: bool = False) -> AdamWState:
    """Zero moments (f32, or bf16 when ``lean``) and an f32 master copy
    (None when ``lean``), step 0."""
    mdt = torch.bfloat16 if lean else torch.float32
    device = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device),
                    params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device),
                    params),
        master=(None if lean else tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)))


def _f32(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def lr_schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine
    decay to 0.1·lr at ``total_steps``; f32, on step's device."""
    dev = step.device
    s = step.to(torch.float32)
    warm = torch.minimum(s / max(cfg.warmup_steps, 1), _f32(1.0, dev))
    t = ((s - cfg.warmup_steps)
         / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, dev) * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def global_norm(tree) -> torch.Tensor:
    """``sqrt(Σ g²)`` over every leaf, in f32 (a slice at a time).  DTensor
    leaves (a mesh's grads) add their local sums, all-reduced once: a
    plain 0-d tensor, the same on every rank."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    sharded = [g for g in leaves if is_dtensor(g)]
    for g in leaves:
        if is_dtensor(g):
            continue
        for c in _chunks(g.detach()):
            total = total + c.to(torch.float32).square().sum()
    if sharded:
        part = torch.zeros_like(total)
        for g in sharded:
            part = part + _replica_sum(g)
        import torch.distributed as dist
        dist.all_reduce(part)
        total = total + part
    return total.sqrt()


def _replica_sum(g) -> torch.Tensor:
    """This rank's share of ``Σ g²`` over a DTensor: its local sum, divided
    by the number of ranks holding the same block (its replicas), so that
    the sum over every rank counts each element once."""
    local = g.detach().to_local().to(torch.float32).square().sum()
    reps = 1
    for i, p in enumerate(g.placements):
        if not p.is_shard():
            reps *= g.device_mesh.size(i)
    return local / reps


def adamw_update(grads, state: AdamWState, cfg: OptimizerConfig, params
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: ``(params, new state, {"grad_norm", "lr"})``.

    ``state``'s moments and master and the ``params`` (which must have the
    grads' dtypes) are updated in place, as the reference donates them,
    and returned.  Each slice runs the arithmetic above with in-place
    ops on its f32 moments and master (``add_``/``addcmul_`` may round
    ``a + c·b`` once, where the reference rounds twice)."""
    ref = state.master if state.master is not None else params
    step = state.step + 1
    dev = step.device
    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, dev), cfg.grad_clip / (gnorm + 1e-9))
    lr = lr_schedule(step, cfg)
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), sf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), sf)

    def upd(g, m, v, p, out):
        if out.dtype != g.dtype or out.shape != g.shape:
            raise ValueError(f"a param of {out.dtype} {tuple(out.shape)} for a "
                             f"grad of {g.dtype} {tuple(g.shape)}")
        if is_dtensor(m):
            return _upd_local(g, m, v, p, out)
        for gc, mc, vc, pc, oc in zip(*map(_chunks, (g.detach(), m, v,
                                                     p.detach(),
                                                     out.detach()))):
            g32 = gc.to(torch.float32, copy=True).mul_(scale)
            # f32 leaves in place; bf16 (lean) ones through an f32 copy
            m32, v32, p32 = (c if c.dtype == torch.float32
                             else c.to(torch.float32) for c in (mc, vc, pc))
            m32.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
            v32.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
            den = torch.div(v32, bc2).sqrt_().add_(cfg.eps)
            u = torch.div(m32, bc1, out=g32).div_(den)
            p32.addcmul_(u.add_(p32, alpha=cfg.weight_decay), lr, value=-1)
            for c, c32 in ((mc, m32), (vc, v32), (oc, p32)):
                if c is not c32:
                    c.copy_(c32)
        return out

    def _upd_local(g, m, v, p, out):
        """The update on a mesh (ZeRO-1): each rank steps its own block of
        the moments and master, the grad brought to their layout, and the
        new param block is gathered back to the param's layout."""
        from torch.distributed.tensor import DTensor

        g_l = like(g.detach(), m).to_local()
        if p is out:                 # lean: the params are the reference
            ref_l = like(p.detach(), m).to_local().clone()
            new_l = ref_l
        else:                        # the master's own block, in place
            ref_l = p.to_local()
            new_l = torch.empty_like(ref_l, dtype=out.dtype)
        upd(g_l, m.to_local(), v.to_local(), ref_l, new_l)
        new = DTensor.from_local(new_l, m.device_mesh, m.placements,
                                 run_check=False, shape=m.shape,
                                 stride=m.stride())
        out.detach().copy_(like(new, out))
        return out

    with torch.no_grad():
        tree_map(upd, grads, state.mu, state.nu, ref, params)
    return params, AdamWState(step, state.mu, state.nu, state.master), {
        "grad_norm": gnorm, "lr": lr}
