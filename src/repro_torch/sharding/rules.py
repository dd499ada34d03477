"""Parameter, optimizer-state, batch and cache sharding rules.

Own copy of the JAX package's ``sharding/rules.py``: the same regexes in
the same order, the same divisibility fallbacks, the same specs.

Mesh axes: ``("pod", "data", "model")`` or ``("data", "model")``.  Batch
shards over (pod×)data; tensor dims over model:

* embedding & head      — vocab over ``model``
* attention q/k/v/o     — head dim over ``model``
* dense FFN             — d_ff over ``model``
* MoE experts           — expert axis over ``model`` (expert parallelism)
* mamba / rwkv inner    — d_inner / heads over ``model``
* KV & state caches     — batch over the data axes, a feature dim over
                          ``model``

A spec is a :class:`P`: one entry per tensor dim, ``None`` (replicated),
an axis name, or a tuple of axis names.  :func:`to_placements` turns it
into DTensor placements on a ``DeviceMesh``.  The rules read only
``mesh.mesh_dim_names`` and ``mesh.shape``, so any object with those two
attributes stands in for a mesh (the tests use one to check the specs of
a 16×16 mesh without a process group).

Stacked period leaves (``periods/...``) carry a leading ``n_periods`` axis
that is never sharded.  ZeRO-1 (:func:`zero1_shardings`) also shards
optimizer-state leaves over ``data`` on the largest free dim.  The frozen
sketch head has its own table (:data:`_HEAD_RULES`): the (L, R, V) count
arrays partition over ``model`` on the repetition axis L, the hash params
replicate, so a sharded decode step ends in one all-reduce of the (B, V)
logits.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence, Tuple


class P(tuple):
    """A partition spec: ``P("model", None)`` shards dim 0 over ``model``
    and replicates dim 1; a tuple entry shards one dim over several mesh
    axes, major first.  Missing trailing entries are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# (path regex, spec WITHOUT the scan axis). First match wins.
_PARAM_RULES = (
    (r"embed$",                       P("model", None)),
    (r"head$",                        P("model", None)),
    (r"final_norm$",                  P(None)),
    # attention
    (r"mixer/w[qkv]$",                P(None, "model")),
    (r"mixer/wo$",                    P("model", None)),
    # MLA
    (r"mixer/w_dq$",                  P(None, None)),
    (r"mixer/w_uq$",                  P(None, "model")),
    (r"mixer/w_dkv$",                 P(None, None)),
    (r"mixer/w_u[kv]$",               P(None, "model")),
    (r"mixer/w_o$",                   P("model", None)),
    # FFN (dense 2-dim and MoE 3-dim share key names; candidates are
    # rank-filtered, and among rank matches the first fully-divisible spec
    # wins: EP on the expert axis, f-TP when E < tp).
    (r"ffn/router$",                  P(None, None)),
    (r"ffn/shared/w_(gate|up)$",      P(None, "model")),
    (r"ffn/shared/w_down$",           P("model", None)),
    # expert weights: EP over model + FSDP over data
    (r"ffn/w_(gate|up)$",             (P("model", "data", None),
                                       P("model", None, None),
                                       P(None, "data", "model"),
                                       P(None, None, "model"),
                                       P(None, "model"))),
    (r"ffn/w_down$",                  (P("model", "data", None),
                                       P("model", None, None),
                                       P(None, "model", "data"),
                                       P(None, "model", None),
                                       P("model", None))),
    # dense FFN
    (r"ffn/w_(gate|up)$",             P(None, "model")),
    (r"ffn/w_down$",                  P("model", None)),
    # mamba
    (r"mixer/in_proj$",               P(None, "model")),
    (r"mixer/conv_w$",                P(None, "model")),
    (r"mixer/conv_b$",                P("model")),
    (r"mixer/x_proj$",                P("model", None)),
    (r"mixer/dt_proj$",               P(None, "model")),
    (r"mixer/dt_bias$",               P("model")),
    (r"mixer/a_log$",                 P("model", None)),
    (r"mixer/d_skip$",                P("model")),
    (r"mixer/out_proj$",              P("model", None)),
    # rwkv
    (r"mixer/mu(_cm)?$",              P(None, None)),
    (r"mixer/w_[rkvg]$",              P(None, "model")),
    (r"mixer/w0$",                    P("model")),
    (r"mixer/w_lora_a$",              P(None, None)),
    (r"mixer/w_lora_b$",              P(None, "model")),
    (r"mixer/u_bonus$",               P("model", None)),
    (r"mixer/ln_x$",                  P("model")),
    (r"mixer/cm_[kr]$",               P(None, "model")),
    (r"mixer/cm_v$",                  P("model", None)),
    # norms & anything scalar
    (r"norm[12]$",                    P(None)),
    # a sketch head inside a model tree (the _HEAD_RULES layout)
    (r"sketch/array$",                P("model", None, None)),
    (r"sketch/scale$",                P("model", None)),
    (r"sketch/.*$",                   P(None)),
)


# The frozen sketch-head tree ({"proj", "w", "b", "array"} + "scale" when
# quantized).  Every shard owns L/m whole repetitions of the (L, R, V)
# count array and its (L, R) scales; the hash params replicate.  Exactly
# one rule per leaf (tests/test_torch_sharding.py).
_HEAD_RULES = (
    (r"(^|/)array$",                  P("model", None, None)),
    (r"(^|/)scale$",                  P("model", None)),
    (r"(^|/)proj$",                   P(None, None)),
    (r"(^|/)w$",                      P(None, None, None)),
    (r"(^|/)b$",                      P(None, None)),
)


def _axes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def data_axes(mesh) -> Tuple[str, ...]:
    """The subset of ``("pod", "data")`` present in ``mesh``, in order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _fit_spec(spec: Sequence, shape: Sequence[int], mesh) -> P:
    """Drop sharded axes that don't divide; pad spec rank to the array rank."""
    axes = _axes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        total = math.prod(axes[n] for n in _names(entry))
        out.append(entry if dim % total == 0 else None)
    return P(*out)


def _fully_fits(spec: Sequence, shape: Sequence[int], mesh) -> bool:
    return tuple(_fit_spec(spec, shape, mesh)) == tuple(
        list(spec) + [None] * (len(shape) - len(spec)))


def tree_paths(tree, prefix: str = ""):
    """``(path, leaf)`` of every tensor leaf of a nested dict/list/tuple
    tree, paths ``/``-joined as the JAX package flattens its pytrees
    (``"periods/pos0/mixer/wq"``, ``"prologue/0/norm1"``); a :class:`P`
    is a leaf."""
    if tree is None:
        return
    if isinstance(tree, P):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_map_paths(fn, tree, prefix: str = ""):
    """A tree of ``tree``'s structure holding ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_paths(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_paths(fn, v, f"{prefix}{k}/")
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_paths(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def param_spec(path_str: str, shape: Sequence[int], mesh,
               scanned: bool) -> P:
    """The spec of one model-parameter leaf: the first matching rule's,
    rank-filtered and divisibility-checked; replicated if none matches.
    ``scanned`` leaves carry a leading ``n_periods`` axis (never
    sharded)."""
    rank = len(shape) - (1 if scanned else 0)
    for pattern, specs in _PARAM_RULES:
        if re.search(pattern, path_str):
            candidates = (specs,) if isinstance(specs, P) else tuple(specs)
            ranked = ([s for s in candidates if len(s) == rank]
                      or list(candidates))
            for spec in ranked:
                base = P(None, *spec) if scanned else spec
                if _fully_fits(base, shape, mesh):
                    return base
            base = P(None, *ranked[0]) if scanned else ranked[0]
            return _fit_spec(base, shape, mesh)
    return _fit_spec(P(), shape, mesh)


def params_shardings(params, mesh):
    """The spec tree of a model parameter tree (``init_model``'s)."""
    return tree_map_paths(
        lambda ps, leaf: param_spec(ps, tuple(leaf.shape), mesh,
                                    "periods/" in ps), params)


def head_rule_matches(path_str: str) -> Tuple[str, ...]:
    """Every :data:`_HEAD_RULES` pattern matching a head-param leaf path,
    in rule order (the tests assert exactly one per leaf)."""
    return tuple(pat for pat, _ in _HEAD_RULES if re.search(pat, path_str))


def head_param_spec(path_str: str, shape: Sequence[int], mesh) -> P:
    """The spec of one frozen-head leaf (``"array"``, ``"proj"``, …): the
    first matching rule's, divisibility-checked; unknown leaves
    replicate."""
    for pattern, spec in _HEAD_RULES:
        if re.search(pattern, path_str):
            return _fit_spec(spec, shape, mesh)
    return _fit_spec(P(), shape, mesh)


def head_param_shardings(head_params: dict, mesh) -> dict:
    """The spec of every leaf of a frozen head tree."""
    return {k: head_param_spec(k, tuple(v.shape), mesh)
            for k, v in head_params.items()}


def head_bank_shardings(bank: dict, mesh) -> dict:
    """The specs of a tenant-stacked head bank (``HeadCache``'s): the
    tenant axis T is never sharded, so one tenant's row is exactly a
    single-tenant head's shard; a ``"tenant_ids"`` leaf replicates."""
    out = {}
    for name, leaf in bank.items():
        if name == "tenant_ids":
            out[name] = P(None)
            continue
        inner = head_param_spec(name, tuple(leaf.shape[1:]), mesh)
        out[name] = P(None, *inner)
    return out


def zero1_shardings(params, mesh):
    """Optimizer-state specs: each leaf's param spec, plus the data axes on
    its largest unsharded divisible dim (ZeRO-1); leaves already sharded
    over a data axis (FSDP experts) keep their spec."""
    dax = data_axes(mesh)
    axes = _axes(mesh)
    dsize = math.prod(axes[a] for a in dax)

    def one(ps, leaf):
        shape = tuple(leaf.shape)
        spec = list(param_spec(ps, shape, mesh, "periods/" in ps))
        spec += [None] * (len(shape) - len(spec))
        used = {n for e in spec for n in _names(e)}
        if used & set(dax):
            return P(*spec)
        best, best_dim = -1, -1
        for i, (dim, entry) in enumerate(zip(shape, spec)):
            if entry is None and dim % dsize == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best >= 0 and dsize > 1:
            spec[best] = dax if len(dax) > 1 else dax[0]
        return P(*spec)

    return tree_map_paths(one, params)


def batch_spec(batch_size: int, mesh):
    """The entry of a batch axis: every data axis when their product
    divides ``batch_size``, else ``"data"`` alone if it divides, else
    ``None``."""
    axes = _axes(mesh)
    dax = data_axes(mesh)
    total = math.prod(axes[a] for a in dax)
    if batch_size % total == 0:
        return dax if len(dax) > 1 else dax[0]
    if "data" in axes and batch_size % axes["data"] == 0:
        return "data"
    return None


def _cache_types():
    from repro_torch.models.attention import KVCache
    from repro_torch.models.mamba import MambaCache
    from repro_torch.models.mla import MLACache
    from repro_torch.models.rwkv import RWKVCache
    return KVCache, MambaCache, MLACache, RWKVCache


def cache_shardings(cache: dict, mesh, batch_size: Optional[int] = None):
    """Decode-cache specs: batch over the data axes, a feature dim over
    ``model``; ``None`` stacks preserved.

    Every stack of the port's cache tree (``models/model.init_decode_cache``)
    has a leading layer axis, n_periods for a period's stack and 1 for a
    prologue layer's, which is never sharded.  ``batch_size`` None infers
    the batch from each leaf.  The sequence axis is never sharded:

      attention KVCache k/v  (B, S, kv, dh) → kv over model if divisible,
                                              else dh over model
      MLA c_kv / k_rope      (B, S, r)      → r over model
      mamba conv             (B, c-1, d_in) → d_in over model
      mamba ssm              (B, d_in, N)   → d_in over model
      rwkv prev vectors      (B, d)         → d over model
      rwkv state             (B, H, dk, dv) → H over model
    """
    KVCache, MambaCache, MLACache, RWKVCache = _cache_types()
    bglobal = None if batch_size is None else batch_spec(batch_size, mesh)
    msize = _axes(mesh).get("model", 1)

    def leaf_spec(kind, shape):
        dims = tuple(shape[1:])
        bspec = batch_spec(dims[0], mesh) if batch_size is None else bglobal
        if kind == "kv":
            spec = (P(bspec, None, "model", None) if dims[2] % msize == 0
                    else P(bspec, None, None, "model"))
        elif kind in ("mla", "mamba_conv"):
            spec = P(bspec, None, "model")
        elif kind == "mamba_ssm":
            spec = P(bspec, "model", None)
        elif kind == "rwkv_prev":
            spec = P(bspec, "model")
        elif kind == "rwkv_state":
            spec = P(bspec, "model", None, None)
        else:
            spec = P(bspec, *([None] * (len(dims) - 1)))
        return _fit_spec(P(None, *spec), tuple(shape), mesh)

    def stack(c):
        if c is None:
            return None
        if isinstance(c, KVCache):
            return KVCache(leaf_spec("kv", c.k.shape),
                           leaf_spec("kv", c.v.shape))
        if isinstance(c, MLACache):
            return MLACache(leaf_spec("mla", c.c_kv.shape),
                            leaf_spec("mla", c.k_rope.shape))
        if isinstance(c, MambaCache):
            return MambaCache(leaf_spec("mamba_conv", c.conv.shape),
                              leaf_spec("mamba_ssm", c.ssm.shape))
        if isinstance(c, RWKVCache):
            return RWKVCache(leaf_spec("rwkv_prev", c.tm_prev.shape),
                             leaf_spec("rwkv_prev", c.cm_prev.shape),
                             leaf_spec("rwkv_state", c.state.shape))
        return type(c)(*(leaf_spec("other", leaf.shape) for leaf in c))

    return _map_stacks(stack, cache)


def page_pool_shardings(pages: dict, mesh):
    """Specs of the paged engine's arenas (``init_paged_cache``): feature
    dims over ``model`` as in :func:`cache_shardings`, the page and
    in-page axes replicated (page ids are host-chosen), the leading layer
    axis never sharded; ``None`` stacks preserved."""
    KVCache, _, MLACache, _ = _cache_types()
    msize = _axes(mesh).get("model", 1)

    def leaf_spec(kind, shape):
        dims = tuple(shape[1:])
        if kind == "kv":
            spec = (P(None, None, "model", None) if dims[2] % msize == 0
                    else P(None, None, None, "model"))
        else:
            spec = P(None, None, "model")
        return _fit_spec(P(None, *spec), tuple(shape), mesh)

    def stack(c):
        if c is None:
            return None
        if isinstance(c, KVCache):
            return KVCache(leaf_spec("kv", c.k.shape),
                           leaf_spec("kv", c.v.shape))
        if isinstance(c, MLACache):
            return MLACache(leaf_spec("mla", c.c_kv.shape),
                            leaf_spec("mla", c.k_rope.shape))
        raise TypeError(f"unexpected paged-arena stack {type(c)}")

    return _map_stacks(stack, pages)


def _map_stacks(fn, tree: dict) -> dict:
    out = {"periods": {k: fn(c) for k, c in tree["periods"].items()}}
    if "prologue" in tree:
        out["prologue"] = [fn(c) for c in tree["prologue"]]
    return out


def to_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d's entry names it, else
    ``Replicate()`` (a mesh dim of one rank too: its one shard is the
    whole tensor, and DTensor propagates it as on a larger mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if name in _names(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)
