"""Carry the JAX package's params across to the port.

``params_from_numpy`` takes the JAX params as a nested dict of numpy arrays
in the JAX tree layout (``embed``, ``head``, ``final_norm``,
``periods/pos0/{norm1, norm2, mixer/...}`` stacked over periods) — the
caller does the ``np.asarray`` on the JAX side — and returns the same tree
of torch tensors.  ``torch.from_numpy`` rejects numpy's ``bfloat16``
(an extension dtype), so those leaves travel as their int16 bits.

``jax.random`` draws cannot be replayed in torch, so the paper path's
states travel the same way: :func:`teacher_from_numpy` (an MLP's list of
``{"w", "b"}``), :func:`kernel_params_from_numpy` (a ``KernelModel``'s
``{"points", "alphas", "proj"}``) and :func:`sketch_state_from_numpy` (a
``RepresenterSketch`` state ``{"hash", "array", "mass"}``), each checking
the keys it expects.  :func:`decode_cache_from_numpy` carries a decode
cache (``{"prologue": [cache, ...], "periods": {"pos<j>": cache}}`` with
``KVCache``, ``MLACache``, ``MambaCache`` or ``RWKVCache`` layer caches,
or None, numpy leaves).  A deepseek-style ``prologue`` list of params
travels as a list.  :func:`opt_state_from_numpy` carries an AdamW state
(``step``, ``mu``, ``nu``, ``master``: the JAX package's ``AdamWState``
with numpy leaves), so that both packages start a step from the same
state.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda"):
    """The port's params (same tree) on ``device`` from numpy leaves."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _leaf(tree, device)


def _checked(tree: dict, keys, what: str) -> dict:
    if set(tree) != set(keys):
        raise ValueError(f"{what} needs keys {sorted(keys)}, got "
                         f"{sorted(tree)}")
    return tree


def teacher_from_numpy(layers, device="cuda") -> list:
    """An MLP teacher's params (``[{"w": (a, b), "b": (b,)}, ...]``)."""
    return [params_from_numpy(_checked(dict(layer), ("w", "b"),
                                       "a teacher layer"), device)
            for layer in layers]


def kernel_params_from_numpy(params, device="cuda") -> dict:
    """A ``KernelModel``'s params ``{"points", "alphas", "proj"}``."""
    return params_from_numpy(_checked(dict(params),
                                      ("points", "alphas", "proj"),
                                      "kernel-model params"), device)


def sketch_state_from_numpy(state, device="cuda") -> dict:
    """A ``RepresenterSketch`` state ``{"hash": {...}, "array": (C, L, R),
    "mass": (C,)}``; ``hash`` holds the family's params (``w`` and, for
    the L2 families, ``b``)."""
    state = dict(_checked(dict(state), ("hash", "array", "mass"),
                          "a sketch state"))
    state["hash"] = dict(state["hash"])
    return params_from_numpy(state, device)


def decode_cache_from_numpy(cache, device="cuda") -> dict:
    """A decode cache of the port from the JAX package's (``{"periods":
    {"pos<j>": cache}}`` and, with a dense prologue, ``"prologue": [cache,
    ...]``; numpy leaves): each layer cache becomes the port's
    ``KVCache``, ``MLACache``, ``MambaCache`` or ``RWKVCache`` of the same
    name and fields (None stays None), bit for bit.  A prologue layer's
    (B, ...) leaves become the port's stack of one, (1, B, ...)."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.mamba import MambaCache
    from repro_torch.models.mla import MLACache
    from repro_torch.models.rwkv import RWKVCache

    kinds = {c.__name__: c for c in (KVCache, MLACache, MambaCache,
                                     RWKVCache)}

    def layer_cache(name, layer, lead):
        if layer is None:
            return None
        cls = kinds.get(type(layer).__name__)
        if cls is None or tuple(layer._fields) != cls._fields:
            raise ValueError(f"{name}: no port cache for "
                             f"{type(layer).__name__}")
        return cls(*(_leaf(np.asarray(a).reshape(lead + np.shape(a)), device)
                     for a in layer))

    cache = dict(cache)
    keys = ("prologue", "periods") if "prologue" in cache else ("periods",)
    _checked(cache, keys, "a decode cache")
    out = {"periods": {name: layer_cache(name, layer, ())
                       for name, layer in cache["periods"].items()}}
    if "prologue" in cache:
        out["prologue"] = [layer_cache(f"prologue[{i}]", layer, (1,))
                           for i, layer in enumerate(cache["prologue"])]
    return out


def opt_state_from_numpy(state, device="cuda"):
    """The port's ``AdamWState`` from the JAX package's (a NamedTuple, or
    a dict, of ``step``, ``mu``, ``nu`` and ``master``, numpy leaves;
    ``master`` None in lean mode), bit for bit; ``step`` stays a 0-d
    int32 tensor on ``device``."""
    from repro_torch.optim.adamw import AdamWState

    fields = AdamWState._fields
    if not isinstance(state, dict):
        state = {f: getattr(state, f) for f in getattr(state, "_fields", ())}
    _checked(state, fields, "an AdamW state")
    step = np.asarray(state["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step must be a 0-d int32, got {step.dtype} "
                         f"{step.shape}")
    return AdamWState(
        step=_leaf(step, device),
        mu=params_from_numpy(state["mu"], device),
        nu=params_from_numpy(state["nu"], device),
        master=(None if state["master"] is None
                else params_from_numpy(state["master"], device)))
