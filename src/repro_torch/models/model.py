"""Decoder backbone: embedding → the layer stack → final norm → head.

Parameters keep the JAX package's tree: ``embed``, ``head``,
``final_norm``, and ``periods/pos<j>`` holding each pattern position's
layer params stacked over the ``n_periods`` periods.  The JAX package's
``lax.scan`` over periods is a loop over that stacking axis here; decode
caches are stacked the same way, one NamedTuple (``RWKVCache`` or
``KVCache``) of (n_periods, B, …) leaves per pattern position.

The functions without a trailing ``_`` mirror the JAX package's pure
functions and never write into a cache they are given.  Their in-place
twins (``decode_step_``, ``mask_cache_update_``, ``cache_slot_insert_``,
``cache_slot_reset_``) carry the contract JAX's ``donate_argnums`` gives:
the cache passed in is consumed, written in place (each layer into its
period's view of the stacked leaves), and returned as the same tensors.
They give the functional results bit for bit, and a captured decode step
(``launch/decode_loop.py``) needs them: a CUDA graph replays on fixed
buffers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed_scaled, init_dense, rms_norm,
                                      softcap, unembed)


def init_model(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random params on ``generator``'s device (projections bf16)."""
    params = {
        "embed": init_dense(generator, (cfg.vocab_size, cfg.d_model),
                            scale=0.02),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_dense(generator, (cfg.vocab_size, cfg.d_model),
                                    scale=0.02)
    params["periods"] = {
        f"pos{j}": blocks.init_layer(generator, cfg, kind,
                                     lead=(cfg.n_periods,))
        for j, kind in enumerate(cfg.pattern)}
    return params


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> dict:
    """Zero decode cache, stacked over periods: rwkv state, or KV caches of
    ``max_seq`` positions (rings of ``min(max_seq, window)`` on windowed
    layers)."""
    return {"periods": {
        f"pos{j}": blocks.init_layer_cache(cfg, kind, batch, max_seq,
                                           lead=(cfg.n_periods,),
                                           device=device)
        for j, kind in enumerate(cfg.pattern)}}


def _index(tree, i: int):
    """Period ``i`` of a stacked param dict or cache."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(t[i] for t in tree))
    return tree[i]


def _map_caches(fn, *caches) -> dict:
    """``fn`` over the (n_periods, B, …) leaves of one or more decode
    caches, leaf by leaf (any cache NamedTuple)."""
    return {"periods": {
        name: type(c0)(*(fn(*leaves) for leaves in zip(
            *(c["periods"][name] for c in caches))))
        for name, c0 in caches[0]["periods"].items()}}


def mask_cache_update(cache: dict, new_cache: dict,
                      active: torch.Tensor) -> dict:
    """``new_cache`` where ``active`` (B,) else ``cache`` — parked rows stay
    bitwise unchanged.  Leaves are (n_periods, B, ...)."""
    def pick(old, new):
        mask = active.reshape(1, -1, *([1] * (new.dim() - 2)))
        return torch.where(mask, new, old)
    return _map_caches(pick, cache, new_cache)


def _each_leaf(cache: dict):
    for c in cache["periods"].values():
        yield from c


def mask_cache_update_(cache: dict, new_cache: dict,
                       active: torch.Tensor) -> dict:
    """In-place twin of :func:`mask_cache_update`: ``new_cache``'s rows
    where ``active`` written into ``cache``, which is returned."""
    for old, new in zip(_each_leaf(cache), _each_leaf(new_cache)):
        mask = active.reshape(1, -1, *([1] * (new.dim() - 2)))
        old.copy_(torch.where(mask, new, old))
    return cache


def _slot_index(slots, device) -> torch.Tensor:
    return torch.as_tensor(slots, dtype=torch.int64, device=device)


def cache_slot_insert(cfg: ModelConfig, pool: dict, src: dict,
                      slots) -> dict:
    """A copy of ``pool`` with the rows of a freshly prefilled cache in
    ``slots``: row i of ``src`` goes to pool slot ``slots[i]``.  Rows of
    other slots are copied unchanged, bit for bit, which is what makes
    admission mid-decode safe.  ``cfg`` is unused by the rwkv cache; kept
    for the JAX package's signature."""
    del cfg

    def insert(old, new):
        idx = _slot_index(slots, old.device)
        return old.index_copy(1, idx, new.to(old.dtype))
    return _map_caches(insert, pool, src)


def cache_slot_insert_(cfg: ModelConfig, pool: dict, src: dict,
                       slots) -> dict:
    """In-place twin of :func:`cache_slot_insert`: row i of ``src`` written
    into ``pool`` slot ``slots[i]``; other rows are not touched."""
    del cfg
    for old, new in zip(_each_leaf(pool), _each_leaf(src)):
        old.index_copy_(1, _slot_index(slots, old.device), new.to(old.dtype))
    return pool


def cache_expand_rows(cfg: ModelConfig, cache: dict, inv) -> dict:
    """Batch rows ``inv`` of every leaf, (G_unique, …) → (G, …): the
    admission dedupe prefills each distinct prompt once and expands the
    rows back to one per request."""
    del cfg
    return _map_caches(
        lambda leaf: leaf.index_select(1, _slot_index(inv, leaf.device)),
        cache)


def cache_slot_reset(cfg: ModelConfig, pool: dict, slots) -> dict:
    """A copy of ``pool`` with ``slots`` zeroed — bitwise fresh
    ``init_decode_cache`` rows — and every other row unchanged."""
    del cfg
    return _map_caches(
        lambda leaf: leaf.index_fill(1, _slot_index(slots, leaf.device), 0),
        pool)


def cache_slot_reset_(cfg: ModelConfig, pool: dict, slots) -> dict:
    """In-place twin of :func:`cache_slot_reset`: ``slots`` of ``pool``
    zeroed, other rows not touched."""
    del cfg
    for leaf in _each_leaf(pool):
        leaf.index_fill_(1, _slot_index(slots, leaf.device), 0)
    return pool


def _positions(s: int, cache_pos, device):
    """(positions, cache_pos) as the JAX package's ``forward`` derives them:
    ``arange(S)`` and 0 without ``cache_pos``; ``cache_pos + arange(S)``
    for a scalar; (B, S) rows ``cache_pos[b] + arange(S)`` per slot."""
    ar = torch.arange(s, device=device)
    if cache_pos is None:
        return ar, 0
    if torch.is_tensor(cache_pos) and cache_pos.dim() == 1:
        return cache_pos.long()[:, None] + ar[None, :], cache_pos
    cache_pos = int(cache_pos)
    return cache_pos + ar, cache_pos


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[dict] = None, cache_pos=None,
            return_hidden: bool = False
            ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Run the backbone on tokens (B, S). Returns (logits (B, S, V) f32 or,
    with ``return_hidden``, final hiddens (B, S, d) f32; new cache).

    ``cache_pos`` is the number of tokens already cached: None (0), an int,
    or a (B,) tensor of per-slot counters (the engine's decode)."""
    x, new_cache = backbone(params, tokens, cfg, cache=cache,
                            cache_pos=cache_pos)
    return _output(params, x, cfg, return_hidden), new_cache


def backbone(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
             cache: Optional[dict] = None, cache_pos=None
             ) -> Tuple[torch.Tensor, Optional[dict]]:
    """:func:`forward` up to the final norm: the residual stream (B, S, d)
    in bf16 and the new cache."""
    x = embed_scaled(tokens, params["embed"], cfg.d_model)
    positions, cache_pos = _positions(tokens.shape[1], cache_pos,
                                      tokens.device)
    new_periods = {}
    for j, kind in enumerate(cfg.pattern):
        name = f"pos{j}"
        stacked = params["periods"][name]
        layer_caches = []
        for i in range(cfg.n_periods):
            layer_cache = (None if cache is None
                           else _index(cache["periods"][name], i))
            x, nc = blocks.apply_layer(_index(stacked, i), x, cfg, kind,
                                       positions=positions, cache=layer_cache,
                                       cache_pos=cache_pos)
            layer_caches.append(nc)
        if cache is not None:
            new_periods[name] = type(layer_caches[0])(
                *(torch.stack(leaf) for leaf in zip(*layer_caches)))
    new_cache = {"periods": new_periods} if cache is not None else None
    return x, new_cache


def final_hidden(params: dict, x: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """The final norm of the residual stream, in x's dtype."""
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def dense_logits(params: dict, h: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """f32 logits of final hiddens ``h`` through the output table, then
    ``final_logit_softcap``."""
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = unembed(h, table).to(torch.float32)
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


def _output(params, x, cfg, return_hidden):
    h = final_hidden(params, x, cfg)
    return h.to(torch.float32) if return_hidden else dense_logits(params, h,
                                                                  cfg)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, *, cache_pos=None,
                return_hidden: bool = False) -> Tuple[torch.Tensor, dict]:
    """One decode step on the newest tokens (B, 1): returns (logits (B, V)
    — or the (B, d) final hidden with ``return_hidden`` — and the updated
    cache).  ``cache_pos`` (tokens already cached: an int, or (B,) per
    slot) is required by the attention kinds; rwkv's state needs none."""
    if cache_pos is None and any(k in blocks.ATTN_KINDS for k in cfg.pattern):
        raise ValueError(f"{cfg.name}: decode_step needs cache_pos (tokens "
                         "already cached) for its attention layers")
    out, new_cache = forward(params, tokens, cfg, cache=cache,
                             cache_pos=cache_pos, return_hidden=return_hidden)
    return out[:, -1], new_cache


def _slot_positions(cache_pos, b: int, device) -> torch.Tensor:
    """``cache_pos`` as (B,) int64 on the device: a (B,) tensor as it is, a
    0-d tensor or an int expanded to every row."""
    if torch.is_tensor(cache_pos):
        pos = cache_pos.to(device=device, dtype=torch.int64)
        return pos if pos.dim() == 1 else pos.reshape(1).expand(b)
    return torch.full((b,), int(cache_pos), dtype=torch.int64, device=device)


def decode_step_(params: dict, cache: dict, tokens: torch.Tensor,
                 cfg: ModelConfig, *, cache_pos=None,
                 return_hidden: bool = False,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """In-place twin of :func:`decode_step`: ``cache`` is consumed, each
    layer's new state written into its period's rows, and returned.
    ``active`` (B,) bool leaves inactive rows of the cache unchanged, as
    ``mask_cache_update`` after :func:`decode_step` does.

    ``cache_pos`` may be an int, a 0-d tensor (one depth for every row) or
    a (B,) tensor; either way it is used on the device as (B,) per-row
    positions, and a captured step keeps it a device tensor.
    """
    if cache_pos is None and any(k in blocks.ATTN_KINDS for k in cfg.pattern):
        raise ValueError(f"{cfg.name}: decode_step_ needs cache_pos (tokens "
                         "already cached) for its attention layers")
    b = tokens.shape[0]
    x = embed_scaled(tokens, params["embed"], cfg.d_model)
    pos = positions = None
    if cache_pos is not None:
        pos = _slot_positions(cache_pos, b, tokens.device)
        positions = pos[:, None]
    for j, kind in enumerate(cfg.pattern):
        name = f"pos{j}"
        stacked, caches = params["periods"][name], cache["periods"][name]
        for i in range(cfg.n_periods):
            x = blocks.apply_layer_(_index(stacked, i), x, cfg, kind,
                                    positions=positions,
                                    cache=_index(caches, i), cache_pos=pos,
                                    active=active)
    return _output(params, x, cfg, return_hidden)[:, -1], cache
