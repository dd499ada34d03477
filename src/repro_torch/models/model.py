"""Decoder backbone: embedding → the layer stack → final norm → head.

Parameters keep the JAX package's tree: ``embed``, ``head``,
``final_norm``, ``prologue`` (a list of the ``n_dense_prologue`` leading
layers' params, of kind ``pattern[0]`` with a dense FFN; absent without
them) and ``periods/pos<j>`` holding each pattern position's layer params
stacked over the ``n_periods`` periods.  The prologue runs first, then the
JAX package's ``lax.scan`` over periods is a loop over that stacking axis
here, each period running its pattern positions in order (layer
``n_dense_prologue + i·|pattern| + j`` is period i's position j).  Decode
caches are stacked the same way, one NamedTuple (``RWKVCache``,
``MambaCache``, ``KVCache`` or ``MLACache``) of (n_periods, B, …) leaves
per pattern position, or None for a cacheless ``xattn`` position; a
prologue layer's cache is a stack of one, (1, B, …) leaves, so every
walk over a cache tree (:func:`cache_stacks`, :func:`map_cache`,
:func:`cache_leaves`) treats the prologue layers and the periods alike.
``encoder_states`` (B, T, d) reach every ``xattn`` layer.

The functions without a trailing ``_`` mirror the JAX package's pure
functions and never write into a cache they are given.  Their in-place
twins (``decode_step_``, ``mask_cache_update_``, ``cache_slot_insert_``,
``cache_slot_reset_``) carry the contract JAX's ``donate_argnums`` gives:
the cache passed in is consumed, written in place (each layer into its
period's view of the stacked leaves), and returned as the same tensors.
They give the functional results bit for bit, and a captured decode step
(``launch/decode_loop.py``) needs them: a CUDA graph replays on fixed
buffers.

Speculative decode keeps its rollback state here (``init_spec_snapshot``,
``cache_snapshot_``, ``cache_rollback_``) and verifies through
``dense_verify_logits``; the paged engine's cache trees (page arenas and
state rows) are built and moved by the ``paged_*`` functions at the end.

Training: :func:`lm_loss` (the JAX package's ``lm_loss``) runs the
cacheless backbone with the MoE aux loss summed over the layers and, by
default, each period rematerialized in the backward
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` of its
scan body).  Every walk over the layers takes the periods' views of a
stacked leaf with one ``unbind(0)`` (:func:`_unbind`), so that under
autograd each stack's per-layer grads are stacked once.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed_scaled, init_dense, rms_norm,
                                      softcap, unembed)
from repro_torch.sharding.ctx import (constrain, is_dtensor, like,
                                      recompute_contexts)
from repro_torch.sharding.local import (index_copy_, index_fill_, new_zeros,
                                        put_rows_, spec_of)


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
    if cfg.n_dense_prologue:
        params["prologue"] = [
            blocks.init_layer(generator, cfg, cfg.pattern[0], ffn="dense")
            for _ in range(cfg.n_dense_prologue)]
    params["periods"] = {
        f"pos{j}": blocks.init_layer(generator, cfg, kind,
                                     lead=(cfg.n_periods,),
                                     ffn=period_ffn(cfg, j))
        for j, kind in enumerate(cfg.pattern)}
    return params


def period_ffn(cfg: ModelConfig, j: int) -> str:
    """The FFN kind of pattern position ``j`` (the same in every period)."""
    return cfg.ffn_kind(cfg.n_dense_prologue + j)


def _cache_tree(cfg: ModelConfig, make) -> dict:
    """A cache-shaped tree of ``make(kind, lead)``: a stack of one per
    prologue layer, then one stack per pattern position."""
    tree = {"periods": {f"pos{j}": make(kind, (cfg.n_periods,))
                        for j, kind in enumerate(cfg.pattern)}}
    if cfg.n_dense_prologue:
        tree["prologue"] = [make(cfg.pattern[0], (1,))
                            for _ in range(cfg.n_dense_prologue)]
    return tree


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> dict:
    """Zero decode cache, stacked over periods (the prologue's layers as
    stacks of one): rwkv or mamba state, or KV and MLA caches of
    ``max_seq`` positions (rings of ``min(max_seq, window)`` on windowed
    layers); None at ``xattn`` positions."""
    return _cache_tree(cfg, lambda kind, lead: blocks.init_layer_cache(
        cfg, kind, batch, max_seq, lead=lead, device=device))


def cache_stacks(tree: dict):
    """``(key, stack)`` of every layer stack of a cache tree, the
    prologue's first; ``key`` is ("prologue", i) or ("periods", "pos<j>")
    and ``tree[key[0]][key[1]]`` is the stack (None where cacheless)."""
    for i, c in enumerate(tree.get("prologue", ())):
        yield ("prologue", i), c
    for name, c in tree["periods"].items():
        yield ("periods", name), c


def stack_kind(cfg: ModelConfig, key) -> str:
    """The block kind of the layers of stack ``key``."""
    return cfg.pattern[0 if key[0] == "prologue" else int(key[1][3:])]


def _rebuild(tree: dict, fn) -> dict:
    """A tree of ``tree``'s structure holding ``fn(key, stack)``."""
    out = {"periods": {name: fn(("periods", name), c)
                       for name, c in tree["periods"].items()}}
    if "prologue" in tree:
        out["prologue"] = [fn(("prologue", i), c)
                           for i, c in enumerate(tree["prologue"])]
    return out


def map_cache(fn, *caches) -> dict:
    """``fn`` over the stacked (n, B, …) leaves of one or more cache trees
    of one structure, leaf by leaf (None stacks stay None)."""
    def stack(key, c0):
        if c0 is None:
            return None
        return type(c0)(*(fn(*leaves) for leaves in zip(
            *(c[key[0]][key[1]] for c in caches))))
    return _rebuild(caches[0], stack)


def cache_leaves(tree: dict):
    """Every leaf of a cache tree, stack by stack (None stacks skipped)."""
    for _, c in cache_stacks(tree):
        if c is not None:
            yield from c


def _unbind(tree) -> list:
    """Every period's view of a stacked param dict, one ``unbind(0)`` a
    leaf.  Under autograd an unbind's backward stacks the per-layer grads
    once, where each ``_index`` select's backward would write a zero
    tensor the size of the whole stack."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def _index(tree, i: int):
    """Period ``i`` of a stacked param dict or cache."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(t[i] for t in tree))
    return tree[i]


def mask_cache_update(cache: dict, new_cache: dict,
                      active: torch.Tensor) -> dict:
    """``new_cache`` where ``active`` (B,) else ``cache`` — parked rows stay
    bitwise unchanged.  Leaves are (n_periods, B, ...)."""
    def pick(old, new):
        mask = active.reshape(1, -1, *([1] * (new.dim() - 2)))
        return torch.where(mask, new, old)
    return map_cache(pick, cache, new_cache)


def _leaf_pairs(dst: dict, src: dict):
    """(dst leaf, src leaf) pairs by stack, over the stacks ``dst`` holds:
    a paged engine's state tree holds only its recurrent layers, while a
    prefilled ``src`` holds every layer."""
    for (sec, key), c in cache_stacks(dst):
        if c is not None:
            yield from zip(c, src[sec][key])


def mask_cache_update_(cache: dict, new_cache: dict,
                       active: torch.Tensor) -> dict:
    """In-place twin of :func:`mask_cache_update`: ``new_cache``'s rows
    where ``active`` written into ``cache``, which is returned."""
    for old, new in zip(cache_leaves(cache), cache_leaves(new_cache)):
        mask = active.reshape(1, -1, *([1] * (new.dim() - 2)))
        old.copy_(like(torch.where(mask, new, old), old))
    return cache


def _slot_index(slots, device) -> torch.Tensor:
    return torch.as_tensor(slots, dtype=torch.int64, device=device)


def cache_slot_insert(cfg: ModelConfig, pool: dict, src: dict,
                      slots) -> dict:
    """A copy of ``pool`` with the rows of a freshly prefilled cache in
    ``slots``: row i of ``src`` goes to pool slot ``slots[i]``.  Rows of
    other slots are copied unchanged, bit for bit, which is what makes
    admission mid-decode safe.  ``cfg`` is unused (the leaves carry the
    layout); kept for the JAX package's signature."""
    del cfg

    def insert(old, new):
        idx = _slot_index(slots, old.device)
        return old.index_copy(1, idx, new.to(old.dtype))
    return map_cache(insert, pool, src)


def cache_slot_insert_(cfg: ModelConfig, pool: dict, src: dict,
                       slots) -> dict:
    """In-place twin of :func:`cache_slot_insert`: row i of ``src`` written
    into ``pool`` slot ``slots[i]``; other rows are not touched."""
    del cfg
    for old, new in _leaf_pairs(pool, src):
        index_copy_(old, 1, slots, new.to(old.dtype))
    return pool


def cache_expand_rows(cfg: ModelConfig, cache: dict, inv) -> dict:
    """Batch rows ``inv`` of every leaf, (G_unique, …) → (G, …): the
    admission dedupe prefills each distinct prompt once and expands the
    rows back to one per request."""
    del cfg
    return map_cache(
        lambda leaf: leaf.index_select(1, _slot_index(inv, leaf.device)),
        cache)


def cache_slot_reset(cfg: ModelConfig, pool: dict, slots) -> dict:
    """A copy of ``pool`` with ``slots`` zeroed — bitwise fresh
    ``init_decode_cache`` rows — and every other row unchanged."""
    del cfg
    return map_cache(
        lambda leaf: leaf.index_fill(1, _slot_index(slots, leaf.device), 0),
        pool)


def cache_slot_reset_(cfg: ModelConfig, pool: dict, slots) -> dict:
    """In-place twin of :func:`cache_slot_reset`: ``slots`` of ``pool``
    zeroed, other rows not touched."""
    del cfg
    for leaf in cache_leaves(pool):
        index_fill_(leaf, 1, slots, 0)
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


def _layers(params: dict, cfg: ModelConfig):
    """``(layer params, kind, ffn, cache stack key, index in the stack)``
    of every layer in order: the prologue, then the periods, period-major
    (the JAX package's scan runs period by period)."""
    for i, layer in enumerate(params.get("prologue", ())):
        yield layer, cfg.pattern[0], "dense", ("prologue", i), 0
    views = {name: _unbind(stack) for name, stack in params["periods"].items()}
    for i in range(cfg.n_periods):
        for j, kind in enumerate(cfg.pattern):
            name = f"pos{j}"
            yield (views[name][i], kind, period_ffn(cfg, j), ("periods", name),
                   i)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[dict] = None, cache_pos=None,
            return_hidden: bool = False,
            encoder_states: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Run the backbone on tokens (B, S). Returns (logits (B, S, V) f32 or,
    with ``return_hidden``, final hiddens (B, S, d) f32; new cache).

    ``cache_pos`` is the number of tokens already cached: None (0), an int,
    or a (B,) tensor of per-slot counters (the engine's decode).
    ``encoder_states`` (B, T, d) are what the ``xattn`` layers attend to."""
    x, new_cache = backbone(params, tokens, cfg, cache=cache,
                            cache_pos=cache_pos,
                            encoder_states=encoder_states)
    return _output(params, x, cfg, return_hidden), new_cache


def _period(x: torch.Tensor, layers: list, positions: torch.Tensor,
            encoder_states: Optional[torch.Tensor], cfg: ModelConfig):
    """One period's layers on x, cacheless: ``(x, the period's aux)``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, (layer, kind) in enumerate(zip(layers, cfg.pattern)):
        x, _, a = blocks.apply_layer(layer, x, cfg, kind, positions=positions,
                                     ffn=period_ffn(cfg, j),
                                     encoder_states=encoder_states,
                                     with_aux=True)
        aux = aux + a
    return x, aux


def _train_backbone(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                    encoder_states: Optional[torch.Tensor], remat: bool):
    """The cacheless backbone with the aux loss: ``(x, aux)``.  With
    ``remat`` each period runs under ``torch.utils.checkpoint`` (its
    activations recomputed in the backward; the prologue's are kept, as
    the JAX package keeps them outside its scan)."""
    x = constrain(embed_scaled(tokens, params["embed"], cfg.d_model),
                  "dp", None, None)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in params.get("prologue", ()):
        x, _, a = blocks.apply_layer(layer, x, cfg, cfg.pattern[0],
                                     positions=positions, ffn="dense",
                                     encoder_states=encoder_states,
                                     with_aux=True)
        aux = aux + a
    views = [_unbind(params["periods"][f"pos{j}"])
             for j in range(len(cfg.pattern))]
    for i in range(cfg.n_periods):
        layers = [v[i] for v in views]
        if remat:
            x, a = checkpoint(_period, x, layers, positions, encoder_states,
                              cfg, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=recompute_contexts)
        else:
            x, a = _period(x, layers, positions, encoder_states, cfg)
        aux = aux + a
    return x, aux


def backbone(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
             cache: Optional[dict] = None, cache_pos=None,
             in_place: bool = False,
             encoder_states: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[dict]]:
    """:func:`forward` up to the final norm: the residual stream (B, S, d)
    in bf16 and the new cache.  With ``in_place``, each layer's new cache
    is written into its rows of ``cache``, which is returned: the same
    values, and only one layer's new cache is live beside it."""
    x = constrain(embed_scaled(tokens, params["embed"], cfg.d_model),
                  "dp", None, None)
    positions, cache_pos = _positions(tokens.shape[1], cache_pos,
                                      tokens.device)
    made = {}
    for layer, kind, ffn, (sec, key), i in _layers(params, cfg):
        stack = None if cache is None else cache[sec][key]
        x, nc = blocks.apply_layer(
            layer, x, cfg, kind, positions=positions,
            cache=None if stack is None else _index(stack, i),
            cache_pos=cache_pos, ffn=ffn, encoder_states=encoder_states)
        if in_place and nc is not None:
            for dst, leaf in zip(stack, nc):
                dst = dst[i]
                dst.copy_(like(leaf, dst))
        elif not in_place:
            made.setdefault((sec, key), []).append(nc)
    if in_place or cache is None:
        return x, cache
    return x, _rebuild(cache, lambda k, c: None if c is None else type(c)(
        *(torch.stack(leaf) for leaf in zip(*made[k]))))


def lm_loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, *,
            encoder_states: Optional[torch.Tensor] = None,
            aux_coef: float = 0.01, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy over the f32 logits of tokens (B, S) against
    labels (B, S) (-1 masks a position), plus ``aux_coef`` times the MoE
    aux loss: ``(loss, {"ce", "aux"})``, 0-d f32 tensors (the JAX
    package's ``lm_loss``; the forward rematerialized by default, as its
    ``forward`` is)."""
    x, aux = _train_backbone(params, tokens, cfg, encoder_states, remat)
    logits = _output(params, x, cfg, False)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # Vocab-parallel logits: each rank picks the labels in its vocab
        # block (one nonzero term a row, so the sum is exact), where a
        # gather would need DTensor's masked partial through a squeeze.
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        label_logit = torch.where(vocab == safe[..., None], logits,
                                  0.0).sum(-1)
    else:
        label_logit = logits.gather(-1, safe[..., None])[..., 0]
    nll = lse - label_logit
    ce = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}


def final_hidden(params: dict, x: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """The final norm of the residual stream, in x's dtype (gathered over
    the sequence on a mesh, as each layer's norms are)."""
    return constrain(rms_norm(x, params["final_norm"], cfg.norm_eps),
                     "dp", None, None)


def dense_logits(params: dict, h: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """f32 logits of final hiddens ``h`` through the output table, then
    ``final_logit_softcap``."""
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = constrain(unembed(h, table).to(torch.float32),
                       "dp", None, "tp")          # vocab-parallel logits
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


def dense_verify_logits(params: dict, hidden: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """:func:`dense_logits` on carried f32 final hiddens, bit for bit the
    unembed of the decode step that made them.

    ``hidden`` is the f32 output of ``return_hidden=True``; bf16 → f32 is
    exact, so casting back gives the step's own bf16 activations.  A (B, d)
    input is lifted to the decode step's (B, 1, d) before the product; a
    (K, B, d) block (a speculative draft's hiddens) is unembedded one
    position at a time at that same shape, so that every row meets the
    GEMM the dense step runs (a (B, K, d) product may pick another kernel
    and give other bits).  Returns (B, V) or (K, B, V) f32.
    """
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    if hidden.dim() == 3:
        return torch.stack([dense_verify_logits(params, h, cfg)
                            for h in hidden])
    return dense_logits(params, hidden.to(table.dtype)[:, None], cfg)[:, 0]


def _output(params, x, cfg, return_hidden):
    h = final_hidden(params, x, cfg)
    return h.to(torch.float32) if return_hidden else dense_logits(params, h,
                                                                  cfg)


def _needs_cache_pos(cfg: ModelConfig) -> bool:
    return any(k in blocks.SEQ_KINDS for k in cfg.pattern)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, *, cache_pos=None,
                return_hidden: bool = False,
                encoder_states: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, dict]:
    """One decode step on the newest tokens (B, 1): returns (logits (B, V)
    — or the (B, d) final hidden with ``return_hidden`` — and the updated
    cache).  ``cache_pos`` (tokens already cached: an int, or (B,) per
    slot) is required by the attention and MLA kinds; a recurrent state
    needs none."""
    if cache_pos is None and _needs_cache_pos(cfg):
        raise ValueError(f"{cfg.name}: decode_step needs cache_pos (tokens "
                         "already cached) for its attention layers")
    out, new_cache = forward(params, tokens, cfg, cache=cache,
                             cache_pos=cache_pos, return_hidden=return_hidden,
                             encoder_states=encoder_states)
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
                 active: Optional[torch.Tensor] = None,
                 encoder_states: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """In-place twin of :func:`decode_step`: ``cache`` is consumed, each
    layer's new state written into its period's rows, and returned.
    ``active`` (B,) bool leaves inactive rows of the cache unchanged, as
    ``mask_cache_update`` after :func:`decode_step` does.

    ``cache_pos`` may be an int, a 0-d tensor (one depth for every row) or
    a (B,) tensor; either way it is used on the device as (B,) per-row
    positions, and a captured step keeps it a device tensor.
    """
    if cache_pos is None and _needs_cache_pos(cfg):
        raise ValueError(f"{cfg.name}: decode_step_ needs cache_pos (tokens "
                         "already cached) for its attention layers")
    b = tokens.shape[0]
    x = constrain(embed_scaled(tokens, params["embed"], cfg.d_model),
                  "dp", None, None)
    pos = positions = None
    if cache_pos is not None:
        pos = _slot_positions(cache_pos, b, tokens.device)
        positions = pos[:, None]
    for layer, kind, ffn, (sec, key), i in _layers(params, cfg):
        stack = cache[sec][key]
        x = blocks.apply_layer_(layer, x, cfg, kind, positions=positions,
                                cache=None if stack is None
                                else _index(stack, i),
                                cache_pos=pos, active=active, ffn=ffn,
                                encoder_states=encoder_states)
    return _output(params, x, cfg, return_hidden)[:, -1], cache


# -- speculative decode: rollback state (launch/decode_loop.py) -----------


class RingSnapshot(NamedTuple):
    """What K draft steps overwrite in a period-stacked SWA ring: before
    step i, the (n_periods, B, n_kv, dh) key and value rows at the slot it
    writes, and that slot (B,)."""
    k: torch.Tensor       # (K, n_periods, B, n_kv, dh)
    v: torch.Tensor
    slot: torch.Tensor    # (K, B) int64


def init_spec_snapshot(cfg: ModelConfig, cache: dict, k: int) -> dict:
    """Static rollback buffers for ``k`` draft steps over ``cache``: for
    each layer stack whose cache cannot be rewound by position
    (``blocks.cache_needs_snapshot``), a recurrent whole state (K, *leaf) or a
    ring's :class:`RingSnapshot`; None for the others.

    A ring keeps only the slots the steps overwrite, (K, P, B, n_kv, dh)
    a leaf, not the reference's whole ring each step (K x the ring): at
    gemma2-27b's 4096-slot rings that is 2 x 23 x 16 x 128 x 2 B = 188 KB
    a row a step, against 0.77 GB."""
    def buffers(key, c):
        kind = stack_kind(cfg, key)
        if c is None or not blocks.cache_needs_snapshot(cfg, kind,
                                                        _index(c, 0)):
            return None
        if kind in blocks.RECURRENT_KINDS:
            return type(c)(*(new_zeros(leaf, (k, *leaf.shape), spec=(
                (None, *spec_of(leaf)) if is_dtensor(leaf) else None))
                for leaf in c))
        rows = (k, c.k.shape[0], c.k.shape[1], *c.k.shape[3:])
        spec = None
        if is_dtensor(c.k):
            sp = spec_of(c.k)
            spec = (None, sp[0], sp[1], *sp[3:])
        return RingSnapshot(new_zeros(c.k, rows, spec=spec),
                            new_zeros(c.v, rows, spec=spec),
                            torch.zeros((k, c.k.shape[1]), dtype=torch.int64,
                                        device=c.k.device))
    return _rebuild(cache, buffers)


def cache_snapshot_(cfg: ModelConfig, cache: dict, snap: dict,
                    step: torch.Tensor, pos: torch.Tensor) -> None:
    """Before draft step ``step`` ((1,) int64 on the device), record into
    slot ``step`` of ``snap`` what the step is about to change: a recurrent
    state, and each ring's rows at ``pos % size`` (``pos``: (B,) device
    positions the step writes).  Device indices only, so a captured step
    can run it."""
    del cfg
    for (sec, key), s in cache_stacks(snap):
        if s is None:
            continue
        c = cache[sec][key]
        if isinstance(s, RingSnapshot):
            slot = pos % c.k.shape[2]
            bi = torch.arange(slot.shape[0], device=slot.device)
            index_copy_(s.k, 0, step, c.k[:, bi, slot][None])
            index_copy_(s.v, 0, step, c.v[:, bi, slot][None])
            s.slot.index_copy_(0, step, slot[None])
        else:
            for buf, leaf in zip(s, c):
                index_copy_(buf, 0, step, leaf[None])


def cache_rollback_(cfg: ModelConfig, cache: dict, snap: dict,
                    m: torch.Tensor, k: int) -> None:
    """Rewind ``cache`` after ``k`` draft steps to its state after the
    first ``m`` (a 0-d int64 device tensor, 1 <= m <= k), in place, with
    no host sync: a recurrent state from its snapshot before step ``m`` (kept
    when m == k), each ring's slots written by steps m..k-1 restored, the
    last step first (steps may share a slot when the ring is shorter than
    k).  Plain KV and MLA caches keep the draft's writes past the rewound
    position: decode masks keys past ``cache_pos``."""
    del cfg
    keep = m >= k
    for (sec, key), s in cache_stacks(snap):
        if s is None:
            continue
        c = cache[sec][key]
        if isinstance(s, RingSnapshot):
            bi = torch.arange(s.slot.shape[1], device=m.device)
            for j in reversed(range(k)):
                undo = m <= j
                slot = s.slot[j]
                for leaf, old in ((c.k, s.k[j]), (c.v, s.v[j])):
                    put_rows_(leaf, slot,
                              torch.where(undo, old, leaf[:, bi, slot]), dim=1)
        else:
            idx = m.clamp(max=k - 1).reshape(1)
            for buf, leaf in zip(s, c):
                leaf.copy_(like(torch.where(keep, leaf,
                                            buf.index_select(0, idx)[0]),
                                leaf))


# -- the paged pool (launch/engine.py, launch/paging.py) -------------------
#
# The paged engine splits the decode cache in two trees: ``pages`` holds a
# stacked (n, num_pages, page_size, ...) arena per attention or MLA layer
# stack, addressed through the host page table; ``state`` holds the
# recurrent layers' (n, n_slots, ...) state rows under the ordinary slot
# ops.  A layer is in at most one of them (None in the other; an ``xattn``
# layer is in neither).  A paged decode gathers each slot's view, merges
# the state in, runs the in-place decode step on that tree (the state is
# written where it lives) and commits the written position back to the
# arenas.


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device="cuda") -> dict:
    """Zero page arenas, one per attention or MLA layer stack (None for
    the others); one page id addresses the same physical page in every
    arena."""
    return _cache_tree(cfg, lambda kind, lead: blocks.init_paged_layer_cache(
        cfg, kind, num_pages, page_size, lead=lead, device=device))


def init_paged_state(cfg: ModelConfig, n_slots: int, device="cuda") -> dict:
    """Zero state rows (n, n_slots, ...) for the recurrent layers only."""
    return _cache_tree(cfg, lambda kind, lead: blocks.init_paged_state_cache(
        cfg, kind, n_slots, lead=lead, device=device))


def paged_gather_cache(cfg: ModelConfig, pages: dict, pt: torch.Tensor,
                       max_seq: int) -> dict:
    """Each slot's contiguous view of every arena through the (B, npp)
    page table (unmapped entries read the zero page: fresh-cache bytes)."""
    return _rebuild(pages, lambda key, c: blocks.paged_view_cache(
        cfg, stack_kind(cfg, key), c, pt, max_seq))


def paged_commit_cache(cfg: ModelConfig, pages: dict, view: dict,
                       pt: torch.Tensor, pos: torch.Tensor,
                       max_seq: int) -> dict:
    """The position each slot's decode step wrote in ``view`` (at ``pos``,
    ring-adjusted per layer) scattered back into the arenas, in place."""
    for (sec, key), c in cache_stacks(pages):
        blocks.paged_commit_cache(cfg, stack_kind(cfg, (sec, key)), c,
                                  view[sec][key], pt, pos, max_seq)
    return pages


def paged_insert_cache(cfg: ModelConfig, pages: dict, src: dict,
                       pt_rows: torch.Tensor) -> dict:
    """Freshly prefilled rows (the tree ``cache_slot_insert_`` takes) into
    their newly mapped pages, in place."""
    for (sec, key), c in cache_stacks(pages):
        blocks.paged_insert_cache(stack_kind(cfg, (sec, key)), c,
                                  src[sec][key], pt_rows)
    return pages


def paged_copy_pages(cfg: ModelConfig, pages: dict, src_ids: torch.Tensor,
                     dst_ids: torch.Tensor) -> dict:
    """Whole pages ``src_ids`` → ``dst_ids`` across every arena (the
    copy-on-write fork), in place."""
    for key, c in cache_stacks(pages):
        blocks.paged_copy_pages(stack_kind(cfg, key), c, src_ids, dst_ids)
    return pages


def merge_paged_view(cfg: ModelConfig, view: dict, state: dict) -> dict:
    """One full cache tree from gathered views and the state rows (the
    same tensors, no copy): the tree a contiguous pool would be."""
    del cfg
    return _rebuild(view, lambda key, v: v if v is not None
                    else state[key[0]][key[1]])


def extract_paged_state(cfg: ModelConfig, cache: dict) -> dict:
    """The recurrent half (rwkv, mamba) of a full cache tree (the same
    tensors; None for the other kinds)."""
    return _rebuild(cache, lambda key, c: (
        c if stack_kind(cfg, key) in blocks.RECURRENT_KINDS else None))


def extract_state_rows(cfg: ModelConfig, cache: dict, row: int) -> dict:
    """Copies of batch row ``row`` of the recurrent layers of a prefilled
    cache, (n, 1, ...) a leaf: the constant-size state a prefix-cache
    entry keeps."""
    return _rebuild(extract_paged_state(cfg, cache), lambda key, c: (
        None if c is None else type(c)(*(leaf[:, row:row + 1].clone()
                                          for leaf in c))))
