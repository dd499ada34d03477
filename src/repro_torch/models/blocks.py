"""Per-layer block: init, decode cache and forward of every block kind.

A layer is a mixer followed by an FFN, pre-norm residual style: rwkv's
time-mix and channel-mix (its own FFN), or the Mamba-1 mixer, causal
self-attention (``attn``, ``attn_local`` with the config's window,
``attn_global`` without one), Multi-head Latent Attention (``mla``) or
cross-attention to the encoder states (``xattn``: no window, no RoPE, no
cache) followed by its FFN: a dense SwiGLU, or the MoE FFN where the
caller's ``ffn`` says ``"moe"``.  ``apply_layer`` returns a new cache
(and, ``with_aux``, the layer's MoE load-balancing loss, which training
adds to its objective and serving drops); its decode twin
``apply_layer_`` writes into the one it is given.

Paged dispatch: the kinds whose cache has a sequence axis (self-attention,
MLA) keep it in page arenas (``paged_*``), the recurrent kinds' (rwkv,
mamba) constant-size state stays one row a slot in a state tree, and
``xattn`` has neither; a layer belongs to at most one of the two."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import PORTED_KINDS, AttentionConfig, ModelConfig
from repro_torch.models.layers import init_dense, rms_norm, swiglu
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.sharding.ctx import constrain, like
from repro_torch.sharding.local import put_

#: The causal self-attention kinds (each runs ``flash_attn`` in a prefill).
ATTN_KINDS = ("attn", "attn_local", "attn_global")
#: The kinds whose cache has a sequence axis (decode needs ``cache_pos``).
SEQ_KINDS = ATTN_KINDS + ("mla",)
#: The kinds whose cache is a constant-size recurrent state, one row a slot.
RECURRENT_KINDS = ("rwkv", "mamba")


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise ValueError(f"block kind {kind!r} is not ported; ported: "
                         f"{list(PORTED_KINDS)}")


def _attn_cfg(cfg: ModelConfig, kind: str) -> AttentionConfig:
    """The layer's attention config: a global layer drops the window, a
    cross-attention layer the window and RoPE."""
    a = cfg.attention
    if kind == "attn_global":
        return dataclasses.replace(a, window=None)
    if kind == "xattn":
        return dataclasses.replace(a, window=None, use_rope=False)
    if kind == "attn_local" and a.window is None:
        raise ValueError("attn_local requires attention.window")
    return a


def init_layer(generator: torch.Generator, cfg: ModelConfig, kind: str,
               lead: tuple = (), ffn: str = "dense") -> dict:
    """Params of one layer (``lead`` stacks layers on leading axes);
    ``ffn`` ("dense" or "moe", ``cfg.ffn_kind`` of the layer) picks the
    FFN after a mamba, attention or MLA mixer."""
    _check_kind(kind)
    d = cfg.d_model
    zeros = lambda: torch.zeros((*lead, d), dtype=torch.float32,
                                device=generator.device)
    if kind == "rwkv":
        return {"norm1": zeros(), "norm2": zeros(),
                "mixer": rwkv_mod.init_rwkv(generator, d, cfg.d_ff,
                                            lead=lead)}
    if kind == "mamba":
        mixer = mamba_mod.init_mamba(generator, d, cfg.mamba, lead=lead)
    elif kind == "mla":
        mixer = mla_mod.init_mla(generator, d, cfg.mla, lead=lead)
    else:
        mixer = attn_mod.init_attention(generator, d, _attn_cfg(cfg, kind),
                                        lead=lead)
    if ffn == "moe":
        f = init_moe(generator, d, cfg.moe, lead=lead)
    else:
        f = {"w_gate": init_dense(generator, (d, cfg.d_ff), lead=lead),
             "w_up": init_dense(generator, (d, cfg.d_ff), lead=lead),
             "w_down": init_dense(generator, (cfg.d_ff, d), lead=lead)}
    return {"norm1": zeros(), "norm2": zeros(), "mixer": mixer, "ffn": f}


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     lead: tuple = (), device="cuda"):
    """Zero decode cache of one layer: rwkv's or mamba's recurrent state,
    an ``MLACache`` or a ``KVCache`` of ``max_seq`` (a ring of
    ``min(max_seq, window)`` on a windowed layer); None for ``xattn``,
    whose keys and values come from the encoder states at every step."""
    _check_kind(kind)
    if kind == "xattn":
        return None
    if kind == "mla":
        return mla_mod.init_mla_cache(batch, max_seq, cfg.mla, lead=lead,
                                      device=device)
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_cache(batch, cfg.d_model, lead=lead,
                                        device=device)
    if kind == "mamba":
        return mamba_mod.init_mamba_cache(batch, cfg.d_model, cfg.mamba,
                                          lead=lead, device=device)
    return attn_mod.init_cache(batch, max_seq, _attn_cfg(cfg, kind),
                               lead=lead, device=device)


def cache_needs_snapshot(cfg: ModelConfig, kind: str, cache) -> bool:
    """Whether a speculative rollback must record this layer's cache (one
    layer's, (B, S, ...)) at each draft step: a recurrent state (rwkv,
    mamba) has no position to rewind, and a rolling SWA ring
    (``window <= size``) loses the previous lap's entry, still inside the
    window, to each draft write.  A plain KV cache and an MLA latent cache
    rewind by position alone: draft writes past the rewound position are
    masked and overwritten before they are read.
    """
    _check_kind(kind)
    if cache is None or kind == "mla":
        return False
    if kind in RECURRENT_KINDS:
        return True
    a = _attn_cfg(cfg, kind)
    return bool(a.window) and a.window <= cache.k.shape[1]


def paged_geometry(cfg: ModelConfig, kind: str, max_seq: int):
    """``(size, ring)`` of one layer's paged cache (the per-slot length and
    whether decode writes roll, ``pos % size``), or None for the
    recurrent kinds, whose state is not paged, and ``xattn``, which has
    no cache."""
    _check_kind(kind)
    if kind not in SEQ_KINDS:
        return None
    if kind == "mla":
        return max_seq, False
    a = _attn_cfg(cfg, kind)
    size = min(max_seq, a.window) if a.window else max_seq
    return size, bool(a.window) and a.window <= size


def init_paged_layer_cache(cfg: ModelConfig, kind: str, num_pages: int,
                           page_size: int, lead: tuple = (), device="cuda"):
    """Zero page arenas of one layer (None for the unpaged kinds)."""
    if paged_geometry(cfg, kind, 1) is None:
        return None
    if kind == "mla":
        return mla_mod.init_paged_cache(num_pages, page_size, cfg.mla,
                                        lead=lead, device=device)
    return attn_mod.init_paged_cache(num_pages, page_size,
                                     _attn_cfg(cfg, kind), lead=lead,
                                     device=device)


def init_paged_state_cache(cfg: ModelConfig, kind: str, n_slots: int,
                           lead: tuple = (), device="cuda"):
    """Zero state rows of one layer (the recurrent kinds; None for the
    paged kinds)."""
    _check_kind(kind)
    if kind not in RECURRENT_KINDS:
        return None
    return init_layer_cache(cfg, kind, n_slots, 1, lead=lead, device=device)


def _wpos(cfg: ModelConfig, kind: str, pos: torch.Tensor,
          max_seq: int) -> torch.Tensor:
    """The (B,) index a decode step writes at: ``pos % size`` on a ring,
    else ``pos`` clamped to the last slot (``attention_``'s parked slot)."""
    size, ring = paged_geometry(cfg, kind, max_seq)
    return pos % size if ring else pos.clamp(max=size - 1)


def paged_view_cache(cfg: ModelConfig, kind: str, cache, pt, max_seq: int):
    """One layer's per-slot view gathered from its arenas (None stays)."""
    if cache is None:
        return None
    size, _ = paged_geometry(cfg, kind, max_seq)
    return attn_mod.paged_view(cache, pt, size)


def paged_commit_cache(cfg: ModelConfig, kind: str, cache, view, pt, pos,
                       max_seq: int):
    """The position a decode step wrote in ``view`` back into the arenas."""
    if cache is None:
        return None
    return attn_mod.paged_commit(cache, view, pt,
                                 _wpos(cfg, kind, pos, max_seq))


def paged_insert_cache(kind: str, cache, src, pt_rows):
    """Freshly prefilled rows into newly mapped pages (None stays)."""
    if cache is None:
        return None
    return attn_mod.paged_insert(cache, src, pt_rows)


def paged_copy_pages(kind: str, cache, src_ids: torch.Tensor,
                     dst_ids: torch.Tensor):
    """Whole pages ``src_ids`` → ``dst_ids`` in every arena of one layer
    (the copy-on-write fork), in place."""
    if cache is None:
        return None
    for leaf in cache:
        put_(leaf, (slice(None), dst_ids), leaf[:, src_ids])
    return cache


def _ffn(params: dict, h: torch.Tensor, cfg: ModelConfig,
         ffn: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN on the normed stream: ``(delta, aux)``, the MoE FFN
    with its f32 aux loss, or the dense SwiGLU and None."""
    f = params["ffn"]
    if ffn == "moe":
        return moe_ffn(f, h, cfg.moe)
    return swiglu(h, f["w_gate"], f["w_up"], f["w_down"]), None


def _with_aux(x: torch.Tensor, new_cache, aux: Optional[torch.Tensor],
              with_aux: bool):
    """``(x, new_cache)``, or with ``with_aux`` ``(x, new_cache, aux)``
    (a 0-d f32 zero for a layer without an MoE FFN)."""
    if not with_aux:
        return x, new_cache
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, new_cache, aux


def apply_layer(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                *, positions: Optional[torch.Tensor] = None, cache=None,
                cache_pos=None, ffn: str = "dense",
                encoder_states: Optional[torch.Tensor] = None,
                with_aux: bool = False) -> tuple:
    """One layer on the residual stream x (B, S, d). Returns (x, new cache)
    or, ``with_aux``, (x, new cache, the f32 aux loss of its MoE FFN; 0
    for the other FFNs), as the JAX package's ``apply_layer``.

    ``positions`` ((S,) or (B, S); ``arange(S)`` when omitted) and
    ``cache_pos`` (see ``attention.attention``) are read by the attention
    and MLA kinds only; ``ffn`` is the layer's ``cfg.ffn_kind``.  An
    ``xattn`` layer attends to ``encoder_states`` (B, T, d); without them
    it is cacheless causal self-attention, as in the JAX package."""
    _check_kind(kind)
    eps = cfg.norm_eps
    # Sequence parallelism: the residual stream lives sequence-sharded over
    # TP (decode's S = 1 drops it); MoE layers opt out, as in the JAX
    # package.  Each norm's output is gathered over the sequence before
    # the mixer's and the FFN's products (Megatron's sequence parallelism,
    # where GSPMD picks the same all-gather): flattening a (B, S, d)
    # activation sharded on both B and S is a view DTensor refuses.
    seq = "tp" if ffn != "moe" else None
    x = constrain(x, "dp", seq, None)
    h = _norm(x, params["norm1"], eps)
    if kind == "rwkv":
        delta, tm_last, new_state = rwkv_mod.rwkv_time_mix(
            params["mixer"], h,
            prev=cache.tm_prev if cache is not None else None,
            state0=cache.state if cache is not None else None)
        x = x + constrain(delta, "dp", seq, None)
        h2 = _norm(x, params["norm2"], eps)
        delta2, cm_last = rwkv_mod.rwkv_channel_mix(
            params["mixer"], h2,
            prev=cache.cm_prev if cache is not None else None)
        new_cache = None
        if cache is not None:
            new_cache = rwkv_mod.RWKVCache(
                tm_last.to(cache.tm_prev.dtype), cm_last.to(cache.cm_prev.dtype),
                new_state.to(cache.state.dtype))
        return _with_aux(x + constrain(delta2, "dp", seq, None), new_cache,
                         None, with_aux)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    if kind == "mamba":
        delta, new_cache = mamba_mod.mamba_block(params["mixer"], h,
                                                 cfg.mamba, cache=cache)
    elif kind == "mla":
        delta, new_cache = mla_mod.mla_attention(
            params["mixer"], h, positions, cfg.mla, cache=cache,
            cache_pos=cache_pos)
    elif kind == "xattn":
        delta, new_cache = attn_mod.attention(
            params["mixer"], h, positions, _attn_cfg(cfg, kind),
            kv_source=encoder_states)
    else:
        delta, new_cache = attn_mod.attention(
            params["mixer"], h, positions, _attn_cfg(cfg, kind), cache=cache,
            cache_pos=cache_pos)
    x = x + constrain(delta, "dp", seq, None)
    h2 = _norm(x, params["norm2"], eps)
    delta2, aux = _ffn(params, h2, cfg, ffn)
    return _with_aux(x + constrain(delta2, "dp", seq, None), new_cache, aux,
                     with_aux)


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``rms_norm(x)``, gathered over the sequence on a mesh."""
    return constrain(rms_norm(x, scale, eps), "dp", None, None)


def _commit_(dst: torch.Tensor, new: torch.Tensor,
             active: Optional[torch.Tensor]) -> None:
    """``dst`` ← ``new`` (cast to dst's dtype), or only on the rows (axis 0)
    where ``active``: the value ``mask_cache_update`` would leave."""
    new = like(new.to(dst.dtype), dst)
    if active is not None:
        new = torch.where(active.reshape(-1, *([1] * (dst.dim() - 1))),
                          new, dst)
    dst.copy_(new)


def apply_layer_(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 *, positions: Optional[torch.Tensor], cache,
                 cache_pos: Optional[torch.Tensor],
                 active: Optional[torch.Tensor] = None,
                 ffn: str = "dense",
                 encoder_states: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The in-place decode twin of :func:`apply_layer`: one token a row, the
    layer's new cache written into ``cache`` (where ``active``, when
    given), the residual stream returned.  ``positions`` (B, 1) and
    ``cache_pos`` (B,) are device tensors (the attention and MLA kinds read
    them); an ``xattn`` layer reads ``encoder_states``.  The result and the
    written cache equal ``apply_layer``'s followed by
    ``mask_cache_update``, bit for bit."""
    _check_kind(kind)
    eps = cfg.norm_eps
    seq = "tp" if ffn != "moe" else None
    x = constrain(x, "dp", seq, None)
    h = _norm(x, params["norm1"], eps)
    if kind == "rwkv":
        delta, tm_last, new_state = rwkv_mod.rwkv_time_mix(
            params["mixer"], h, prev=cache.tm_prev, state0=cache.state)
        x = x + constrain(delta, "dp", seq, None)
        h2 = _norm(x, params["norm2"], eps)
        delta2, cm_last = rwkv_mod.rwkv_channel_mix(
            params["mixer"], h2, prev=cache.cm_prev)
        _commit_(cache.tm_prev, tm_last, active)
        _commit_(cache.cm_prev, cm_last, active)
        _commit_(cache.state, new_state, active)
        return x + constrain(delta2, "dp", seq, None)
    if kind == "mamba":
        delta, new = mamba_mod.mamba_block(params["mixer"], h, cfg.mamba,
                                           cache=cache)
        _commit_(cache.conv, new.conv, active)
        _commit_(cache.ssm, new.ssm, active)
    elif kind == "mla":
        delta = mla_mod.mla_attention_(params["mixer"], h, positions, cfg.mla,
                                       cache, cache_pos, active)
    elif kind == "xattn":       # no cache: the functional form writes nothing
        delta, _ = attn_mod.attention(params["mixer"], h, positions,
                                      _attn_cfg(cfg, kind),
                                      kv_source=encoder_states)
    else:
        delta = attn_mod.attention_(params["mixer"], h, positions,
                                    _attn_cfg(cfg, kind), cache, cache_pos,
                                    active)
    x = x + constrain(delta, "dp", seq, None)
    h2 = _norm(x, params["norm2"], eps)
    return x + constrain(_ffn(params, h2, cfg, ffn)[0], "dp", seq, None)
