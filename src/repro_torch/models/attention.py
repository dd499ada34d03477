"""Causal self-attention (GQA, sliding window, softcap, RoPE, KV cache) and
cross-attention to encoder states.

The JAX package's ``models/attention.py``.  Two self-attention regimes:

* **Bulk prefill into a fresh cache, and the cacheless forward**: the
  attention of the whole prompt is causal attention over its own q, k, v
  with the layer's window and softcap, so it runs on the ``flash_attn``
  kernel (``kernels/flash_attn``), GQA not expanded.  The JAX package
  computes the same function with ``_attend_full``/``_attend_chunked``/
  ``_attend_banded`` over the fresh cache, whose unwritten keys are masked;
  the port's tests hold the kernel's plain version against those.
* **Decode, and bulk writes into a non-fresh cache**: plain PyTorch
  ``_attend_full``/``_attend_chunked`` over the cache, as the JAX package
  computes them (outside any Pallas kernel).

The cache is ``(B, S_max, n_kv, head_dim)`` bf16; a sliding-window layer
keeps a ring of ``min(max_seq, window)`` slots.  A scalar ``cache_pos``
(tokens already cached) is a host integer here; a per-slot one is a (B,)
tensor (continuous batching).  ``attention`` never writes into its inputs;
its in-place twin ``attention_`` (one decode token, per-slot positions on
the device) writes the new keys and values into the cache it is given,
which is what a captured decode step needs (``launch/decode_loop.py``).

Cross-attention (``kv_source=``, the ``xattn`` layers): the keys and
values are the encoder states' projections, with no RoPE, no mask and no
cache; a non-causal softmax over every encoder position in f32 plain
PyTorch, as the JAX package computes it (``flash_attn`` is causal).

The paged variants (``init_paged_cache``, ``paged_view``, ``paged_commit``,
``paged_insert``) keep the keys and values of every slot in one
``(num_pages, page_size, n_kv, head_dim)`` arena per layer, addressed
through a host page table (``launch/paging.py``); page 0 is the reserved
zero page, so a view gathered through unmapped entries equals a fresh
cache row.  The arenas stack the periods on a leading axis, as the decode
caches do.  The view, commit and insert move each leaf of the cache tuple
alike, so they serve MLA's latent arenas (``models/mla.py``) too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.sharding.ctx import constrain, logical_axis_size
from repro_torch.kernels.common import operand_mesh
from repro_torch.sharding.local import on_local_blocks, put_, put_rows_
from repro_torch.models.config import AttentionConfig
from repro_torch.models.layers import apply_rope, init_dense, matmul, softcap

_CHUNK_THRESHOLD = 8192
_KV_CHUNK = 1024
_NEG_INF = -1e30
_INT32_MAX = 2 ** 31 - 1      # the JAX package's "never written" key position


def init_attention(generator: torch.Generator, d_model: int,
                   cfg: AttentionConfig, lead: tuple = ()) -> dict:
    q_dim, kv_dim = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {
        "wq": init_dense(generator, (d_model, q_dim), lead=lead),
        "wk": init_dense(generator, (d_model, kv_dim), lead=lead),
        "wv": init_dense(generator, (d_model, kv_dim), lead=lead),
        "wo": init_dense(generator, (q_dim, d_model), lead=lead),
    }


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, n_kv, head_dim)
    v: torch.Tensor  # (B, S_max, n_kv, head_dim)


def init_cache(batch: int, max_seq: int, cfg: AttentionConfig,
               lead: tuple = (), device="cuda",
               dtype=torch.bfloat16) -> KVCache:
    """Zero cache; a windowed layer's ring holds ``min(max_seq, window)``."""
    size = min(max_seq, cfg.window) if cfg.window else max_seq
    shape = (*lead, batch, size, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_paged_cache(num_pages: int, page_size: int, cfg: AttentionConfig,
                     lead: tuple = (), device="cuda",
                     dtype=torch.bfloat16) -> KVCache:
    """Zero page arenas ``(*lead, num_pages, page_size, n_kv, head_dim)``."""
    shape = (*lead, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def paged_view(cache: KVCache, pt: torch.Tensor, size: int) -> KVCache:
    """Per-slot contiguous rows gathered from period-stacked arenas
    (P, num_pages, ps, ...) through the (B, npp_max) page table:
    (P, B, size, ...), fresh tensors, for each leaf of the cache tuple.
    This layer reads the first ``ceil(size / ps)`` entries; unmapped (0)
    entries read the zero page, so the view equals a contiguous pool row
    at the same depth."""
    ps = cache[0].shape[2]
    npp = -(-size // ps)
    idx = pt[:, :npp].long()

    def gather(pages):
        v = pages[:, idx]                          # (P, B, npp, ps, kv, dh)
        v = v.reshape(pages.shape[0], idx.shape[0], npp * ps,
                      *pages.shape[3:])
        return v[:, :, :size].contiguous()

    return type(cache)(*(gather(pages) for pages in cache))


def paged_commit(cache: KVCache, view: KVCache, pt: torch.Tensor,
                 wpos: torch.Tensor) -> KVCache:
    """Scatter the position each slot's decode step wrote in ``view`` back
    into the arenas, in place.  ``wpos`` (B,) is the step's write index
    (``pos % size`` on a ring, else ``pos`` clamped to the last slot, as
    ``attention_`` writes).  An unmapped slot (a free one: the masked step
    restored its row) writes the gathered zeros onto the zero page."""
    ps = cache[0].shape[2]
    bi = torch.arange(pt.shape[0], device=wpos.device)
    phys = pt.long()[bi, wpos // ps]
    off = wpos % ps
    for pages, rows in zip(cache, view):
        put_(pages, (slice(None), phys, off), rows[:, bi, wpos].to(pages.dtype))
    return cache


def paged_insert(cache: KVCache, src: KVCache,
                 pt_rows: torch.Tensor) -> KVCache:
    """Scatter freshly prefilled rows (P, G, size, ...) into their
    newly mapped pages, in place (``pt_rows``: the requests' (G, npp_max)
    page-table rows).  Positions past the prompt are still zero after the
    prefill, so unmapped trailing entries write zeros onto the zero
    page."""
    ps = cache[0].shape[2]
    size = src[0].shape[2]
    npp = -(-size // ps)
    idx = pt_rows[:, :npp].long()
    for pages, rows in zip(cache, src):
        pad = npp * ps - size
        if pad:
            rows = torch.cat([rows, rows.new_zeros(
                (*rows.shape[:2], pad, *rows.shape[3:]))], dim=2)
        rows = rows.reshape(rows.shape[0], rows.shape[1], npp, ps,
                            *rows.shape[3:])
        put_(pages, (slice(None), idx), rows.to(pages.dtype))
    return cache


def _scores_mask(scores: torch.Tensor, q_pos: torch.Tensor,
                 k_pos: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """Causal (+ window) mask on (..., Sq, Sk) scores, masked as -1e30.
    Positions are shared ((Sq,), (Sk,)) or per sequence ((B, Sq), (B, Sk)),
    the scores then (B, n_kv, groups, Sq, Sk)."""
    if q_pos.dim() == 2 or k_pos.dim() == 2:
        q2 = q_pos if q_pos.dim() == 2 else q_pos[None]
        k2 = k_pos if k_pos.dim() == 2 else k_pos[None]
        keep = q2[:, :, None] >= k2[:, None, :]
        if window is not None:
            keep &= (q2[:, :, None] - k2[:, None, :]) < window
        return torch.where(keep[:, None, None], scores, _NEG_INF)
    keep = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        keep &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(keep, scores, _NEG_INF)


def _attend_full(q, k, v, q_pos, k_pos, cfg: AttentionConfig):
    """Masked attention. q (B, Sq, Hq, dh), k/v (B, Sk, Hkv, dh).  On a
    mesh, each rank attends with its local batch rows and heads."""
    if operand_mesh(q, k, v) is not None:
        return _on_local_heads(_attend_full, q, k, v, q_pos, k_pos, cfg)
    b, sq, hq, dh = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, hq // n_kv, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs",
                          qg.to(torch.float32) * dh ** -0.5,
                          k.to(torch.float32))
    if cfg.logit_softcap:
        scores = softcap(scores, cfg.logit_softcap)
    scores = _scores_mask(scores, q_pos, k_pos, cfg.window)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def _attend_chunked(q, k, v, q_pos, k_pos, cfg: AttentionConfig,
                    chunk: int = _KV_CHUNK):
    """Online-softmax attention over KV chunks (the flash recurrence, the
    JAX package's ``lax.scan`` as a loop); k_pos is (Sk,).  On a mesh,
    each rank attends with its local batch rows and heads."""
    if operand_mesh(q, k, v) is not None:
        return _on_local_heads(_attend_chunked, q, k, v, q_pos, k_pos, cfg,
                               chunk)
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    n_kv = k.shape[2]
    groups = hq // n_kv
    pad = (-sk) % chunk
    if pad:
        zeros = k.new_zeros((b, pad, *k.shape[2:]))
        k, v = torch.cat([k, zeros], 1), torch.cat([v, zeros.to(v.dtype)], 1)
        k_pos = torch.cat([k_pos, k_pos.new_full((pad,), _INT32_MAX)])
    qg = (q.to(torch.float32) * dh ** -0.5).reshape(b, sq, n_kv, groups, dh)
    m = torch.full((b, n_kv, groups, sq), _NEG_INF, device=q.device)
    s = torch.zeros((b, n_kv, groups, sq), device=q.device)
    o = torch.zeros((b, sq, n_kv, groups, dh), device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kb.to(torch.float32))
        if cfg.logit_softcap:
            scores = softcap(scores, cfg.logit_softcap)
        scores = _scores_mask(scores, q_pos, k_pos[c0:c0 + chunk], cfg.window)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        s = s * corr + p.sum(dim=-1)
        o = o * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
            "bkgqs,bskd->bqkgd", p, vb.to(torch.float32))
        m = m_new
    out = o / s.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def _on_local_heads(core, q, k, v, q_pos, k_pos, *rest):
    """``core`` on each rank's local batch rows and heads (positions of
    shape (B, S) follow the batch); a DTensor of q's shape comes back."""
    pos = lambda p: "bs" if p.dim() == 2 else "s"
    return on_local_blocks(
        lambda *a: (core(*a, *rest),), (q, k, v, q_pos, k_pos),
        ("bshd", "bshd", "bshd", pos(q_pos), pos(k_pos)), ("bshd",))[0]


def _ring_positions(size: int, cache_pos, device) -> torch.Tensor:
    """Absolute position each ring slot holds after writing ``cache_pos``
    (scalar, or (B,) per slot); slots never written hold ``_INT32_MAX``."""
    i = torch.arange(size, device=device)
    if torch.is_tensor(cache_pos):
        i, cache_pos = i[None, :], cache_pos[:, None]
    slot = cache_pos % size
    k_pos = torch.where(i <= slot, i + (cache_pos - slot),
                        i + (cache_pos - slot) - size)
    return torch.where(k_pos >= 0, k_pos, _INT32_MAX)


def _split_heads(t: torch.Tensor, n_heads: int, head_dim: int):
    """(B, S, n·dh) → (B, S, n, dh).  On a mesh whose model axis does not
    divide n, the features are gathered first: DTensor has no layout for
    a head split between ranks (GSPMD's reshape makes one)."""
    if n_heads % logical_axis_size("tp"):
        t = constrain(t, "dp", None, None)
    return t.reshape(*t.shape[:2], n_heads, head_dim)


def _qkv(params: dict, x: torch.Tensor, cfg: AttentionConfig):
    """q (B, S, H, dh), k and v (B, S, Hkv, dh) of x (B, S, d); on a mesh
    the heads pinned to TP shards (head-parallel attention; KV heads
    follow where they divide the axis)."""
    q = _split_heads(x @ params["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, cfg.head_dim)
    return tuple(constrain(t, "dp", None, "tp", None) for t in (q, k, v))


def _expand_kv(k: torch.Tensor, v: torch.Tensor, cfg: AttentionConfig):
    """The JAX package's train/prefill rule: on a mesh whose model axis
    does not divide the KV heads, each KV head is repeated over its group
    of query heads (then MHA), so that attention splits over the heads;
    k and v as they are otherwise."""
    groups = cfg.n_heads // cfg.n_kv_heads
    tp = logical_axis_size("tp")
    if groups == 1 or cfg.n_kv_heads % tp == 0:
        return k, v
    b, s, n_kv, dh = k.shape
    return tuple(constrain(t[:, :, :, None].expand(b, s, n_kv, groups, dh)
                           .reshape(b, s, cfg.n_heads, dh),
                           "dp", None, "tp", None) for t in (k, v))


def _cross_core(q, k, v):
    """Unmasked grouped attention in f32: q (B, S, H, dh), k/v (B, T,
    Hkv, dh) → (B, S, H, dh) f32."""
    b, s, hq, dh = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, s, n_kv, hq // n_kv, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs",
                          qg.to(torch.float32) * dh ** -0.5,
                          k.to(torch.float32))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(b, s, hq, dh)


def cross_attention(params: dict, x: torch.Tensor, kv_source: torch.Tensor,
                    cfg: AttentionConfig) -> torch.Tensor:
    """x (B, S, d) attending to every state of ``kv_source`` (B, T, d):
    grouped heads, no RoPE, no mask, the softmax and both products in
    f32, the output cast to x's dtype before the output projection."""
    b, s, _ = x.shape
    q = _split_heads(x @ params["wq"], cfg.n_heads, cfg.head_dim)
    # The JAX package's einsum promotes f32 states (the training data's)
    # with the bf16 weights to f32; bf16 states stay bf16.
    dt = torch.promote_types(kv_source.dtype, params["wk"].dtype)
    kv = kv_source.to(dt)
    k = _split_heads(kv @ params["wk"].to(dt), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(kv @ params["wv"].to(dt), cfg.n_kv_heads, cfg.head_dim)
    if operand_mesh(q, k, v) is not None:
        out = on_local_blocks(lambda *a: (_cross_core(*a),), (q, k, v),
                              ("bshd",) * 3, ("bshd",))[0]
    else:
        out = _cross_core(q, k, v)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return matmul(out, params["wo"])


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: AttentionConfig, *, kv_source: Optional[torch.Tensor] = None,
              cache: Optional[KVCache] = None,
              cache_pos=None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """The attention block on x (B, S, d): returns (output, updated cache).

    Args:
      positions: (S,) or, with a per-slot ``cache_pos``, (B, S) absolute
        token positions (RoPE and the masks).
      kv_source: encoder states (B, T, d) to cross-attend to
        (:func:`cross_attention`: no positions, no cache; None returned).
      cache: this layer's ``KVCache`` or None (cacheless forward).
      cache_pos: tokens already cached: an int (or 0-d tensor), or a (B,)
        tensor for per-slot decode (one token per slot).
    """
    if kv_source is not None:
        return cross_attention(params, x, kv_source, cfg), None
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    per_slot = torch.is_tensor(cache_pos) and cache_pos.dim() == 1
    if cache is not None and not per_slot:
        cache_pos = int(cache_pos)
    new_cache = None
    if cache is None:
        out = flash_attention(q, *_expand_kv(k, v, cfg), window=cfg.window,
                              softcap=cfg.logit_softcap)
    elif s > 1 and not per_slot and cfg.window and cfg.window <= cache.k.shape[1]:
        # Bulk write into a rolling SWA ring: attend over (old ring ∪ new
        # tokens), then rebuild the ring with the last `size` positions.
        size = cache.k.shape[1]
        j = torch.arange(size, device=x.device)
        if cache_pos == 0:
            # Every old slot is unwritten (masked): causal attention over
            # the prompt alone.
            out = flash_attention(q, k, v, window=cfg.window,
                                  softcap=cfg.logit_softcap)
        else:
            t_old = cache_pos - 1 - ((cache_pos - 1 - j) % size)
            k_pos = torch.cat([torch.where(t_old >= 0, t_old, _INT32_MAX),
                               positions])
            k_cat = torch.cat([cache.k.to(k.dtype), k], 1)
            v_cat = torch.cat([cache.v.to(v.dtype), v], 1)
            attend = (_attend_chunked if s > min(_CHUNK_THRESHOLD,
                                                 cfg.window + _KV_CHUNK)
                      else _attend_full)
            out = attend(q, k_cat, v_cat, positions, k_pos, cfg)
        # After the write, slot j holds the largest t ≡ j (mod size) with
        # t < cache_pos + s; it keeps its old value where that t is old.
        t_new = cache_pos + s - 1 - ((cache_pos + s - 1 - j) % size)
        rel = (t_new - cache_pos).clamp(0, s - 1)
        is_new = (t_new >= cache_pos)[None, :, None, None]
        new_cache = KVCache(
            torch.where(is_new, k[:, rel].to(cache.k.dtype), cache.k),
            torch.where(is_new, v[:, rel].to(cache.v.dtype), cache.v))
    elif per_slot:
        # Per-slot decode (the engine): each row writes at its own position.
        if s != 1:
            raise NotImplementedError(
                "per-slot cache_pos supports single-token decode only; "
                "prefill into a fresh cache and slot_insert it instead")
        size = cache.k.shape[1]
        cache_pos = cache_pos.long()
        ring = bool(cfg.window) and cfg.window <= size
        slot = cache_pos % size if ring else cache_pos
        bi = torch.arange(b, device=x.device)
        new_cache = KVCache(
            cache.k.index_put((bi, slot), k[:, 0].to(cache.k.dtype)),
            cache.v.index_put((bi, slot), v[:, 0].to(cache.v.dtype)))
        if ring:
            k_pos = _ring_positions(size, cache_pos, x.device)
        else:
            i = torch.arange(size, device=x.device)[None, :]
            k_pos = torch.where(i < cache_pos[:, None] + 1, i, _INT32_MAX)
        out = _attend_full(q, new_cache.k, new_cache.v, positions, k_pos, cfg)
    else:
        # Scalar decode, or a bulk write into a cache without a ring.
        size = cache.k.shape[1]
        ring = bool(cfg.window) and cfg.window <= size
        slot = cache_pos % size if ring else cache_pos
        start = max(0, min(slot, size - s))     # dynamic_update_slice clamps
        # A copy of this layer's rows, written in place (slice_scatter on a
        # period's view of the stacked cache would copy the whole stack).
        new_cache = KVCache(cache.k.clone(), cache.v.clone())
        new_cache.k[:, start:start + s] = k.to(cache.k.dtype)
        new_cache.v[:, start:start + s] = v.to(cache.v.dtype)
        if cache_pos == 0 and s > 1:
            # Fresh cache: keys past the prompt are masked, so this is
            # causal attention over the prompt alone.
            out = flash_attention(q, k, v, window=cfg.window,
                                  softcap=cfg.logit_softcap)
        else:
            if ring:
                k_pos = _ring_positions(size, cache_pos, x.device)
            else:
                k_pos = torch.arange(size, device=x.device)
                k_pos = torch.where(k_pos < cache_pos + s, k_pos, _INT32_MAX)
            attend = _attend_chunked if s > _CHUNK_THRESHOLD else _attend_full
            out = attend(q, new_cache.k, new_cache.v, positions, k_pos, cfg)
    out = constrain(out.reshape(b, s, cfg.n_heads * cfg.head_dim),
                    "dp", None, "tp")
    return matmul(out, params["wo"]), new_cache


def attention_(params: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: AttentionConfig, cache: KVCache, cache_pos: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The in-place twin of :func:`attention`'s per-slot decode: one token
    a row, x (B, 1, d), ``positions`` (B, 1) and ``cache_pos`` (B,) on the
    device.  Each row's key and value go into ``cache`` at its own slot
    (``cache_pos`` mod the ring on a windowed layer) by a device index, and
    the attention reads the written cache; returns the output only.

    With ``active`` (B,) bool, an inactive row's slot gets its old key and
    value back after the attention: the cache ends as
    ``mask_cache_update`` leaves it and every row's output is what
    :func:`attention` gives, bit for bit.  A scalar ``cache_pos``, expanded
    to every row, gives :func:`attention`'s scalar decode bit for bit too
    (the same masks and RoPE angles, element by element).
    """
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"attention_ decodes one token a row, got {s}")
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    size = cache.k.shape[1]
    ring = bool(cfg.window) and cfg.window <= size
    # A parked engine slot whose request used its whole budget sits one past
    # the cache's end; its write lands on the last slot and, inactive, gets
    # the old value back (the JAX package's scatter drops it instead).
    slot = cache_pos % size if ring else cache_pos.clamp(max=size - 1)
    bi = torch.arange(b, device=x.device)
    k_new, v_new = k[:, 0].to(cache.k.dtype), v[:, 0].to(cache.v.dtype)
    if active is not None:
        k_old, v_old = cache.k[bi, slot], cache.v[bi, slot]
    put_rows_(cache.k, slot, k_new)
    put_rows_(cache.v, slot, v_new)
    if ring:
        k_pos = _ring_positions(size, cache_pos, x.device)
    else:
        i = torch.arange(size, device=x.device)[None, :]
        k_pos = torch.where(i < cache_pos[:, None] + 1, i, _INT32_MAX)
    out = _attend_full(q, cache.k, cache.v, positions, k_pos, cfg)
    if active is not None:
        keep = active[:, None, None]
        put_rows_(cache.k, slot, torch.where(keep, k_new, k_old))
        put_rows_(cache.v, slot, torch.where(keep, v_new, v_old))
    out = constrain(out.reshape(b, s, cfg.n_heads * cfg.head_dim),
                    "dp", None, "tp")
    return matmul(out, params["wo"])
