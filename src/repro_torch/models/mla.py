"""Multi-head Latent Attention (DeepSeek-V2/V3).

The JAX package's ``models/mla.py``.  K and V are compressed into a shared
latent ``c_kv`` (``kv_lora_rank`` values a position) and a decoupled RoPE
key ``k_rope`` (``qk_rope_head_dim``); queries go through a low-rank
bottleneck.  The decode cache keeps only ``(c_kv, k_rope)`` a position,
``(*lead, B, S_max, rank)`` bf16 leaves.

* **Decode, and bulk writes into a non-fresh cache**: the absorption
  trick in f32 plain PyTorch, as the JAX package computes it outside any
  Pallas kernel: ``W_uk`` folds into the query and ``W_uv`` into the
  output, so the scores and the weighted sum run over the latent cache.
* **Bulk prefill into a fresh cache (``cache_pos == 0``), and the
  cacheless forward**: causal attention over the prompt alone, on the
  ``flash_attn`` kernel with H = Hkv = ``n_heads``: q = [q_nope, q_rope],
  k = [c_kv·W_uk, k_rope broadcast over the heads], V = c_kv·W_uv padded
  to ``qk_head_dim`` (the JAX package's own materialised form, which its
  cacheless branch runs; its fresh-cache prefill runs the absorbed form
  over the cache, whose unwritten positions are masked, the same
  function).  The latent goes into the cache.  The kernel takes B·H up
  to 65535 (B ≤ 511 at deepseek-v3's 128 heads).

``mla_attention`` never writes into its inputs; its in-place twin
``mla_attention_`` (one decode token a row, per-slot positions on the
device) writes the new latent into the cache it is given, as a captured
decode step needs.  The caller passes RoPE's theta: the JAX package's
``apply_layer`` leaves it at 10000.

The cache is append-only and masked by position, so a speculative
rollback rewinds the position alone, and the paged engine keeps it in
page arenas through ``attention.paged_view``/``paged_commit``/
``paged_insert``, which move the leaves of any cache tuple.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.sharding.ctx import constrain, logical_axis_size
from repro_torch.sharding.local import put_rows_
from repro_torch.models.attention import _split_heads
from repro_torch.models.config import MLAConfig
from repro_torch.models.layers import apply_rope, init_dense, matmul

_NEG_INF = -1e30
_INT32_MAX = 2 ** 31 - 1      # the JAX package's "never written" key position


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (*lead, B, S_max, kv_lora_rank)
    k_rope: torch.Tensor  # (*lead, B, S_max, qk_rope_head_dim)


def init_mla(generator: torch.Generator, d_model: int, cfg: MLAConfig,
             lead: tuple = ()) -> dict:
    """Random MLA params (bf16), with ``lead`` stacking axes."""
    h = cfg.n_heads
    return {
        "w_dq": init_dense(generator, (d_model, cfg.q_lora_rank), lead=lead),
        "w_uq": init_dense(generator, (cfg.q_lora_rank, h * cfg.qk_head_dim),
                           lead=lead),
        "w_dkv": init_dense(generator, (d_model, cfg.kv_lora_rank
                                        + cfg.qk_rope_head_dim), lead=lead),
        "w_uk": init_dense(generator, (cfg.kv_lora_rank,
                                       h * cfg.qk_nope_head_dim), lead=lead),
        "w_uv": init_dense(generator, (cfg.kv_lora_rank, h * cfg.v_head_dim),
                           lead=lead),
        "w_o": init_dense(generator, (h * cfg.v_head_dim, d_model),
                          lead=lead),
    }


def init_mla_cache(batch: int, max_seq: int, cfg: MLAConfig,
                   lead: tuple = (), device="cuda",
                   dtype=torch.bfloat16) -> MLACache:
    """Zero latent cache of ``max_seq`` positions."""
    return MLACache(
        torch.zeros((*lead, batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((*lead, batch, max_seq, cfg.qk_rope_head_dim),
                    dtype=dtype, device=device))


def init_paged_cache(num_pages: int, page_size: int, cfg: MLAConfig,
                     lead: tuple = (), device="cuda",
                     dtype=torch.bfloat16) -> MLACache:
    """Zero page arenas ``(*lead, num_pages, page_size, rank)``: the latent
    has no head axis."""
    return init_mla_cache(num_pages, page_size, cfg, lead=lead,
                          device=device, dtype=dtype)


def slot_insert(cache: MLACache, src: MLACache, slots) -> MLACache:
    """A copy of ``cache`` with row i of a freshly prefilled ``src`` in
    batch row ``slots[i]`` (the batch axis is the third from the end)."""
    idx = torch.as_tensor(slots, dtype=torch.int64, device=cache.c_kv.device)
    return MLACache(*(leaf.index_copy(-3, idx, new.to(leaf.dtype))
                      for leaf, new in zip(cache, src)))


def slot_reset(cache: MLACache, slots) -> MLACache:
    """A copy of ``cache`` with batch rows ``slots`` zeroed: fresh rows."""
    idx = torch.as_tensor(slots, dtype=torch.int64, device=cache.c_kv.device)
    return MLACache(*(leaf.index_fill(-3, idx, 0) for leaf in cache))


def _project(params: dict, x: torch.Tensor, positions: torch.Tensor,
             cfg: MLAConfig, rope_theta: float):
    """q_nope (B, S, H, nope), q_rope (B, S, H, rope) and the latent c_kv
    (B, S, rank), k_rope (B, S, rope) of x (B, S, d), RoPE applied."""
    q = _split_heads((x @ params["w_dq"]) @ params["w_uq"], cfg.n_heads,
                     cfg.qk_head_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                             dim=-1)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c_kv, k_rope = (x @ params["w_dkv"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _head_weight(w: torch.Tensor, n_heads: int, head_dim: int):
    """(rank, n·dh) → (rank, n, dh).  On a mesh whose model axis does not
    divide n the weight is gathered first, as ``_split_heads`` gathers an
    activation's features."""
    if n_heads % logical_axis_size("tp"):
        w = constrain(w, None, None)
    return w.reshape(w.shape[0], n_heads, head_dim)


def _materialised(params: dict, q_nope, q_rope, c_kv, k_rope,
                  cfg: MLAConfig) -> torch.Tensor:
    """Causal attention over the prompt's own latent on the ``flash_attn``
    kernel: per-head K and V materialised from the latent (V padded up to
    the q/k head dim), H = Hkv.  Returns (B, S, H · v_head_dim)."""
    b, s, h, _ = q_nope.shape
    k_nope = _split_heads(c_kv @ params["w_uk"], h, cfg.qk_nope_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_head_dim)], dim=-1)
    v = _split_heads(c_kv @ params["w_uv"], h, cfg.v_head_dim)
    pad = cfg.qk_head_dim - cfg.v_head_dim
    if pad > 0:
        v = torch.cat([v, v.new_zeros((b, s, h, pad))], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    return out[..., :cfg.v_head_dim].reshape(b, s, h * cfg.v_head_dim)


def _absorbed(params: dict, q_nope, q_rope, c_all, r_all, positions,
              k_pos, cfg: MLAConfig, dtype) -> torch.Tensor:
    """Attention over the latent cache c_all (B, T, rank), r_all (B, T,
    rope) in f32 with ``W_uk`` folded into the query and ``W_uv`` into the
    output; keys at ``k_pos`` ((T,) or (B, T)) later than the query's
    position are masked.  Returns (B, S, H · v_head_dim) in ``dtype``."""
    b, s, h, _ = q_nope.shape
    w_uk = _head_weight(params["w_uk"], h, cfg.qk_nope_head_dim)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.to(torch.float32),
                         w_uk.to(torch.float32))
    c32 = c_all.to(torch.float32)
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c32)
              + torch.einsum("bshd,btd->bhst", q_rope.to(torch.float32),
                             r_all.to(torch.float32))) * cfg.qk_head_dim ** -0.5
    if positions.dim() == 2 or k_pos.dim() == 2:
        p2 = positions if positions.dim() == 2 else positions[None]
        k2 = k_pos if k_pos.dim() == 2 else k_pos[None]
        keep = (p2[:, :, None] >= k2[:, None, :])[:, None]
    else:
        keep = (positions[:, None] >= k_pos[None, :])[None, None]
    probs = torch.softmax(torch.where(keep, scores, _NEG_INF), dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", probs, c32)
    w_uv = _head_weight(params["w_uv"], h, cfg.v_head_dim)
    o = torch.einsum("bshr,rhd->bshd", o_lat, w_uv.to(torch.float32))
    return o.reshape(b, s, h * cfg.v_head_dim).to(dtype)


def mla_attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: MLAConfig, *, rope_theta: float = 10000.0,
                  cache: Optional[MLACache] = None, cache_pos=None
                  ) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """The MLA block on x (B, S, d): returns (output, updated cache).

    Args:
      positions: (S,) or, with a per-slot ``cache_pos``, (B, S) absolute
        token positions.
      cache: this layer's ``MLACache`` or None (cacheless forward).
      cache_pos: tokens already cached: an int (or 0-d tensor), or a (B,)
        tensor for per-slot decode (one token per slot).
    """
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _project(params, x, positions, cfg,
                                            rope_theta)
    per_slot = torch.is_tensor(cache_pos) and cache_pos.dim() == 1
    new_cache = None
    if cache is None:
        out = _materialised(params, q_nope, q_rope, c_kv, k_rope, cfg)
    elif per_slot:
        # Per-slot decode (the engine): each row writes at its own position.
        if s != 1:
            raise NotImplementedError(
                "per-slot cache_pos supports single-token decode only; "
                "prefill into a fresh cache and slot_insert it instead")
        cache_pos = cache_pos.long()
        bi = torch.arange(b, device=x.device)
        new_cache = MLACache(
            cache.c_kv.index_put((bi, cache_pos),
                                 c_kv[:, 0].to(cache.c_kv.dtype)),
            cache.k_rope.index_put((bi, cache_pos),
                                   k_rope[:, 0].to(cache.k_rope.dtype)))
        i = torch.arange(cache.c_kv.shape[1], device=x.device)[None, :]
        k_pos = torch.where(i < cache_pos[:, None] + 1, i, _INT32_MAX)
        out = _absorbed(params, q_nope, q_rope, *new_cache, positions, k_pos,
                        cfg, x.dtype)
    else:
        cache_pos = int(cache_pos)
        size = cache.c_kv.shape[1]
        start = max(0, min(cache_pos, size - s))  # dynamic_update_slice clamps
        new_cache = MLACache(cache.c_kv.clone(), cache.k_rope.clone())
        new_cache.c_kv[:, start:start + s] = c_kv.to(cache.c_kv.dtype)
        new_cache.k_rope[:, start:start + s] = k_rope.to(cache.k_rope.dtype)
        if cache_pos == 0 and s > 1:
            # Fresh cache: positions past the prompt are masked, so this is
            # causal attention over the prompt alone.
            out = _materialised(params, q_nope, q_rope, c_kv, k_rope, cfg)
        else:
            k_pos = torch.arange(size, device=x.device)
            k_pos = torch.where(k_pos < cache_pos + s, k_pos, _INT32_MAX)
            out = _absorbed(params, q_nope, q_rope, *new_cache, positions,
                            k_pos, cfg, x.dtype)
    return matmul(out, params["w_o"]), new_cache


def mla_attention_(params: dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: MLAConfig, cache: MLACache, cache_pos: torch.Tensor,
                   active: Optional[torch.Tensor] = None, *,
                   rope_theta: float = 10000.0) -> torch.Tensor:
    """The in-place twin of :func:`mla_attention`'s per-slot decode: one
    token a row, x (B, 1, d), ``positions`` (B, 1) and ``cache_pos`` (B,)
    on the device.  Each row's latent goes into ``cache`` at its position
    by a device index and the attention reads the written cache; returns
    the output only.  With ``active`` (B,) bool, an inactive row's
    position gets its old latent back after the attention, as
    ``mask_cache_update`` leaves it.  A parked engine slot one past the
    cache's end writes (and restores) the last position."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mla_attention_ decodes one token a row, got {s}")
    q_nope, q_rope, c_kv, k_rope = _project(params, x, positions, cfg,
                                            rope_theta)
    size = cache.c_kv.shape[1]
    slot = cache_pos.clamp(max=size - 1)
    bi = torch.arange(b, device=x.device)
    new = (c_kv[:, 0].to(cache.c_kv.dtype), k_rope[:, 0].to(cache.k_rope.dtype))
    if active is not None:
        old = tuple(leaf[bi, slot] for leaf in cache)
    for leaf, row in zip(cache, new):
        put_rows_(leaf, slot, row)
    i = torch.arange(size, device=x.device)[None, :]
    k_pos = torch.where(i < cache_pos[:, None] + 1, i, _INT32_MAX)
    out = _absorbed(params, q_nope, q_rope, *cache, positions, k_pos, cfg,
                    x.dtype)
    if active is not None:
        keep = active[:, None]
        for leaf, row, was in zip(cache, new, old):
            put_rows_(leaf, slot, torch.where(keep, row, was))
    return matmul(out, params["w_o"])
