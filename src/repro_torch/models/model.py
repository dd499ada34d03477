"""Decoder backbone: embedding → the layer stack → final norm → head.

Parameters keep the JAX package's tree: ``embed``, ``head``,
``final_norm``, and ``periods/pos<j>`` holding each pattern position's
layer params stacked over the ``n_periods`` periods.  The JAX package's
``lax.scan`` over periods is a loop over that stacking axis here; decode
caches are stacked the same way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed, init_dense, rms_norm, softcap, unembed
from repro_torch.models.rwkv import RWKVCache


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
    """Zero decode cache, stacked over periods (``max_seq`` is unused by
    the recurrent rwkv state; kept for the JAX package's signature)."""
    del max_seq
    return {"periods": {
        f"pos{j}": blocks.init_layer_cache(cfg, kind, batch,
                                           lead=(cfg.n_periods,),
                                           device=device)
        for j, kind in enumerate(cfg.pattern)}}


def _index(tree, i: int):
    """Period ``i`` of a stacked param dict or cache."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, RWKVCache):
        return RWKVCache(*(t[i] for t in tree))
    return tree[i]


def mask_cache_update(cache: dict, new_cache: dict,
                      active: torch.Tensor) -> dict:
    """``new_cache`` where ``active`` (B,) else ``cache`` — parked rows stay
    bitwise unchanged.  Leaves are (n_periods, B, ...)."""
    def pick(old, new):
        mask = active.reshape(1, -1, *([1] * (new.dim() - 2)))
        return torch.where(mask, new, old)
    return {"periods": {
        name: RWKVCache(*(pick(o, n) for o, n in zip(cache["periods"][name],
                                                     new_cache["periods"][name])))
        for name in new_cache["periods"]}}


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[dict] = None, return_hidden: bool = False
            ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Run the backbone on tokens (B, S). Returns (logits (B, S, V) f32 or,
    with ``return_hidden``, final hiddens (B, S, d) f32; new cache)."""
    x = embed(tokens, params["embed"]) * torch.tensor(
        cfg.d_model ** 0.5, dtype=torch.bfloat16, device=tokens.device)
    new_periods = {}
    for j, kind in enumerate(cfg.pattern):
        name = f"pos{j}"
        stacked = params["periods"][name]
        layer_caches = []
        for i in range(cfg.n_periods):
            layer_cache = (None if cache is None
                           else _index(cache["periods"][name], i))
            x, nc = blocks.apply_layer(_index(stacked, i), x, cfg, kind,
                                       cache=layer_cache)
            layer_caches.append(nc)
        if cache is not None:
            new_periods[name] = RWKVCache(
                *(torch.stack(leaf) for leaf in zip(*layer_caches)))
    new_cache = {"periods": new_periods} if cache is not None else None

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x.to(torch.float32), new_cache
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = unembed(x, table).to(torch.float32)
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits, new_cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, *, return_hidden: bool = False
                ) -> Tuple[torch.Tensor, dict]:
    """One decode step on the newest tokens (B, 1): returns (logits (B, V)
    — or the (B, d) final hidden with ``return_hidden`` — and the updated
    cache)."""
    out, new_cache = forward(params, tokens, cfg, cache=cache,
                             return_hidden=return_hidden)
    return out[:, -1], new_cache
