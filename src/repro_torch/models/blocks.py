"""Per-layer block: init, decode cache and forward of the ``rwkv`` kind
(the only kind ported).  A layer is the time-mix followed by the
channel-mix (rwkv's FFN), pre-norm residual style."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm


def _check_kind(kind: str) -> None:
    if kind != "rwkv":
        raise ValueError(f"block kind {kind!r} is not ported; only 'rwkv' is")


def init_layer(generator: torch.Generator, cfg: ModelConfig, kind: str,
               lead: tuple = ()) -> dict:
    """Params of one layer (``lead`` stacks layers on leading axes)."""
    _check_kind(kind)
    zeros = lambda: torch.zeros((*lead, cfg.d_model), dtype=torch.float32,
                                device=generator.device)
    return {"norm1": zeros(), "norm2": zeros(),
            "mixer": rwkv_mod.init_rwkv(generator, cfg.d_model, cfg.d_ff,
                                        lead=lead)}


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int,
                     lead: tuple = (), device="cuda") -> rwkv_mod.RWKVCache:
    _check_kind(kind)
    return rwkv_mod.init_rwkv_cache(batch, cfg.d_model, lead=lead,
                                    device=device)


def apply_layer(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                *, cache: Optional[rwkv_mod.RWKVCache] = None
                ) -> Tuple[torch.Tensor, Optional[rwkv_mod.RWKVCache]]:
    """One layer on the residual stream x (B, S, d). Returns (x, new cache)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h = rms_norm(x, params["norm1"], eps)
    delta, tm_last, new_state = rwkv_mod.rwkv_time_mix(
        params["mixer"], h,
        prev=cache.tm_prev if cache is not None else None,
        state0=cache.state if cache is not None else None)
    x = x + delta
    h2 = rms_norm(x, params["norm2"], eps)
    delta2, cm_last = rwkv_mod.rwkv_channel_mix(
        params["mixer"], h2,
        prev=cache.cm_prev if cache is not None else None)
    new_cache = None
    if cache is not None:
        new_cache = rwkv_mod.RWKVCache(
            tm_last.to(cache.tm_prev.dtype), cm_last.to(cache.cm_prev.dtype),
            new_state.to(cache.state.dtype))
    return x + delta2, new_cache
