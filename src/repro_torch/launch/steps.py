"""Serving steps: the bulk prefill and one decode step through a head."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import softcap
from repro_torch.models.model import decode_step, forward, mask_cache_update


def prefill_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 cache: dict) -> Tuple[torch.Tensor, dict]:
    """The whole (B, P) prompt in one forward pass through the dense head:
    returns the last position's logits (B, V) and the filled cache."""
    logits, new_cache = forward(params, tokens, cfg, cache=cache)
    return logits[:, -1], new_cache


def serve_step(params: dict, cache: dict, tokens: torch.Tensor,
               cfg: ModelConfig, head=None,
               active: Optional[torch.Tensor] = None, *,
               pos: Optional[torch.Tensor] = None, head_params=None
               ) -> Tuple[torch.Tensor, dict]:
    """One decode step for the newest tokens (B, 1) → (logits (B, V), cache).

    A head with ``needs_hidden`` (``SketchHead``) replaces the dense
    unembed: the backbone returns the final hidden, the head turns it into
    logits, then ``final_logit_softcap`` applies.  ``head_params``
    overrides the head's own params (the per-tenant engine passes the
    ``HeadCache`` bank and slot binding here each tick).  ``active`` (B,)
    bool keeps the cache rows of inactive sequences unchanged.  ``pos``
    ((B,) tokens cached per slot) is not read by the recurrent rwkv cache;
    it stays in the signature for the attention families to come.
    """
    del pos
    if head is None or not head.needs_hidden:
        logits, new_cache = decode_step(params, cache, tokens, cfg)
    else:
        hidden, new_cache = decode_step(params, cache, tokens, cfg,
                                        return_hidden=True)
        logits = head.apply(head.params if head_params is None
                            else head_params, hidden)
        if cfg.final_logit_softcap:
            logits = softcap(logits, cfg.final_logit_softcap)
    if active is not None:
        new_cache = mask_cache_update(cache, new_cache, active)
    return logits, new_cache
