"""Shared building blocks: RMS norm, embedding, unembedding, bf16 init."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """``x / rms(x) · (1 + scale)`` computed in f32, returned in x's dtype."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Logit soft-capping: cap·tanh(x/cap)."""
    return cap * torch.tanh(x / cap)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits through the output table: (..., d) · (V, d)ᵀ → (..., V)."""
    return x @ table.t()


def init_dense(generator: torch.Generator, shape, scale: Optional[float] = None,
               lead: tuple = ()) -> torch.Tensor:
    """N(0, scale²) weights drawn in f32 and stored bf16 (default scale
    1/sqrt(fan_in), fan_in = shape[0]); ``lead`` prepends stacking axes."""
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn((*lead, *shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * scale).to(torch.bfloat16)
