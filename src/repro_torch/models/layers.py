"""Shared building blocks: RMS norm, RoPE, sigmoid/silu, SwiGLU, embedding,
unembedding, bf16 init."""

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


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """``1 / theta^(i / half)`` for i < head_dim / 2, in f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # theta by a fill, not a host-to-device copy: a captured decode step
    # (launch/decode_loop.py) may make no copy from the host.
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding in f32, cast back to x's dtype.  x: (..., S, H, dh);
    positions: (S,) or (B, S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    # cos and sin of the f32 angles, correctly rounded to f32 (through
    # f64): nearer XLA's f32 cos/sin than torch's, and the same on every
    # device.
    cos = torch.cos(angles.double()).float()[..., None, :]     # (..., S, 1, half)
    sin = torch.sin(angles.double()).float()[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` with one rounding to x's dtype per step: the
    JAX package's bf16 sigmoid as XLA lowers it, so the two agree bit for
    bit where ``torch.sigmoid``'s single rounding would differ by an ulp."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · sigmoid(x)``, rounded as :func:`sigmoid` (``jax.nn.silu``)."""
    return x * sigmoid(x)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: ``(silu(x·w_gate) ⊙ (x·w_up)) · w_down``."""
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Logit soft-capping: cap·tanh(x/cap)."""
    return cap * torch.tanh(x / cap)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def embed_scaled(tokens: torch.Tensor, table: torch.Tensor,
                 d_model: int) -> torch.Tensor:
    """``embed(tokens) · sqrt(d_model)``, the factor rounded to bf16 first
    as the JAX package rounds it (a device fill, no copy from the host)."""
    return embed(tokens, table) * torch.full(
        (), d_model ** 0.5, dtype=torch.bfloat16, device=tokens.device)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits through the output table: (..., d) · (V, d)ᵀ → (..., V)."""
    return x @ table.t()


def init_dense(generator: torch.Generator, shape, scale: Optional[float] = None,
               lead: tuple = ()) -> torch.Tensor:
    """N(0, scale²) weights drawn in f32 and stored bf16 (default scale
    1/sqrt(fan_in), fan_in = shape[0]); ``lead`` prepends stacking axes.

    The stack is drawn in one call and scaled in place, so its f32
    transient is one copy of the stack (15.6 GB for gemma2-27b's stacked
    FFN weights), not two."""
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn((*lead, *shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return w.mul_(scale).to(torch.bfloat16)
