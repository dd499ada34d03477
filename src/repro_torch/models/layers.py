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


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w: (..., d_in, d_out)).

    On a mesh where w is sharded on its contraction axis over a mesh dim
    of more than one rank, each rank multiplies its local blocks with an
    f32 result (:func:`_partial_product`), the partials are summed in f32
    and rounded to x's dtype once, as the one-device product rounds its
    f32 accumulator once (a sum of rounded partials would round twice).
    A mesh dim of one rank holds the whole product and needs no sum."""
    dims = _contraction_mesh_dims(w)
    if not dims:
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, nd, nw = w.device_mesh, x.dim(), w.dim()
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    # Per mesh dim: x's placement, the product's, and the placements of
    # the local blocks' gradients (a partial sum where the other operand
    # is sharded on a dim the gradient's product contracts).
    x_pl, y_pl, x_grad, w_grad = [], [], [], []
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        if i in dims:                                  # contraction
            x_pl.append(Shard(nd - 1))
            y_pl.append(Partial())
        elif wp.is_shard():                            # d_out, or a stacked dim
            d = wp.dim % nw
            x_pl.append(Replicate() if d == nw - 1 else Shard(d + nd - nw))
            y_pl.append(Shard(nd - 1 if d == nw - 1 else d + nd - nw))
        elif xp.is_shard() and xp.dim % nd < nd - 1:   # x's own batch dims
            x_pl.append(xp)
            y_pl.append(xp)
        else:
            x_pl.append(Replicate())
            y_pl.append(Replicate())
        x_grad.append(Partial() if wp.is_shard(nw - 1) else x_pl[-1])
        w_grad.append(Partial() if x_pl[-1].is_shard() and not wp.is_shard()
                      else wp)
    x = x.redistribute(mesh, x_pl)
    part = _partial_product(x.to_local(grad_placements=x_grad),
                            w.to_local(grad_placements=w_grad))
    shape = torch.Size([*torch.broadcast_shapes(x.shape[:-2], w.shape[:-2]),
                        x.shape[-2], w.shape[-1]])
    y = DTensor.from_local(part, mesh, y_pl, run_check=False, shape=shape,
                           stride=torch.empty(shape, device="meta").stride())
    return y.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in y_pl]).to(x.dtype)


def _contraction_mesh_dims(w: torch.Tensor) -> tuple:
    """The mesh dims of more than one rank that shard w's contraction
    axis (none for a plain tensor)."""
    placements = getattr(w, "placements", None)
    if placements is None:
        return ()
    dim = w.dim() - 2
    return tuple(i for i, p in enumerate(placements)
                 if p.is_shard(dim) and w.device_mesh.size(i) > 1)


def _partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of local bf16 blocks as f32.  On the card, outside
    autograd, the bf16 tensor cores' f32 accumulator is the result
    (``out_dtype``; no f32 copy of the weight block).  Otherwise the
    blocks are widened: to f64 on the CPU, whose f32 GEMM rounds a single
    row (a GEMV) differently from several, so that a row's partial is the
    same whatever the batch layout; to f32 for a CUDA product under
    autograd (``out_dtype`` has no derivative)."""
    if x.is_cuda and not (torch.is_grad_enabled()
                          and (x.requires_grad or w.requires_grad)):
        if w.dim() == 2:
            y = torch.mm(x.reshape(-1, x.shape[-1]), w,
                         out_dtype=torch.float32)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return torch.bmm(x, w, out_dtype=torch.float32)
    wide = torch.float64 if x.device.type == "cpu" else torch.float32
    return (x.to(wide) @ w.to(wide)).to(torch.float32)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: ``(silu(x·w_gate) ⊙ (x·w_up)) · w_down``; on a mesh the
    d_ff intermediate is pinned to TP shards (the Megatron pattern: one
    all-reduce, after w_down)."""
    from repro_torch.sharding.ctx import constrain

    g = constrain(silu(x @ w_gate), "dp", None, "tp")
    u = constrain(x @ w_up, "dp", None, "tp")
    return matmul(g * u, w_down)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Logit soft-capping: cap·tanh(x/cap)."""
    return cap * torch.tanh(x / cap)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens`` (an exact gather; a negative id
    counts from the end, as indexing does).  On a mesh the vocab-parallel
    lookup (DTensor's masked partial) is summed at once, and its gradient
    settled to the sum's layout: torch 2.11's DTensor can neither index
    with a batch split over two mesh dims nor turn a partial gradient back
    into the masked partial."""
    from repro_torch.sharding.ctx import is_dtensor, settled

    if not is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import Replicate

    x = torch.nn.functional.embedding(tokens.long() % table.shape[0], table)
    return settled(x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements]))


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
