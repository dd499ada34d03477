"""Mamba-1 selective SSM block (Jamba's recurrent mixer).

The selective scan ``h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t`` runs as the
JAX package's ``models/mamba.py`` evaluates it: time in chunks of
``_SCAN_CHUNK``, a loop carrying the f32 state across chunks, and within a
chunk the (decay, increment) pairs combined by the same tree as
``jax.lax.associative_scan`` (:func:`associative_scan`: pairs combined,
the half-length scan recursed, then the even positions fixed up), so the
f32 state takes the same roundings as far as ``exp`` and ``softplus``
agree.  Pad positions of the last chunk are identities for the state; the
carried state enters at the chunk's position 0.  A single token against a
cache takes the decode branch: one step of the recurrence.

The cache (``MambaCache``: the last ``d_conv - 1`` conv inputs and the
(d_inner, d_state) state) is f32 and one row a slot: it has no sequence
axis, so nothing of it is paged, and a speculative rollback restores it
from a snapshot.  The JAX package has no Pallas kernel here, and neither
has the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.work import chunk_loop
from repro_torch.models.config import MambaConfig
from repro_torch.models.layers import init_dense, matmul, silu

_SCAN_CHUNK = 256


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv - 1, d_inner) rolling conv inputs
    ssm: torch.Tensor    # (B, d_inner, d_state) recurrent state


def dt_rank(d_model: int, cfg: MambaConfig) -> int:
    return cfg.dt_rank or -(-d_model // 16)


def init_mamba(generator: torch.Generator, d_model: int, cfg: MambaConfig,
               lead: tuple = ()) -> dict:
    """Random layer params (bf16 projections; ``conv_b``, ``dt_bias``,
    ``a_log`` and ``d_skip`` f32), with ``lead`` stacking axes."""
    d_in = cfg.expand * d_model
    r = dt_rank(d_model, cfg)
    dev = generator.device

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=dev)

    a_log = torch.log(torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_proj": init_dense(generator, (d_model, 2 * d_in), lead=lead),
        "conv_w": init_dense(generator, (cfg.d_conv, d_in), lead=lead),
        "conv_b": full((d_in,), 0.0),
        "x_proj": init_dense(generator, (d_in, r + 2 * cfg.d_state),
                             lead=lead),
        "dt_proj": init_dense(generator, (r, d_in), lead=lead),
        "dt_bias": full((d_in,), 0.0),
        # A is -exp(a_log) (negative real); d_skip is a skip gain.
        "a_log": a_log.expand(*lead, d_in, cfg.d_state).contiguous(),
        "d_skip": full((d_in,), 1.0),
        "out_proj": init_dense(generator, (d_in, d_model), lead=lead),
    }


def init_mamba_cache(batch: int, d_model: int, cfg: MambaConfig,
                     lead: tuple = (), device="cuda",
                     dtype=torch.float32) -> MambaCache:
    d_in = cfg.expand * d_model
    zeros = lambda *s: torch.zeros((*lead, *s), dtype=dtype, device=device)
    return MambaCache(zeros(batch, cfg.d_conv - 1, d_in),
                      zeros(batch, d_in, cfg.d_state))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as it evaluates it, ``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _selective_params(params: dict, x_conv: torch.Tensor, d_state: int,
                      r: int):
    """The conv output (bf16) → (Δ, B_t, C_t), f32."""
    proj = matmul(x_conv, params["x_proj"]).to(torch.float32)
    dt, b_sel, c_sel = torch.split(proj, [r, d_state, d_state], dim=-1)
    dt = softplus(dt @ params["dt_proj"].to(torch.float32)
                  + params["dt_bias"])
    return dt, b_sel, c_sel


def _combine(left, right):
    (dl, il), (dr, ir) = left, right
    return dl * dr, il * dr + ir


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Positions 0, 2, ... from ``even`` and 1, 3, ... from ``odd``
    (along dim 1)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(decay: torch.Tensor, inc: torch.Tensor):
    """The inclusive scan of (decay, inc) pairs along dim 1 under
    ``(dl, il) ∘ (dr, ir) = (dl·dr, il·dr + ir)``, by the combining tree
    of ``jax.lax.associative_scan``."""
    n = decay.shape[1]
    if n < 2:
        return decay, inc
    od, oi = associative_scan(*_combine(
        (decay[:, 0:n - 1:2], inc[:, 0:n - 1:2]),
        (decay[:, 1::2], inc[:, 1::2])))
    if n % 2 == 0:
        od_, oi_ = od[:, :-1], oi[:, :-1]
    else:
        od_, oi_ = od, oi
    ed, ei = _combine((od_, oi_), (decay[:, 2::2], inc[:, 2::2]))
    ed = torch.cat([decay[:, :1], ed], dim=1)
    ei = torch.cat([inc[:, :1], ei], dim=1)
    return _interleave(ed, od), _interleave(ei, oi)


def mamba_block(params: dict, x: torch.Tensor, cfg: MambaConfig, *,
                cache: Optional[MambaCache] = None
                ) -> Tuple[torch.Tensor, Optional[MambaCache]]:
    """The mixer on x (B, S, d) (bf16) → (out (B, S, d), new cache or
    None).  A cache with S == 1 takes the decode branch; otherwise the
    chunked scan runs from the cache's state (zero without one)."""
    b, s, d_model = x.shape
    d_in = cfg.expand * d_model
    r = dt_rank(d_model, cfg)

    xz = x @ params["in_proj"]
    xs, z = xz[..., :d_in], xz[..., d_in:]

    # Depthwise causal conv over time.
    if cache is not None:
        conv_in = torch.cat([cache.conv.to(xs.dtype), xs], dim=1)
        new_conv = conv_in[:, -(cfg.d_conv - 1):].to(cache.conv.dtype)
    else:
        conv_in = torch.cat([xs.new_zeros((b, cfg.d_conv - 1, d_in)), xs],
                            dim=1)
        new_conv = None
    acc = conv_in[:, 0:s] * params["conv_w"][0]
    for i in range(1, cfg.d_conv):
        acc = acc + conv_in[:, i:i + s] * params["conv_w"][i]
    x_conv = silu(acc + params["conv_b"]).to(x.dtype)

    a = -torch.exp(params["a_log"])                    # (d_in, N)
    init_h = (cache.ssm.to(torch.float32) if cache is not None
              else torch.zeros((b, d_in, cfg.d_state), dtype=torch.float32,
                               device=x.device))

    if cache is not None and s == 1:
        dt, b_sel, c_sel = _selective_params(params, x_conv, cfg.d_state, r)
        decay = torch.exp(dt[:, 0, :, None] * a)
        inc = (dt[:, 0, :, None] * b_sel[:, 0, None, :]
               * x_conv.to(torch.float32)[:, 0, :, None])
        h = init_h * decay + inc
        y = torch.einsum("bin,bn->bi", h, c_sel[:, 0])[:, None, :]
    else:
        chunk = min(s, _SCAN_CHUNK)
        n_chunks = -(-s // chunk)

        def chunk_step(c, h):
            x_chunk = x_conv[:, c * chunk:(c + 1) * chunk]
            live = x_chunk.shape[1]
            if live < chunk:           # the last chunk's pad: zero inputs
                x_chunk = torch.cat([x_chunk, x_chunk.new_zeros(
                    (b, chunk - live, d_in))], dim=1)
            dt, b_sel, c_sel = _selective_params(params, x_chunk,
                                                 cfg.d_state, r)
            decay = torch.exp(dt[..., None] * a)               # (B,c,d_in,N)
            inc = (dt[..., None] * b_sel[:, :, None, :]
                   * x_chunk.to(torch.float32)[..., None])
            if live < chunk:
                # Pad positions are identities for the state: x = 0 kills
                # the increment, but dt > 0 would still decay it.
                valid = (torch.arange(chunk, device=x.device)
                         < live)[None, :, None, None]
                decay = torch.where(valid, decay, 1.0)
                inc = torch.where(valid, inc, 0.0)
            inc = torch.cat([inc[:, :1] + h[:, None] * decay[:, :1],
                             inc[:, 1:]], dim=1)
            _, states = associative_scan(decay, inc)
            return (torch.einsum("bsin,bsn->bsi", states, c_sel)
                    .to(x.dtype), states[:, -1])

        ys, h = chunk_loop(n_chunks, chunk_step, init_h)
        y = torch.cat(ys, dim=1)[:, :s].to(torch.float32)

    y = y + x_conv.to(torch.float32) * params["d_skip"]
    y = (y * silu(z.to(torch.float32))).to(x.dtype)
    out = matmul(y, params["out_proj"])
    new_cache = (MambaCache(new_conv, h.to(cache.ssm.dtype))
                 if cache is not None else None)
    return out, new_cache
