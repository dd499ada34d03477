"""RWKV-6 (Finch) block: time-mix with data-dependent decay + channel-mix.

The WKV-6 recurrence per head (state ``S ∈ R^{dk×dv}``)::

    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

with the data-dependent decay ``w_t = exp(−exp(w0 + LoRA(x_t)))``.  It runs
in the chunked linear-attention form of the JAX package (chunks of
``_CHUNK`` tokens, dense products against cumulative decays kept in log
space in f32, a loop carrying the state across chunks), with the same
bf16/f32 casts at the same places, so the two agree to bf16 rounding.
The JAX package has no Pallas kernel here and neither has the port.

Parameters of one layer are a dict of tensors; ``init_rwkv`` can stack
``n`` layers on a leading axis, as the JAX package's periods do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import operand_mesh
from repro_torch.kernels.work import chunk_loop
from repro_torch.models.layers import init_dense, matmul, sigmoid, silu
from repro_torch.sharding.local import on_local_blocks

_CHUNK = 32
_HEAD_DIM = 64
_DECAY_LORA = 64


class RWKVCache(NamedTuple):
    tm_prev: torch.Tensor  # (B, d) last token entering time-mix
    cm_prev: torch.Tensor  # (B, d) last token entering channel-mix
    state: torch.Tensor    # (B, H, dk, dv) WKV state


def init_rwkv(generator: torch.Generator, d_model: int, d_ff: int,
              lead: tuple = ()) -> dict:
    """Random layer params (bf16 projections, f32 mixing vectors), with
    ``lead`` stacking axes."""
    h = d_model // _HEAD_DIM
    dev = generator.device

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=dev)

    lora_b = torch.randn((*lead, _DECAY_LORA, d_model), generator=generator,
                         device=dev, dtype=torch.float32)
    return {
        # time-mix
        "mu": full((5, d_model), 0.5),        # r,k,v,w,g shift mix
        "w_r": init_dense(generator, (d_model, d_model), lead=lead),
        "w_k": init_dense(generator, (d_model, d_model), lead=lead),
        "w_v": init_dense(generator, (d_model, d_model), lead=lead),
        "w_g": init_dense(generator, (d_model, d_model), lead=lead),
        "w_o": init_dense(generator, (d_model, d_model), lead=lead),
        "w0": full((d_model,), -6.0),
        "w_lora_a": init_dense(generator, (d_model, _DECAY_LORA), lead=lead),
        "w_lora_b": (lora_b * 0.01).to(torch.bfloat16),
        "u_bonus": full((h, _HEAD_DIM), 0.0),
        "ln_x": full((d_model,), 0.0),
        # channel-mix
        "mu_cm": full((2, d_model), 0.5),
        "cm_k": init_dense(generator, (d_model, d_ff), lead=lead),
        "cm_v": init_dense(generator, (d_ff, d_model), lead=lead),
        "cm_r": init_dense(generator, (d_model, d_model), lead=lead),
    }


def init_rwkv_cache(batch: int, d_model: int, lead: tuple = (),
                    device="cuda", dtype=torch.float32) -> RWKVCache:
    h = d_model // _HEAD_DIM
    zeros = lambda *s: torch.zeros((*lead, *s), dtype=dtype, device=device)
    return RWKVCache(zeros(batch, d_model), zeros(batch, d_model),
                     zeros(batch, h, _HEAD_DIM, _HEAD_DIM))


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Shift the sequence right by one; position 0 sees ``prev`` (or 0)."""
    first = (prev[:, None, :] if prev is not None
             else torch.zeros_like(x[:, :1]))
    return torch.cat([first.to(x.dtype), x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, logw, u, state0):
    """Chunked WKV-6. r,k,v: (B,S,H,dk); logw: (B,S,H,dk) (≤0); u: (H,dk).

    Returns y: (B,S,H,dv) and the final state (B,H,dk,dv), all f32.  On a
    mesh each rank runs its local batch rows and heads.
    """
    if operand_mesh(r, k, v, logw, state0) is not None:
        return on_local_blocks(_wkv_chunked, (r, k, v, logw, u, state0),
                               ("bshd",) * 4 + ("hd", "bhde"),
                               ("bshd", "bhde"))
    b, s, h, dk = r.shape
    chunk = min(s, _CHUNK)
    pad = (-s) % chunk
    if pad:
        z = lambda t: F.pad(t, (0, 0, 0, 0, 0, pad))
        r, k, v, logw = z(r), z(k), z(v), z(logw)
    n_chunks = r.shape[1] // chunk
    resh = lambda t: t.reshape(b, n_chunks, chunk, h, dk).to(torch.float32)
    rc, kc, vc, lwc = resh(r), resh(k), resh(v), resh(logw)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)

    def chunk_step(c, state):
        rb, kb, vb, lwb = rc[:, c], kc[:, c], vc[:, c], lwc[:, c]  # (B,c,H,dk)
        # Cumulative log-decay INCLUSIVE of step t: L_t = Σ_{s≤t} logw_s.
        lcum = torch.cumsum(lwb, dim=1)
        l_prev = lcum - lwb                      # exclusive: Σ_{s<t}
        l_total = lcum[:, -1]                    # (B,H,dk)

        r_dec = rb * torch.exp(l_prev)           # r̃_t = r_t ⊙ W_{t-1}
        k_inc = kb * torch.exp(l_total[:, None] - lcum)  # k̃_s = k_s ⊙ W_c/W_s

        # Inter-chunk: y_inter_t = r̃_t · S_in.
        y_inter = torch.einsum("bchk,bhkv->bchv", r_dec, state)
        # Intra-chunk (strictly past): scores_{t,s} = r_t·W_{t-1}/W_s·k_s.
        k_rel = kb * torch.exp(-lcum)
        scores = torch.einsum("bchk,bshk->bhcs", r_dec, k_rel)
        scores = torch.where(mask, scores, torch.zeros((), device=r.device))
        y_intra = torch.einsum("bhcs,bshv->bchv", scores, vb)
        # Diagonal bonus term: r_t · diag(u) k_tᵀ v_t.
        bonus = torch.einsum("bchk,hk,bchk->bch", rb, u, kb)
        y_diag = bonus[..., None] * vb
        # State update: S_out = diag(W_c) S_in + Σ_s diag(W_c/W_s) k_sᵀ v_s.
        state = (torch.exp(l_total)[..., None] * state
                 + torch.einsum("bshk,bshv->bhkv", k_inc, vb))
        return y_inter + y_intra + y_diag, state

    ys, state = chunk_loop(n_chunks, chunk_step, state0.to(torch.float32))
    y = torch.cat(ys, dim=1)[:, :s]
    return y, state


def rwkv_time_mix(params: dict, x: torch.Tensor, *,
                  prev: Optional[torch.Tensor] = None,
                  state0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """WKV-6 time-mix of pre-normed x (B, S, d). Returns (delta, last
    token, new state)."""
    b, s, d = x.shape
    h = d // _HEAD_DIM
    shifted = _token_shift(x, prev)
    mu = params["mu"][:, None, None, :]           # (5,1,1,d) f32
    x32, sh32 = x.to(torch.float32), shifted.to(torch.float32)
    xr, xk, xv, xw, xg = ((x32 * mu[i] + sh32 * (1.0 - mu[i])).to(x.dtype)
                          for i in range(5))

    to_heads = lambda t: t.reshape(b, s, h, _HEAD_DIM)
    r = to_heads(xr @ params["w_r"])
    k = to_heads(xk @ params["w_k"])
    v = to_heads(xv @ params["w_v"])
    xg = xg @ params["w_g"]
    g = silu(xg)                               # as the JAX package rounds it

    # Finch data-dependent decay: logw = −exp(w0 + LoRA(x_w)) ∈ (−∞, 0).
    lora = torch.tanh(xw @ params["w_lora_a"]) @ params["w_lora_b"]
    logw = to_heads(-torch.exp(params["w0"] + lora.to(torch.float32)))

    if state0 is None:
        state0 = torch.zeros((b, h, _HEAD_DIM, _HEAD_DIM),
                             dtype=torch.float32, device=x.device)
    y, state = _wkv_chunked(r.to(torch.float32), k.to(torch.float32),
                            v.to(torch.float32), logw, params["u_bonus"],
                            state0)
    # GroupNorm over heads (ln_x), then gate and project.
    yh = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
        y.var(-1, unbiased=False, keepdim=True) + 1e-5)
    y = (yh.reshape(b, s, d) * (1.0 + params["ln_x"])).to(x.dtype)
    return matmul(y * g, params["w_o"]), x[:, -1], state


def rwkv_channel_mix(params: dict, x: torch.Tensor, *,
                     prev: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 channel-mix of pre-normed x. Returns (delta, last token)."""
    shifted = _token_shift(x, prev)
    mu_cm = params["mu_cm"][:, None, None, :]
    x32, sh32 = x.to(torch.float32), shifted.to(torch.float32)
    xk = (x32 * mu_cm[0] + sh32 * (1 - mu_cm[0])).to(x.dtype)
    xr = (x32 * mu_cm[1] + sh32 * (1 - mu_cm[1])).to(x.dtype)
    kk = torch.square(F.relu(xk @ params["cm_k"]))
    cm = matmul(kk, params["cm_v"])
    rr = sigmoid(xr @ params["cm_r"])
    return rr * cm, x[:, -1]
