"""Mixture-of-Experts FFN: a top-k f32 router and grouped capacity dispatch.

The JAX package's ``models/moe.py`` semantics: tokens are folded into
routing groups of ``min(S, group_size)`` (the last group zero-padded; its
padded tokens route like any other), each token picks the experts whose
router logit reaches its k-th largest (a threshold: a tie selects more
than k), the gates are the softmax renormalised over the picked experts,
and each expert takes at most ``capacity = max(1, int(capacity_factor · s
· k / e))`` tokens of a group, in token order (a cumsum over the group):
later tokens are dropped.  Optional shared experts add a dense SwiGLU of
width ``n_shared_experts · d_ff_expert``; the Switch load-balancing loss
comes back beside the output.

The reference dispatches and combines with one-hot einsums over an
(B, S, E, C) tensor.  Here the dispatch is index-based: each (group,
expert, capacity slot) gathers its token (or a zero row), the experts run
as one ``torch.bmm`` over the expert axis, and each token gathers its
experts' rows back and weights them.  A dispatch copies values exactly,
and a combine of two live terms rounds once in f32 whatever the order, so
:func:`moe_ffn` equals :func:`moe_ffn_onehot` (the reference's einsums,
kept for the tests) bit for bit.  No shape depends on the data (no
``nonzero``, no boolean indexing, no host sync), so a captured decode step
can run it; at decode (S = 1) the capacity is 1 and no token is dropped.
The JAX package runs these products outside any Pallas kernel, and so
does the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import init_dense, matmul, silu
from repro_torch.sharding.ctx import (constrain, logical_axis_size,
                                      replicated, settled)


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             lead: tuple = ()) -> dict:
    """Random MoE params (the router f32, the experts bf16), with ``lead``
    stacking axes."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    router = torch.randn((*lead, d_model, e), generator=generator,
                         device=generator.device, dtype=torch.float32)
    params = {
        "router": router.mul_(d_model ** -0.5),
        "w_gate": init_dense(generator, (e, d_model, f),
                             scale=d_model ** -0.5, lead=lead),
        "w_up": init_dense(generator, (e, d_model, f), scale=d_model ** -0.5,
                           lead=lead),
        "w_down": init_dense(generator, (e, f, d_model), scale=f ** -0.5,
                             lead=lead),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        params["shared"] = {
            "w_gate": init_dense(generator, (d_model, fs), lead=lead),
            "w_up": init_dense(generator, (d_model, fs), lead=lead),
            "w_down": init_dense(generator, (fs, d_model), lead=lead)}
    return params


def _groups(x: torch.Tensor, cfg: MoEConfig):
    """x (B, S, d) zero-padded to whole routing groups and folded into
    (B · n_groups, gsz, d); returns it with ``gsz``."""
    b0, s0, d = x.shape
    gsz = min(s0, cfg.group_size)
    pad = (-s0) % gsz
    if pad:
        x = torch.cat([x, x.new_zeros((b0, pad, d))], dim=1)
    # The gradient comes back split over the model axis too (the expert
    # path's layout), more ways than the batch has rows, which DTensor
    # cannot fold back into (B, S, d): settled to the forward's layout.
    return settled(x.reshape(-1, gsz, d)), gsz


def route(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """Routing of grouped tokens x (G, s, d): ``(probs, mask, gates, pos,
    in_cap, capacity)`` — the router's softmax, the threshold top-k mask,
    the renormalised gates, each token's position in each expert's buffer
    and whether it fits (all (G, s, E)), and the capacity."""
    s, e, k = x.shape[1], cfg.n_experts, cfg.top_k
    capacity = max(1, int(cfg.capacity_factor * s * k / e))
    logits = x.to(torch.float32) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    # A threshold on the k-th largest logit, as the reference's _topk_mask
    # (a tie selects more than k experts), never topk's indices.
    mask = logits >= torch.topk(logits, k, dim=-1).values[..., -1:]
    gates = torch.where(mask, probs, 0.0)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    in_cap = mask & (pos < capacity)
    return probs, mask, gates, pos, in_cap, capacity


def _experts(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its buffer: xe (G, E, C, d) → (G, E, C, d),
    one ``torch.bmm`` over the expert axis per product."""
    g, e, c, d = xe.shape
    ep = e % logical_axis_size("tp") == 0
    spec_f = ("tp", None, None) if ep else (None, None, "tp")
    xs = xe.permute(1, 0, 2, 3).reshape(e, g * c, d)
    gate = constrain(silu(torch.bmm(xs, params["w_gate"])), *spec_f)
    up = constrain(torch.bmm(xs, params["w_up"]), *spec_f)
    ye = matmul(gate * up, params["w_down"])
    return ye.reshape(e, g, c, d).permute(1, 0, 2, 3)


def _aux_loss(probs: torch.Tensor, mask: torch.Tensor,
              cfg: MoEConfig) -> torch.Tensor:
    """Switch load balancing: E · Σ_e f_e · p_e / k over every routed token
    (the padding included, as the reference counts it)."""
    frac_tokens = mask.to(torch.float32).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return cfg.n_experts * (frac_tokens * frac_probs).sum() / cfg.top_k


def _shared(params: dict, x: torch.Tensor) -> torch.Tensor:
    sh = params["shared"]
    gs = constrain(silu(x @ sh["w_gate"]) * (x @ sh["w_up"]), "dp", None, "tp")
    return matmul(gs, sh["w_down"])


def moe_ffn(params: dict, x: torch.Tensor,
            cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on x (B, S, d) → (out (B, S, d) in x's dtype, the f32
    aux loss), index-based dispatch (see the module docstring)."""
    b0, s0, d = x.shape
    # Routing needs whole groups: gather a sequence-sharded stream once.
    x = constrain(x, "dp", None, None)
    xg, gsz = _groups(x, cfg)
    g, s, e = xg.shape[0], gsz, cfg.n_experts
    probs, mask, gates, pos, in_cap, capacity = route(params, xg, cfg)
    slots = e * capacity
    expert = torch.arange(e, device=x.device)
    # (G, s, E): each routed token's flat (expert, slot), or the spare
    # column ``slots`` where it is not routed or does not fit.
    flat = torch.where(in_cap,
                       expert * capacity + pos.clamp(max=capacity - 1), slots)
    # On a mesh the dispatch indices are gathered whole (G·s·E int64s):
    # the scatter below builds a plain index table from them.
    flat = replicated(flat)
    # Each (expert, slot) names its token, or the zero row s; only the
    # spare column takes duplicate writes, and it is dropped.
    src = torch.full((g, slots + 1), s, dtype=torch.int64, device=x.device)
    tok = torch.arange(s, device=x.device)[None, :, None].expand(g, s, e)
    src.scatter_(1, flat.reshape(g, s * e), tok.reshape(g, s * e))
    xz = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    xe = torch.gather(xz, 1, src[:, :slots, None].expand(g, slots, d))
    ye = _experts(params, xe.reshape(g, e, capacity, d))
    yz = torch.cat([ye.reshape(g, slots, d), ye.new_zeros((g, 1, d))], dim=1)
    back = torch.gather(yz, 1, flat.reshape(g, s * e, 1).expand(g, s * e, d))
    w = gates.to(x.dtype).to(torch.float32)
    out = (back.reshape(g, s, e, d).to(torch.float32)
           * w[..., None]).sum(dim=2).to(x.dtype)
    if "shared" in params:
        out = out + _shared(params, xg)
    aux = _aux_loss(probs, mask, cfg)
    return out.reshape(b0, -1, d)[:, :s0], aux


def moe_ffn_onehot(params: dict, x: torch.Tensor,
                   cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the reference's one-hot dispatch and combine
    einsums over a (G, s, E, C) tensor; the experts as in :func:`moe_ffn`."""
    b0, s0, d = x.shape
    xg, gsz = _groups(x, cfg)
    probs, mask, gates, pos, in_cap, capacity = route(params, xg, cfg)
    iota = torch.arange(capacity, device=x.device)
    dispatch = (in_cap[..., None]
                & (iota == torch.where(in_cap, pos, 0)[..., None])).to(x.dtype)
    combine = dispatch * gates.to(x.dtype)[..., None]
    xe = torch.einsum("gsd,gsec->gecd", xg, dispatch)
    ye = _experts(params, xe)
    out = torch.einsum("gecd,gsec->gsd", ye, combine)
    if "shared" in params:
        out = out + _shared(params, xg)
    aux = _aux_loss(probs, mask, cfg)
    return out.reshape(b0, -1, d)[:, :s0], aux
