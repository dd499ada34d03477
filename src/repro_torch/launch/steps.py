"""Training and serving steps: one optimizer step, the bulk prefill and
one decode step through a head.

``train_step`` is the JAX package's: ``lm_loss`` and its grads over the
batch (accumulated over ``grad_accum`` microbatches), then ``adamw_update``
(in place on the optimizer state and the params).  ``opt_config_for`` is
its default optimizer config of an arch.

``serve_step`` never writes into the cache it is given; its in-place twin
``serve_step_`` consumes the cache and writes the step into it (the decode
loops of ``generate``, the engine and ``launch/decode_loop.py`` run it),
and so does ``prefill_step_``, the prefill into a zeroed cache.  Each
takes ``encoder_states`` (B, T, d), what an arch's ``xattn`` layers
attend to.

``abstract_params``, ``abstract_opt_state``, ``abstract_cache`` and
``input_specs`` are the JAX package's ``jax.eval_shape`` inputs of the dry
run (``launch/dryrun.py``): fake tensors (``FakeTensorMode``) of the
shapes and dtypes a step takes, allocating nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models.config import ModelConfig, param_count
from repro_torch.models.layers import softcap
from repro_torch.sharding.ctx import active_mesh, is_dtensor, replicated
from repro_torch.models.model import (backbone, decode_step, decode_step_,
                                      dense_logits, dense_verify_logits,
                                      final_hidden, init_decode_cache,
                                      init_model, lm_loss, mask_cache_update)
from repro_torch.optim.adamw import (AdamWState, OptimizerConfig,
                                     adamw_update, init_adamw, tree_leaves,
                                     tree_map)


def opt_config_for(cfg: ModelConfig, **kw) -> OptimizerConfig:
    """The default optimizer config of an arch: above 100 B params lean
    state (bf16 moments, no master) and 2 microbatches a step, as the
    reference picks them."""
    big = param_count(cfg) > 100e9
    kw.setdefault("grad_accum", 2 if big else 1)
    return OptimizerConfig(lean=big, **kw)


def _like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _microbatch(x: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    """Microbatch ``i`` of ``accum`` along x's first axis: its i-th block
    of rows; a DTensor's from each rank's own rows (its placements kept)."""
    if not is_dtensor(x):
        m = x.shape[0] // accum
        return x[i * m:(i + 1) * m]
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    m = local.shape[0] // accum
    return DTensor.from_local(local[i * m:(i + 1) * m], x.device_mesh,
                              x.placements, run_check=False)


def loss_and_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   opt_cfg: OptimizerConfig):
    """``(loss, {"ce", "aux"}, grads)`` of ``lm_loss`` over ``batch``
    (tokens, labels[, encoder_states]); grads in the params' dtypes.

    With ``opt_cfg.grad_accum > 1`` the batch splits along its first axis
    into that many microbatches, run one after the other; their grads, loss
    and parts are summed in f32, each divided by the count first, and the
    summed grads cast to the params' dtypes, as the reference's scan
    does.  On a mesh each rank splits its own rows (:func:`_microbatch`),
    so every microbatch keeps every rank busy and no row moves.  The
    params' leaves are set to require grad (in place)."""
    leaves = tree_leaves(params)
    for t in leaves:
        if not t.requires_grad:
            t.requires_grad_(True)

    def one(mb):
        with torch.enable_grad():
            loss, parts = lm_loss(params, mb["tokens"], mb["labels"], cfg,
                                  encoder_states=mb.get("encoder_states"))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, leaves)]
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    accum = opt_cfg.grad_accum
    if accum == 1:
        loss, parts, grads = one(batch)
        return loss, parts, _like(params, grads)
    n = next(iter(batch.values())).shape[0]
    if n % accum:
        raise ValueError(f"batch of {n} rows does not split into {accum} "
                         f"microbatches")
    dev = leaves[0].device
    zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)
    gacc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
    lacc, pacc = zero(), {"ce": zero(), "aux": zero()}
    for i in range(accum):
        mb = {k: _microbatch(v, i, accum) for k, v in batch.items()}
        loss, parts, grads = one(mb)
        for a, g in zip(gacc, grads):
            a.add_(g / accum)
        lacc = lacc + loss / accum
        pacc = {k: pacc[k] + parts[k] / accum for k in pacc}
        del grads
    return lacc, pacc, _like(params, [a.to(t.dtype)
                                      for a, t in zip(gacc, leaves)])


def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, opt_cfg: OptimizerConfig):
    """One optimizer step: ``(params, opt_state, metrics)`` with ``loss``,
    ``ce``, ``aux``, ``grad_norm`` and ``lr`` as 0-d device tensors (no
    host sync).  The params and the state's moments and master are
    updated in place (the reference donates them) and returned."""
    loss, parts, grads = loss_and_grads(params, batch, cfg, opt_cfg)
    params, opt_state, opt_metrics = adamw_update(grads, opt_state, opt_cfg,
                                                  params=params)
    return params, opt_state, {"loss": loss, **parts, **opt_metrics}


def place_cache(cache: dict, mesh, batch_size: Optional[int] = None,
                paged: bool = False) -> dict:
    """``cache`` (a decode cache, or with ``paged`` a page-arena tree) as
    DTensors on ``mesh`` by ``cache_shardings`` (``page_pool_shardings``);
    ``cache`` itself without a mesh."""
    if mesh is None:
        return cache
    from repro_torch.launch.mesh import distribute_tree
    from repro_torch.sharding.rules import cache_shardings, page_pool_shardings

    specs = (page_pool_shardings(cache, mesh) if paged
             else cache_shardings(cache, mesh, batch_size))
    return distribute_tree(cache, specs, mesh)


def _constrain_cache(cache: dict) -> dict:
    """Pin a decode cache to its per-leaf mesh layout inside an active
    ``activation_sharding`` context (the JAX package's ``_constrain_cache``):
    every DTensor leaf redistributed to its ``cache_shardings`` placements,
    so prefill, decode and the slot ops keep the cache's layout step over
    step.  A no-op outside a context."""
    mesh = active_mesh()
    if mesh is None:
        return cache
    from repro_torch.launch.mesh import distribute_tree
    from repro_torch.sharding.rules import cache_shardings

    return distribute_tree(cache, cache_shardings(cache, mesh), mesh)


def prefill_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 cache: Optional[dict] = None,
                 encoder_states: Optional[torch.Tensor] = None):
    """The whole (B, P) prompt in one forward pass: the last position's
    logits (B, V) through the dense head.  With ``cache`` (the serving
    prefill) it fills the cache and returns ``(logits, filled cache)``;
    without one (the JAX package's cacheless form, the dry run's prefill)
    the logits alone.  Only the last position is unembedded (and
    softcapped): the (B, P, V) logits of the other positions are never
    made."""
    x, new_cache = backbone(params, tokens, cfg, cache=cache, cache_pos=0,
                            encoder_states=encoder_states)
    h = final_hidden(params, x, cfg)
    logits = replicated(dense_logits(params, h[:, -1], cfg))
    if cache is None:
        return logits
    return logits, _constrain_cache(new_cache)


def prefill_step_(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  cache: dict, encoder_states: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """In-place twin of :func:`prefill_step`: ``cache`` must be zero (a
    fresh cache, or one zeroed in place); each layer's rows are written
    into it, and it is returned with the same logits.  No second cache is
    made: beside ``cache`` only one layer's new rows are live at a time."""
    x, cache = backbone(params, tokens, cfg, cache=cache, cache_pos=0,
                        in_place=True, encoder_states=encoder_states)
    h = final_hidden(params, x, cfg)
    return replicated(dense_logits(params, h[:, -1], cfg)), cache


def serve_step(params: dict, cache: dict, tokens: torch.Tensor,
               cfg: ModelConfig, head=None,
               active: Optional[torch.Tensor] = None, *,
               pos: Optional[torch.Tensor] = None, head_params=None,
               encoder_states: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, dict]:
    """One decode step for the newest tokens (B, 1) → (logits (B, V), cache).

    A head with ``needs_hidden`` (``SketchHead``) replaces the dense
    unembed: the backbone returns the final hidden, the head turns it into
    logits, then ``final_logit_softcap`` applies.  ``head_params``
    overrides the head's own params (the per-tenant engine passes the
    ``HeadCache`` bank and slot binding here each tick).  ``active`` (B,)
    bool keeps the cache rows of inactive sequences unchanged.  ``pos``
    is the number of tokens already cached (an int, or (B,) per slot); the
    attention kinds need it, rwkv's recurrent state does not.
    """
    if head is None or not head.needs_hidden:
        logits, new_cache = decode_step(params, cache, tokens, cfg,
                                        cache_pos=pos,
                                        encoder_states=encoder_states)
    else:
        hidden, new_cache = decode_step(params, cache, tokens, cfg,
                                        cache_pos=pos, return_hidden=True,
                                        encoder_states=encoder_states)
        logits = head.apply(head.params if head_params is None
                              else head_params, hidden)
        if cfg.final_logit_softcap:
            logits = softcap(logits, cfg.final_logit_softcap)
    if active is not None:
        new_cache = mask_cache_update(cache, new_cache, active)
    return replicated(logits), _constrain_cache(new_cache)


def serve_step_(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, head=None,
                active: Optional[torch.Tensor] = None, *, pos=None,
                head_params=None, return_hidden: bool = False,
                encoder_states: Optional[torch.Tensor] = None):
    """In-place twin of :func:`serve_step`: ``cache`` is consumed, the step
    written into it (inactive rows unchanged), and returned with the
    (B, V) logits, which equal ``serve_step``'s bit for bit.  ``pos`` may
    be an int, a 0-d tensor or a (B,) tensor (see ``decode_step_``).

    ``return_hidden=True`` also returns the (B, d) f32 final hidden, the
    input of a speculative verify, as a third element; the dense head then
    takes its logits from that hidden through ``dense_verify_logits``, bit
    for bit the unembed it runs otherwise."""
    if (head is None or not head.needs_hidden) and not return_hidden:
        logits, cache = decode_step_(params, cache, tokens, cfg,
                                     cache_pos=pos, active=active,
                                     encoder_states=encoder_states)
        return replicated(logits), cache
    hidden, cache = decode_step_(params, cache, tokens, cfg, cache_pos=pos,
                                 return_hidden=True, active=active,
                                 encoder_states=encoder_states)
    if head is None or not head.needs_hidden:
        logits = dense_verify_logits(params, hidden, cfg)
    else:
        logits = head.apply(head.params if head_params is None
                              else head_params, hidden)
        if cfg.final_logit_softcap:
            logits = softcap(logits, cfg.final_logit_softcap)
    logits = replicated(logits)
    return (logits, cache, hidden) if return_hidden else (logits, cache)


# --------------------------------------------------------------------------
# abstract inputs
# --------------------------------------------------------------------------

def _fake_mode():
    """The active ``FakeTensorMode``, or a new one: every abstract input
    of one dry-run cell must come from the mode its trace runs in."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    return detect_fake_mode() or FakeTensorMode()


def abstract_params(cfg: ModelConfig, device="cuda") -> dict:
    """``init_model``'s tree as fake tensors on ``device``: the same
    shapes and dtypes, nothing drawn."""
    with _fake_mode():
        params = init_model(cfg, torch.Generator())
        return tree_map(lambda t: torch.empty_like(t, device=device), params)


def abstract_opt_state(cfg: ModelConfig, lean: bool = False,
                       device="cuda") -> AdamWState:
    """``init_adamw``'s state of :func:`abstract_params`, fake."""
    with _fake_mode():
        return init_adamw(abstract_params(cfg, device), lean=lean)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   device="cuda") -> dict:
    """``init_decode_cache``'s tree, fake."""
    with _fake_mode():
        return init_decode_cache(cfg, batch, max_seq, device=device)


def input_specs(arch: str, shape: str, *, smoke: bool = False,
                device="cuda") -> Dict[str, Any]:
    """Fake inputs of one (arch × shape) dry-run cell (the JAX package's
    ShapeDtypeStructs): ``kind`` (train, prefill or decode), ``cfg``,
    ``seq``, ``batch`` and what that step takes: ``batch_inputs`` (tokens
    and labels (B, S) int32, with ``encoder_states``) for a train step;
    ``tokens`` (B, S) and ``encoder_states`` (B, T, d) bf16 or None for a
    prefill; ``tokens`` (B, 1), ``pos`` (a 0-d int32), ``cache`` (a
    decode cache of ``seq`` positions) and ``encoder_states`` for a
    decode step."""
    cfg = get_config(arch, smoke=smoke)
    seq, batch, kind = SHAPES[shape]
    out: Dict[str, Any] = {"kind": kind, "cfg": cfg, "seq": seq,
                           "batch": batch}
    with _fake_mode():
        i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=device)
        enc = (torch.empty((batch, cfg.n_encoder_tokens, cfg.d_model),
                           dtype=torch.bfloat16, device=device)
               if cfg.n_encoder_tokens else None)
        if kind == "train":
            out["batch_inputs"] = {"tokens": i32(batch, seq),
                                   "labels": i32(batch, seq)}
            if enc is not None:
                out["batch_inputs"]["encoder_states"] = enc
        elif kind == "prefill":
            out["tokens"] = i32(batch, seq)
            out["encoder_states"] = enc
        else:           # decode: one new token against a cache of seq
            out["tokens"] = i32(batch, 1)
            out["pos"] = i32()
            out["cache"] = abstract_cache(cfg, batch, seq, device)
            out["encoder_states"] = enc
    return out
