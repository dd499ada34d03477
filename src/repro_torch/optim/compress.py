"""Symmetric integer quantization helpers and int8 gradient compression.

Two consumers share the symmetric-scale construction:

* **Gradient compression** (:func:`compressed_psum`): per-tensor int8
  scales for a bandwidth-bound data-parallel all-reduce, with an
  error-feedback buffer carrying the residual into the next step (EF-SGD).
* **Quantized sketch-head storage** (``core.sketch_lm_head.quantize_head``):
  per-*row* int8/int4 scales over the (L, R, V) count arrays.
  :func:`quantize_symmetric` is the shared form: the amax over ``axis``,
  all-zero slices guarded so no scale is 0, inf or nan.

Own copy of the JAX package's ``optim/compress.py``, the same arithmetic
(round half to even in both).  ``compressed_psum`` runs over a
``torch.distributed`` process group where the JAX package runs inside
``shard_map`` over a named axis.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def quantize_symmetric(x: torch.Tensor, *, bits: int = 8,
                       axis: Optional[Union[int, Tuple[int, ...]]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric signed quantization with per-``axis``-slice scales.

    Returns ``(q, scale)``: ``q`` int8 in [-qmax, qmax] (qmax = 2^(bits-1)-1)
    and f32 ``scale`` with the ``axis`` dims squeezed out, ``q·scale ≈ x``.
    All-zero slices get scale ``1/qmax`` (never 0, so no inf/nan).
    """
    qmax = float(2 ** (bits - 1) - 1)
    ax = x.to(torch.float32)
    if axis is None:
        amax = ax.abs().amax()
    else:
        amax = ax.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / qmax
    q = torch.clamp(torch.round(ax / scale), -qmax, qmax).to(torch.int8)
    if axis is not None:
        scale = scale.squeeze(axis)
    return q, scale.to(torch.float32)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: ``(q, scale)``."""
    amax = x.abs().amax() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grad_leaf(g: torch.Tensor, err: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``g + err`` (the error feedback): ``(q, scale,
    new_err)``."""
    target = g.to(torch.float32) + err
    q, scale = quantize_int8(target)
    new_err = target - dequantize_int8(q, scale)
    return q, scale, new_err


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def compressed_psum(tree, err_tree, group=None):
    """Error-feedback int8 mean over the ranks of ``group`` (the default
    group when None), leaf by leaf: ``(mean_tree, new_err_tree)``.

    Per leaf: one ``all_reduce(MAX)`` agrees on the ranks' largest local
    scale, each rank quantizes ``g + err`` against it, the int8 payload is
    summed as int32 by ``all_reduce(SUM)`` (exactly: the sum of int8
    values), and ``mean = sum · scale / n``; ``new_err`` is what the
    rank's quantization dropped.  The JAX package's arithmetic, bit for
    bit.
    """
    import torch.distributed as dist

    n = dist.get_world_size(group)

    def one(g, e):
        target = g.to(torch.float32) + e
        local_scale = target.abs().amax() / 127.0 + 1e-12
        smax = local_scale.clone()
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(target / smax), -127, 127).to(torch.int8)
        new_e = target - q.to(torch.float32) * smax
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        mean = summed.to(torch.float32) * smax / n
        return mean, new_e

    pairs = _map(one, tree, err_tree)
    is_pair = lambda x: isinstance(x, tuple) and len(x) == 2 and all(
        isinstance(t, torch.Tensor) for t in x)

    def pick(node, i):
        if is_pair(node):
            return node[i]
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return type(node)(pick(v, i) for v in node)

    return pick(pairs, 0), pick(pairs, 1)


def init_error_feedback(params):
    """Zero f32 error-feedback buffers shaped like ``params``."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
