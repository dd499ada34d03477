"""Causal flash attention (the prefill's and the training forward's
attention): kernel wrappers, the autograd function, and plain versions.

``flash_attention`` runs the plain version for CPU tensors and launches
``csrc/flash_attn.cu`` for CUDA tensors (or raises);
``flash_attention.launches`` counts its launches.  Both take the JAX
layout, q (B, S, H, dh) and k, v (B, S, Hkv, dh), with query head h reading
KV head ``h // (H // Hkv)`` (``Hkv == H`` is the TPU kernel's own
signature).  Tiling is the kernel's business: there is no
``block_q``/``block_k``.  The kernel runs f32 inputs on the CUDA cores and
bf16 inputs on the tensor cores.

Under autograd (grad enabled and an input that requires it) the call goes
through ``_FlashAttention``: its forward is the same kernel with each
row's log-sum-exp written beside the output, and it saves q, k, v, the
output and that lse; its backward is ``flash_attention_bwd``, which
launches ``csrc/flash_attn_bwd.cu`` on the card
(``flash_attention_bwd.launches``) and runs ``flash_attention_bwd_ref`` on
the CPU.  A call with no grad (serving) takes the kernel alone and saves
nothing.  The backward, like the forward, runs bf16 inputs on the tensor
cores (a dK/dV kernel by key tile and a dQ kernel by query tile, bf16
wgmma on TMA-staged tiles, p and ds split into three exact bf16 terms;
held to ``parity.flash_attn_bwd_tol``'s tensor-core form) and f32 inputs
on the CUDA cores.

Fake CUDA tensors (``FakeTensorMode``: the dry run's shape propagation)
take the kernels' own checks but the pointer alignment (a fake tensor has
no address), get empty outputs of the kernels' shapes and dtypes, and
launch nothing.  Every call, launched or fake, reports its work
(``kernels/work.py``) to an active op analyzer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build, work
from repro_torch.kernels.common import check_operand, operand_mesh, stream_of
from repro_torch.sharding.local import on_local_blocks

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(q, k, v, window) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, dh), got {tuple(q.shape)}")
    b, s, h, dh = q.shape
    if k.dim() != 4 or tuple(k.shape[:2]) != (b, s) or k.shape[3] != dh:
        raise ValueError(f"k must be (B, S, Hkv, dh) = ({b}, {s}, Hkv, {dh}), "
                         f"got {tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} must match k {tuple(k.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"H={h} is not a multiple of Hkv={k.shape[2]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _scores_ref(q, k, window, softcap):
    """The plain version's f32 scores (B, Hkv, G, S, S), softcapped and
    masked with ``-1e30``, and the softcap's ``tanh(s / softcap)`` (None
    without one)."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    qg = (q.to(torch.float32) * dh ** -0.5).reshape(b, s, hkv, h // hkv, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    t = None
    if softcap:
        t = torch.tanh(scores / softcap)
        scores = softcap * t
    pos = torch.arange(s, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return torch.where(mask, scores, _NEG_INF), t


def _out_ref(probs, v, q):
    b, s, h, dh = q.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(b, s, h, dh).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version (the JAX package's ``flash_attention_ref`` with grouped
    KV heads): scores ``(q·dh^-0.5)·kᵀ`` in f32, the optional
    ``softcap·tanh(s/softcap)``, the causal (and window) mask as ``-1e30``,
    softmax and ``p·v`` in f32, cast to q's dtype."""
    _check_args(q, k, v, window)
    scores, _ = _scores_ref(q, k, window, softcap)
    return _out_ref(torch.softmax(scores, dim=-1), v, q)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """``(flash_attention_ref(...), lse)``: the same output bit for bit and
    each row's log-sum-exp of its masked scores, (B, H, S) f32 (the
    kernel's ``lse`` output)."""
    _check_args(q, k, v, window)
    scores, _ = _scores_ref(q, k, window, softcap)
    b, s, h, _ = q.shape
    lse = torch.logsumexp(scores, dim=-1).reshape(b, h, s)
    return _out_ref(torch.softmax(scores, dim=-1), v, q), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor, window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """Plain backward: ``(dq, dk, dv)`` of :func:`flash_attention` at
    ``(q, k, v)`` for the cotangent ``dout``, from the forward's ``out``
    and ``lse`` (B, H, S), by the explicit formulas in f32:
    ``p = exp(s_c − lse)`` (0 where masked), ``D = Σ_d dout·out``,
    ``dv = pᵀ·dout``, ``ds_c = p ∘ (dout·vᵀ − D)``, with a softcap
    ``ds = ds_c ∘ (1 − tanh²(s/softcap))``, ``dq = dh^-0.5 · ds·k`` and
    ``dk = dsᵀ·(q·dh^-0.5)``; dk and dv sum over each GQA group of query
    heads.  Each is cast to its input's dtype."""
    _check_args(q, k, v, window)
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    f32 = torch.float32
    scores, t = _scores_ref(q, k, window, softcap)
    p = torch.exp(scores - lse.reshape(b, hkv, g, s, 1).to(f32))
    do = dout.to(f32).reshape(b, s, hkv, g, dh)
    d_row = (do * out.to(f32).reshape(b, s, hkv, g, dh)).sum(-1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.to(f32))
    ds = p * (dp - d_row.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    qs = (q.to(f32) * dh ** -0.5).reshape(b, s, hkv, g, dh)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(f32)) * dh ** -0.5
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qs)
    return (dq.reshape(b, s, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("flash_attn").flash_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.library("flash_attn_bwd").flash_attn_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name, q, k, v, window):
    """Raise unless the kernels take these operands; returns the shape."""
    _check_args(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes f32 or bf16, got {q.dtype}")
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    if dh % 16 or not 16 <= dh <= 256:
        raise ValueError(f"the {name} kernel takes dh a multiple of 16 up to "
                         f"256, got {dh}")
    dev = q.device
    check_operand("q", q, dev, q.dtype, (b, s, h, dh))
    check_operand("k", k, dev, q.dtype, (b, s, hkv, dh))
    check_operand("v", v, dev, q.dtype, (b, s, hkv, dh))
    return b, s, h, hkv, dh


def _check_tma_aligned(name, *tensors) -> None:
    """The bf16 kernels load their operands with TMA, which needs
    16-byte-aligned data."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the {name} kernel's bf16 path loads its operands "
                         "with TMA, which needs 16-byte-aligned data")


def _forward(q, k, v, window, softcap, with_lse: bool):
    """The forward on the card (or the plain version on the CPU):
    ``(out, lse)``, lse (B, H, S) f32 only ``with_lse`` (else None)."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_lse_ref(q, k, v, window=window,
                                           softcap=softcap)
        return flash_attention_ref(q, k, v, window=window,
                                   softcap=softcap), None
    b, s, h, hkv, dh = _check_cuda("flash_attn", q, k, v, window)
    fake = is_fake(q)
    if q.dtype == torch.bfloat16 and not fake:
        _check_tma_aligned("flash_attn", q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    work.record("flash_attn", *work.flash_attn_work(
        b, s, h, hkv, dh, window, q.element_size(), with_lse))
    if fake:                  # shape propagation: nothing to launch
        return out, lse
    with torch.cuda.device(q.device):
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                         b, s, h, hkv, dh, dh ** -0.5, window or 0,
                         softcap or 0.0, _DTYPES[q.dtype], stream_of(q.device))
    flash_attention.launches += 1
    _build.check_launch("flash_attn", rc)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward kernel with its
    lse, the backward kernel (or the plain backward on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, window, softcap):
        out, lse = _forward(q, k, v, window, softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.softcap = window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         window=ctx.window,
                                         softcap=ctx.softcap)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Causal (+window, +softcap) attention → (B, S, H, dh) in q's dtype.

    Args:
      q: (B, S, H, dh) queries, f32 or bf16.
      k / v: (B, S, Hkv, dh) keys and values of q's dtype, H % Hkv == 0.
      window: sliding window (query q sees keys k with q - k < window), or
        None for full causal attention.
      softcap: the score softcap, or None (0 is none, as in JAX).

    On the card the kernel takes contiguous tensors with dh a multiple of 16
    up to 256 (bf16 also 16-byte-aligned data, as its TMA loads need), and
    raises on anything else.  Differentiable: with grad enabled and an
    input that requires it, the backward is ``flash_attention_bwd``.
    """
    _check_args(q, k, v, window)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if operand_mesh(q, k, v) is not None:
        return on_local_blocks(
            lambda ql, kl, vl: (flash_attention(ql, kl, vl, window=window,
                                                softcap=softcap),),
            (q, k, v), ("bshd",) * 3, ("bshd",))[0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, window, softcap)
    return _forward(q, k, v, window, softcap, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """``(out, lse)``: :func:`flash_attention`'s output (the same bits) and
    each row's log-sum-exp (B, H, S) f32, from one launch of the forward
    kernel (counted in ``flash_attention.launches``); no autograd."""
    _check_args(q, k, v, window)
    if operand_mesh(q, k, v) is not None:
        return on_local_blocks(
            lambda ql, kl, vl: _forward(ql, kl, vl, window, softcap,
                                        with_lse=True),
            (q, k, v), ("bshd",) * 3, ("bshd", "bhs"))
    return _forward(q, k, v, window, softcap, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """``(dq, dk, dv)`` of :func:`flash_attention` (see
    :func:`flash_attention_bwd_ref` for the formulas): the plain version
    for CPU tensors, ``csrc/flash_attn_bwd.cu`` for CUDA tensors (or
    raises): bf16 on the tensor cores (q, k, v and dout 16-byte-aligned,
    as their TMA loads need), f32 on the CUDA cores.  ``out`` and ``dout``
    have q's shape and dtype, ``lse`` is the forward's (B, H, S) f32."""
    if operand_mesh(q, k, v, out, dout, lse) is not None:
        return on_local_blocks(
            lambda *t: flash_attention_bwd(*t, window=window,
                                           softcap=softcap),
            (q, k, v, out, dout, lse), ("bshd",) * 5 + ("bhs",),
            ("bshd",) * 3)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, dout, lse, window=window,
                                       softcap=softcap)
    b, s, h, hkv, dh = _check_cuda("flash_attn_bwd", q, k, v, window)
    dev = q.device
    check_operand("out", out, dev, q.dtype, (b, s, h, dh))
    check_operand("dout", dout, dev, q.dtype, (b, s, h, dh))
    check_operand("lse", lse, dev, torch.float32, (b, h, s))
    fake = is_fake(q)
    if q.dtype == torch.bfloat16 and not fake:
        _check_tma_aligned("flash_attn_bwd", q, k, v, dout)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    d_row = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    n_bytes, ops, recomputed = work.flash_attn_bwd_work(
        b, s, h, hkv, dh, window, q.element_size())
    work.record("flash_attn_bwd", n_bytes, ops + recomputed)
    if fake:                  # shape propagation: nothing to launch
        return dq, dk, dv
    with torch.cuda.device(dev):
        rc = _bwd_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), d_row.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, h, hkv, dh, dh ** -0.5,
            window or 0, softcap or 0.0, _DTYPES[q.dtype], stream_of(dev))
    flash_attention_bwd.launches += 1
    _build.check_launch("flash_attn_bwd", rc)
    return dq, dk, dv


flash_attention_bwd.launches = 0
