"""Causal flash attention (the bulk prefill's attention): kernel wrapper and
plain version.

``flash_attention`` runs the plain version for CPU tensors and launches
``csrc/flash_attn.cu`` for CUDA tensors (or raises);
``flash_attention.launches`` counts its launches.  Both take the JAX
layout, q (B, S, H, dh) and k, v (B, S, Hkv, dh), with query head h reading
KV head ``h // (H // Hkv)`` (``Hkv == H`` is the TPU kernel's own
signature).  Tiling is the kernel's business: there is no
``block_q``/``block_k``.  The kernel runs f32 inputs on the CUDA cores and
bf16 inputs on the tensor cores.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_operand, stream_of

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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version (the JAX package's ``flash_attention_ref`` with grouped
    KV heads): scores ``(q·dh^-0.5)·kᵀ`` in f32, the optional
    ``softcap·tanh(s/softcap)``, the causal (and window) mask as ``-1e30``,
    softmax and ``p·v`` in f32, cast to q's dtype."""
    _check_args(q, k, v, window)
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    qg = (q.to(torch.float32) * dh ** -0.5).reshape(b, s, hkv, h // hkv, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(b, s, h, dh).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("flash_attn").flash_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    raises on anything else.
    """
    _check_args(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes f32 or bf16, got {q.dtype}")
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    if dh % 16 or not 16 <= dh <= 256:
        raise ValueError(f"the flash_attn kernel takes dh a multiple of 16 up "
                         f"to 256, got {dh}")
    dev = q.device
    check_operand("q", q, dev, q.dtype, (b, s, h, dh))
    check_operand("k", k, dev, q.dtype, (b, s, hkv, dh))
    check_operand("v", v, dev, q.dtype, (b, s, hkv, dh))
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the flash_attn kernel's bf16 path loads q, k, v with "
                         "TMA, which needs 16-byte-aligned data")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b, s, h, hkv, dh, dh ** -0.5,
                         window or 0, softcap or 0.0, _DTYPES[q.dtype],
                         stream_of(dev))
    flash_attention.launches += 1
    _build.check_launch("flash_attn", rc)
    return out


flash_attention.launches = 0
