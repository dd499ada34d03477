"""Representer-Sketch LM head, decode side: freeze, quantize, apply, and
the ``.npz`` archive shared with the JAX package.

A frozen head is ``{"proj": (d, d'), "w": (L, K, d'), "b": (L, K),
"array": (L, R, V)}`` (+ ``"scale": (L, R)`` when the counts are stored
int8 or packed int4).  Its decode cost is a d×d' transform, L·K hashes and
L·V adds, in place of the dense head's 2·d·V multiply-adds.  Per-tenant
serving stacks several such heads into a bank (:func:`stack_heads`) and
``apply_head(tenant_ids=…)`` decodes each batch row through its own
tenant's head; :func:`refresh_head` folds live traffic into a head online.

Decode backends: ``fused`` (one kernel: transform → hash → gather, the
serving default), ``two_kernel`` (``q = h·A`` as a plain matmul, then the
``lsh_hash`` and ``sketch_head`` kernels) and ``ref`` (the plain
composition, on request only).  Archive formats v1 (f32 only, no
metadata) and v2 (``meta_format_version``, ``meta_quant``, ``scale``) load;
v2 is written.  In-process distillation is not ported: heads arrive as
archives or are frozen here from given kernel params.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.lsh import L2LSH, LSHConfig
from repro_torch.kernels.common import (pack_int4_rows, select_tenant_rows,
                                        unpack_int4_rows)
from repro_torch.kernels.fused_decode.ops import (fused_decode_logits,
                                                  fused_decode_ref)
from repro_torch.kernels.lsh_hash.ops import lsh_hash
from repro_torch.kernels.race_update.ops import race_update_counts
from repro_torch.kernels.sketch_head.ops import sketch_head_logits
from repro_torch.models.config import SketchHeadConfig

#: Count-array storage modes.
QUANT_MODES = (None, "int8", "int4")

#: Decode backends of the sketched head.
HEAD_BACKENDS = ("fused", "two_kernel", "ref")

#: Archive format written by :func:`save_head` (v1 archives still load).
HEAD_FORMAT_VERSION = 2


def _check_quant(quant: Optional[str]) -> None:
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}; "
                         f"expected one of {QUANT_MODES}")


def quantize_symmetric(x: torch.Tensor, *, bits: int = 8,
                       axis: Optional[Union[int, Tuple[int, ...]]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric signed quantization with per-``axis``-slice scales.

    Returns ``(q, scale)``: ``q`` int8 in [-qmax, qmax] (qmax = 2^(bits-1)-1)
    and f32 ``scale`` with the ``axis`` dims squeezed out, ``q·scale ≈ x``.
    All-zero slices get scale ``1/qmax`` (never 0, so no inf/nan).  Same
    arithmetic as the JAX package's ``optim/compress.quantize_symmetric``
    (round half to even in both).
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


def quantize_counts(array: torch.Tensor, quant: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization of an (L, R, V) count array →
    ``(store, scale)``: (L, R, V) int8 or (⌈L/2⌉, R, V) packed int4 bytes,
    and (L, R) f32 scales."""
    _check_quant(quant)
    bits = {"int8": 8, "int4": 4}[quant]
    q, scale = quantize_symmetric(array, bits=bits, axis=-1)
    if quant == "int4":
        q = pack_int4_rows(q)
    return q, scale


def quantize_head(head: dict, quant: Optional[str]) -> dict:
    """A copy of the f32 head with its counts quantized (adds ``"scale"``).
    ``None`` returns a shallow copy: a new dict holding the same tensors,
    so a caller that updates one in place clones it first."""
    _check_quant(quant)
    if "scale" in head:
        raise ValueError("head is already quantized (has a 'scale' leaf)")
    if quant is None:
        return dict(head)
    store, scale = quantize_counts(head["array"], quant)
    return {**head, "array": store, "scale": scale}


def dequantize_head(head: dict, quant: Optional[str],
                    n_rows: Optional[int] = None) -> dict:
    """The f32 head back from quantized storage (``n_rows`` = L, read off
    ``head["w"]`` when omitted).  ``None`` returns a shallow copy (a new
    dict holding the same tensors), as :func:`quantize_head` does."""
    _check_quant(quant)
    if quant is None:
        return dict(head)
    store = head["array"]
    if quant == "int4":
        store = unpack_int4_rows(
            store, n_rows if n_rows is not None else head["w"].shape[0])
    out = {k: v for k, v in head.items() if k != "scale"}
    out["array"] = store.to(torch.float32) * head["scale"][:, :, None]
    return out


def freeze_head(generator: torch.Generator, kernel_params: dict,
                cfg: SketchHeadConfig, *, quant: Optional[str] = None) -> dict:
    """Deployable head from kernel params ``{"points": (M, d'), "alphas":
    (M, V), "proj": (d, d')}``: draws the hash bank from ``generator`` and
    sums each anchor's weights into the buckets it hashes to —
    ``array[l, r, v] = Σ_m [idx[m, l] = r]·α[m, v]``."""
    points = kernel_params["points"]
    alphas = kernel_params["alphas"].to(torch.float32)
    lsh = L2LSH(LSHConfig(n_rows=cfg.n_rows, n_buckets=cfg.n_buckets,
                          k=cfg.k, dim=cfg.proj_dim, bandwidth=cfg.bandwidth))
    hash_params = lsh.params(generator)
    idx = lsh.hash(hash_params, points)                        # (M, L)
    onehot = F.one_hot(idx.long(), cfg.n_buckets).to(torch.float32)
    array = torch.einsum("mlr,mv->lrv", onehot, alphas)
    head = {"proj": kernel_params["proj"], "w": hash_params["w"],
            "b": hash_params["b"], "array": array}
    return quantize_head(head, quant)


def stack_heads(heads) -> dict:
    """Stack per-tenant frozen heads into one bank: every leaf gains a
    leading bank axis T.  All heads must share leaves (one quantization
    mode), shapes and dtypes."""
    heads = list(heads)
    if not heads:
        raise ValueError("stack_heads needs at least one head")
    keys = set(heads[0])
    for h in heads[1:]:
        if set(h) != keys:
            raise ValueError(
                f"cannot stack heads with different leaves: {sorted(keys)} "
                f"vs {sorted(h)} — mixed quantization across tenants is not "
                f"supported")
    return {k: torch.stack([h[k] for h in heads]) for k in keys}


def refresh_head(head: dict, cfg: SketchHeadConfig, hidden: torch.Tensor, *,
                 alphas: Optional[torch.Tensor] = None,
                 targets: Optional[torch.Tensor] = None, lr: float = 1.0,
                 pred_backend: str = "fused",
                 out: Optional[torch.Tensor] = None) -> dict:
    """Fold live-traffic (hidden, logit) pairs into an f32 head's counts.

    The (M, d) hiddens hash through the head's own transform and bank
    (``lsh_hash``), then ``race_update_counts`` adds the per-point weights
    into the (L, R, V) counts in their own layout.  Exactly one of

    * ``alphas`` — (M, V) direct fold: the points join the anchor set with
      these weights, :func:`freeze_head` over the augmented set up to f32
      summation order;
    * ``targets`` — (M, V) residual fold: the weights are
      ``lr · (targets − pred)`` with ``pred`` the head's own logits for
      ``hidden``.

    One deliberate difference from the JAX package, which computes
    ``pred`` with its plain composition (``backend="ref"``): on a CUDA
    tensor ``pred`` comes from the head's decode backend ``pred_backend``
    (``fused`` by default), so no plain version runs on the card's path.
    On CPU tensors every backend is the plain composition, as in JAX.

    Returns a new dict whose ``"array"`` is a fresh tensor, or ``out`` —
    an (L, R, V) f32 tensor the caller owns, which may be
    ``head["array"]`` itself for an in-place fold.  The other leaves are
    the input's tensors.

    Raises:
      ValueError: the head is quantized (dequantize it first and
        re-quantize on publish, as ``ServeEngine.refresh``/``publish``
        do), or not exactly one of ``alphas``/``targets`` is given.
    """
    if "scale" in head:
        raise ValueError(
            "refresh_head accumulates in f32; dequantize the head first "
            "(dequantize_head) and re-quantize on publish — see "
            "ServeEngine.refresh")
    if (alphas is None) == (targets is None):
        raise ValueError("pass exactly one of alphas= (direct fold) / "
                         "targets= (residual fold)")
    q = hidden.to(torch.float32) @ head["proj"]
    idx = lsh_hash(q, head["w"], head["b"], bandwidth=cfg.bandwidth,
                   n_buckets=cfg.n_buckets)                        # (M, L)
    if targets is not None:
        pred = apply_head(head, hidden, cfg, backend=pred_backend)
        alphas = lr * (targets.to(torch.float32) - pred)
    res = dict(head)
    res["array"] = race_update_counts(head["array"], idx,
                                      alphas.to(torch.float32).contiguous(),
                                      out=out)
    return res


def apply_head(head: dict, hidden: torch.Tensor, cfg: SketchHeadConfig, *,
               backend: str = "fused", quant: Optional[str] = None,
               tenant_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sketched logits (B, V) f32 for (B, d) final hiddens (f32 or bf16).

    ``backend``: ``"fused"`` (one kernel), ``"two_kernel"`` (matmul, then
    the ``lsh_hash`` and ``sketch_head`` kernels) or ``"ref"`` (the plain
    composition).  On CPU tensors the kernel wrappers run their plain
    versions.  ``quant`` must match the presence of the head's ``"scale"``.

    ``tenant_ids`` ((B,) bank rows) selects the multi-tenant path: ``head``
    is a bank (:func:`stack_heads`, leading axis T on every leaf), each
    bank row's logits are computed over the full batch by the unchanged
    single-tenant path — on ``two_kernel`` each row hashes through its own
    ``(proj, w, b)`` — and row ``b`` takes bank row ``tenant_ids[b]``'s
    logits without arithmetic, bitwise what that head alone gives.
    """
    _check_quant(quant)
    if (quant is not None) != ("scale" in head):
        raise ValueError(
            f"quant={quant!r} inconsistent with head params: a quantized "
            "head carries a 'scale' leaf and needs the matching quant= "
            "(got scale " + ("present" if "scale" in head else "absent") + ")")
    scale = head.get("scale")
    h32 = hidden.to(torch.float32).contiguous()
    if tenant_ids is not None:
        return _apply_bank(head, h32, cfg, backend, quant, tenant_ids)
    if backend == "ref":
        return fused_decode_ref(h32, head["proj"], head["w"], head["b"],
                                head["array"], cfg.bandwidth, cfg.n_buckets,
                                scale, quant)
    if backend == "fused":
        return fused_decode_logits(
            h32, head["proj"], head["w"], head["b"], head["array"],
            bandwidth=cfg.bandwidth, n_buckets=cfg.n_buckets, scale=scale,
            quant=quant)
    if backend == "two_kernel":
        q = h32 @ head["proj"]
        idx = lsh_hash(q, head["w"], head["b"], bandwidth=cfg.bandwidth,
                       n_buckets=cfg.n_buckets)
        return sketch_head_logits(head["array"], idx, scale=scale,
                                  quant=quant)
    raise ValueError(f"unknown sketch-head backend {backend!r}; "
                     f"expected one of {HEAD_BACKENDS}")


def _apply_bank(bank, h32, cfg, backend, quant, tenant_ids):
    """The ``tenant_ids`` branch of :func:`apply_head`."""
    scale = bank.get("scale")
    n_bank = bank["w"].shape[0]
    if backend == "ref":
        per_tenant = torch.stack([
            fused_decode_ref(h32, bank["proj"][t], bank["w"][t],
                             bank["b"][t], bank["array"][t], cfg.bandwidth,
                             cfg.n_buckets,
                             None if scale is None else scale[t], quant)
            for t in range(n_bank)])
        return select_tenant_rows(per_tenant, tenant_ids)
    if backend == "fused":
        return fused_decode_logits(
            h32, bank["proj"], bank["w"], bank["b"], bank["array"],
            bandwidth=cfg.bandwidth, n_buckets=cfg.n_buckets, scale=scale,
            quant=quant, tenant_ids=tenant_ids)
    if backend == "two_kernel":
        idx = torch.stack([
            lsh_hash(h32 @ bank["proj"][t], bank["w"][t], bank["b"][t],
                     bandwidth=cfg.bandwidth, n_buckets=cfg.n_buckets)
            for t in range(n_bank)])
        return sketch_head_logits(bank["array"], idx, scale=scale,
                                  quant=quant, tenant_ids=tenant_ids)
    raise ValueError(f"unknown sketch-head backend {backend!r}; "
                     f"expected one of {HEAD_BACKENDS}")


def save_head(path, head: dict, cfg: SketchHeadConfig, *,
              kind: str = "sketch", backend: str = "fused",
              quant: Optional[str] = None) -> None:
    """Write a frozen head and its config as a compressed v2 ``.npz``
    (the JAX package's ``save_head`` format: it loads there too)."""
    _check_quant(quant)
    if (quant is not None) != ("scale" in head):
        raise ValueError(f"quant={quant!r} inconsistent with head params "
                         "(see apply_head)")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, **{k: v.detach().cpu().numpy() for k, v in head.items()},
        meta_format_version=np.asarray(HEAD_FORMAT_VERSION),
        meta_kind=np.asarray(kind), meta_backend=np.asarray(backend),
        meta_quant=np.asarray("none" if quant is None else quant),
        **{f"cfg_{f.name}": getattr(cfg, f.name)
           for f in dataclasses.fields(cfg)
           if getattr(cfg, f.name) is not None})


def _coerce_config_value(value, typ):
    """One archived config value (often a 0-d array) as its field type."""
    origin = typing.get_origin(typ)
    if origin is typing.Union or origin is getattr(types, "UnionType", None):
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if len(args) == 1:
            typ = args[0]
    v = (value.item() if isinstance(value, np.ndarray) and value.ndim == 0
         else value)
    if typ is bool:
        return bool(v)
    if typ is int:
        return int(v)
    if typ is float:
        return float(v)
    if typ is str:
        return str(v)
    return v


def coerce_config(cls, raw: Dict[str, object]):
    """A config dataclass from raw archive values, typed per field; missing
    fields take their defaults."""
    hints = typing.get_type_hints(cls)
    return cls(**{f.name: _coerce_config_value(raw[f.name], hints[f.name])
                  for f in dataclasses.fields(cls) if f.name in raw})


def _meta_from_archive(data) -> Dict[str, object]:
    quant = str(data["meta_quant"]) if "meta_quant" in data else "none"
    return {
        "format_version": (int(data["meta_format_version"])
                           if "meta_format_version" in data else 1),
        "kind": str(data["meta_kind"]) if "meta_kind" in data else "sketch",
        "backend": (str(data["meta_backend"])
                    if "meta_backend" in data else "fused"),
        "quant": None if quant == "none" else quant,
    }


def load_head_full(path, device="cuda"
                   ) -> Tuple[dict, SketchHeadConfig, Dict[str, object]]:
    """One archive read → (params on ``device``, config, metadata
    ``{format_version, kind, backend, quant}``).  v1 archives load as the
    fused f32 head."""
    with np.load(Path(path)) as data:
        keys = ["proj", "w", "b", "array"] + (["scale"] if "scale" in data
                                              else [])
        head = {k: torch.from_numpy(np.array(data[k])).to(device)
                for k in keys}
        cfg = coerce_config(SketchHeadConfig, {
            f.name: data[f"cfg_{f.name}"]
            for f in dataclasses.fields(SketchHeadConfig)
            if f"cfg_{f.name}" in data})
        meta = _meta_from_archive(data)
    if (meta["quant"] is not None) != ("scale" in head):
        raise ValueError(f"corrupt head archive {path}: meta_quant="
                         f"{meta['quant']!r} but scale leaf "
                         + ("present" if "scale" in head else "missing"))
    return head, cfg, meta


def load_head(path, device="cuda") -> Tuple[dict, SketchHeadConfig]:
    """Params and config of a saved head."""
    head, cfg, _ = load_head_full(path, device)
    return head, cfg


def load_head_meta(path) -> Dict[str, object]:
    """Registry metadata of a saved head."""
    with np.load(Path(path)) as data:
        return _meta_from_archive(data)
