"""The work each hand-written kernel does: its (bytes, operations) from
the shapes (and, for the sketch heads' gathers, the indices) it is given,
and the record of each call for an active op analyzer.

One home for these figures: ``chip_smoke.py`` prices its bounds with
them, and the kernel wrappers report every call through :func:`record`,
so that ``launch/hlo_analysis.analyze`` counts a kernel's work alike
whether the wrapper launched it on the card or only propagated its shapes
for the dry run (fake tensors).  Bytes count each input read once and
each output written once; a multiply-add counts 2 operations.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import torch

# The active sinks, process-wide: a backward on CUDA tensors runs on the
# autograd engine's device thread, and its kernel calls count too.
_sinks: List[Callable[[str, int, int], None]] = []


@contextmanager
def recording(sink: Callable[[str, int, int], None]):
    """Send every kernel call made inside, on any thread, to ``sink(name,
    bytes, operations)`` (nested: each active sink sees each call)."""
    _sinks.append(sink)
    try:
        yield
    finally:
        _sinks.remove(sink)


def record(name: str, n_bytes: int, n_ops: int) -> None:
    """One call of kernel ``name`` moving ``n_bytes`` and doing ``n_ops``
    operations, told to every active :func:`recording` sink."""
    for sink in tuple(_sinks):
        sink(name, n_bytes, n_ops)


def live_pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal (+window) attention of length s keeps:
    ``Σ_i min(i + 1, window)``."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_attn_work(b: int, s: int, h: int, n_kv: int, dh: int,
                    window: Optional[int], itemsize: int,
                    with_lse: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of the causal flash-attention forward on
    q (B, S, H, dh), k, v (B, S, n_kv, dh): q, k, v read and the output
    written (and with ``with_lse`` the (B, H, S) f32 log-sum-exp), the two
    products 4·dh a live (query, key) pair."""
    n_bytes = itemsize * (2 * b * s * h * dh + 2 * b * s * n_kv * dh)
    if with_lse:
        n_bytes += 4 * b * h * s
    return n_bytes, 4 * dh * b * h * live_pairs(s, window)


def flash_attn_bwd_work(b: int, s: int, h: int, n_kv: int, dh: int,
                        window: Optional[int], itemsize: int
                        ) -> Tuple[int, int, int]:
    """(bytes, operations, recomputed operations) of the attention
    backward: q, k, v, out, dout and the f32 lse read, dq, dk, dv written;
    the gradient's four products (dv, dp, dq, dk) 8·dh a live pair, and
    the scores recomputed from q and k 2·dh a pair."""
    q_elems, kv_elems = b * s * h * dh, b * s * n_kv * dh
    n_bytes = itemsize * (4 * q_elems + 4 * kv_elems) + 4 * b * h * s
    pairs = b * h * live_pairs(s, window)
    return n_bytes, 8 * dh * pairs, 2 * dh * pairs


def count_bytes(store: torch.Tensor, idx: torch.Tensor, quant) -> int:
    """Bytes of the count rows that ``idx`` (B, L) touches: one V-row of
    the (L or ⌈L/2⌉, R, V) store per distinct (storage row, bucket)."""
    n_rows = idx.shape[1]
    rows = torch.arange(n_rows, device=idx.device)
    srow = rows // 2 if quant == "int4" else rows
    key = (srow[None, :] * store.shape[1] + idx.long()).unique()
    return int(key.numel()) * store.shape[2] * store.element_size()


def kernel_work(name, hidden, head, idx, quant):
    """(bytes, operations) the sketch-head kernel ``name`` (fused_decode,
    lsh_hash or sketch_head) needs on these inputs: each input read once
    (only the count rows idx touches), each output written once; f32
    multiply-adds count 2."""
    b, d = hidden.shape
    n_rows, k, dp = head["w"].shape
    v = head["array"].shape[2]
    small = 4 * (n_rows * k * dp + n_rows * k)                  # w, b
    scale = 0 if quant is None else 4 * head["scale"].numel()
    gather_ops = b * n_rows * v * (1 if quant is None else 2)
    hash_ops = 2 * b * n_rows * k * dp
    sketch = count_bytes(head["array"], idx, quant)
    if name == "fused_decode":
        return (4 * b * d + 4 * d * dp + small + scale + sketch + 4 * b * v,
                2 * b * d * dp + hash_ops + gather_ops)
    if name == "lsh_hash":
        return hash_work(b, n_rows, k, dp)
    return 4 * b * n_rows + scale + sketch + 4 * b * v, gather_ops


def hash_work(b, n_rows, k, dp):
    """(bytes, operations) of lsh_hash on (B, d') queries and an (L, K, d')
    bank: x, w and b read once, the (B, L) int32 indices written once; the
    B·L·K·d' multiply-adds count 2."""
    return (4 * (b * dp + n_rows * k * dp + n_rows * k + b * n_rows),
            2 * b * n_rows * k * dp)
