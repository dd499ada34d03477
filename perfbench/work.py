"""The yardstick's arithmetic: each kernel's bytes and operations from its
shapes, the model FLOPs of served work, and the card's peaks.

Frozen copies of the program's formulas as they stood when the benchmark
was defined (``kernels/work.py``: ``live_pairs``, ``flash_attn_work``,
``kernel_work``; ``core/sketch_lm_head.head_costs``' sketch FLOPs), so
that a later change to the program cannot move its own yardstick.  Bytes
count each input read once and each output written once; a multiply-add
counts 2 operations.
"""

from __future__ import annotations

from typing import Optional, Tuple

#: One NVIDIA H100 SXM (data sheet, dense): HBM bytes/s, bf16 tensor-core
#: FLOP/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


def live_pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal (+window) attention of length s keeps."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_attn_work(b: int, s: int, h: int, n_kv: int, dh: int,
                    window: Optional[int], itemsize: int) -> Tuple[int, int]:
    """(bytes, operations) of the causal flash-attention forward: q, k, v
    read, the output written; the two products 4·dh a live pair."""
    n_bytes = itemsize * (2 * b * s * h * dh + 2 * b * s * n_kv * dh)
    return n_bytes, 4 * dh * b * h * live_pairs(s, window)


def expected_rows(n_rows: int, n_buckets: int, batch: int) -> float:
    """Distinct (row, bucket) count rows that B uniform hashes touch, in
    expectation: L·R·(1 − (1 − 1/R)^B).  A captured call's indices never
    reach the host, so its gather is priced at this count."""
    return n_rows * n_buckets * (1.0 - (1.0 - 1.0 / n_buckets) ** batch)


def fused_decode_work(batch: int, d: int, head: dict, vocab: int,
                      rows: Optional[float] = None) -> Tuple[float, int]:
    """(bytes, operations) of one f32 ``fused_decode`` call over ``batch``
    rows: h, A, w, b read, the touched count rows (``rows``, else
    :func:`expected_rows`) read once, the (B, V) logits written; the
    transform, the hashes and the L adds a logit."""
    n_rows, k, dp = head["n_rows"], head["k"], head["proj_dim"]
    small = 4 * (n_rows * k * dp + n_rows * k)
    if rows is None:
        rows = expected_rows(n_rows, head["n_buckets"], batch)
    sketch = rows * vocab * 4
    n_bytes = 4 * batch * d + 4 * d * dp + small + sketch + 4 * batch * vocab
    ops = 2 * batch * d * dp + 2 * batch * n_rows * k * dp + batch * n_rows * vocab
    return n_bytes, ops


def sketch_flops(head: dict, d: int, vocab: int) -> int:
    """The sketched head's FLOPs a token (transform, hashes, L adds a
    logit)."""
    return (2 * d * head["proj_dim"]
            + 2 * head["proj_dim"] * head["k"] * head["n_rows"]
            + head["n_rows"] * vocab)


def matmul_params(cfg: dict) -> int:
    """Weights a token multiplies through in the backbone (no embedding
    lookup, no head)."""
    d, n = cfg["d_model"], cfg["n_layers"]
    if cfg["kind"] == "rwkv":
        return n * (5 * d * d + 2 * 64 * d + 2 * d * cfg["d_ff"] + d * d)
    a = cfg["attention"]
    q, kv = a["n_heads"] * a["head_dim"], a["n_kv_heads"] * a["head_dim"]
    return n * (2 * d * q + 2 * d * kv + 3 * d * cfg["d_ff"])


def mixer_flops(cfg: dict, context: int) -> int:
    """A token's sequence-mixing FLOPs beyond its products with weights:
    attention's two products over ``context`` keys (causal: the token's
    own position + 1), or rwkv's WKV read and state update (two 64×64
    products a head)."""
    d, n = cfg["d_model"], cfg["n_layers"]
    if cfg["kind"] == "rwkv":
        return n * 4 * 64 * d
    a = cfg["attention"]
    return n * 4 * a["head_dim"] * a["n_heads"] * context


def prefill_flops(cfg: dict, prompt: int) -> int:
    """Model FLOPs of one prompt's prefill, its last position unembedded by
    the dense head (causal attention: position i attends to i + 1 keys)."""
    if cfg["kind"] == "rwkv":
        mix = mixer_flops(cfg, 0) * prompt
    else:
        mix = mixer_flops(cfg, 1) * prompt * (prompt + 1) // 2
    return (2 * matmul_params(cfg) * prompt + mix
            + 2 * cfg["vocab_size"] * cfg["d_model"])


def decode_flops(cfg: dict, head: dict, prompt: int, a: int, b: int) -> int:
    """Model FLOPs of a request's decode tokens a..b-1 (token i, i ≥ 1, is
    made at i + prompt cached positions, its input's included), through
    the sketched head."""
    n = max(0, b - a)
    per = 2 * matmul_params(cfg) + sketch_flops(head, cfg["d_model"],
                                                cfg["vocab_size"])
    if cfg["kind"] == "rwkv":
        return n * (per + mixer_flops(cfg, 0))
    contexts = n * prompt + (a + b - 1) * n // 2
    return n * per + mixer_flops(cfg, 1) * contexts
