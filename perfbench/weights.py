"""Weights and sketched heads drawn from a run's seed, on the device.

The benchmark draws its own inputs: the backbone's parameters in the port's
parameter tree (``embed``, ``final_norm``, ``head`` when untied,
``periods/pos<j>`` stacked over the periods), and the frozen sketched heads.
Both sides of the comparison get the same tensors: the program serves them,
and the plain reference (``reference.py``) reads them.

Each stacked leaf is drawn by one ``torch.randn`` on the card's generator,
in bf16 (the type it is served in) and scaled in place, so that no f32 copy
of a stack ever exists (command-r's FFN stacks are 14.8 GB in bf16).  The
vectors that the port initialises to constants (norm scales, rwkv's token
mixes, decay base and bonus) are drawn around those constants, so that the
comparison sees every one of them used.
"""

from __future__ import annotations

import torch

from perfbench import hashing


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed."""
    mixed = (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)
    return torch.Generator(device).manual_seed(mixed)


def _randn(gen, shape, scale, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype).mul_(scale)


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32).mul_(hi - lo).add_(lo)


def _near(gen, shape, value, spread):
    """f32 vector(s) ``value + N(0, spread²)``."""
    return _randn(gen, shape, spread, torch.float32).add_(value)


def draw_backbone(cfg: dict, seed: int, device) -> dict:
    """The backbone's params for the config file's ``model`` block."""
    gen = generator(seed, 1, device)
    d, v, n = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    params = {"embed": _randn(gen, (v, d), 0.02),
              "final_norm": _near(gen, (d,), 0.0, 0.1)}
    if not cfg["tie_embeddings"]:
        params["head"] = _randn(gen, (v, d), 0.02)
    kind = cfg["kind"]
    if kind == "rwkv":
        layer = _rwkv_stack(gen, n, d, cfg["d_ff"])
    elif kind == "attn":
        layer = _attn_stack(gen, n, d, cfg["d_ff"], cfg["attention"])
    else:
        raise ValueError(f"no weight recipe for block kind {kind!r}")
    params["periods"] = {"pos0": layer}
    return params


def _rwkv_stack(gen, n, d, d_ff):
    h, lora = d // 64, 64
    return {
        "norm1": _near(gen, (n, d), 0.0, 0.1),
        "norm2": _near(gen, (n, d), 0.0, 0.1),
        "mixer": {
            "mu": _uniform(gen, (n, 5, d), 0.2, 0.8),
            "w_r": _randn(gen, (n, d, d), d ** -0.5),
            "w_k": _randn(gen, (n, d, d), d ** -0.5),
            "w_v": _randn(gen, (n, d, d), d ** -0.5),
            "w_g": _randn(gen, (n, d, d), d ** -0.5),
            "w_o": _randn(gen, (n, d, d), d ** -0.5),
            "w0": _near(gen, (n, d), -6.0, 0.5),
            "w_lora_a": _randn(gen, (n, d, lora), d ** -0.5),
            "w_lora_b": _randn(gen, (n, lora, d), 0.01),
            "u_bonus": _near(gen, (n, h, 64), 0.0, 0.3),
            "ln_x": _near(gen, (n, d), 0.0, 0.1),
            "mu_cm": _uniform(gen, (n, 2, d), 0.2, 0.8),
            "cm_k": _randn(gen, (n, d, d_ff), d ** -0.5),
            "cm_v": _randn(gen, (n, d_ff, d), d_ff ** -0.5),
            "cm_r": _randn(gen, (n, d, d), d ** -0.5),
        },
    }


def _attn_stack(gen, n, d, d_ff, a):
    q_dim = a["n_heads"] * a["head_dim"]
    kv_dim = a["n_kv_heads"] * a["head_dim"]
    return {
        "norm1": _near(gen, (n, d), 0.0, 0.1),
        "norm2": _near(gen, (n, d), 0.0, 0.1),
        "mixer": {"wq": _randn(gen, (n, d, q_dim), d ** -0.5),
                  "wk": _randn(gen, (n, d, kv_dim), d ** -0.5),
                  "wv": _randn(gen, (n, d, kv_dim), d ** -0.5),
                  "wo": _randn(gen, (n, q_dim, d), q_dim ** -0.5)},
        "ffn": {"w_gate": _randn(gen, (n, d, d_ff), d ** -0.5),
                "w_up": _randn(gen, (n, d, d_ff), d ** -0.5),
                "w_down": _randn(gen, (n, d_ff, d), d_ff ** -0.5)},
    }


def draw_head(head_cfg: dict, d_model: int, vocab: int, seed: int,
              tenant: int, device) -> dict:
    """One frozen sketched head ``{"proj", "w", "b", "array"}`` (f32):
    the transform (d, d')/√d, the L2-LSH bank (L, K, d') with offsets in
    [0, r), and the counts of ``n_anchors`` anchors N(0, I) in the d'
    space with weights (M, V)·``alpha_scale``, centred over the anchors:
    ``array[l, r, v] = Σ_m [idx[m, l] = r]·α[m, v]``.

    The centring (Σ_m α[m, v] = 0) takes away the part of each logit that
    every bucket shares: without it the token with the largest total
    weight wins at nearly every position whatever the hidden, and the
    served tokens say nothing of the backbone."""
    gen = generator(seed, 100 + tenant, device)
    n_rows, k, dp = head_cfg["n_rows"], head_cfg["k"], head_cfg["proj_dim"]
    n_buckets, r = head_cfg["n_buckets"], head_cfg["bandwidth"]
    f32 = torch.float32
    proj = _randn(gen, (d_model, dp), d_model ** -0.5, f32)
    w = _randn(gen, (n_rows, k, dp), 1.0, f32)
    b = _uniform(gen, (n_rows, k), 0.0, r)
    anchors = _randn(gen, (head_cfg["n_anchors"], dp), 1.0, f32)
    alphas = _randn(gen, (head_cfg["n_anchors"], vocab),
                    head_cfg["alpha_scale"], f32)
    alphas -= alphas.mean(0, keepdim=True)
    idx = hashing.bucket_indices(anchors, w, b, r, n_buckets)   # (M, L)
    onehot = torch.nn.functional.one_hot(idx.long(), n_buckets).to(f32)
    m = anchors.shape[0]
    array = (onehot.reshape(m, n_rows * n_buckets).t() @ alphas)
    return {"proj": proj, "w": w, "b": b,
            "array": array.reshape(n_rows, n_buckets, vocab).contiguous()}
