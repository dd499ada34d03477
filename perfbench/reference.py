"""The plain reference the served tokens are judged against.

A straightforward PyTorch forward pass, float32 with TF32 off, of the two
backbones the benchmark serves, written from their equations and not from
the program:

* ``rwkv``: pre-norm RMS norms ``x/rms(x)·(1 + s)``; the RWKV-6 time-mix
  (token shift, five learned mixes, data-dependent decay
  ``w_t = exp(−exp(w0 + tanh(x_w A) B))``, the WKV recurrence
  ``y_t = r_t (S_{t−1} + diag(u) k_tᵀ v_t)``, ``S_t = diag(w_t) S_{t−1} +
  k_tᵀ v_t``, a per-head group norm, the SiLU gate) and channel-mix
  (``σ(x_r W_r) ⊙ relu(x_k W_k)² W_v``);
* ``attn``: pre-norm causal GQA attention with RoPE (half-split rotation)
  and a SwiGLU FFN;

both with the embedding scaled by √d and a final norm.  The decode head is
the dense unembed for the first token of a request (it comes from the
prefill) and the sketched head (``q = h·A``, L2-LSH buckets, the mean of
the L count rows) for every later one.

The sequence runs whole (prompt and served tokens, teacher-forced), one
request at a time, each layer's weights widened to f32 only while that
layer runs, attention by query blocks, the WKV recurrence by chunks of
exact decays, logits by blocks of positions, so that it fits beside the
weights.

``Precision("fp8")`` is the control: every backbone product takes its
inputs rounded to float8 e4m3 (weights per output column, activations per
row), the step below the bf16 that the configurations serve.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from perfbench import hashing

WKV_CHUNK = 32
Q_BLOCK = 512
ROW_BLOCK = 2048
POS_BLOCK = 256
VOCAB_BLOCK = 32768
FP8_MAX = 448.0


class Precision:
    """How the reference's backbone products round their inputs:
    ``"f32"`` (none) or ``"fp8"`` (the control)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def _fp8(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (d_in, d_out) weight as the products read it."""
        w = w.to(torch.float32)
        return self._fp8(w, 0) if self.mode == "fp8" else w

    def mm(self, x: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
        """``x @ w`` of f32 rows x and a weight from :meth:`weight`, in
        row blocks."""
        x = x.to(torch.float32)
        out = []
        for i in range(0, x.shape[0], ROW_BLOCK):
            xb = x[i:i + ROW_BLOCK]
            if self.mode == "fp8":
                xb = self._fp8(xb, 1)
            out.append(xb @ w32)
        return torch.cat(out)


def no_tf32() -> None:
    """Full-precision f32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale.to(torch.float32))


def _shift(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _layer(stack: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in stack.items()}


def _wkv(r, k, v, logw, u):
    """The WKV-6 recurrence over (S, H, K) f32 inputs, by chunks of
    ``WKV_CHUNK`` tokens with each pair's decay taken as one exponent
    ``exp(Σ_{s<j<t} log w_j) ≤ 1``; returns (S, H, K)."""
    s_len, h, dk = r.shape
    state = torch.zeros((h, dk, dk), dtype=torch.float32, device=r.device)
    ys = []
    for c0 in range(0, s_len, WKV_CHUNK):
        rc, kc, vc, lw = (t[c0:c0 + WKV_CHUNK] for t in (r, k, v, logw))
        n = rc.shape[0]
        incl = torch.cumsum(lw, 0)                 # Σ_{j≤t}
        excl = incl - lw                           # Σ_{j<t}
        y = torch.einsum("thk,hkv->thv", rc * torch.exp(excl), state)
        dec = excl[:, None] - incl[None, :]        # (t, s, H, K)
        past = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                     device=r.device), -1)
        dec = torch.where(past[:, :, None, None], dec, -math.inf)
        att = torch.einsum("thk,tshk,shk->tsh", rc, torch.exp(dec), kc)
        y = y + torch.einsum("tsh,shv->thv", att, vc)
        y = y + (rc * u * kc).sum(-1, keepdim=True) * vc
        tail = torch.exp(incl[-1][None] - incl)    # (s, H, K)
        state = (torch.exp(incl[-1])[..., None] * state
                 + torch.einsum("shk,shv->hkv", kc * tail, vc))
        ys.append(y)
    return torch.cat(ys)


def _rwkv_layer(p: dict, x: torch.Tensor, eps: float,
                prec: Precision) -> torch.Tensor:
    m = p["mixer"]
    s_len, d = x.shape
    h = rms_norm(x, p["norm1"], eps)
    sh = _shift(h)
    mu = m["mu"].to(torch.float32)
    xr, xk, xv, xw, xg = (h * mu[i] + sh * (1.0 - mu[i]) for i in range(5))
    heads = lambda t: t.reshape(s_len, d // 64, 64)
    r = heads(prec.mm(xr, prec.weight(m["w_r"])))
    k = heads(prec.mm(xk, prec.weight(m["w_k"])))
    v = heads(prec.mm(xv, prec.weight(m["w_v"])))
    g = torch.nn.functional.silu(prec.mm(xg, prec.weight(m["w_g"])))
    lora = prec.mm(torch.tanh(prec.mm(xw, prec.weight(m["w_lora_a"]))),
                   prec.weight(m["w_lora_b"]))
    logw = heads(-torch.exp(m["w0"].to(torch.float32) + lora))
    y = _wkv(r, k, v, logw, m["u_bonus"].to(torch.float32))
    y = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
        y.var(-1, unbiased=False, keepdim=True) + 1e-5)
    y = y.reshape(s_len, d) * (1.0 + m["ln_x"].to(torch.float32))
    x = x + prec.mm(y * g, prec.weight(m["w_o"]))
    h2 = rms_norm(x, p["norm2"], eps)
    sh2 = _shift(h2)
    mc = m["mu_cm"].to(torch.float32)
    xk2 = h2 * mc[0] + sh2 * (1.0 - mc[0])
    xr2 = h2 * mc[1] + sh2 * (1.0 - mc[1])
    kk = torch.relu(prec.mm(xk2, prec.weight(m["cm_k"]))).square()
    cm = prec.mm(kk, prec.weight(m["cm_v"]))
    return x + torch.sigmoid(prec.mm(xr2, prec.weight(m["cm_r"]))) * cm


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(S, H, dh) rotated by position, the two halves of each head."""
    s_len, _, dh = x.shape
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = torch.arange(s_len, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).to(torch.float32)[:, None]
    sin = torch.sin(ang).to(torch.float32)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attn_layer(p: dict, x: torch.Tensor, cfg: dict,
                prec: Precision) -> torch.Tensor:
    a = cfg["attention"]
    nh, nkv, dh = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    s_len = x.shape[0]
    m = p["mixer"]
    h = rms_norm(x, p["norm1"], cfg["norm_eps"])
    q = _rope(prec.mm(h, prec.weight(m["wq"])).reshape(s_len, nh, dh),
              a["rope_theta"])
    k = _rope(prec.mm(h, prec.weight(m["wk"])).reshape(s_len, nkv, dh),
              a["rope_theta"])
    v = prec.mm(h, prec.weight(m["wv"])).reshape(s_len, nkv, dh)
    groups = nh // nkv
    outs = []
    for q0 in range(0, s_len, Q_BLOCK):
        qb = q[q0:q0 + Q_BLOCK].reshape(-1, nkv, groups, dh)
        end = q0 + qb.shape[0]
        sc = torch.einsum("qkgd,skd->kgqs", qb, k[:end]) * dh ** -0.5
        qpos = torch.arange(q0, end, device=x.device)
        keep = qpos[:, None] >= torch.arange(end, device=x.device)[None]
        sc = sc.masked_fill(~keep, -math.inf)
        pr = torch.softmax(sc, -1)
        outs.append(torch.einsum("kgqs,skd->qkgd", pr, v[:end])
                    .reshape(-1, nh * dh))
    x = x + prec.mm(torch.cat(outs), prec.weight(m["wo"]))
    f = p["ffn"]
    h2 = rms_norm(x, p["norm2"], cfg["norm_eps"])
    gate = torch.nn.functional.silu(prec.mm(h2, prec.weight(f["w_gate"])))
    up = prec.mm(h2, prec.weight(f["w_up"]))
    return x + prec.mm(gate * up, prec.weight(f["w_down"]))


def final_hidden(params: dict, cfg: dict, tokens: torch.Tensor,
                 prec: Optional[Precision] = None) -> torch.Tensor:
    """(S, d) f32 final-norm hiddens of one token sequence (S,)."""
    prec = prec or Precision()
    x = params["embed"][tokens.long()].to(torch.float32) * math.sqrt(
        cfg["d_model"])
    stack = params["periods"]["pos0"]
    for i in range(cfg["n_layers"]):
        p = _layer(stack, i)
        if cfg["kind"] == "rwkv":
            x = _rwkv_layer(p, x, cfg["norm_eps"], prec)
        else:
            x = _attn_layer(p, x, cfg, prec)
    return rms_norm(x, params["final_norm"], cfg["norm_eps"])


def dense_logits(params: dict, cfg: dict, h: torch.Tensor) -> torch.Tensor:
    """(n, V) f32 logits of (n, d) hiddens through the output table."""
    table = params["embed"] if cfg["tie_embeddings"] else params["head"]
    return torch.cat([h @ table[v0:v0 + VOCAB_BLOCK].to(torch.float32).t()
                      for v0 in range(0, table.shape[0], VOCAB_BLOCK)], -1)


def sketch_logits(head: dict, head_cfg: dict, h: torch.Tensor) -> torch.Tensor:
    """(n, V) f32 sketched logits: the mean over the L rows of the count
    row each hidden's bucket picks."""
    q = h.to(torch.float32) @ head["proj"]
    idx = hashing.bucket_indices(q, head["w"], head["b"],
                                 head_cfg["bandwidth"], head_cfg["n_buckets"])
    array = head["array"]
    acc = torch.zeros((h.shape[0], array.shape[2]), dtype=torch.float32,
                      device=h.device)
    for row in range(array.shape[0]):
        acc += array[row][idx[:, row]]
    return acc / array.shape[0]


def _gap(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each row's chosen logit lies below the row's best."""
    return logits.max(-1).values - logits.gather(-1, chosen[:, None])[:, 0]


def request_gaps(params: dict, cfg: dict, head: dict, head_cfg: dict,
                 prompt: torch.Tensor, served: torch.Tensor,
                 control: Optional[Precision] = None) -> Dict[str, float]:
    """The widest gaps of one request's served tokens under the reference:
    ``first`` (the dense head's token from the prefill) and ``decode``
    (the sketched head's, every later token; 0 for a one-token answer).
    With ``control``, also ``control_first`` and ``control_decode``: the
    gaps of the tokens that reference, run in ``control``'s precision on
    the same prompt and served tokens, would have put first."""
    seq = torch.cat([prompt, served[:-1]]).long()
    p0 = prompt.shape[0] - 1                   # hidden of the first token
    hid = final_hidden(params, cfg, seq)[p0:]
    ctl = (final_hidden(params, cfg, seq, control)[p0:]
           if control is not None else None)
    out = {}
    dense = dense_logits(params, cfg, hid[:1])
    out["first"] = float(_gap(dense, served[:1].long())[0])
    if ctl is not None:
        pick = dense_logits(params, cfg, ctl[:1]).argmax(-1)
        out["control_first"] = float(_gap(dense, pick)[0])
    gaps, control_gaps = [], []
    for i in range(1, hid.shape[0], POS_BLOCK):
        lg = sketch_logits(head, head_cfg, hid[i:i + POS_BLOCK])
        gaps.append(_gap(lg, served[i:i + POS_BLOCK].long()))
        if ctl is not None:
            pick = sketch_logits(head, head_cfg,
                                 ctl[i:i + POS_BLOCK]).argmax(-1)
            control_gaps.append(_gap(lg, pick))
    out["decode_gaps"] = torch.cat(gaps).cpu() if gaps else torch.zeros(0)
    if ctl is not None:
        out["control_decode_gaps"] = (torch.cat(control_gaps).cpu()
                                      if control_gaps else torch.zeros(0))
    return out


def check_requests(params: dict, cfg: dict, heads: Callable[[object], dict],
                   head_cfg: dict, requests: List[dict],
                   control: Optional[Precision] = None) -> Dict[str, float]:
    """The widest gaps over ``requests`` (dicts with ``prompt``, ``served``
    and ``tenant``), ``heads(tenant)`` giving each request's head."""
    no_tf32()
    worst: Dict[str, float] = {}
    decode: Dict[str, list] = {"decode_gaps": [], "control_decode_gaps": []}
    with torch.no_grad():
        for r in requests:
            dev = params["embed"].device
            gaps = request_gaps(
                params, cfg, heads(r["tenant"]), head_cfg,
                torch.as_tensor(r["prompt"], device=dev),
                torch.as_tensor(r["served"], device=dev), control)
            for k, v in gaps.items():
                if k in decode:
                    decode[k].append(v)
                else:
                    worst[k] = max(worst.get(k, 0.0), v)
    for k, parts in decode.items():
        if not parts:
            continue
        g = torch.cat(parts)
        name = k[:-len("_gaps")]
        worst[name] = float(g.max()) if g.numel() else 0.0
        worst[name + "_mean"] = float(g.mean()) if g.numel() else 0.0
        worst[name + "_over_0.05"] = (float((g > 0.05).float().mean())
                                       if g.numel() else 0.0)
    return worst
