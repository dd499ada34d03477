#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch and CUDA
   versions, and builds the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (build time and ptxas register report).
2. Kernel phase: each kernel (fused_decode, lsh_hash, sketch_head) against
   its plain PyTorch version on the card at d=2048, V=65536 (and a ragged
   V=65519), for the head ``launch/serve.py`` freezes for rwkv6 (L=128,
   R=16, K=1, d'=32, r=2) and ``SketchHeadConfig()`` (L=64, R=16, K=2,
   d'=64, r=4), B in {1, 2, 4, 64, 256} (2 is the per-tenant engine's
   batch, 256 the refresh's), f32/int8/int4 counts.  Indices obey the
   boundary rule and logits the gather bound of
   ``repro_torch.parity``; one ``kernel_case`` JSON line each, with
   CUDA-event times (median of 20 runs after warm-up, L2 flushed before
   each run).  Then race_update against its plain version for M in {32,
   256, 1024}, both heads' L, both V, through both entries ((L, R, V) and
   (C, L, R)): within ``race_update_tol``, two launches bit for bit equal,
   timed beside the one-call ``baddbmm``/``addmm`` yardstick.
3. Backbone check: the rwkv6 smoke model on the card against the same
   model on the CPU, teacher-forced (bf16 tolerance of
   tests/test_torch_model.py).
4. Main path: full-width rwkv6-1.6b (24 layers, d_model 2048, vocab 65536,
   random bf16 weights from a seed) serves 4 prompts of 32 tokens for 16
   new tokens through ``LM.generate`` three times — dense head, sketched
   head on ``fused``, on ``two_kernel`` — with the launch counts set to 0
   before and read after each run.  Then one decode step's hidden,
   teacher-forced, holds fused against two-kernel, and the three kernels
   are timed on that step's real inputs beside their plain versions, the
   one-call PyTorch equivalent where one exists, and their bound.
5. Refresh path, on an f32 and an int8 bank: two tenant-0 requests in
   flight in a per-tenant engine, then ``engine.refresh`` of M = 256 live
   hiddens with the dense logits as targets (launch counts zeroed before,
   read after: race_update, lsh_hash and fused_decode once each); the
   residual's fused_decode at B=256 against fused_decode_ref and the
   shadow against a plain fold of the same points; the bank row and the
   in-flight streams bitwise unchanged until ``publish``; after it, new
   requests equal a fresh engine loaded with the published head.
6. Engine path: ``LM.engine`` with the dense and the fused head (requests
   arriving together equal ``LM.generate`` of the same batch; every step
   of the staggered ``serve --engine`` stream against a solo run
   teacher-forced on the engine's tokens, see ``check_staggered``), and
   three tenants over a capacity-2 ``HeadCache`` against single-tenant
   engines, with fused_decode launched once per bank row per tick.
7. Prints the ``{"kernels": [...]}`` line (race_update's launches from the
   refresh path), the card line, and last ``{"ok": true, "device":
   {...}}``.

Any failed check raises, so the exit code is non-zero and the last line
is not printed.  Without a CUDA device it exits non-zero at once.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api import LM, DenseHead, HeadCache, SketchHead
from repro_torch.core.sketch_lm_head import (dequantize_head, freeze_head, quantize_counts,
                                             quantize_head)
from repro_torch.kernels import _build
from repro_torch.kernels.fused_decode.ops import fused_decode_logits, fused_decode_ref
from repro_torch.kernels.lsh_hash.ops import lsh_hash, lsh_hash_ref
from repro_torch.kernels.race_update.ops import (race_update, race_update_counts,
                                                 race_update_counts_ref, race_update_ref)
from repro_torch.parity import (BF16_MAX_TOL, BF16_NORM_TOL, assert_bf16_backbone_close,
                                bf16_backbone_errors, check_hash_indices, gather_atol,
                                race_update_tol)
from repro_torch.kernels.sketch_head.ops import (dequantize_sketch_ref,
                                                 sketch_head_logits,
                                                 sketch_head_ref)
from repro_torch.launch.serve import engine_stream
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models import model
from repro_torch.models.config import SketchHeadConfig

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
D_MODEL, VOCAB = 2048, 65536
SERVE_HEAD = SketchHeadConfig(n_rows=128, n_buckets=16, k=1, proj_dim=32,
                              bandwidth=2.0)
DEFAULT_HEAD = SketchHeadConfig()
BATCH, PROMPT, GEN = 4, 32, 16
REPEATS = 3
KERNELS = {   # name: (wrapper, source, TPU kernel it replaces)
    "fused_decode": (fused_decode_logits, "src/repro_torch/kernels/csrc/fused_decode.cu",
                     "src/repro/kernels/fused_decode/kernel.py:50"),
    "lsh_hash": (lsh_hash, "src/repro_torch/kernels/csrc/lsh_hash.cu",
                 "src/repro/kernels/lsh_hash/kernel.py:53"),
    "sketch_head": (sketch_head_logits, "src/repro_torch/kernels/csrc/sketch_head.cu",
                    "src/repro/kernels/sketch_head/kernel.py:41"),
    "race_update": (race_update, "src/repro_torch/kernels/csrc/race_update.cu",
                    "src/repro/kernels/race_update/kernel.py:27"),
}
N_REQUESTS, SLOTS, TENANT_SLOTS, CAPACITY = 12, 4, 2, 2
REFRESH_PROMPTS = 8                 # x PROMPT tokens = M = 256 refresh points


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def reset_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def counts() -> dict:
    return {name: w.launches for name, (w, _, _) in KERNELS.items()}


class Timer:
    """Median CUDA-event time of a call, the L2 cache (50 MB) flushed by a
    1 GiB write before each run, as a decode step finds it after the
    backbone's weights went through."""

    def __init__(self, dev):
        self.flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def count_bytes(store: torch.Tensor, idx: torch.Tensor, quant) -> int:
    """Bytes of the count rows that ``idx`` (B, L) touches: one V-row of
    the (L or ⌈L/2⌉, R, V) store per distinct (storage row, bucket)."""
    n_rows = idx.shape[1]
    rows = torch.arange(n_rows, device=idx.device)
    srow = rows // 2 if quant == "int4" else rows
    key = (srow[None, :] * store.shape[1] + idx.long()).unique()
    return int(key.numel()) * store.shape[2] * store.element_size()


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_work(name, hidden, head, idx, quant):
    """(bytes, operations) the kernel's function needs on these inputs:
    each input read once (only the count rows idx touches), each output
    written once; f32 multiply-adds count 2."""
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
        return 4 * b * dp + small + 4 * b * n_rows, hash_ops
    return 4 * b * n_rows + scale + sketch + 4 * b * v, gather_ops


def random_head(gen, cfg, v, quant):
    dev = gen.device
    head = {"proj": torch.randn((D_MODEL, cfg.proj_dim), generator=gen, device=dev) / D_MODEL ** 0.5,
            "w": torch.randn((cfg.n_rows, cfg.k, cfg.proj_dim), generator=gen, device=dev),
            "b": torch.rand((cfg.n_rows, cfg.k), generator=gen, device=dev) * cfg.bandwidth,
            "array": torch.randn((cfg.n_rows, cfg.n_buckets, v), generator=gen, device=dev)}
    if quant is not None:
        head["array"], head["scale"] = quantize_counts(head["array"], quant)
    return head


def check_fused(cfg, head, hidden, quant):
    """fused_decode against its plain version on (hidden, head): indices
    under the boundary rule, logits against the plain gather at the
    kernel's own indices and, where the indices agree, against the plain
    version, both within the gather bound.  Returns the kernel's logits
    (``got``), the error, the mismatch count and the plain indices."""
    store, scale = head["array"], head.get("scale")
    deq = store if quant is None else dequantize_sketch_ref(store, scale, quant)
    atol = gather_atol(cfg.n_rows, float(deq.abs().max()))
    r, nb = cfg.bandwidth, cfg.n_buckets
    args = (hidden, head["proj"], head["w"], head["b"], store)
    idx = torch.empty((hidden.shape[0], cfg.n_rows), dtype=torch.int32, device=hidden.device)
    ref_idx = torch.empty_like(idx)
    got = fused_decode_logits(*args, bandwidth=r, n_buckets=nb, scale=scale, quant=quant,
                              idx_out=idx)
    want = fused_decode_ref(*args, r, nb, scale, quant, ref_idx)
    torch.cuda.synchronize()
    mism = check_hash_indices(idx, ref_idx, hidden, head["w"], head["b"], r, proj=head["proj"])
    torch.testing.assert_close(got, sketch_head_ref(store, idx, scale, quant), rtol=0, atol=atol)
    same = (idx == ref_idx).all(dim=1)
    err = float((got[same] - want[same]).abs().max()) if bool(same.any()) else 0.0
    if err > atol:
        raise AssertionError(f"fused_decode logits off by {err} > {atol}")
    return dict(got=got, max_abs_err=err, idx_mismatches=mism, atol=atol, idx=ref_idx)


def check_and_time(timer, cfg, head, hidden, quant, library: bool):
    """Every kernel against its plain version on (hidden, head); returns
    {name: record}."""
    store, scale = head["array"], head.get("scale")
    deq = store if quant is None else dequantize_sketch_ref(store, scale, quant)
    atol = gather_atol(cfg.n_rows, float(deq.abs().max()))
    r, nb = cfg.bandwidth, cfg.n_buckets
    args = (hidden, head["proj"], head["w"], head["b"], store)
    kw = dict(bandwidth=r, n_buckets=nb, scale=scale, quant=quant)
    out = {}

    chk = check_fused(cfg, head, hidden, quant)
    out["fused_decode"] = dict(
        ms=timer.ms(lambda: fused_decode_logits(*args, **kw)),
        plain_ms=timer.ms(lambda: fused_decode_ref(*args, r, nb, scale, quant)),
        max_abs_err=chk["max_abs_err"], idx_mismatches=chk["idx_mismatches"], atol=atol,
        idx=chk["idx"], library_ms=None)

    q = hidden @ head["proj"]
    got_idx = lsh_hash(q, head["w"], head["b"], bandwidth=r, n_buckets=nb)
    want_idx = lsh_hash_ref(q, head["w"], head["b"], r, nb)
    torch.cuda.synchronize()
    mism = check_hash_indices(got_idx, want_idx, q, head["w"], head["b"], r)
    out["lsh_hash"] = dict(
        ms=timer.ms(lambda: lsh_hash(q, head["w"], head["b"], bandwidth=r, n_buckets=nb)),
        plain_ms=timer.ms(lambda: lsh_hash_ref(q, head["w"], head["b"], r, nb)),
        max_abs_err=float((got_idx - want_idx).abs().max()), idx_mismatches=mism,
        atol=0.0, idx=want_idx, library_ms=None)

    got = sketch_head_logits(store, want_idx, scale=scale, quant=quant)
    want = sketch_head_ref(store, want_idx, scale, quant)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= atol:
        raise AssertionError(f"sketch_head logits off by {err} > {atol}")
    lib = None
    if library and quant is None:
        # One PyTorch call computing the same mean of gathered rows (the
        # index offsets l·R are set up outside the timing).
        flat = (want_idx.long() + torch.arange(cfg.n_rows, device=q.device) * cfg.n_buckets)
        table = store.reshape(-1, store.shape[2])
        torch.testing.assert_close(F.embedding_bag(flat, table, mode="mean"), want,
                                   rtol=0, atol=atol)
        lib = timer.ms(lambda: F.embedding_bag(flat, table, mode="mean"))
    out["sketch_head"] = dict(
        ms=timer.ms(lambda: sketch_head_logits(store, want_idx, scale=scale, quant=quant)),
        plain_ms=timer.ms(lambda: sketch_head_ref(store, want_idx, scale, quant)),
        max_abs_err=err, idx_mismatches=0, atol=atol, idx=want_idx, library_ms=lib)

    for name, rec in out.items():
        nbytes, nops = kernel_work(name, hidden, head, rec.pop("idx"), quant)
        rec["bytes"], rec["ops"] = nbytes, nops
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, nops)
    return out


def kernel_phase(dev, timer):
    gen = torch.Generator(dev).manual_seed(1)
    cases = [(cfg, b, VOCAB, quant) for cfg in (SERVE_HEAD, DEFAULT_HEAD)
             for b in (1, 2, 4, 64, 256) for quant in (None, "int8", "int4")]
    cases += [(SERVE_HEAD, 4, VOCAB - 17, quant) for quant in (None, "int8", "int4")]
    for cfg, b, v, quant in cases:
        head = random_head(gen, cfg, v, quant)
        hidden = torch.randn((b, D_MODEL), generator=gen, device=dev)
        for name, rec in check_and_time(timer, cfg, head, hidden, quant, False).items():
            print("kernel_case " + json.dumps(dict(
                kernel=name, L=cfg.n_rows, R=cfg.n_buckets, K=cfg.k, d_proj=cfg.proj_dim,
                r=cfg.bandwidth, B=b, V=v, quant=quant or "f32", **rec)), flush=True)


def backbone_phase(dev):
    """The smoke model on the card against the same params on the CPU."""
    cpu_lm = LM.from_config("rwkv6-1.6b", smoke=True, device="cpu")
    cfg = cpu_lm.cfg

    def move(tree):
        return ({k: move(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.to(dev))
    params = move(cpu_lm.params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 40)))
    want, _ = model.forward(cpu_lm.params, toks, cfg)
    got, _ = model.forward(params, toks.to(dev), cfg)
    norm_err, max_err = bf16_backbone_errors(got.cpu().numpy(), want.numpy())
    print(f"backbone smoke cuda-vs-cpu: relative error {norm_err:.3g} in norm, "
          f"{max_err:.3g} of the largest logit (limits {BF16_NORM_TOL}, {BF16_MAX_TOL})")
    assert_bf16_backbone_close(got.cpu().numpy(), want.numpy())


def main_path(dev, timer):
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    lm = LM.from_config("rwkv6-1.6b", device=dev, generator=gen)
    cfg = lm.cfg
    m = 256
    kparams = {"points": torch.randn((m, SERVE_HEAD.proj_dim), generator=gen, device=dev),
               "alphas": torch.randn((m, cfg.vocab_size), generator=gen, device=dev) * 0.1,
               "proj": torch.randn((cfg.d_model, SERVE_HEAD.proj_dim), generator=gen,
                                   device=dev) / cfg.d_model ** 0.5}
    frozen = freeze_head(gen, kparams, SERVE_HEAD)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(lm.params))
    print(f"main path: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params, built and head "
          f"frozen in {time.perf_counter() - t0:.2f} s")
    heads = {"dense": lm.head,
             "fused": SketchHead(cfg=SERVE_HEAD, backend="fused", params=frozen),
             "two_kernel": SketchHead(cfg=SERVE_HEAD, backend="two_kernel", params=frozen)}
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    for head in heads.values():                       # warm-up: libraries, handles
        lm.with_head(head).generate(prompts, 2)
    runs = {name: [] for name in heads}
    want_launches = {"dense": {}, "fused": {"fused_decode": GEN - 1},
                     "two_kernel": {"lsh_hash": GEN - 1, "sketch_head": GEN - 1}}
    for rep in range(REPEATS):
        for name, head in heads.items():
            served = lm.with_head(head)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            tokens = served.generate(prompts, GEN)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launched = counts()
            if tokens.shape != (BATCH, PROMPT + GEN) or not torch.equal(tokens[:, :PROMPT], prompts):
                raise AssertionError(f"{name}: bad token block {tuple(tokens.shape)}")
            if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
                raise AssertionError(f"{name}: token ids out of range")
            for kname, n in launched.items():
                if n != want_launches[name].get(kname, 0):
                    raise AssertionError(f"{name} run launched {kname} {n} times, expected "
                                         f"{want_launches[name].get(kname, 0)}")
            runs[name].append(dict(seconds=dt, tokens=tokens, launches=launched))
            print(f"run {rep} head={served.head.describe()}: {BATCH}x{GEN} new tokens in "
                  f"{dt:.4f} s = {BATCH * GEN / dt:.1f} new tok/s; launches {launched}",
                  flush=True)
    for name, rs in runs.items():
        tps = sorted(BATCH * GEN / r["seconds"] for r in rs)
        print(f"generate head={name}: new tok/s over {REPEATS} runs {tps} "
              f"(median {float(np.median(tps)):.1f})")
    agree = float((runs["fused"][-1]["tokens"][:, PROMPT:]
                   == runs["two_kernel"][-1]["tokens"][:, PROMPT:]).float().mean())
    print(f"free-running fused vs two_kernel token agreement (reported, not gated): {agree:.3f}")
    step_profile(lm, heads, prompts, runs["fused"][-1]["tokens"])

    # Teacher-forced: the dense prefill, then one decode step's hidden
    # through both sketched backends.
    with torch.inference_mode():
        cache = model.init_decode_cache(cfg, BATCH, PROMPT + GEN, device=dev)
        logits, cache = prefill_step(lm.params, prompts, cfg, cache)
        tok = runs["fused"][-1]["tokens"][:, PROMPT:PROMPT + 1]
        hidden, _ = model.decode_step(lm.params, cache, tok, cfg, return_hidden=True)
    if logits.shape != (BATCH, cfg.vocab_size) or not bool(logits.isfinite().all()):
        raise AssertionError("prefill logits not finite or mis-shaped")
    if hidden.shape != (BATCH, cfg.d_model) or not bool(hidden.isfinite().all()):
        raise AssertionError("decode hidden not finite or mis-shaped")
    idx_f = torch.empty((BATCH, SERVE_HEAD.n_rows), dtype=torch.int32, device=dev)
    fused = fused_decode_logits(hidden, frozen["proj"], frozen["w"], frozen["b"], frozen["array"],
                                bandwidth=SERVE_HEAD.bandwidth, n_buckets=SERVE_HEAD.n_buckets,
                                idx_out=idx_f)
    idx_t = lsh_hash(hidden @ frozen["proj"], frozen["w"], frozen["b"],
                     bandwidth=SERVE_HEAD.bandwidth, n_buckets=SERVE_HEAD.n_buckets)
    two = sketch_head_logits(frozen["array"], idx_t)
    torch.cuda.synchronize()
    if not (bool(fused.isfinite().all()) and bool(two.isfinite().all())):
        raise AssertionError("sketched logits not finite")
    mism = check_hash_indices(idx_f, idx_t, hidden, frozen["w"], frozen["b"],
                              SERVE_HEAD.bandwidth, proj=frozen["proj"])
    atol = gather_atol(SERVE_HEAD.n_rows, float(frozen["array"].abs().max()))
    same = (idx_f == idx_t).all(dim=1)
    torch.testing.assert_close(fused[same], two[same], rtol=0, atol=atol)
    print(f"teacher-forced decode step: fused vs two_kernel {mism} index mismatches "
          f"(all at floor boundaries), logits within {atol:.3g} on {int(same.sum())}/{BATCH} rows")

    recs = check_and_time(timer, SERVE_HEAD, frozen, hidden, None, True)
    return runs, recs, lm, frozen, kparams


def step_profile(lm, heads, prompts, tokens):
    """One decode step per head: median wall time of 5 synchronized steps,
    then one step under torch.profiler for the device's kernel time (busy
    share = kernel time / unprofiled step time) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    cfg, dev = lm.cfg, prompts.device
    with torch.inference_mode():
        cache = model.init_decode_cache(cfg, BATCH, PROMPT + GEN, device=dev)
        _, cache = prefill_step(lm.params, prompts, cfg, cache)
        tok = tokens[:, PROMPT:PROMPT + 1]
        for name, head in heads.items():
            head = head.to(dev)
            walls = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve_step(lm.params, cache, tok, cfg, head=head)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = float(np.median(walls[1:]))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                serve_step(lm.params, cache, tok, cfg, head=head)
                torch.cuda.synchronize()
            kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
            busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 if kernels else None
            top = {}
            for e in kernels:
                top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us()
            top = sorted(top.items(), key=lambda kv: -kv[1])[:6]
            busy_txt = ("not measured (the profiler saw no device events)" if busy is None
                        else f"{busy:.3f} ms of kernels in {len(kernels)} launches, busy share "
                             f"{busy / wall:.3f}")
            print(f"decode step head={name}: {wall:.3f} ms wall (median of 5); {busy_txt}")
            for kname, us in top:
                print(f"    {us / 1e3:8.4f} ms  {kname[:90]}")


def race_inputs(counts, idx, alphas, entry):
    """(kernel, plain, library call, class axis) of one race_update entry on
    these inputs.  The library call is one PyTorch call computing the same
    ``counts + delta`` as a one-hot product (the TPU kernel's MXU form), its
    one-hot built here, outside any timing: ``baddbmm`` over the (L, R, V)
    layout, ``addmm`` over the (C, L·R) view of a (C, L, R) sketch."""
    m, n_rows = idx.shape
    n_buckets = counts.shape[1] if entry == "counts" else counts.shape[2]
    onehot = (idx.long()[..., None] == torch.arange(n_buckets, device=idx.device)).float()
    if entry == "counts":
        lrm = onehot.permute(1, 2, 0).contiguous()                  # (L, R, M)
        expanded = alphas[None].expand(n_rows, m, alphas.shape[1])  # (L, M, V), no copy
        return (lambda: race_update_counts(counts, idx, alphas),
                lambda: race_update_counts_ref(counts, idx, alphas),
                lambda: torch.baddbmm(counts, lrm, expanded), -1)
    flat, mlr = counts.view(counts.shape[0], -1), onehot.reshape(m, -1)
    return (lambda: race_update(counts, idx, alphas),
            lambda: race_update_ref(counts, idx, alphas),
            lambda: torch.addmm(flat, alphas.t(), mlr).view(counts.shape), 0)


def race_work(counts, idx, alphas):
    """(bytes, operations) of one fold: counts read and written once, idx and
    alphas read once; one f32 add per (point, row, class)."""
    m, n_rows = idx.shape
    return (8 * counts.numel() + 4 * alphas.numel() + 4 * idx.numel(),
            m * n_rows * alphas.shape[1])


def check_race(timer, counts, idx, alphas, entry, library=True):
    """race_update against its plain version: every element within
    ``race_update_tol``, two launches bit for bit equal, and the library
    call within twice that bound; returns the timed record."""
    fn, plain, lib, axis = race_inputs(counts, idx, alphas, entry)
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"race_update ({entry}): two launches gave different bits")
    tol = race_update_tol(counts, alphas, axis)
    err = (got - want).abs()
    if not bool((err.double() <= tol).all()):
        raise AssertionError(f"race_update ({entry}) off by {float(err.max())}, beyond the "
                             f"gamma bound")
    rec = dict(max_abs_err=float(err.max()), ms=timer.ms(fn), plain_ms=timer.ms(plain),
               library_ms=None)
    if library:
        if not bool(((lib() - want).abs().double() <= 2 * tol).all()):
            raise AssertionError(f"race_update ({entry}): the library call disagrees")
        rec["library_ms"] = timer.ms(lib)
    rec["bytes"], rec["ops"] = race_work(counts, idx, alphas)
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["ops"])
    return rec


def race_phase(dev, timer):
    """race_update against race_update_ref at M in {32, 256, 1024}, the serve
    head (L=128) and SketchHeadConfig() (L=64), R=16, V=65536 and a ragged
    65519, through both entries."""
    gen = torch.Generator(dev).manual_seed(2)
    for cfg in (SERVE_HEAD, DEFAULT_HEAD):
        for v in (VOCAB, VOCAB - 17):
            counts = torch.randn((cfg.n_rows, cfg.n_buckets, v), generator=gen, device=dev)
            for m in (32, 256, 1024):
                idx = torch.randint(0, cfg.n_buckets, (m, cfg.n_rows), generator=gen,
                                    device=dev, dtype=torch.int32)
                alphas = torch.randn((m, v), generator=gen, device=dev) * 0.1
                for entry in ("counts", "sketch"):
                    arr = counts if entry == "counts" else counts.permute(2, 0, 1).contiguous()
                    rec = check_race(timer, arr, idx, alphas, entry)
                    print("kernel_case " + json.dumps(dict(
                        kernel="race_update", entry=entry, M=m, L=cfg.n_rows,
                        R=cfg.n_buckets, V=v, **rec)), flush=True)
                    del arr


def run_engine(lm, stream, n_slots, *, tenants=None, head_cache=None):
    """Serve ``stream`` through ``lm.engine`` with the launch counts zeroed
    just before and read just after; returns (engine, finished, seconds,
    launches)."""
    eng = lm.engine(n_slots, PROMPT + GEN, head_cache=head_cache)
    for i, (prompt, gen, arrival) in enumerate(stream):
        eng.submit(prompt, gen, arrival=arrival,
                   tenant=None if tenants is None else tenants[i])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    finished = eng.run()
    torch.cuda.synchronize()
    return eng, finished, time.perf_counter() - t0, counts()


def engine_report(label, eng, finished, seconds, launched):
    n_new = sum(len(v) for v in finished.values())
    steps = eng.stats["decode_steps"]
    print(f"engine {label}: {len(finished)} requests over {eng.n_slots} slots, {n_new} new "
          f"tokens in {seconds:.4f} s = {n_new / seconds:.1f} new tok/s, {steps} decode ticks, "
          f"slot utilization {eng.slot_utilization:.3f}, launches {launched} "
          f"({ {k: v / steps for k, v in launched.items() if v} } per tick)", flush=True)


def expect_launches(label, launched, want):
    for name, n in launched.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {n} times, expected "
                                 f"{want.get(name, 0)}")


def engine_phase(dev, lm, frozen, kparams):
    """(a) Dense and single sketched engines: four requests arriving together
    into four slots equal LM.generate of the same batch token for token; the
    staggered 12-request stream served twice to the same tokens, every slot
    back to a fresh row after it, and every step of every stream held
    against a solo run (``check_staggered``).  (b) Per-tenant heads through
    a HeadCache against single-tenant engines."""
    cfg = lm.cfg
    stream = engine_stream(cfg.vocab_size, N_REQUESTS, PROMPT, GEN, 1, 0)
    together = torch.randint(0, cfg.vocab_size, (SLOTS, PROMPT),
                             generator=torch.Generator(dev).manual_seed(5), device=dev)
    for name, head in (("dense", DenseHead()),
                       ("fused", SketchHead(cfg=SERVE_HEAD, backend="fused", params=frozen))):
        served = lm.with_head(head)
        want = served.generate(together, GEN)[:, PROMPT:].tolist()
        got = served.serve([(p, GEN) for p in together.cpu().numpy()], n_slots=SLOTS)
        if [got[i] for i in range(SLOTS)] != want:
            raise AssertionError(f"engine {name}: requests arriving together differ from "
                                 f"LM.generate of the same batch")
        print(f"engine {name}: {SLOTS} requests arriving together equal LM.generate of the "
              f"same batch token for token")

        eng, fin, dt, launched = run_engine(served, stream, SLOTS)
        engine_report(served.head.describe(), eng, fin, dt, launched)
        expect_launches(name, launched,
                        {"fused_decode": eng.stats["decode_steps"]} if name == "fused" else {})
        fresh = model.init_decode_cache(cfg, SLOTS, PROMPT + GEN, device=dev)
        for a, b in zip(eng.pool["periods"]["pos0"], fresh["periods"]["pos0"]):
            if not torch.equal(a, b):
                raise AssertionError(f"engine {name}: a retired slot is not a fresh row")
        rec_fin, ticks = record_engine(served, stream, SLOTS)
        if rec_fin != fin:
            raise AssertionError(f"engine {name}: a second run of the stream gave other tokens")
        check_staggered(name, served, stream, fin, ticks, frozen)

    tenants = {f"tenant-{t}": freeze_head(torch.Generator(dev).manual_seed(100 + t), kparams,
                                          SERVE_HEAD) for t in range(3)}
    names = [f"tenant-{i % 3}" for i in range(N_REQUESTS)]
    cache = HeadCache(tenants.__getitem__, CAPACITY)
    spec = lm.with_head(SketchHead(cfg=SERVE_HEAD, backend="fused"))
    eng, multi, dt, launched = run_engine(spec, stream, TENANT_SLOTS, tenants=names,
                                          head_cache=cache)
    engine_report(f"{eng.backend.head.describe()} (3 tenants, capacity {CAPACITY})",
                  eng, multi, dt, launched)
    print(f"  head cache stats {cache.stats}")
    expect_launches("per-tenant", launched,
                    {"fused_decode": CAPACITY * eng.stats["decode_steps"]})
    if not cache.stats["evictions"]:
        raise AssertionError("the per-tenant run evicted no tenant")
    for t, params in tenants.items():
        single = lm.with_head(SketchHead(cfg=SERVE_HEAD, backend="fused", params=params))
        _, solo, _, _ = run_engine(single, stream, TENANT_SLOTS)
        for i, name in enumerate(names):
            if name == t and multi[i] != solo[i]:
                raise AssertionError(f"per-tenant request {i} ({t}) differs from the "
                                     f"single-tenant engine")
    print("per-tenant engine: every stream equals its tenant's single-tenant engine")
    return launched


class HiddenTap:
    """Stands in for a head and keeps a copy of the final hidden of every
    call (the head's own ``apply`` still computes the logits)."""

    def __init__(self, head):
        self.head, self.seen = head, []

    def __getattr__(self, name):
        return getattr(self.head, name)

    def apply(self, params, hidden):
        self.seen.append(hidden.float().clone())
        return self.head.apply(params, hidden)


def record_engine(served, stream, n_slots):
    """Serve ``stream`` through an engine whose backend keeps, at every
    decode tick, the slot owners, the (n_slots, V) logits and, for a
    sketched head, the (n_slots, d) final hidden; returns (finished,
    ticks)."""
    eng = served.engine(n_slots, PROMPT + GEN)
    for prompt, gen, arrival in stream:
        eng.submit(prompt, gen, arrival=arrival)
    backend, ticks = eng.backend, []
    tap = HiddenTap(backend.head) if backend.head.needs_hidden else None
    if tap is not None:
        backend.head = tap
    decode = backend.decode

    def recording_decode(pool, tokens, pos, active, head_params=None):
        owner = dict(eng.sched.owner)
        logits, pool = decode(pool, tokens, pos, active, head_params=head_params)
        ticks.append(dict(owner=owner, logits=logits.float().clone(),
                          hidden=None if tap is None else tap.seen.pop()))
        return logits, pool

    backend.decode = recording_decode
    return eng.run(), ticks


def solo_steps(served, prompt, tokens):
    """A solo run (batch 1, ``LM.generate``'s own prefill and decode steps)
    teacher-forced on ``tokens``: the logits that pick each of them and,
    for a sketched head, the final hidden of each decode step (None for
    the prefill's)."""
    cfg, dev = served.cfg, served.device
    tap = HiddenTap(served.head) if served.head.needs_hidden else None
    with torch.inference_mode():
        cache = model.init_decode_cache(cfg, 1, PROMPT + GEN, device=dev)
        logits, cache = prefill_step(served.params, torch.as_tensor(prompt, device=dev)[None]
                                     .long(), cfg, cache)
        out = [logits[0].float()]
        for tok in tokens[:-1]:
            logits, cache = serve_step(served.params, cache, torch.tensor([[tok]], device=dev),
                                       cfg, head=tap or served.head)
            out.append(logits[0].float())
    return out, [None] + ([h[0] for h in tap.seen] if tap else [None] * (len(out) - 1))


def track(worst, errs, i, j):
    """[largest norm error, largest max error, (request, token) of the
    largest norm error] after one more step's errors."""
    at = (i, j) if errs[0] > worst[0] else worst[2]
    return [max(worst[0], errs[0]), max(worst[1], errs[1]), at]


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def check_staggered(name, served, stream, fin, ticks, frozen):
    """Every step of every staggered stream against a solo run teacher-forced
    on the engine's tokens.  On the card a row's bf16 bits depend on how
    many rows share its GEMM (cuBLAS picks its kernel by the row count; the
    engine decodes four rows a step, solo generate one), so the two agree
    under the bf16 backbone rule, not bit for bit:

    * every token taken from dense logits (all of the dense head's, the
      first of the sketched head's, from the prefill) is within two bf16
      ulps of the solo logits' maximum, and from the second token on the
      engine's own logits meet the bf16 backbone rule against the solo's;
    * sketched: the engine's final hidden meets the bf16 backbone rule
      against the solo's at every decode step, and each tick's logits are
      bit for bit the fused kernel's on that tick's hiddens, which is held
      against fused_decode_ref (``check_fused``: indices under the boundary
      rule, logits under the gather bound).  The engine's and the solo's
      buckets are computed from hiddens that differ in their last bits, so
      a bucket may flip between them; those flips are counted, not gated.

    A stream equals solo ``LM.generate`` token for token exactly when the
    solo run picks the engine's token at every step (the same steps at
    batch 1, deterministic)."""
    per_rid = {}
    for tick in ticks:
        if tick["hidden"] is not None:
            chk = check_fused(SERVE_HEAD, frozen, tick["hidden"], None)
            rows = sorted(tick["owner"])
            if not torch.equal(chk["got"][rows], tick["logits"][rows]):
                raise AssertionError(f"engine {name}: a tick's logits are not the fused "
                                     f"kernel's on its hiddens")
        for s, rid in tick["owner"].items():
            per_rid.setdefault(rid, []).append((tick["logits"][s], None if tick["hidden"] is None
                                                else tick["hidden"][s]))
    proj, w, b = frozen["proj"], frozen["w"], frozen["b"]
    n_equal, n_steps, n_flips, worst_gap, worst = 0, 0, 0, 0.0, [0.0, 0.0, None]
    for i, (prompt, gen, _) in enumerate(stream):
        toks, steps = fin[i], per_rid.get(i, [])
        if len(toks) != gen or len(steps) != gen - 1:
            raise AssertionError(f"engine {name}: request {i} has {len(toks)} tokens from "
                                 f"{len(steps)} decode steps, expected {gen} from {gen - 1}")
        solo, solo_hidden = solo_steps(served, prompt, toks)
        n_equal += all(int(torch.argmax(solo[j])) == toks[j] for j in range(gen))
        for j in range(gen):
            n_steps += 1
            eng_logits, eng_hidden = steps[j - 1] if j else (None, None)
            if j and int(torch.argmax(eng_logits)) != toks[j]:
                raise AssertionError(f"engine {name}: request {i} token {j} is not the first "
                                     f"maximum of its own logits")
            if j and eng_hidden is not None:
                got, want = eng_hidden.cpu().numpy(), solo_hidden[j].cpu().numpy()
                worst = track(worst, bf16_backbone_errors(got, want), i, j)
                assert_bf16_backbone_close(got, want)
                pair = torch.stack([eng_hidden, solo_hidden[j]])
                buckets = lsh_hash_ref(pair @ proj, w, b, SERVE_HEAD.bandwidth,
                                       SERVE_HEAD.n_buckets)
                n_flips += int((buckets[0] != buckets[1]).sum())
                continue
            logits = solo[j]
            top = float(logits.max())
            gap, tol = top - float(logits[toks[j]]), 2 * bf16_ulp(float(logits.abs().max()))
            worst_gap = max(worst_gap, gap)
            if not gap <= tol:
                raise AssertionError(f"engine {name}: request {i} token {j} ({toks[j]}) is "
                                     f"{gap} below the solo maximum {top}, beyond two bf16 "
                                     f"ulps ({tol})")
            if j:
                got, want = eng_logits.cpu().numpy(), logits.cpu().numpy()
                worst = track(worst, bf16_backbone_errors(got, want), i, j)
                assert_bf16_backbone_close(got, want)
    what = "logits" if name == "dense" else "final hidden"
    print(f"engine {name}: {n_equal} of {len(stream)} staggered streams equal solo "
          f"LM.generate token for token; all {n_steps} steps held against a teacher-forced "
          f"solo run: dense-logit tokens at most {worst_gap:.6g} below the solo maximum (two "
          f"bf16 ulps allowed), engine {what} within {worst[0]:.3g} in norm and "
          f"{worst[1]:.3g} of the largest (limits {BF16_NORM_TOL}, {BF16_MAX_TOL}; largest "
          f"norm error at request, new token {worst[2]})"
          + ("" if name == "dense" else f"; {n_flips} engine-vs-solo bucket flips over "
             f"{n_steps - len(stream)} decode steps (reported)"), flush=True)


def refresh_phase(dev, timer, lm, kparams, quant):
    """(c) Refresh tenant-0 from M = 256 live hiddens with the dense head's
    logits as targets while tenant-0 requests are in flight; check the fold,
    the double buffer and the publish.  Returns the launches of the refresh
    and, for f32 counts, the race_update record at the refresh's inputs."""
    cfg = lm.cfg
    gen = torch.Generator(dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (REFRESH_PROMPTS, PROMPT), generator=gen, device=dev)
    with torch.inference_mode():
        hidden, _ = model.forward(lm.params, toks, cfg, return_hidden=True)
        targets, _ = model.forward(lm.params, toks, cfg)
    hidden, targets = hidden.reshape(-1, cfg.d_model), targets.reshape(-1, cfg.vocab_size)
    tenants = {f"tenant-{t}": freeze_head(torch.Generator(dev).manual_seed(100 + t), kparams,
                                          SERVE_HEAD, quant=quant) for t in range(2)}
    spec = lm.with_head(SketchHead(cfg=SERVE_HEAD, backend="fused", quant=quant))
    stream = engine_stream(cfg.vocab_size, 4, PROMPT, GEN, 1, 3)
    # Each comparison runs the same requests on the same ticks in both
    # engines: on the card a row's bits depend on its prefill batch size.
    before = [(p, GEN, a) for p, _, a in stream[:2]]
    after = [(p, GEN, 0) for p, _, _ in stream[2:]]
    label = f"refresh ({'f32' if quant is None else quant} bank)"

    _, base, _, _ = run_engine(spec, before, TENANT_SLOTS, tenants=["tenant-0"] * 2,
                               head_cache=HeadCache(tenants.__getitem__, CAPACITY))
    cache = HeadCache(tenants.__getitem__, CAPACITY)
    eng = spec.engine(TENANT_SLOTS, PROMPT + GEN, head_cache=cache)
    for p, g, a in before:
        eng.submit(p, g, arrival=a, tenant="tenant-0")
    eng.step()
    eng.step()
    row = cache.tenant_params("tenant-0")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng.refresh("tenant-0", hidden, targets=targets)
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    launched = counts()
    expect_launches(label, launched, {"race_update": 1, "lsh_hash": 1, "fused_decode": 1})
    shadow = {k: v.clone() for k, v in eng.pending_refresh("tenant-0").items()}

    # The fold against the plain version on the same points: indices under
    # the boundary rule; pred, fused_decode at B = M on the f32 shadow's
    # counts, against fused_decode_ref under the boundary rule and the
    # gather bound; counts under gamma.
    row32 = dequantize_head(row, quant)
    q = hidden @ row32["proj"]
    idx = lsh_hash(q, row32["w"], row32["b"], bandwidth=SERVE_HEAD.bandwidth,
                   n_buckets=SERVE_HEAD.n_buckets)
    mism = check_hash_indices(idx, lsh_hash_ref(q, row32["w"], row32["b"], SERVE_HEAD.bandwidth,
                                                SERVE_HEAD.n_buckets),
                              q, row32["w"], row32["b"], SERVE_HEAD.bandwidth)
    pred_chk = check_fused(SERVE_HEAD, row32, hidden, None)
    print("kernel_case " + json.dumps(dict(
        kernel="fused_decode", entry=f"refresh pred ({'f32' if quant is None else quant} bank)",
        B=hidden.shape[0], L=SERVE_HEAD.n_rows, R=SERVE_HEAD.n_buckets, V=cfg.vocab_size,
        **{k: pred_chk[k] for k in ("max_abs_err", "idx_mismatches", "atol")})))
    alphas = targets - pred_chk["got"]
    want = race_update_counts_ref(row32["array"], idx, alphas)
    err = (shadow["array"] - want).abs()
    if not bool((err.double() <= race_update_tol(row32["array"], alphas, -1)).all()):
        raise AssertionError(f"{label}: shadow counts off by {float(err.max())}")

    for k, v in cache.tenant_params("tenant-0").items():
        if not torch.equal(v, row[k]):
            raise AssertionError(f"{label}: bank row {k} changed before publish")
    inflight = eng.run()
    for i in range(len(before)):
        if inflight[i] != base[i]:
            raise AssertionError(f"{label}: in-flight request {i} changed before publish")
    for k, v in cache.tenant_params("tenant-0").items():
        if not torch.equal(v, row[k]):
            raise AssertionError(f"{label}: bank row {k} changed before publish")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.publish("tenant-0")
    torch.cuda.synchronize()
    t_publish = time.perf_counter() - t0
    published = cache.tenant_params("tenant-0")
    for k, v in quantize_head(shadow, quant).items():
        if not torch.equal(published[k], v):
            raise AssertionError(f"{label}: published {k} is not the re-stored shadow")
    if torch.equal(published["array"], row["array"]):
        raise AssertionError(f"{label}: publish left the counts unchanged")

    rids = [eng.submit(p, g, arrival=a, tenant="tenant-0") for p, g, a in after]
    got = eng.run()
    fresh_store = dict(tenants, **{"tenant-0": published})
    _, fresh, _, _ = run_engine(spec, after, TENANT_SLOTS, tenants=["tenant-0"] * 2,
                                head_cache=HeadCache(fresh_store.__getitem__, CAPACITY))
    for j, rid in enumerate(rids):
        if got[rid] != fresh[j]:
            raise AssertionError(f"{label}: request {rid} after publish differs from a fresh "
                                 f"engine loaded with the published head")
    print(f"{label}: M={hidden.shape[0]} points folded in {t_refresh * 1e3:.3f} ms wall "
          f"(launches {launched}), published in {t_publish * 1e3:.3f} ms wall; "
          f"{mism} index mismatches at floor boundaries, shadow within the gamma bound "
          f"(max error {float(err.max()):.3g}); bank row and in-flight streams unchanged "
          f"until publish; after publish streams equal a fresh engine", flush=True)
    rec = None
    if quant is None:
        rec = check_race(timer, row32["array"], idx, alphas.contiguous(), "counts")
        print("kernel_case " + json.dumps(dict(kernel="race_update", entry="refresh",
                                               M=hidden.shape[0], L=SERVE_HEAD.n_rows,
                                               R=SERVE_HEAD.n_buckets, V=cfg.vocab_size, **rec)))
    return launched, rec


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False      # IEEE f32: TF32 flips floor()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()
    print(card_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    print(f"kernel build: {seconds:.2f} s for {', '.join(_build.sources())}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    timer = Timer(dev)

    phase_seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("kernels", kernel_phase, dev, timer)
    timed("race_update", race_phase, dev, timer)
    timed("backbone", backbone_phase, dev)
    runs, recs, lm, frozen, kparams = timed("main path", main_path, dev, timer)
    refresh_launches, recs["race_update"] = timed("refresh f32", refresh_phase, dev, timer, lm,
                                                  kparams, None)
    timed("refresh int8", refresh_phase, dev, timer, lm, kparams, "int8")
    timed("engine", engine_phase, dev, lm, frozen, kparams)
    print(f"phase seconds: {phase_seconds}")

    line = []
    for name, (_, source, replaces) in KERNELS.items():
        rec = recs[name]
        if name == "race_update":
            launches = refresh_launches[name]
        else:
            launches = runs["two_kernel" if name != "fused_decode" else "fused"][-1][
                "launches"][name]
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches, max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                         plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                         bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
