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
   d'=64, r=4), B in {1, 4, 64}, f32/int8/int4 counts.  Indices obey the
   boundary rule and logits the gather bound of
   ``repro_torch.parity``; one ``kernel_case`` JSON line each, with
   CUDA-event times (median of 20 runs after warm-up, L2 flushed before
   each run).
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
5. Prints the ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is non-zero and the last line
is not printed.  Without a CUDA device it exits non-zero at once.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api import LM, SketchHead
from repro_torch.core.sketch_lm_head import freeze_head, quantize_counts
from repro_torch.kernels import _build
from repro_torch.kernels.fused_decode.ops import fused_decode_logits, fused_decode_ref
from repro_torch.kernels.lsh_hash.ops import lsh_hash, lsh_hash_ref
from repro_torch.parity import (BF16_MAX_TOL, BF16_NORM_TOL, assert_bf16_backbone_close,
                                bf16_backbone_errors, check_hash_indices, gather_atol)
from repro_torch.kernels.sketch_head.ops import (dequantize_sketch_ref,
                                                 sketch_head_logits,
                                                 sketch_head_ref)
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
}


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

    # fused_decode: indices under the boundary rule, logits against the
    # plain gather at the kernel's own indices and, where the indices
    # agree, against the plain version.
    idx = torch.empty((hidden.shape[0], cfg.n_rows), dtype=torch.int32, device=hidden.device)
    ref_idx = torch.empty_like(idx)
    got = fused_decode_logits(*args, idx_out=idx, **kw)
    want = fused_decode_ref(*args, r, nb, scale, quant, ref_idx)
    torch.cuda.synchronize()
    mism = check_hash_indices(idx, ref_idx, hidden, head["w"], head["b"], r, proj=head["proj"])
    torch.testing.assert_close(got, sketch_head_ref(store, idx, scale, quant), rtol=0, atol=atol)
    same = (idx == ref_idx).all(dim=1)
    err = float((got[same] - want[same]).abs().max()) if bool(same.any()) else 0.0
    if err > atol:
        raise AssertionError(f"fused_decode logits off by {err} > {atol}")
    out["fused_decode"] = dict(
        ms=timer.ms(lambda: fused_decode_logits(*args, **kw)),
        plain_ms=timer.ms(lambda: fused_decode_ref(*args, r, nb, scale, quant)),
        max_abs_err=err, idx_mismatches=mism, atol=atol, idx=ref_idx,
        library_ms=None)

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
             for b in (1, 4, 64) for quant in (None, "int8", "int4")]
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
    return runs, recs


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

    kernel_phase(dev, timer)
    backbone_phase(dev)
    runs, recs = main_path(dev, timer)

    line = []
    for name, (_, source, replaces) in KERNELS.items():
        rec = recs[name]
        launches = runs["two_kernel" if name != "fused_decode" else "fused"][-1]["launches"][name]
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
