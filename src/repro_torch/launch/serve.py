"""Serving launcher: dense or sketched head, greedy or seeded sampling, as
one static batch or (``--engine``) a request stream through the
continuous-batching engine.

A single bulk prefill ingests every prompt through the dense head, then
the decode loop emits tokens step by step; with ``--sketch-head`` each
decode step's logits come from the Representer-Sketch head on its
``--backend`` (``fused``: one CUDA kernel; ``two_kernel``; ``ref``);
``--decode-chunk K`` decodes K tokens per megastep (on the card, a CUDA
graph of one decode step replayed K times), for ``generate`` and the
engine alike, with the same tokens; ``--spec-decode K`` decodes
speculatively instead (the head drafts up to K tokens a tick, the dense
head verifies them: the dense head's tokens, and the banner prints the
acceptance rate).  ``--engine --paged --page-size N`` keeps the engine's
caches in a page pool with a prefix cache (the same streams; repeated
prompts skip their prefill; the banner prints prefix hits and
copy-on-write copies).  ``--temperature`` (0: greedy), ``--top-k`` and
``--top-p`` sample on the key chain of ``--seed`` (which also seeds the
random backbone, the prompts and, for an arch with cross-attention
layers, its stub encoder states), the same stream at every
``--decode-chunk`` and ``--spec-decode``.  The
head is loaded from a ``--head-path`` archive saved by either package, or,
without one, distilled from the dense unembed in process (a short
distillation, then a freeze).  ``--engine`` serves a synthetic stream
instead (staggered arrivals, every 4th prompt shared, lengths ``gen`` and
``gen // 4``) over ``--batch`` slots; ``--tenants N`` with ``--engine
--sketch-head`` serves N per-tenant heads (one shared distillation, a hash
bank each) through a ``HeadCache``, requests round-robin over tenants.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      [--arch {rwkv6-1.6b,gemma2-27b,granite-8b,stablelm-12b,command-r-35b,
               musicgen-large,mixtral-8x7b,jamba-v0.1-52b,deepseek-v3-671b,
               llama-3.2-vision-11b}] [--smoke] \\
      [--sketch-head [--head-path head.npz]] [--backend fused] \\
      [--quant int8] [--batch 4 --prompt-len 32 --gen 16] [--device cuda] \\
      [--decode-chunk 16 | --spec-decode 4] \
      [--temperature 0.9 --top-k 12 --top-p 0.95 --seed 7] \\
      [--engine --requests 12 --arrival-every 1 --stats-json [--tenants 3]
       [--paged --page-size 16]]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api.heads import DenseHead, SketchHead
from repro_torch.api.sampler import Sampler
from repro_torch.launch.decode_loop import (decode_chunks, generate_loop,
                                            spec_decode_chunks)
from repro_torch.launch.steps import place_cache, prefill_step_, serve_step_
from repro_torch.models.config import SketchHeadConfig
from repro_torch.models.model import cache_leaves, init_decode_cache
from repro_torch.sharding.ctx import serving

#: The head that ``--sketch-head`` distills for an arch without its own.
QUICK_HEAD = SketchHeadConfig(n_rows=128, n_buckets=16, k=1, proj_dim=32,
                              bandwidth=2.0)


def generate(params: dict, cfg, prompts: torch.Tensor, gen_len: int, *,
             head=None, sampler: Optional[Sampler] = None,
             eos_id: Optional[int] = None, pad_id: int = 0,
             decode_chunk: int = 1, spec_decode: int = 0,
             return_stats: bool = False, loops: Optional[dict] = None,
             encoder_states: Optional[torch.Tensor] = None, mesh=None):
    """Bulk prefill + decode. prompts (B, P) → tokens (B, P + gen_len).

    The first new token comes from the prefill's dense logits, each later
    one from a decode step through ``head`` (``gen_len - 1`` steps, each
    writing the cache in place); ``sampler`` (greedy when omitted) picks
    them, a seeded one on the key chain of its seed: the root key samples
    the first token and every later sample splits the carried key once,
    the JAX package's chain, whatever ``decode_chunk`` or ``spec_decode``.  With ``eos_id``, a finished sequence's
    later positions hold ``pad_id``, its cache rows freeze, and the loop
    ends once every row is done.  The prefill writes into the one decode
    cache of the call (``prefill_step_``).

    ``decode_chunk=K`` (> 1) runs the decode loop as megasteps of K steps
    (``launch/decode_loop.py``: a CUDA graph of one step replayed K times
    on the card), with the same tokens; the early exit on ``eos_id`` then
    comes at chunk granularity, and the tail is padding.

    ``spec_decode=K`` (> 0) decodes speculatively: ``head`` drafts up to K
    tokens a tick, the dense head verifies them (``SpecLoop``), and the
    tokens are the dense head's, bit for bit.  It excludes
    ``decode_chunk > 1``.  ``return_stats=True`` also returns a dict:
    ``decode_steps`` (the backbone's steps), and with ``spec_decode``
    ``verify_calls``, ``draft_tokens`` and ``accepted_draft_tokens``.

    ``loops`` memoizes the loops of ``decode_chunk > 1`` and
    ``spec_decode``, which own the call's decode cache (see
    ``decode_loop.memo_loop`` for the bound).  ``encoder_states`` (B, T,
    d) are what an arch's ``xattn`` layers attend to, in the prefill and
    at every decode step.

    Raises:
      ValueError: ``decode_chunk < 1``, ``spec_decode < 0``, or both
        ``spec_decode`` and ``decode_chunk > 1``.
    """
    if decode_chunk < 1:
        raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
    if spec_decode < 0:
        raise ValueError(f"spec_decode must be >= 0, got {spec_decode}")
    if spec_decode and decode_chunk > 1:
        raise ValueError("spec_decode and decode_chunk > 1 are mutually "
                         "exclusive: the speculative tick already advances "
                         "up to K tokens")
    head = head or DenseHead()
    sampler = sampler or Sampler()
    b, p = prompts.shape
    with serving(mesh):
        if decode_chunk > 1 or spec_decode:
            template = init_decode_cache(cfg, b, p + gen_len, device="meta")
            loop = generate_loop(params, cfg, head=head, sampler=sampler,
                                 template=template, device=prompts.device,
                                 masked=eos_id is not None, eos_id=eos_id,
                                 pad_id=pad_id, spec_k=spec_decode,
                                 loops=loops, encoder_states=encoder_states,
                                 mesh=mesh)
            cache = loop.cache
            for leaf in cache_leaves(cache):
                leaf.zero_()
        else:
            cache = place_cache(init_decode_cache(
                cfg, b, p + gen_len, device=prompts.device), mesh)
        logits, cache = prefill_step_(params, prompts, cfg, cache,
                                      encoder_states=encoder_states)
        kw = dict(cfg=cfg, head=head, sampler=sampler, gen_len=gen_len,
                  start_pos=p, eos_id=eos_id, pad_id=pad_id,
                  encoder_states=encoder_states)
        if spec_decode:
            tail, stats = spec_decode_chunks(params, cache, logits,
                                             spec_k=spec_decode, loops=loops,
                                             **kw)
        elif decode_chunk > 1:
            stats = {}
            tail = decode_chunks(params, cache, logits, chunk=decode_chunk,
                                 loops=loops, stats=stats, **kw)
        else:
            tail, stats = _decode_host_loop(params, cache, logits, **kw)
    tokens = torch.cat([prompts, tail], dim=1)
    return (tokens, stats) if return_stats else tokens


def _decode_host_loop(params, cache, logits, *, cfg, head, sampler, gen_len,
                      start_pos, eos_id, pad_id, encoder_states):
    """The per-token decode loop (``decode_chunk=1``): returns ((B,
    gen_len) tokens, {"decode_steps"})."""
    b = logits.shape[0]
    out = []
    finished = torch.zeros(b, dtype=torch.bool, device=logits.device)
    steps = 0
    key = sampler.init_key(logits.device)
    for t in range(gen_len):
        key, nxt = sampler.sample(key, logits)
        if eos_id is not None:
            nxt = torch.where(finished, torch.full_like(nxt, pad_id), nxt)
            finished = finished | (nxt == eos_id)
        out.append(nxt[:, None])
        if t == gen_len - 1:
            break   # the last token's logits are never used
        if eos_id is not None and bool(finished.all()):
            out.append(torch.full((b, gen_len - 1 - t), pad_id,
                                  dtype=nxt.dtype, device=nxt.device))
            break
        logits, cache = serve_step_(
            params, cache, nxt[:, None], cfg, head=head,
            active=~finished if eos_id is not None else None,
            pos=start_pos + t, encoder_states=encoder_states)
        steps += 1
    return torch.cat(out, dim=1), {"decode_steps": steps}


def _distill_quick(params, cfg, distill_steps: int):
    """The in-process distillation of ``--sketch-head`` without a head
    archive: 1024 random hiddens (seed 11), ``distill_head`` with 256
    anchors (seed 12).  Returns (head config, kernel params)."""
    from repro_torch.core.distill import DistillConfig
    from repro_torch.core.sketch_lm_head import distill_head

    head_cfg = cfg.sketch_head or QUICK_HEAD
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    dev = table.device
    hiddens = torch.randn((1024, cfg.d_model),
                          generator=torch.Generator(dev).manual_seed(11),
                          device=dev)
    print(f"distilling sketch head (L={head_cfg.n_rows}, "
          f"R={head_cfg.n_buckets}, {distill_steps} steps) ...")
    t0 = time.perf_counter()
    kparams, metrics = distill_head(
        torch.Generator(dev).manual_seed(12), table, hiddens, head_cfg,
        n_points=256,
        distill_cfg=DistillConfig(n_steps=distill_steps, lr=5e-3))
    print(f"  distill MSE: {metrics['final_mse']:.5f} "
          f"({time.perf_counter() - t0:.2f} s)")
    return head_cfg, kparams


def build_or_load_head(params, cfg, head_path: Optional[str],
                       backend: Optional[str] = None,
                       distill_steps: int = 300,
                       quant: Optional[str] = None) -> SketchHead:
    """A ready-to-serve :class:`SketchHead` on the params' device: loaded
    from ``head_path`` (on the backend it was saved with unless
    ``backend`` says otherwise; ``quant`` quantizes an f32 archive's
    counts), or distilled from the dense head now (seeds 11, 12) and
    frozen (seed 13) when ``head_path`` is None."""
    from repro_torch.core.sketch_lm_head import freeze_head, quantize_head
    from repro_torch.api.heads import load_head

    dev = params["embed"].device
    if head_path is None:
        head_cfg, kparams = _distill_quick(params, cfg, distill_steps)
        return SketchHead(cfg=head_cfg, backend=backend or "fused",
                          quant=quant, params=freeze_head(
                              torch.Generator(dev).manual_seed(13), kparams,
                              head_cfg, quant=quant))
    head = load_head(head_path, dev)
    v, d = head.params["array"].shape[-1], head.params["proj"].shape[0]
    if (d, v) != (cfg.d_model, cfg.vocab_size):
        raise ValueError(
            f"sketch head {head_path} was frozen for (d_model={d}, vocab={v}) "
            f"but --arch {cfg.name} has (d_model={cfg.d_model}, "
            f"vocab={cfg.vocab_size})")
    if backend is not None:
        head = head.with_backend(backend)
    if quant is not None and head.quant != quant:
        if head.quant is not None:
            raise ValueError(f"head is stored {head.quant}; cannot "
                             f"re-quantize to {quant}")
        head = dataclasses.replace(head, quant=quant,
                                   params=quantize_head(head.params, quant))
    return head


def build_tenant_heads(params, cfg, n_tenants: int,
                       backend: Optional[str] = None,
                       quant: Optional[str] = None,
                       distill_steps: int = 300):
    """One shared quick distillation, ``n_tenants`` freezes: every tenant
    shares the anchors, alphas and transform and draws its own hash bank
    (seed 100 + t).  Returns (the shared ``SketchHead`` spec, {"tenant-t":
    frozen params})."""
    from repro_torch.core.sketch_lm_head import freeze_head

    head_cfg, kparams = _distill_quick(params, cfg, distill_steps)
    dev = params["embed"].device
    spec = SketchHead(cfg=head_cfg, backend=backend or "fused", quant=quant)
    heads = {f"tenant-{t}": freeze_head(
        torch.Generator(dev).manual_seed(100 + t), kparams, head_cfg,
        quant=quant) for t in range(n_tenants)}
    return spec, heads


def engine_stream(vocab_size: int, n_requests: int, prompt_len: int,
                  gen: int, arrival_every: int, seed: int) -> list:
    """The synthetic request stream of ``--engine``: ``(prompt, max_new,
    arrival)`` with arrivals every ``arrival_every`` ticks, every 4th
    prompt one shared prompt (the rest unique), and a skewed length mix —
    even requests ``max(1, gen // 4)`` new tokens, odd ones ``gen``."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab_size, prompt_len, dtype=np.int32)
    stream = []
    for i in range(n_requests):
        prompt = (shared if i % 4 == 3 else
                  rng.integers(0, vocab_size, prompt_len, dtype=np.int32))
        stream.append((prompt, gen if i % 2 else max(1, gen // 4),
                       i * arrival_every))
    return stream


def run_engine(lm, args, head_cache=None, sampler=None) -> None:
    """Serve ``engine_stream`` through ``lm.engine`` over ``args.batch``
    slots (with ``head_cache``, request i to tenant ``i % args.tenants``);
    prints the run and, with ``args.stats_json``, one ``STATS_JSON {…}``
    line."""
    n_requests = args.requests or 2 * args.batch
    engine = lm.engine(n_slots=args.batch,
                       max_seq=args.prompt_len + args.gen, sampler=sampler,
                       head_cache=head_cache, decode_chunk=args.decode_chunk,
                       spec_decode=args.spec_decode, paged=args.paged,
                       page_size=args.page_size)
    for i, (prompt, gen, arrival) in enumerate(engine_stream(
            lm.cfg.vocab_size, n_requests, args.prompt_len, args.gen,
            args.arrival_every, args.seed)):
        engine.submit(prompt, gen, arrival=arrival,
                      tenant=(None if head_cache is None
                              else f"tenant-{i % args.tenants}"))
    dev = lm.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    finished = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dur = time.perf_counter() - t0
    n_generated = sum(len(v) for v in finished.values())
    print(f"arch={lm.cfg.name} head={lm.head.describe()} device={dev} "
          f"sampler={engine.sampler.describe()} engine "
          f"served {len(finished)} requests over {args.batch} slots: "
          f"{n_generated} new tokens in {dur:.3f}s "
          f"({n_generated / dur:.1f} new tok/s), "
          f"{engine.stats['decode_steps']} decode steps in "
          f"{engine.stats['megasteps']} megasteps (chunk "
          f"{engine.decode_chunk}), slot utilization "
          f"{engine.slot_utilization:.2f}")
    s = engine.stats
    if engine.spec_decode:
        print(f"speculative: K={engine.spec_decode}, {s['verify_calls']} "
              f"verify calls, acceptance {s['accepted_draft_tokens']}/"
              f"{s['draft_tokens']} "
              f"({s['accepted_draft_tokens'] / max(1, s['draft_tokens']):.2f})")
    if engine.paged:
        print(f"paged: page_size={engine.page_size}, prefix hits "
              f"{s['prefix_hits']}/{s['prefix_queries']}, "
              f"{s['prefill_batches']} prefill batches, {s['cow_copies']} "
              f"COW copies, pages in use peak {s['pages_in_use_peak']}")
    if head_cache is not None:
        hs = head_cache.stats
        print(f"tenants: {args.tenants} over HeadCache capacity "
              f"{head_cache.capacity}, hits {hs['hits']}/"
              f"{hs['hits'] + hs['misses']}, {hs['loads']} loads, "
              f"{hs['evictions']} evictions")
    print("sample token ids:", finished[min(finished)][:24])
    if args.stats_json:
        record = {"arch": lm.cfg.name, "head": engine.backend.head.describe(),
                  "device": str(dev), "n_slots": args.batch,
                  "requests": len(finished), "tokens": n_generated,
                  "seconds": dur,
                  "slot_utilization": engine.slot_utilization,
                  "spec_decode": engine.spec_decode, "paged": engine.paged,
                  "page_size": engine.page_size if engine.paged else None}
        record.update({k: int(v) for k, v in engine.stats.items()})
        if head_cache is not None:
            record["tenants"] = {
                "n_tenants": args.tenants, "capacity": head_cache.capacity,
                **{k: int(v) for k, v in head_cache.stats.items()}}
        print("STATS_JSON " + json.dumps(record, sort_keys=True))


def main(argv=None) -> None:
    from repro_torch.api.heads import HeadCache
    from repro_torch.api.lm import LM, check_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b",
                    help="an architecture: rwkv6-1.6b, gemma2-27b, "
                         "granite-8b, stablelm-12b, command-r-35b, "
                         "musicgen-large, mixtral-8x7b, jamba-v0.1-52b, "
                         "deepseek-v3-671b or llama-3.2-vision-11b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sketch-head", action="store_true",
                    help="decode through the Representer-Sketch head "
                         "instead of the dense unembed (loaded from "
                         "--head-path, else distilled in process)")
    ap.add_argument("--head-path", default=None,
                    help="frozen head .npz (saved by either package)")
    ap.add_argument("--backend", default=None,
                    choices=["fused", "two_kernel", "ref"],
                    help="sketch-head decode backend (default: the one the "
                         "archive was saved with)")
    ap.add_argument("--quant", default=None, choices=["int8", "int4"],
                    help="quantize an f32 head's counts on load")
    ap.add_argument("--decode-chunk", type=int, default=1,
                    help="decode K tokens per megastep (launch/decode_loop.py;"
                         " on the card a CUDA graph of one step replayed K "
                         "times), for generate and --engine; 1 = the "
                         "per-token host loop")
    ap.add_argument("--spec-decode", type=int, default=0,
                    help="speculative decode: the head drafts up to K tokens "
                         "a tick and the dense head verifies them (the dense "
                         "head's tokens); not with --decode-chunk > 1")
    ap.add_argument("--engine", action="store_true",
                    help="serve a request stream through the "
                         "continuous-batching engine (--batch slots) instead "
                         "of one static batch")
    ap.add_argument("--requests", type=int, default=0,
                    help="engine mode: number of requests (default 2 x batch)")
    ap.add_argument("--arrival-every", type=int, default=1,
                    help="engine mode: ticks between request arrivals")
    ap.add_argument("--paged", action="store_true",
                    help="engine mode: a paged cache pool with an "
                         "exact-prompt prefix cache (the same streams; "
                         "repeated prompts prefill once); not with "
                         "--decode-chunk > 1 or --spec-decode")
    ap.add_argument("--page-size", type=int, default=16,
                    help="engine mode with --paged: tokens a page")
    ap.add_argument("--stats-json", action="store_true",
                    help="engine mode: print the engine stats as one "
                         "'STATS_JSON {...}' line")
    ap.add_argument("--tenants", type=int, default=0,
                    help="engine mode with --sketch-head: serve N per-tenant "
                         "heads (one shared distillation, a hash bank each) "
                         "through an LRU HeadCache; requests round-robin "
                         "over tenants (not with --head-path)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample among the k largest logits (0: all)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="sample from the smallest nucleus of mass >= p "
                         "(1: all)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the sampler's key chain, and of the "
                         "random backbone and prompts")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="serve SPMD over a '<data>x<model>' mesh, one "
                         "process a rank: run under torchrun (--nproc-per-"
                         "node data*model; gloo on the CPU, NCCL on cards), "
                         "which this joins; params, head and caches are "
                         "placed by sharding/rules.py, and rank 0 prints")
    args = ap.parse_args(argv)
    if (args.stats_json or args.paged) and not args.engine:
        ap.error("--stats-json/--paged apply to engine mode; add --engine")
    if args.tenants:
        if not (args.engine and args.sketch_head):
            ap.error("--tenants needs --engine and --sketch-head")
        if args.head_path:
            ap.error("--tenants distills one shared head in process; "
                     "--head-path is not supported")
        if args.spec_decode:
            ap.error("--tenants and --spec-decode are mutually exclusive")
    if args.decode_chunk < 1:
        ap.error("--decode-chunk must be >= 1")
    if args.spec_decode < 0:
        ap.error("--spec-decode must be >= 0")
    if args.spec_decode and args.decode_chunk > 1:
        ap.error("--spec-decode and --decode-chunk > 1 are mutually exclusive")
    if args.paged and (args.decode_chunk > 1 or args.spec_decode):
        ap.error("--paged runs the per-token tick: not with --decode-chunk > 1 "
                 "or --spec-decode")
    if args.page_size < 1:
        ap.error("--page-size must be >= 1")
    if (args.quant or args.backend) and not args.sketch_head:
        ap.error("--quant/--backend apply to the sketch head; add "
                 "--sketch-head")
    try:
        sampler = Sampler(temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, seed=args.seed)
    except ValueError as e:
        ap.error(str(e))
    device = check_device(args.device)
    if args.mesh:
        from repro_torch.launch.mesh import join_launcher_group
        device = join_launcher_group(device)

    gen = torch.Generator(device).manual_seed(args.seed)
    lm = LM.from_config(args.arch, smoke=args.smoke, device=device,
                        generator=gen, mesh=args.mesh)
    head_cache = None
    if args.tenants:
        spec, tenant_heads = build_tenant_heads(
            lm.params, lm.cfg, args.tenants, args.backend, args.quant)
        # Capacity below the tenant count when the slots allow it, so the
        # run pages tenants in and out.
        head_cache = HeadCache(tenant_heads.__getitem__,
                               capacity=max(1, min(args.tenants, args.batch)),
                               mesh=lm.mesh)
        lm = lm.with_head(spec)
    elif args.sketch_head:
        lm = lm.with_head(build_or_load_head(
            lm.params, lm.cfg, args.head_path, args.backend,
            quant=args.quant))
    if args.engine:
        run_engine(lm, args, head_cache, sampler)
        return
    prompts = torch.randint(0, lm.cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=device)
    enc = None
    if lm.cfg.n_encoder_tokens:
        # The vision frontend is a stub: random states stand in for its
        # patch embeddings.
        enc = torch.randn((args.batch, lm.cfg.n_encoder_tokens,
                           lm.cfg.d_model), generator=gen,
                          device=device).to(torch.bfloat16)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out, stats = lm.generate(prompts, args.gen, sampler=sampler,
                             decode_chunk=args.decode_chunk,
                             spec_decode=args.spec_decode, return_stats=True,
                             encoder_states=enc)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dur = time.perf_counter() - t0
    print(f"arch={lm.cfg.name} head={lm.head.describe()} device={device} "
          f"sampler={sampler.describe()} served {args.batch} seqs x "
          f"{args.gen} new tokens in {dur:.3f}s "
          f"({args.batch * args.gen / dur:.1f} new tok/s, decode chunk "
          f"{args.decode_chunk})")
    if args.spec_decode:
        drafted, accepted = stats["draft_tokens"], stats["accepted_draft_tokens"]
        print(f"speculative: K={args.spec_decode}, {stats['verify_calls']} verify "
              f"calls, acceptance {accepted}/{drafted} "
              f"({accepted / max(1, drafted):.2f})")
    print("sample token ids:", out[0, :24].tolist())


if __name__ == "__main__":
    main()
