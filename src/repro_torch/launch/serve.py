"""Serving launcher: one static batch, greedy, dense or sketched head.

A single bulk prefill ingests every prompt through the dense head, then
the decode loop emits tokens step by step; with ``--sketch-head`` each
decode step's logits come from the Representer-Sketch head on its
``--backend`` (``fused``: one CUDA kernel; ``two_kernel``; ``ref``).  The
head is loaded from a ``--head-path`` archive saved by either package.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      [--smoke] [--sketch-head --head-path head.npz] [--backend fused] \\
      [--quant int8] [--batch 4 --prompt-len 32 --gen 16] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.api.heads import DenseHead
from repro_torch.api.sampler import Sampler
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models.model import init_decode_cache


def generate(params: dict, cfg, prompts: torch.Tensor, gen_len: int, *,
             head=None, sampler: Optional[Sampler] = None,
             eos_id: Optional[int] = None, pad_id: int = 0) -> torch.Tensor:
    """Bulk prefill + decode. prompts (B, P) → tokens (B, P + gen_len).

    The first new token comes from the prefill's dense logits, each later
    one from a decode step through ``head`` (``gen_len - 1`` steps).  With
    ``eos_id``, a finished sequence's later positions hold ``pad_id``, its
    cache rows freeze, and the loop ends once every row is done.
    """
    head = head or DenseHead()
    sampler = sampler or Sampler()
    b, p = prompts.shape
    cache = init_decode_cache(cfg, b, p + gen_len, device=prompts.device)
    with torch.inference_mode():
        logits, cache = prefill_step(params, prompts, cfg, cache)
        out = [prompts]
        finished = torch.zeros(b, dtype=torch.bool, device=prompts.device)
        for t in range(gen_len):
            nxt = sampler.sample(logits)
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
            logits, cache = serve_step(
                params, cache, nxt[:, None], cfg, head=head,
                active=~finished if eos_id is not None else None)
    return torch.cat(out, dim=1)


def main(argv=None) -> None:
    from repro_torch.api.heads import load_head
    from repro_torch.api.lm import LM, check_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sketch-head", action="store_true",
                    help="decode through the Representer-Sketch head loaded "
                         "from --head-path instead of the dense unembed")
    ap.add_argument("--head-path", default=None,
                    help="frozen head .npz (saved by either package)")
    ap.add_argument("--backend", default=None,
                    choices=["fused", "two_kernel", "ref"],
                    help="sketch-head decode backend (default: the one the "
                         "archive was saved with)")
    ap.add_argument("--quant", default=None, choices=["int8", "int4"],
                    help="quantize an f32 head's counts on load")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random backbone and prompts")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.sketch_head and not args.head_path:
        ap.error("--sketch-head needs --head-path: in-process distillation "
                 "of a head is not ported yet (a later slice); save one "
                 "with repro's examples/serve_sketch_head.py")
    if (args.quant or args.backend) and not args.sketch_head:
        ap.error("--quant/--backend apply to the sketch head; add "
                 "--sketch-head")
    device = check_device(args.device)

    gen = torch.Generator(device).manual_seed(args.seed)
    lm = LM.from_config(args.arch, smoke=args.smoke, device=device,
                        generator=gen)
    if args.sketch_head:
        head = load_head(args.head_path, device)
        v, d = head.params["array"].shape[-1], head.params["proj"].shape[0]
        if (d, v) != (lm.cfg.d_model, lm.cfg.vocab_size):
            raise ValueError(
                f"sketch head {args.head_path} was frozen for (d_model={d}, "
                f"vocab={v}) but --arch {lm.cfg.name} has "
                f"(d_model={lm.cfg.d_model}, vocab={lm.cfg.vocab_size})")
        if args.backend is not None:
            head = head.with_backend(args.backend)
        if args.quant is not None and head.quant != args.quant:
            if head.quant is not None:
                ap.error(f"head is stored {head.quant}; cannot re-quantize "
                         f"to {args.quant}")
            from repro_torch.core.sketch_lm_head import quantize_head
            head = dataclasses.replace(
                head, quant=args.quant,
                params=quantize_head(head.params, args.quant))
        lm = lm.with_head(head)
    prompts = torch.randint(0, lm.cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = lm.generate(prompts, args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dur = time.perf_counter() - t0
    print(f"arch={lm.cfg.name} head={lm.head.describe()} device={device} "
          f"served {args.batch} seqs x {args.gen} new tokens in {dur:.3f}s "
          f"({args.batch * args.gen / dur:.1f} new tok/s)")
    print("sample token ids:", out[0, :24].tolist())


if __name__ == "__main__":
    main()
