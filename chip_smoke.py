#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, the result line last
    python3 chip_smoke.py --kernels        # the kernel and hash phases only
    python3 chip_smoke.py --kernels --csrc OTHER/src/repro_torch/kernels/csrc

``--csrc`` builds the kernels from another checkout's sources (the C
interfaces are unchanged), so that one call times two versions of the
kernels through the same wrappers and checks.

1. Prints the card (nvidia-smi name and power limit), torch and CUDA
   versions, and builds the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (build time and ptxas register report).
2. Kernel phase: each kernel (fused_decode, lsh_hash, sketch_head) against
   its plain PyTorch version on the card at d=2048, V=65536 (and a ragged
   V=65519), for the head ``launch/serve.py`` freezes for rwkv6 (L=128,
   R=16, K=1, d'=32, r=2) and ``SketchHeadConfig()`` (L=64, R=16, K=2,
   d'=64, r=4), B in {1, 2, 4, 64, 256} (2 is the per-tenant engine's
   batch, 256 the refresh's), f32/int8/int4 counts, and the serve head at
   gemma2-27b's width (d 4608, V 256000; f32, int8).  Indices obey the
   boundary rule and logits the gather bound of
   ``repro_torch.parity``; sketch_head's logits equal
   ``sketch_head_ordered_ref`` bit for bit, and fused_decode's equal
   sketch_head's kernel at fused_decode's own indices bit for bit; one
   ``kernel_case`` JSON line each, with CUDA-event times (median of 20 runs
   after warm-up, L2 flushed before each run; fused_decode's ``gather_ms``
   is sketch_head's time at its indices, the gather without the transform;
   f32 gathers beside ``F.embedding_bag(mode="mean")`` as ``library_ms``).
   Then lsh_hash at each dataset's FULL query and freeze shape and at the
   refresh's B=256 (``hash_phase``), beside its plain version, its bound
   and the f32 projection alone.  Then race_update against its plain
   versions for M in {32, 256, 1024}, both heads' L, both V, through both
   entries ((L, R, V) and
   (C, L, R)), and a (C, L, R) sketch with C=50021, L=100, M=77: equal to
   ``race_update_ordered_ref`` bit for bit, within ``race_update_tol`` of
   the einsum version, two launches bit for bit equal, timed beside the
   one-call ``baddbmm``/``addmm`` yardstick (``library_factor``: the
   kernel's time over it; the slowest case is printed).
3. Backbone check: the rwkv6 smoke model on the card against the same
   model on the CPU, teacher-forced (bf16 tolerance of
   tests/test_torch_model.py).
4. Main path: full-width rwkv6-1.6b (24 layers, d_model 2048, vocab 65536,
   random bf16 weights from a seed, drawn a layer at a time, each matrix
   its own draw) serves 4 prompts of 32 tokens for 16
   new tokens through ``LM.generate`` three times — dense head, sketched
   head on ``fused``, on ``two_kernel`` — with the launch counts set to 0
   before and read after each run; the eager decode step's profile,
   functional (``serve_step``) and in place (``serve_step_``).  Then one
   decode step's hidden, teacher-forced, holds fused against two-kernel,
   and the three kernels are timed on that step's real inputs beside their
   plain versions, the one-call PyTorch equivalent where one exists, and
   their bound.  Then the decode loop: ``LM.generate`` through each head
   at decode_chunk 1, 4 and 16 (the decode step captured once as a CUDA
   graph and replayed), launch counts asserted, every stream equal to the
   eager one; the captured step's ms/step by decode_chunk, its kernel time
   and busy share over 15 replays, and each wrapper's launches a replay.
5. Refresh path, on an f32 and an int8 bank: two tenant-0 requests in
   flight in a per-tenant engine, then ``engine.refresh`` of M = 256 live
   hiddens with the dense logits as targets (launch counts zeroed before,
   read after: race_update, lsh_hash and fused_decode once each); the
   residual's fused_decode at B=256 against fused_decode_ref (and timed)
   and the
   shadow against a plain fold of the same points; the bank row and the
   in-flight streams bitwise unchanged until ``publish``; after it, new
   requests equal a fresh engine loaded with the published head.
6. Engine path (since PR 28 on the first ENGINE_LAYERS of the main
   path's 24 layers, full width, ``shallow``): ``LM.engine`` with the
   dense and the fused head (requests
   arriving together equal ``LM.generate`` of the same batch; every step
   of the staggered ``serve --engine`` stream against the request run
   alone at the engine's row counts, bit for bit, and at batch 1 under
   the bf16 rule, teacher-forced on the engine's tokens, see
   ``check_staggered``; the
   same stream at decode_chunk 4 equal to decode_chunk 1 stream for
   stream), and three tenants over a capacity-2 ``HeadCache`` against
   single-tenant engines, with fused_decode launched once per bank row per
   tick.
7. race_query kernel phase: the CUDA kernel against ``race_query_ref``
   at each tabular dataset's FULL-budget query shape (B = its test set,
   L = 2000 or 4000, R = 30-100 or 64, C = 2 or 1, g = 8), g in {5, 1},
   L % g != 0, a ragged B, a bf16 sketch, tied means and the [1, 2, 3, 10]
   even-g median: bit for bit ``race_query_ordered_ref``, every estimate
   within ``race_query_tol`` of ``race_query_ref``, two launches bit for
   bit equal, timed beside its plain version and its bound.
8. Paper phase: ``repro_torch.launch.paper_repro.run_dataset`` on all six
   datasets at the FULL budget (teacher → distill → freeze → query), each
   in a process of its own, all six at once (the recipe's training loops
   are host-bound, 50-65 s a dataset alone; its stage seconds are then
   those of six processes sharing the host), with
   the launch counts zeroed before and read after each (lsh_hash 2,
   race_update 1, race_query 1); then, in this process, one dataset at a
   time, the query held against the plain version
   on the same debiased state, the hash against its plain version, the
   freeze's race_update (C, L, R) against its plain version and timed;
   classification sets gated on tests/test_distill.py's relations
   (kernel >= NN - 0.08, sketch >= kernel - 0.10).  The process runs with
   PYTHONHASHSEED=0 (it re-executes itself once to set it), because the
   datasets are seeded with Python's salted ``hash(name)``.
9. LM distill phase: the serve CLI's own ``--sketch-head`` without
   ``--head-path`` on full-width rwkv6-1.6b (in-process ``distill_head``,
   300 steps, 1024 hiddens, 256 anchors; freeze; ``generate`` at
   ``--decode-chunk 16``), then ``--engine --tenants 3 --decode-chunk 4``
   over 2 slots, launch counts asserted (the capture's warm-up steps
   included).
10. flash_attn kernel phase (after race_update's): the CUDA kernel against
   ``flash_attention_ref`` with gemma2-27b's heads (H=32, Hkv=16, dh=128,
   bf16, softcap 50) at the main path's prefill (B=4, S=32) and the long
   prefill (B=1, S=4160), window 4096 and none, plus softcap-free twins;
   ragged S=200 with window 64 (the band starts mid-tile, f32); S=256,
   window 32, softcap 30 (f32); dh=160, Hkv=8, S=1000 (bf16, stablelm's
   heads); dh=64, MHA, S=1000 (bf16, musicgen's); dh=192, H = Hkv = 128,
   B=4, S=32 (bf16, deepseek-v3's MLA prefill).  Every element within
   ``repro_torch.parity.flash_attn_tol`` (bf16: the kernel on the tensor
   cores, plus one bf16 ulp), two launches bit for bit equal; timed
   beside the plain version and one PyTorch call computing the same
   function: ``scaled_dot_product_attention`` without a softcap (GQA; a
   boolean mask for a window), compiled ``flex_attention`` with one (the
   softcap as its score_mod, the causal or window block mask, GQA).
   ``bound_ms`` prices bf16 cases' products at the bf16 tensor-core peak
   (989 TFLOP/s) and f32 cases' at the f32 CUDA-core peak (67 TFLOP/s);
   ``f32_core_bound_ms`` is the latter for every case.
11. gemma2-27b main path (after freeing the rwkv6 model): full width and
   depth (46 layers, d_model 4608, vocab 256000, 27.2 B random bf16 params
   from seed 0) with the serve head frozen at V=256000; ``LM.generate`` of
   4 x 32-token prompts for 16 new tokens, dense and fused (flash_attn 46
   launches per generate, all in the prefill; fused_decode 15); the decode
   step's profile; the teacher-forced prefill check (the flash prefill's
   last hidden against the prompt fed token by token through decode steps
   without flash, bf16 backbone rule); one teacher-forced decode step's
   hidden (B=4, cache_pos 32) with fused_decode, lsh_hash and sketch_head
   held against their plain versions and timed at gemma2's width; then
   the decode loop as for rwkv6 (dense and fused), with the peak memory
   and the captured graphs' pools.
12. gemma2-27b engine, dense and fused (since PR 28 on its first
   ENGINE_LAYERS layers, full width): four requests arriving together
   over four slots equal ``LM.generate``; six staggered requests over two
   slots under ``check_staggered``; flash_attn one a layer per prefill
   batch.
13. gemma2-27b long prefill: B=1, a 4160-token prompt (only the last
   position unembedded; peak memory): flash_attn 46 launches, the first
   local layer's ring (4096 slots, 64 wrapped) equal to its keys
   recomputed, a decode step at that context functional against in place
   (the functional step's two cache copies timed alone), wall time and
   flash_attn's share of the kernel time under torch.profiler, then 4 new
   tokens through ``LM.generate``.  Then granite-8b, stablelm-12b,
   musicgen-large and command-r-35b (all 40 layers, drawn a layer at a
   time by ``draw_params``) at full width and depth: ``LM.generate`` dense
   and fused at decode_chunk 1 and 16, equal streams, launch counts, new
   tok/s, init and generate peak memory, the phase's seconds.
14. Speculative decode and the paged engine (PR 21): after each decode
   loop phase (rwkv6: fused and two_kernel drafts; gemma2: fused),
   ``LM.generate(spec_decode=K)`` for K in SPEC_KS, each stream equal to
   the dense one, launch counts (the draft head's kernels once a draft
   step), acceptance rate, mean m, ms a tick and new tok/s; the dense
   head as the draft (acceptance exactly 1.0, verify logits equal to the
   captured draft steps' bit for bit).  After rwkv6's engine phase, the
   speculative engine (K=4, fused) against the dense engine on 12
   staggered requests of distinct prompt lengths; after each engine
   phase, the paged engine (page 16, fused) against the contiguous one on
   a trace that repeats two prompts (prefix hits, COW copies on gemma2).
   For gemma2, before its long prefill, the memo: generate at
   decode_chunk 16 over three prompt lengths (one loop kept), the
   long-prompt peak at decode_chunk 16 against 1 (less than one KV cache
   apart), and speculative decode at the wrapped ring (K=4, the dense
   stream, the snapshot's bytes).
15. Seeded sampling on rwkv6-1.6b after its spec phase
   (``seeded_phase``: the card's threefry keys, split chain, bits and
   uniforms of a (4, 65536) draw equal the CPU port's bit for bit;
   ``Sampler(temperature=0.9, top_k=12, seed=7)`` gives one stream at
   decode_chunk 1 and 16 and through spec K=4 with the dense-head draft,
   and the engine's streams at decode_chunk 4 equal decode_chunk 1's;
   ms/step of the captured step greedy, seeded and seeded at top_p 0.95,
   and the sort's share).  Last, the MoE archs at full width, drawn a
   layer at a time: mixtral-8x7b at 24 of 32 layers (65.4 GiB; flash_attn
   24 a prefill, its 4096 window wraps no ring at prompt 32) and
   jamba-v0.1-52b at 16 of 32 (two periods, 48.5 GiB; flash_attn 2 a
   prefill), the cells of the plain archs, then for jamba spec generate at
   K=4 (dense-head and fused drafts, the dense stream), the paged engine
   against the contiguous one (prefix hits: mamba state rows in the
   prefix cache) and the spec engine against the dense one.
16. The last two families (``NEW_ARCHS``), the cells of the plain archs
   and then spec generate at K=4 (dense-head and fused drafts, the dense
   stream): deepseek-v3-671b at full width and 5 of 61 layers (its 3 dense
   prologue layers and 2 MoE layers of 256 + 1 experts, 49.6 GiB; drawn a
   layer at a time, the experts EXPERT_CHUNK at a time into their
   preallocated stacks; flash_attn 5 a prefill, on the materialised MLA
   form at dh=192), then its paged engine (latent pages) and spec engine
   against the contiguous and dense ones; llama-3.2-vision-11b at full
   width and depth (32 self-attention layers, flash_attn 32 a prefill, and
   8 cross-attention layers over stub encoder states (4, 1600, 4096) bf16
   drawn from the seed; its engine is refused, as in the JAX package).
17. flash_attn_bwd kernel phase (after the flash_attn phase; PR 24): the
   forward with its row log-sum-exp against without it (the output's bits
   unchanged) and the lse within ``parity.flash_attn_lse_tol`` of the
   plain one; then the backward kernel against
   ``flash_attention_bwd_ref`` on the same q, k, v, out, dout and lse,
   dq, dk, dv within ``parity.flash_attn_bwd_tol`` (plus one bf16 ulp),
   two launches bit for bit equal, at musicgen-large's training shapes
   (8, 128, 32/32, 64) and (4, 2048, 32/32, 64), gemma2-27b's layer (H
   32, Hkv 16, dh 128, softcap 50) at S = 4160 with its 4096 window and
   the softcap-free twin, and at S = 1024 with a 64-token window,
   stablelm's dh 160, MLA's dh 192 and the f32 path; timed beside the
   plain backward and a library backward (SDPA's on the softcap-free
   function; compiled flex_attention's with the softcap at S = 4160);
   ``bound_ms`` prices the gradient's four products at the bf16
   tensor-core peak (``bound_with_recompute_ms`` adds the recomputed
   scores); bf16 cases (the tensor-core kernels, held to the bound's
   tensor-core form) add ``kernel_tensor_core_ms``, the kernels'
   own 14 products a pair at that peak, and the f32 case
   ``kernel_f32_core_ms``.  The build's ptxas report gives each kernel's
   registers and spills and any wgmma serialization warning
   (``ptxas_report``).
18. Training (PR 24, after the last arch): musicgen-large at full width and
   depth (48 layers, d 2048, vocab 2048; 3.23 B params, 51.7 GB of state
   with the grads) through ``launch.train.train`` for 12 steps at B = 8, S
   = 128 (the CLI's defaults): per step flash_attn 96 launches (48 forward,
   48 remat recomputes) and flash_attn_bwd 48; finite losses, the last
   below the first; the peak memory; ms a step split into forward+backward
   and the optimizer (CUDA events), a profiled step (busy share,
   attention's kernel share, top kernels), and one step at B = 4, S =
   2048 (ungated: attention's share at length).  A profiled step with no
   backward attention kernel fails.  Then the resume check at
   2 of 48 layers: 6 steps saving at step 3, a new run restored from that
   checkpoint, its params and optimizer state equal to the continuous
   run's bit for bit; a restore into a fresh state allocates no more than
   the largest leaf beyond it (the restore copies in place).
19. Mesh phase (after rwkv6's seeded sampling): the card's one-rank
   NCCL group (a ``TCPStore`` on 127.0.0.1, ``init_device_mesh("cuda",
   (1, 1))``); the params and caches carry the rules' ``Shard``
   placements on its one-rank dims, so DTensor propagates them as on a
   larger mesh.  rwkv6-1.6b at full width and depth through
   ``LM.from_config(..., mesh=...)`` on the main path's params, with the
   fused head: ``generate`` at decode_chunk 1 and 16 equal to the main
   path's single-device fused tokens bit for bit (fused_decode 15 a
   generate), timed beside the same generate off the mesh (plain, mesh,
   mesh, plain); gemma2-27b at full width and 2 layers, its prefill's
   flash_attn through the DTensor wrapper (2 launches), the tokens equal
   to the same model off the mesh; the global-row input of fused_decode
   on the card (the serve head at f32, int8 and int4, row halves and
   quarters with ``row_start``: each part's indices equal the whole
   launch's columns exactly, its logits within the gather bound of
   ``fused_decode_ref`` at that ``row_start``, the scaled parts' sum
   within the gather bound of the whole); a rank's product of a
   contraction-sharded weight (``layers._partial_product``: bf16 blocks
   with an f32 result) timed beside the bf16 and the widened-f32 product;
   the smoke models of nine archs (all but deepseek-v3-671b, whose smoke
   head dim the flash kernel does not take) on the mesh, generate at
   decode_chunk 1 and 4 and the engine equal off it; ``compressed_psum``
   of CUDA gradients over the one-rank group (mean + new error = the
   gradient); and the checkpoints of a mesh run (``mesh_resume``):
   musicgen-large at full width and 2 layers through ``launch.train.train``
   on the mesh, 6 steps saving at step 3 (each leaf gathered, rank 0
   writing), then a new mesh run restored from it (each rank's own
   blocks): its losses, params and optimizer state equal the continuous
   mesh run's bit for bit, flash_attn 4 and flash_attn_bwd 2 launches a
   step.  The group is destroyed at the end of the phase.
20. Prints the ``{"kernels": [...]}`` line (race_update's launches from the
   refresh path, race_query's from the paper phase, flash_attn's from the
   gemma2 main path with its record at the main path's global-layer
   prefill, flex_attention as its library call, softcap-free kernel and
   SDPA times beside it, the long prefill's global case under
   ``long_prefill_*`` and the MLA prefill case under ``mla_prefill_*``;
   flash_attn_bwd's launches from the training run, its record at
   musicgen's training shape and every case under ``cases``), the card
   line, and last ``{"ok": true, "device": {...}}``.

21. Dry-run phase: the JAX package's four test_dryrun cells at full size
   (granite-8b train_4k on the 16×16 mesh and decode_32k on the 2×16×16,
   mixtral-8x7b train_4k on the 2×16×16, rwkv6-1.6b long_500k on the
   16×16) and granite-8b decode_32k on the 16×16, each ``python -m
   repro_torch.launch.dryrun --device cuda`` in a process of its own,
   started after the kernel phases and collected after the flash_attn_bwd
   phase: exit 0, per-rank FLOPs, 256 or 512 ranks, flash_attn traced on
   the train cells, and granite's decode on the 2×16×16 mesh moving no more
   collective bytes a rank than on the 16×16 (its batch, and its cache's,
   split over pod and data, never gathered back to data); each cell's
   per-rank FLOPs, collective bytes and arguments + temp against the
   card's memory.  And
   the calibration, around the musicgen-large step at B = 4, S = 2048 and
   gemma2-27b's 4160-token prefill: ``launch/hlo_analysis.analyze`` on the
   real step and on its fake trace at one rank, equal FLOPs, the fake
   trace's kernel calls equal to the real launches, and the predicted peak
   (arguments + temp) against the allocator's within PEAK_RATIO_BOUND.

Any failed check raises, so the exit code is non-zero and the last line
is not printed.  Without a CUDA device it exits non-zero at once.
"""

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api import LM, DenseHead, HeadCache, Sampler, SketchHead
from repro_torch.api import sampler as sampling
from repro_torch.configs import get_config
from repro_torch.core.sketch_lm_head import (dequantize_head, freeze_head, quantize_counts,
                                             quantize_head)
from repro_torch.kernels import _build
from repro_torch.kernels.work import (flash_attn_bwd_work, flash_attn_work, hash_work,
                                      kernel_work, live_pairs)
from repro_torch.kernels.flash_attn.ops import (flash_attention, flash_attention_bwd,
                                               flash_attention_bwd_ref, flash_attention_lse,
                                               flash_attention_lse_ref, flash_attention_ref)
from repro_torch.kernels.fused_decode.ops import fused_decode_logits, fused_decode_ref
from repro_torch.kernels.lsh_hash.ops import lsh_hash, lsh_hash_ref
from repro_torch.kernels.race_query.ops import (race_query, race_query_ordered_ref,
                                                race_query_ref)
from repro_torch.kernels.race_update.ops import (race_update, race_update_counts,
                                                 race_update_counts_ref,
                                                 race_update_ordered_ref, race_update_ref)
from repro_torch.parity import (BF16_MAX_TOL, BF16_NORM_TOL, assert_bf16_backbone_close,
                                assert_flash_attn_close, bf16_backbone_errors,
                                check_hash_indices, flash_attn_bwd_tol,
                                flash_attn_lse_tol, flash_attn_tol,
                                flash_attn_tol_ratio, gather_atol,
                                race_query_tol, race_update_tol)
from repro_torch.kernels.sketch_head.ops import (dequantize_sketch_ref,
                                                 sketch_head_logits,
                                                 sketch_head_ordered_ref,
                                                 sketch_head_ref)
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.data.tabular import DATASETS
from repro_torch.launch import paper_repro, serve
from repro_torch.launch.decode_loop import WARMUP_STEPS, SpecLoop
from repro_torch.launch.engine import EngineBackend
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.serve import engine_stream
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.steps import prefill_step, prefill_step_, serve_step, serve_step_
from repro_torch.models import blocks, layers, model
from repro_torch.models.attention import KVCache
from repro_torch.models.config import SketchHeadConfig
from repro_torch.models.layers import (apply_rope, embed_scaled, init_dense, rms_norm,
                                      softcap)
from repro_torch.optim.adamw import OptimizerConfig, adamw_update, tree_map

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
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
    "race_query": (race_query, "src/repro_torch/kernels/csrc/race_query.cu",
                   "src/repro/kernels/race_query/kernel.py:29"),
    "flash_attn": (flash_attention, "src/repro_torch/kernels/csrc/flash_attn.cu",
                   "src/repro/kernels/flash_attn/kernel.py:40"),
    # No TPU counterpart: the JAX package trains on plain jnp attention
    # (_attend_* at models/attention.py:416-428) and XLA differentiates it.
    "flash_attn_bwd": (flash_attention_bwd, "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
                       "src/repro/models/attention.py:416 (no TPU kernel: the gradient XLA "
                       "takes of _attend_*)"),
}
N_REQUESTS, SLOTS, TENANT_SLOTS, CAPACITY = 12, 4, 2, 2
REFRESH_PROMPTS = 8                 # x PROMPT tokens = M = 256 refresh points
GEMMA = "gemma2-27b"
MESH_SMOKE_ARCHS = ("rwkv6-1.6b", "gemma2-27b", "granite-8b", "stablelm-12b",
                    "musicgen-large", "command-r-35b", "mixtral-8x7b", "jamba-v0.1-52b",
                    "llama-3.2-vision-11b")
GEMMA_LONG = 4160                   # past the 4096 window: the local rings wrap
GEMMA_STAGGERED = 6                 # staggered requests over TENANT_SLOTS slots
DECODE_CHUNKS = (1, 4, 16)          # generate's megastep sizes
ENGINE_CHUNK = 4                    # the engine's megastep size
# The plain-attention archs at full width and depth (command-r-35b's 40
# layers, 56.4 GiB, drawn a layer at a time: ``draw_params``).
PLAIN_ARCHS = (("granite-8b", None, False), ("stablelm-12b", None, False),
               ("musicgen-large", None, False), ("command-r-35b", None, True))
# The MoE archs at full width, at the depth one card holds: mixtral-8x7b
# at 24 of 32 layers (65.4 GiB), jamba-v0.1-52b at 16 of 32 (two periods,
# 48.5 GiB; three would be 72.3 GiB).
MOE_ARCHS = (("mixtral-8x7b", 24), ("jamba-v0.1-52b", 16))
# The last two families: deepseek-v3-671b at full width and 5 of 61 layers
# (its 3 dense prologue layers and 2 MoE layers of 256 + 1 experts: 26.6 B
# params, 49.6 GiB; six would be 71.0 GiB), drawn a layer at a time with
# the experts EXPERT_CHUNK at a time, and llama-3.2-vision-11b at full
# width and depth (18.2 GiB), its stub encoder states drawn from the seed.
NEW_ARCHS = (("deepseek-v3-671b", 5, True), ("llama-3.2-vision-11b", None, False))
EXPERT_CHUNK = 32                   # experts a draw: (32, 7168, 2048) f32 is 1.9 GB
SEEDED = dict(temperature=0.9, top_k=12, seed=7)   # the reference tests' "seeded"
SPEC_KS = (4, 16)                   # speculative draft lengths
ENGINE_LAYERS = 8                   # the rwkv6 and gemma2 engine phases' depth
PAGE_SIZE = 16                      # the paged engine's tokens a page
MEMO_PROMPTS = (16, 32, 64)         # generate's prompt lengths in the memo phase
MEMO_LONG = 4100                    # a prompt past gemma2's 4096-slot window
MLA_PREFILL = "MLA prefill (deepseek-v3), dh=192, H=Hkv=128"
# Training (PR 24): musicgen-large at full width and depth through the train
# entry point, the CLI's B and S, then one step at length; the resume check
# at RESUME_LAYERS of its 48 layers.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "musicgen-large", 8, 128, 12
TRAIN_LONG = (4, 2048)
RESUME_LAYERS, RESUME_STEPS, RESUME_AT = 2, 6, 3
MUSICGEN_TRAIN = "musicgen-large training (B 8, S 128, MHA 32, dh 64)"
# Kernel names under torch.profiler: the forward's, and the backward's
# (D, then dK/dV and dQ: the tensor-core pair for bf16, the CUDA-core pair
# for f32).
FLASH_FWD_KERNELS = ("flash_attn_kernel", "flash_attn_tc_kernel")
FLASH_BWD_KERNELS = ("bwd_dot_kernel", "dkdv_tc_kernel", "dq_tc_kernel", "dkdv_kernel",
                     "dq_kernel")
# The dry run: the JAX package's four test_dryrun cells at full
# size, and granite's decode on the 16×16 mesh beside its 2×16×16 one, each
# traced on fake CUDA tensors over a fake group of the mesh's ranks by
# ``python -m repro_torch.launch.dryrun``.
DRYRUN_CELLS = (("granite-8b", "train_4k", "single"), ("granite-8b", "decode_32k", "multi"),
                ("mixtral-8x7b", "train_4k", "multi"), ("rwkv6-1.6b", "long_500k", "single"),
                ("granite-8b", "decode_32k", "single"))
DRYRUN_RESULTS = Path(__file__).resolve().parent / "results" / "dryrun_torch"
# The calibration's bound on the measured peak over the dry run's (PERF.md
# §6): the caching allocator rounds each block up to 512 bytes and
# may give a large request a block up to 1 MiB larger, and Python's
# collector frees cycles at its own times in either run.
PEAK_RATIO_BOUND = (0.95, 1.05)


def ptxas_report(name, log):
    """Prints nvcc's ptxas report of one library, a line per kernel
    (registers, spill bytes) and every warning (a C7520/C7514 line: a
    wgmma serialized); returns {"kernels", "max_registers",
    "spill_bytes", "warnings"}."""
    entry, stack, regs, spill, warnings = "?", "", [], 0, []
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            entry, stack = line.split("'")[1], ""
            m = re.search(r"\d+([a-z_]+?kernel)I(\w+?)EE", entry)
            if m:       # e.g. dkdv_tc_kernel<64>, dkdv_kernel<f128>
                args = re.sub(r"Li(\d+)", r"\1,", m.group(2)).rstrip(",")
                entry = f"{m.group(1)}<{args}>"
        elif "spill stores" in line:
            found = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            spill += sum(found)
            stack = line
        elif "Used" in line and "registers" in line:
            regs.append(int(re.search(r"Used (\d+) registers", line).group(1)))
            print(f"  {name}: {entry}: {regs[-1]} registers; {stack}")
        elif "warning" in line.lower():
            warnings.append(line)
            print(f"  {name}: {line}")
    return dict(kernels=len(regs), max_registers=max(regs, default=0), spill_bytes=spill,
                warnings=len(warnings))


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


def bound(n_bytes: float, n_ops: float, flop_per_s: float = F32_FLOP_PER_S) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def random_head(gen, cfg, v, quant, d=D_MODEL):
    dev = gen.device
    head = {"proj": torch.randn((d, cfg.proj_dim), generator=gen, device=dev) / d ** 0.5,
            "w": torch.randn((cfg.n_rows, cfg.k, cfg.proj_dim), generator=gen, device=dev),
            "b": torch.rand((cfg.n_rows, cfg.k), generator=gen, device=dev) * cfg.bandwidth,
            "array": torch.randn((cfg.n_rows, cfg.n_buckets, v), generator=gen, device=dev)}
    if quant is not None:
        head["array"], head["scale"] = quantize_counts(head["array"], quant)
    return head


def check_fused(cfg, head, hidden, quant):
    """fused_decode against its plain version on (hidden, head): indices
    under the boundary rule, logits equal to sketch_head's kernel at the
    fused kernel's own indices bit for bit (the same sum in the same
    order), against the plain gather at those indices and, where the
    indices agree, against the plain version, both within the gather
    bound.  Returns the kernel's logits (``got``), the error, the mismatch
    count, the plain indices and the kernel's (``kidx``)."""
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
    if not torch.equal(got, sketch_head_logits(store, idx, scale=scale, quant=quant)):
        raise AssertionError("fused_decode logits are not sketch_head's at its own indices, "
                             "bit for bit")
    torch.testing.assert_close(got, sketch_head_ref(store, idx, scale, quant), rtol=0, atol=atol)
    same = (idx == ref_idx).all(dim=1)
    err = float((got[same] - want[same]).abs().max()) if bool(same.any()) else 0.0
    if err > atol:
        raise AssertionError(f"fused_decode logits off by {err} > {atol}")
    return dict(got=got, max_abs_err=err, idx_mismatches=mism, atol=atol, idx=ref_idx, kidx=idx)


def check_and_time(timer, cfg, head, hidden, quant):
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
    # gather_ms: sketch_head at the fused kernel's own indices, the gather
    # alone; the rest of the fused time is the transform and the hash.
    out["fused_decode"] = dict(
        ms=timer.ms(lambda: fused_decode_logits(*args, **kw)),
        gather_ms=timer.ms(lambda: sketch_head_logits(store, chk["kidx"], scale=scale,
                                                      quant=quant)),
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
    if not torch.equal(got, sketch_head_ordered_ref(store, want_idx, scale, quant)):
        raise AssertionError("sketch_head logits are not sketch_head_ordered_ref's bit for bit")
    err = float((got - want).abs().max())
    if not err <= atol:
        raise AssertionError(f"sketch_head logits off by {err} > {atol}")
    lib = None
    if quant is None:
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
    cases = [(cfg, b, D_MODEL, VOCAB, quant) for cfg in (SERVE_HEAD, DEFAULT_HEAD)
             for b in (1, 2, 4, 64, 256) for quant in (None, "int8", "int4")]
    cases += [(SERVE_HEAD, 4, D_MODEL, VOCAB - 17, quant) for quant in (None, "int8", "int4")]
    # gemma2-27b's width (d 4608, V 256000) on random inputs.
    cases += [(SERVE_HEAD, 4, 4608, 256000, quant) for quant in (None, "int8")]
    for cfg, b, d, v, quant in cases:
        head = random_head(gen, cfg, v, quant, d)
        hidden = torch.randn((b, d), generator=gen, device=dev)
        for name, rec in check_and_time(timer, cfg, head, hidden, quant).items():
            print("kernel_case " + json.dumps(dict(
                kernel=name, L=cfg.n_rows, R=cfg.n_buckets, K=cfg.k, d_proj=cfg.proj_dim,
                r=cfg.bandwidth, B=b, d=d, V=v, quant=quant or "f32", **rec)), flush=True)
        del head
    free_card()


def hash_cases():
    """(label, B, L, K, d', R) of lsh_hash's launches off the serving step:
    each dataset's FULL-budget query and its freeze of the M anchors
    (run_dataset's sizing: d' = min(max(features // 2, 4), 32), r = 2), and
    the refresh of M = 256 live hiddens at the serve head."""
    out = []
    for name, spec in DATASETS.items():
        b, _, n_rows, nb = paper_shape(name)
        dp = min(max(spec.n_features // 2, 4), 32)
        out.append((f"paper {name} query", b, n_rows, spec.rs_K, dp, nb))
        out.append((f"paper {name} freeze", paper_repro.FULL["n_points"], n_rows, spec.rs_K,
                    dp, nb))
    out.append(("refresh", REFRESH_PROMPTS * PROMPT, SERVE_HEAD.n_rows, SERVE_HEAD.k,
                SERVE_HEAD.proj_dim, SERVE_HEAD.n_buckets))
    return out


def hash_phase(dev, timer):
    """lsh_hash at the paper's and the refresh's shapes (hash_cases) on
    seeded random inputs, r = 2: indices under the boundary rule against
    the plain version, timed beside it, its bound, and the projection
    alone (``x @ w.reshape(L·K, d').T`` in f32, not the function: what the
    card's f32 product takes for the kernel's multiply-adds)."""
    gen = torch.Generator(dev).manual_seed(4)
    for label, b, n_rows, k, dp, nb in hash_cases():
        x = torch.randn((b, dp), generator=gen, device=dev)
        w = torch.randn((n_rows, k, dp), generator=gen, device=dev)
        bias = torch.rand((n_rows, k), generator=gen, device=dev) * 2.0
        got = lsh_hash(x, w, bias, bandwidth=2.0, n_buckets=nb)
        want = lsh_hash_ref(x, w, bias, 2.0, nb)
        torch.cuda.synchronize()
        mism = check_hash_indices(got, want, x, w, bias, 2.0)
        wt = w.reshape(n_rows * k, dp).t()
        rec = dict(ms=timer.ms(lambda: lsh_hash(x, w, bias, bandwidth=2.0, n_buckets=nb)),
                   plain_ms=timer.ms(lambda: lsh_hash_ref(x, w, bias, 2.0, nb)),
                   projection_alone_ms=timer.ms(lambda: x @ wt),
                   max_abs_err=float((got - want).abs().max()), idx_mismatches=mism,
                   library_ms=None)
        rec["bytes"], rec["ops"] = hash_work(b, n_rows, k, dp)
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["ops"])
        print("kernel_case " + json.dumps(dict(kernel="lsh_hash", entry=label, B=b, L=n_rows,
                                               K=k, d_proj=dp, R=nb, r=2.0, **rec)), flush=True)


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


def expert_shapes(d, m):
    """(name, (E, in, out)) of an MoE FFN's expert leaves."""
    f = m.d_ff_expert
    return (("w_gate", (m.n_experts, d, f)), ("w_up", (m.n_experts, d, f)),
            ("w_down", (m.n_experts, f, d)))


def draw_moe(gen, d, m, out):
    """Random MoE params of ``init_moe``'s shapes and scales, each expert
    leaf drawn EXPERT_CHUNK experts at a time into ``out[name]``, a
    preallocated bf16 leaf (a period's rows of the stack): one (256, 7168,
    2048) leaf drawn whole in f32 is 15 GB."""
    params = {"router": torch.randn((d, m.n_experts), generator=gen,
                                    device=gen.device).mul_(d ** -0.5)}
    f = m.d_ff_expert
    for name, (_, *shape) in expert_shapes(d, m):
        leaf = params[name] = out[name]
        for e0 in range(0, m.n_experts, EXPERT_CHUNK):
            n = min(EXPERT_CHUNK, m.n_experts - e0)
            leaf[e0:e0 + n] = init_dense(gen, shape, lead=(n,))
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        params["shared"] = {"w_gate": init_dense(gen, (d, fs)), "w_up": init_dense(gen, (d, fs)),
                            "w_down": init_dense(gen, (fs, d))}
    return params


def draw_layer(cfg, gen, kind, ffn, experts=None):
    """One layer's params (``blocks.init_layer``); with ``experts`` (its
    expert leaves, preallocated) its MoE FFN comes from ``draw_moe``."""
    if experts is None:
        return blocks.init_layer(gen, cfg, kind, ffn=ffn)
    one = dataclasses.replace(cfg.moe, n_experts=1, n_shared_experts=0)
    layer = blocks.init_layer(gen, dataclasses.replace(cfg, moe=one), kind, ffn="moe")
    layer["ffn"] = draw_moe(gen, cfg.d_model, cfg.moe, experts)
    return layer


def draw_params(cfg, gen):
    """Random params of ``cfg`` on the generator's device, drawn one layer
    at a time into preallocated bf16 stacks: the f32 transient of the draw
    is then one layer's leaf (1.9 GB for mixtral's (8, 4096, 14336)
    experts; deepseek's 256 experts go EXPERT_CHUNK at a time), where
    ``init_model`` draws each whole stack in f32 (45 GB for mixtral's
    w_gate at 24 layers).  Expert stacks of more than EXPERT_CHUNK experts
    are allocated first and drawn into in place, so that no layer's
    experts are ever held twice (deepseek's are 22.5 GB a layer)."""
    params = {"embed": init_dense(gen, (cfg.vocab_size, cfg.d_model), scale=0.02),
              "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                        device=gen.device)}
    if not cfg.tie_embeddings:
        params["head"] = init_dense(gen, (cfg.vocab_size, cfg.d_model), scale=0.02)
    if cfg.n_dense_prologue:
        params["prologue"] = [draw_layer(cfg, gen, cfg.pattern[0], "dense")
                              for _ in range(cfg.n_dense_prologue)]

    def stack(dst, layer, i):
        for k, v in layer.items():
            if isinstance(v, dict):
                stack(dst.setdefault(k, {}), v, i)
            else:
                if k not in dst:
                    dst[k] = v.new_empty((cfg.n_periods, *v.shape))
                if v.data_ptr() != dst[k][i].data_ptr():    # not drawn in place
                    dst[k][i].copy_(v)

    params["periods"] = {}
    for j, kind in enumerate(cfg.pattern):
        ffn = model.period_ffn(cfg, j)
        stacked = params["periods"][f"pos{j}"] = {}
        chunked = ffn == "moe" and cfg.moe.n_experts > EXPERT_CHUNK
        if chunked:
            stacked["ffn"] = {name: torch.empty((cfg.n_periods, *shape), dtype=torch.bfloat16,
                                                device=gen.device)
                              for name, shape in expert_shapes(cfg.d_model, cfg.moe)}
        for i in range(cfg.n_periods):
            experts = ({name: stacked["ffn"][name][i]
                        for name, _ in expert_shapes(cfg.d_model, cfg.moe)}
                       if chunked else None)
            stack(stacked, draw_layer(cfg, gen, kind, ffn, experts), i)
    return params


def build_served(arch, dev, n_layers=None, per_layer=False):
    """Full-width ``arch`` from seed 0 on the card (``n_layers`` deep when
    given, else at full depth; with ``per_layer``, drawn a layer at a time
    by ``draw_params`` and passed through ``LM.from_config(params=)``), and
    the serve head (SERVE_HEAD) frozen from random kernel params over 256
    anchors at the arch's vocabulary; returns (lm, kernel params, frozen
    head, the generator, for the prompts)."""
    gen = torch.Generator(dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if per_layer:
        cfg = get_config(arch)
        cfg = cfg if n_layers is None else cfg.scaled(n_layers=n_layers)
        lm = LM.from_config(arch, device=dev, params=draw_params(cfg, gen),
                            n_layers=n_layers)
    else:
        lm = LM.from_config(arch, device=dev, generator=gen, n_layers=n_layers)
    cfg = lm.cfg
    m = 256
    kparams = {"points": torch.randn((m, SERVE_HEAD.proj_dim), generator=gen, device=dev),
               "alphas": torch.randn((m, cfg.vocab_size), generator=gen, device=dev) * 0.1,
               "proj": torch.randn((cfg.d_model, SERVE_HEAD.proj_dim), generator=gen,
                                   device=dev) / cfg.d_model ** 0.5}
    frozen = freeze_head(gen, kparams, SERVE_HEAD)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(lm.params))
    depth = (f"{cfg.n_layers} layers" if n_layers is None else
             f"{cfg.n_layers} of {get_config(arch).n_layers} layers")
    print(f"main path: {cfg.name} {depth} d_model {cfg.d_model} "
          f"vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params, built and head "
          f"frozen in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated (peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB)", flush=True)
    return lm, kparams, frozen, gen


def main_path(dev, timer):
    # Drawn a layer at a time, every matrix its own draw: the kind of
    # weights on which the staggered engine's old two-ulp token rule failed.
    lm, kparams, frozen, gen = build_served("rwkv6-1.6b", dev, per_layer=True)
    cfg = lm.cfg
    heads = {"dense": lm.head,
             "fused": SketchHead(cfg=SERVE_HEAD, backend="fused", params=frozen),
             "two_kernel": SketchHead(cfg=SERVE_HEAD, backend="two_kernel", params=frozen)}
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    want = {"dense": {}, "fused": {"fused_decode": GEN - 1},
            "two_kernel": {"lsh_hash": GEN - 1, "sketch_head": GEN - 1}}
    runs = generate_runs(lm, heads, prompts, want)
    agree = float((runs["fused"][-1]["tokens"][:, PROMPT:]
                   == runs["two_kernel"][-1]["tokens"][:, PROMPT:]).float().mean())
    print(f"free-running fused vs two_kernel token agreement (reported, not gated): {agree:.3f}")
    steps = step_profile(lm, heads, prompts, runs["fused"][-1]["tokens"])
    loop_args = (lm, heads, prompts, want, {n: r[-1]["tokens"] for n, r in runs.items()},
                 steps)

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

    recs = check_and_time(timer, SERVE_HEAD, frozen, hidden, None)
    return runs, recs, lm, frozen, kparams, loop_args


def generate_runs(lm, heads, prompts, want_launches):
    """``REPEATS`` rounds of ``LM.generate`` (BATCH x PROMPT prompts, GEN new
    tokens) through each head in turn, after a warm-up, with the launch
    counts zeroed just before and checked just after each run; returns
    {head: [{seconds, tokens, launches}]}."""
    cfg = lm.cfg
    for head in heads.values():                       # warm-up: libraries, handles
        lm.with_head(head).generate(prompts, 2)
    runs = {name: [] for name in heads}
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
            expect_launches(f"{cfg.name} {name} run", launched, want_launches[name])
            runs[name].append(dict(seconds=dt, tokens=tokens, launches=launched))
            print(f"run {rep} {cfg.name} head={served.head.describe()}: {BATCH}x{GEN} new tokens "
                  f"in {dt:.4f} s = {BATCH * GEN / dt:.1f} new tok/s; launches {launched}",
                  flush=True)
    for name, rs in runs.items():
        tps = sorted(BATCH * GEN / r["seconds"] for r in rs)
        print(f"generate {cfg.name} head={name}: new tok/s over {REPEATS} runs {tps} "
              f"(median {float(np.median(tps)):.1f})")
    return runs


def profile_kernels(fn, n_steps=1):
    """``fn`` once under torch.profiler: (kernel ms, kernel launches, the
    top six kernels by time), each per step of ``n_steps``; kernel ms is
    None when the profiler saw no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = (sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_steps
            if kernels else None)
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / n_steps
    return busy, len(kernels) / n_steps, sorted(top.items(), key=lambda kv: -kv[1])[:6]


def busy_text(busy, launches, wall):
    if busy is None:
        return "not measured (the profiler saw no device events)"
    return (f"{busy:.3f} ms of kernels in {launches:g} launches, busy share "
            f"{busy / wall:.3f}")


def step_profile(lm, heads, prompts, tokens):
    """One eager decode step per head, functional (``serve_step``: copies
    the cache) and in place (``serve_step_``, what ``generate`` and the
    engine run at decode_chunk 1): median wall time of 5 synchronized
    steps, then one step under torch.profiler for the device's kernel time
    (busy share = kernel time / unprofiled step time) and the top kernels.
    Returns {head: {"functional"/"in place": (wall ms, kernel ms,
    launches)}}."""
    cfg, dev = lm.cfg, prompts.device
    out = {}
    with torch.inference_mode():
        cache = model.init_decode_cache(cfg, BATCH, PROMPT + GEN, device=dev)
        _, cache = prefill_step(lm.params, prompts, cfg, cache)
        tok = tokens[:, PROMPT:PROMPT + 1]
        for name, head in heads.items():
            head = head.to(dev)
            for label, step in (("functional", serve_step), ("in place", serve_step_)):
                def run():
                    step(lm.params, cache, tok, cfg, head=head, pos=PROMPT)
                walls = []
                for _ in range(6):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                wall = float(np.median(walls[1:]))
                busy, launches, top = profile_kernels(run)
                out.setdefault(name, {})[label] = (wall, busy, launches)
                print(f"decode step {cfg.name} head={name} ({label}): {wall:.3f} ms wall "
                      f"(median of 5); {busy_text(busy, launches, wall)}")
                for kname, us in top:
                    print(f"    {us / 1e3:8.4f} ms  {kname[:90]}")
    return out


def megastep_ms(loop, k, n_steps=GEN - 1, reps=3):
    """Wall ms a decode step over ``n_steps`` steps run as megasteps of
    ``k`` graph replays, each block fetched to the host after its
    megastep (one sync a megastep, as the engine does); median of
    ``reps`` runs after one more."""
    walls = []
    tok = loop.tok.clone()
    for _ in range(reps + 1):
        loop.load(tok, PROMPT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        todo = n_steps
        while todo > 0:
            loop.run(min(k, todo)).cpu()
            todo -= min(k, todo)
        walls.append((time.perf_counter() - t0) * 1e3 / n_steps)
    return float(np.median(walls[1:]))


def replay_enqueue_ms(loop, n_steps=GEN - 1, reps=3):
    """Host ms to enqueue one replay (and its block copy): ``n_steps``
    replays enqueued without a sync, over ``n_steps``; median of ``reps``.
    Where it exceeds the device's time a step, the device waits on the
    host between replays."""
    times = []
    tok = loop.tok.clone()
    for _ in range(reps):
        loop.load(tok, PROMPT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.run(n_steps)
        times.append((time.perf_counter() - t0) * 1e3 / n_steps)
        torch.cuda.synchronize()
    return float(np.median(times))


def decode_loop_phase(lm, heads, prompts, want_launches, eager, steps):
    """``LM.generate`` at every ``DECODE_CHUNKS`` K through each head, after
    one warm-up run that captures the decode step (one capture serves every
    K): launch counts zeroed before and checked after each run (a replay
    adds the capture's count to each wrapper), the streams equal for every
    K and equal to the eager runs' (``eager``: {head: tokens}).  Then the
    captured step itself: ms/step as megasteps of each K (a host fetch per
    megastep), its kernel time, launches and busy share over 15 replays
    under torch.profiler, the host's time to enqueue a replay, beside the
    eager step of ``step_profile`` (``steps``).  Returns {head: the
    captured step's ms/step at decode_chunk 16}."""
    cfg = lm.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    report, per_step = {}, {}
    for name, head in heads.items():
        served = lm.with_head(head)
        t0 = time.perf_counter()
        served.generate(prompts, GEN, decode_chunk=DECODE_CHUNKS[-1])      # capture
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        streams, tps = {}, {}
        for k in DECODE_CHUNKS:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            tokens = served.generate(prompts, GEN, decode_chunk=k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launched = counts()
            expect_launches(f"{cfg.name} {name} decode_chunk={k}", launched,
                            want_launches[name])
            streams[k], tps[k] = tokens, BATCH * GEN / dt
            print(f"decode loop {cfg.name} head={name} decode_chunk={k}: {BATCH}x{GEN} new "
                  f"tokens in {dt:.4f} s = {tps[k]:.1f} new tok/s; launches {launched}",
                  flush=True)
        for k in DECODE_CHUNKS:
            if not torch.equal(streams[k], streams[1]) or not torch.equal(streams[k],
                                                                          eager[name]):
                raise AssertionError(f"{cfg.name} {name}: decode_chunk={k} gave another "
                                     f"stream than the eager decode_chunk=1 runs")
        (loop,) = served._loops.values()
        if loop.graph is None:
            raise AssertionError(f"{cfg.name} {name}: the decode step was not captured")
        per_step[name] = loop.launches_per_step()
        ms = {k: megastep_ms(loop, k) for k in DECODE_CHUNKS}
        enqueue = replay_enqueue_ms(loop)
        loop.load(loop.tok.clone(), PROMPT)
        busy, launches, top = profile_kernels(lambda: loop.run(GEN - 1).cpu(), GEN - 1)
        e_wall, e_busy, e_launches = steps[name]["in place"]
        f_wall = steps[name]["functional"][0]
        print(f"decode loop {cfg.name} head={name}: all {len(DECODE_CHUNKS)} decode_chunk "
              f"streams equal the eager runs token for token; capture + first run "
              f"{capture_s:.2f} s; captured step {ms[16]:.3f} ms/step at decode_chunk 16 "
              f"({ {k: round(v, 3) for k, v in ms.items()} } ms/step by decode_chunk), "
              f"{busy_text(busy, launches, ms[16])}; the host enqueues a replay in "
              f"{enqueue:.3f} ms; wrapper launches a replay "
              f"{per_step[name]}; eager step {e_wall:.3f} ms in place "
              f"({busy_text(e_busy, e_launches, e_wall)}), {f_wall:.3f} ms functional; "
              f"new tok/s by decode_chunk { {k: round(v, 1) for k, v in tps.items()} }",
              flush=True)
        for kname, us in top:
            print(f"    {us / 1e3:8.4f} ms  {kname[:90]}")
        report[name] = ms[16]
    torch.cuda.synchronize()
    print(f"decode loop {cfg.name}: peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB allocated, reserved {reserved / 2 ** 30:.2f} -> "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB with {len(heads)} captured "
          f"steps (their private pools)", flush=True)
    print("captured_step " + json.dumps({"arch": cfg.name, "launches_per_replay": per_step}))
    return report


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
    """race_update against its plain versions: equal to
    ``race_update_ordered_ref`` bit for bit, every element within
    ``race_update_tol`` of the einsum one, two launches bit for bit equal,
    and the library call within twice that bound; returns the timed record,
    with the kernel's time over the library call's (``library_factor``)."""
    fn, plain, lib, axis = race_inputs(counts, idx, alphas, entry)
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"race_update ({entry}): two launches gave different bits")
    if not torch.equal(got, race_update_ordered_ref(counts, idx, alphas, axis)):
        raise AssertionError(f"race_update ({entry}): not race_update_ordered_ref bit for bit")
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
        rec["library_factor"] = rec["ms"] / rec["library_ms"]
    rec["bytes"], rec["ops"] = race_work(counts, idx, alphas)
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["ops"])
    return rec


def race_phase(dev, timer):
    """race_update against its plain versions at M in {32, 256, 1024}, the
    serve head (L=128) and SketchHeadConfig() (L=64), R=16, V=65536 and a
    ragged 65519, through both entries; then a (C, L, R) sketch with C,
    L and M all off the kernel's tiles (C=50021, L=100, M=77).  Prints the
    slowest case's time over its one-call twin's."""
    gen = torch.Generator(dev).manual_seed(2)
    worst = (0.0, None)

    def case(arr, idx, alphas, entry, **shape):
        nonlocal worst
        rec = check_race(timer, arr, idx, alphas, entry)
        print("kernel_case " + json.dumps(dict(kernel="race_update", entry=entry, **shape,
                                               **rec)), flush=True)
        worst = max(worst, (rec["library_factor"], f"{entry} {shape}"))

    for cfg in (SERVE_HEAD, DEFAULT_HEAD):
        for v in (VOCAB, VOCAB - 17):
            counts = torch.randn((cfg.n_rows, cfg.n_buckets, v), generator=gen, device=dev)
            for m in (32, 256, 1024):
                idx = torch.randint(0, cfg.n_buckets, (m, cfg.n_rows), generator=gen,
                                    device=dev, dtype=torch.int32)
                alphas = torch.randn((m, v), generator=gen, device=dev) * 0.1
                for entry in ("counts", "sketch"):
                    arr = counts if entry == "counts" else counts.permute(2, 0, 1).contiguous()
                    case(arr, idx, alphas, entry, M=m, L=cfg.n_rows, R=cfg.n_buckets, V=v)
                    del arr
    c, n_rows, m = 50021, 100, 77
    sketch = torch.randn((c, n_rows, DEFAULT_HEAD.n_buckets), generator=gen, device=dev)
    idx = torch.randint(-1, DEFAULT_HEAD.n_buckets + 1, (m, n_rows), generator=gen,
                        device=dev, dtype=torch.int32)
    case(sketch, idx, torch.randn((m, c), generator=gen, device=dev) * 0.1, "sketch",
         M=m, L=n_rows, R=DEFAULT_HEAD.n_buckets, C=c)
    print(f"race_update: slowest case against its one-call twin {worst[0]:.3f}x ({worst[1]})",
          flush=True)


def run_engine(lm, stream, n_slots, *, tenants=None, head_cache=None, decode_chunk=1):
    """Serve ``stream`` through ``lm.engine`` with the launch counts zeroed
    just before and read just after; returns (engine, finished, seconds,
    launches)."""
    eng = lm.engine(n_slots, PROMPT + GEN, head_cache=head_cache, decode_chunk=decode_chunk)
    for i, (prompt, gen, arrival) in enumerate(stream):
        eng.submit(prompt, gen, arrival=arrival,
                   tenant=None if tenants is None else tenants[i])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    finished = eng.run()
    torch.cuda.synchronize()
    dt, launched = time.perf_counter() - t0, counts()
    eng.close()                                 # its captured loops' graphs
    return eng, finished, dt, launched


def engine_report(label, eng, finished, seconds, launched):
    n_new = sum(len(v) for v in finished.values())
    steps = eng.stats["decode_steps"]
    print(f"engine {label}: {len(finished)} requests over {eng.n_slots} slots, {n_new} new "
          f"tokens in {seconds:.4f} s = {n_new / seconds:.1f} new tok/s, {steps} decode steps "
          f"in {eng.stats['megasteps']} ticks (decode_chunk {eng.decode_chunk}), "
          f"{eng.stats['host_syncs']} host syncs, slot utilization "
          f"{eng.slot_utilization:.3f}, launches {launched} "
          f"({ {k: v / steps for k, v in launched.items() if v} } per decode step)",
          flush=True)


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
        # The same stream in megasteps: the captured step replayed (the
        # capture, once per engine, and its WARMUP_STEPS eager steps are
        # inside the wall time and the counts).
        eng4, fin4, dt4, launched4 = run_engine(served, stream, SLOTS, decode_chunk=ENGINE_CHUNK)
        engine_report(served.head.describe(), eng4, fin4, dt4, launched4)
        expect_launches(f"{name} decode_chunk={ENGINE_CHUNK}", launched4,
                        {"fused_decode": eng4.stats["decode_steps"] + WARMUP_STEPS}
                        if name == "fused" else {})
        if fin4 != fin:
            raise AssertionError(f"engine {name}: decode_chunk={ENGINE_CHUNK} streams differ "
                                 f"from decode_chunk=1")
        print(f"engine {name}: decode_chunk={ENGINE_CHUNK} gives every one of the "
              f"{N_REQUESTS} staggered streams of decode_chunk=1 token for token "
              f"({eng4.stats['megasteps']} ticks, {eng4.stats['host_syncs']} host syncs; "
              f"decode_chunk=1: {eng.stats['megasteps']}, {eng.stats['host_syncs']})",
              flush=True)
        fresh = model.init_decode_cache(cfg, SLOTS, PROMPT + GEN, device=dev)
        for a, b in zip(eng.pool["periods"]["pos0"], fresh["periods"]["pos0"]):
            if not torch.equal(a, b):
                raise AssertionError(f"engine {name}: a retired slot is not a fresh row")
        rec_fin, ticks, admitted = record_engine(served, stream, SLOTS)
        if rec_fin != fin:
            raise AssertionError(f"engine {name}: a second run of the stream gave other tokens")
        check_staggered(name, served, stream, fin, ticks, admitted, frozen)

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
    sketched head, the (n_slots, d) final hidden, and for every request
    its admission: the prompt rows of its prefill batch, its row there,
    its slot and its prefill logits; returns (finished, ticks,
    admissions by request id)."""
    eng = served.engine(n_slots, PROMPT + GEN)
    for prompt, gen, arrival in stream:
        eng.submit(prompt, gen, arrival=arrival)
    backend, ticks, admitted, last = eng.backend, [], {}, {}
    tap = HiddenTap(backend.head) if backend.head.needs_hidden else None
    if tap is not None:
        backend.head = tap
    decode, prefill, finish = backend.decode, backend.prefill, eng._finish_admit

    def recording_prefill(prompts, max_seq):
        logits, filled = prefill(prompts, max_seq)
        last.update(rows=np.array(prompts), logits=logits.float().clone())
        return logits, filled

    def recording_finish(group, slots, first, plen):
        for r, slot in zip(group, slots):
            row = next(i for i, p in enumerate(last["rows"]) if np.array_equal(p, r.prompt))
            admitted[r.rid] = dict(rows=last["rows"], row=row, slot=int(slot),
                                   logits=last["logits"][row])
        return finish(group, slots, first, plen)

    def recording_decode(pool, tokens, pos, active, head_params=None):
        owner = dict(eng.sched.owner)
        logits, pool = decode(pool, tokens, pos, active, head_params=head_params)
        ticks.append(dict(owner=owner, logits=logits.float().clone(),
                          hidden=None if tap is None else tap.seen.pop()))
        return logits, pool

    backend.decode = recording_decode
    backend.prefill = recording_prefill
    eng._finish_admit = recording_finish
    return eng.run(), ticks, admitted


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
        for j, tok in enumerate(tokens[:-1]):
            logits, cache = serve_step(served.params, cache, torch.tensor([[tok]], device=dev),
                                       cfg, head=tap or served.head, pos=len(prompt) + j)
            out.append(logits[0].float())
    return out, [None] + ([h[0] for h in tap.seen] if tap else [None] * (len(out) - 1))


def equal_m_steps(served, n_slots, admission, tokens):
    """The request alone at the engine's row counts, teacher-forced on
    ``tokens``: its prompt at its row of a prefill batch of the engine's
    size (the other rows token 0), its rows inserted into a fresh pool of
    ``n_slots`` rows at its engine slot, then per-slot decode steps over
    the whole pool (the other slots inactive at position 0), all through
    the engine's own backend ops, so that every product has the engine's
    row count.  Returns the logits that pick each of ``tokens``."""
    cfg, rows, row, slot = served.cfg, admission["rows"], admission["row"], admission["slot"]
    backend = EngineBackend(served.params, cfg, head=served.head, device=served.device)
    batch = np.zeros_like(rows)
    batch[row] = rows[row]
    with torch.inference_mode():
        logits, filled = backend.prefill(batch, PROMPT + GEN)
        out = [logits[row].float()]
        pool = backend.insert(backend.init_pool(n_slots, PROMPT + GEN),
                              backend.expand_rows(filled, [row]), [slot])
        tok, pos = np.zeros(n_slots, np.int32), np.zeros(n_slots, np.int32)
        active = np.arange(n_slots) == slot
        for j, t in enumerate(tokens[:-1]):
            tok[slot], pos[slot] = t, rows.shape[1] + j
            logits, pool = backend.decode(pool, tok, pos, active)
            out.append(logits[slot].float())
    return out


def track(worst, errs, i, j):
    """[largest norm error, largest max error, (request, token) of the
    largest norm error] after one more step's errors."""
    at = (i, j) if errs[0] > worst[0] else worst[2]
    return [max(worst[0], errs[0]), max(worst[1], errs[1]), at]


def check_staggered(name, served, stream, fin, ticks, admitted, frozen):
    """Every step of every staggered stream against two runs of the request
    alone, teacher-forced on the engine's tokens.  On the card a row's bf16
    bits depend on how many rows share its GEMM (cuBLAS picks its kernel by
    the row count; the engine decodes four rows a step, solo generate one):

    * at the engine's row counts (``equal_m_steps``: the request's row
      among filler rows, in its prefill batch's size and its slot of a
      pool of the engine's size), the logits that pick every token equal
      the engine's bit for bit, and so do the tokens;
    * at batch 1 (``solo_steps``, ``LM.generate``'s own prefill and
      decode), the engine's logits (dense head) or final hidden (sketched)
      meet the bf16 backbone rule against the solo's at every decode step.
      The engine's and the solo's buckets are computed from hiddens that
      differ in their last bits, so a bucket may flip between them; those
      flips are counted, not gated;
    * sketched: each tick's logits are bit for bit the fused kernel's on
      that tick's hiddens, which is held against fused_decode_ref
      (``check_fused``: indices under the boundary rule, logits under the
      gather bound), then the final-logit softcap where the arch has one.

    A stream equals solo ``LM.generate`` token for token exactly when the
    batch-1 run picks the engine's token at every step (reported)."""
    per_rid = {}
    for tick in ticks:
        if tick["hidden"] is not None:
            chk = check_fused(SERVE_HEAD, frozen, tick["hidden"], None)
            rows = sorted(tick["owner"])
            fused = chk["got"]
            if served.cfg.final_logit_softcap:           # serve_step applies it after the head
                fused = softcap(fused, served.cfg.final_logit_softcap)
            if not torch.equal(fused[rows], tick["logits"][rows]):
                raise AssertionError(f"engine {name}: a tick's logits are not the fused "
                                     f"kernel's on its hiddens")
        for s, rid in tick["owner"].items():
            per_rid.setdefault(rid, []).append((tick["logits"][s], None if tick["hidden"] is None
                                                else tick["hidden"][s]))
    proj, w, b = frozen["proj"], frozen["w"], frozen["b"]
    n_equal, n_steps, n_flips, worst = 0, 0, 0, [0.0, 0.0, None]
    for i, (prompt, gen, _) in enumerate(stream):
        toks, steps = fin[i], per_rid.get(i, [])
        if len(toks) != gen or len(steps) != gen - 1:
            raise AssertionError(f"engine {name}: request {i} has {len(toks)} tokens from "
                                 f"{len(steps)} decode steps, expected {gen} from {gen - 1}")
        at_m = equal_m_steps(served, ticks[0]["logits"].shape[0], admitted[i], toks)
        eng_logits_all = [admitted[i]["logits"]] + [lg for lg, _ in steps]
        for j in range(gen):
            if not torch.equal(eng_logits_all[j], at_m[j]) or int(torch.argmax(at_m[j])) != toks[j]:
                diff = (eng_logits_all[j] != at_m[j]).nonzero()
                raise AssertionError(
                    f"engine {name}: request {i} token {j} ({toks[j]}): the logits at the "
                    f"engine's row counts differ from the engine's at {diff.shape[0]} of "
                    f"{at_m[j].numel()} entries (first {diff[:1].tolist()}), or pick "
                    f"{int(torch.argmax(at_m[j]))}")
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
            elif j:
                got, want = eng_logits.cpu().numpy(), solo[j].cpu().numpy()
                worst = track(worst, bf16_backbone_errors(got, want), i, j)
                assert_bf16_backbone_close(got, want)
    sketched = served.head.needs_hidden
    what = "final hidden" if sketched else "logits"
    print(f"engine {name}: all {n_steps} steps of the {len(stream)} staggered streams equal "
          f"a teacher-forced run at the engine's row counts bit for bit (logits and "
          f"tokens); {n_equal} of {len(stream)} equal solo LM.generate at batch 1 token for "
          f"token, engine {what} within {worst[0]:.3g} in norm and {worst[1]:.3g} of the "
          f"largest of batch 1's (limits {BF16_NORM_TOL}, {BF16_MAX_TOL}; largest norm "
          f"error at request, new token {worst[2]})"
          + (f"; {n_flips} engine-vs-solo bucket flips over {n_steps - len(stream)} decode "
             f"steps (reported)" if sketched else ""), flush=True)


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
    pred_ms = timer.ms(lambda: fused_decode_logits(
        hidden, row32["proj"], row32["w"], row32["b"], row32["array"],
        bandwidth=SERVE_HEAD.bandwidth, n_buckets=SERVE_HEAD.n_buckets))
    pred_bytes, pred_ops = kernel_work("fused_decode", hidden, row32, pred_chk["idx"], None)
    print("kernel_case " + json.dumps(dict(
        kernel="fused_decode", entry=f"refresh pred ({'f32' if quant is None else quant} bank)",
        B=hidden.shape[0], L=SERVE_HEAD.n_rows, R=SERVE_HEAD.n_buckets, V=cfg.vocab_size,
        ms=pred_ms, bound_ms=bound(pred_bytes, pred_ops)[0],
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


def query_work(sketch, idx):
    """(bytes, operations) of one query: the indices read once, the sketch
    entries they touch read once, the (B, C) estimates written once; one
    add per (query, class, row)."""
    c, n_rows, n_buckets = sketch.shape
    b = idx.shape[0]
    rows = torch.arange(n_rows, device=idx.device)
    touched = int((rows[None, :] * n_buckets + idx.long()).unique().numel())
    return (4 * b * n_rows + sketch.element_size() * c * touched + 4 * b * c,
            b * c * n_rows)


def check_query(timer, sketch, idx, n_groups):
    """race_query against its plain versions: bit for bit
    ``race_query_ordered_ref``, every estimate within ``race_query_tol`` of
    ``race_query_ref`` (NaN where both are NaN), two launches bit for bit
    equal; returns the timed record."""
    got = race_query(sketch, idx, n_groups=n_groups)
    again = race_query(sketch, idx, n_groups=n_groups)
    want = race_query_ref(sketch, idx, n_groups)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("race_query: two launches gave different bits")
    ordered = race_query_ordered_ref(sketch, idx, n_groups)
    if not torch.equal(got.view(torch.int32), ordered.view(torch.int32)):
        raise AssertionError("race_query: not race_query_ordered_ref bit for bit")
    tol = race_query_tol(sketch, idx, n_groups)
    both_nan = got.isnan() & want.isnan()
    err = (got.double() - want.double()).abs()
    if not bool(((err <= tol) | both_nan).all()):
        raise AssertionError(f"race_query off by {float(err[~both_nan].max())}, beyond "
                             f"race_query_tol")
    rec = dict(max_abs_err=float(err[~both_nan].max()) if bool((~both_nan).any()) else 0.0,
               ms=timer.ms(lambda: race_query(sketch, idx, n_groups=n_groups)),
               plain_ms=timer.ms(lambda: race_query_ref(sketch, idx, n_groups)),
               library_ms=None, nan=int(both_nan.sum()))
    rec["bytes"], rec["ops"] = query_work(sketch, idx)
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["ops"])
    return rec


def paper_shape(name):
    """(B, C, L, R) of a dataset's query at the FULL budget (run_dataset's
    sizing)."""
    spec, budget = DATASETS[name], paper_repro.FULL
    regression = spec.task == "regression"
    return (min(spec.n_test, budget["test_cap"]), 1 if regression else 2,
            budget["rows"] * (2 if regression else 1),
            64 if regression else max(spec.rs_R // 10, 16))


def query_phase(dev, timer):
    """race_query against its plain version: each dataset's FULL-budget
    shape at g = 8, then g in {5, 1}, L % g != 0, a ragged B, a bf16
    sketch, tied means, L < g (NaN) and the [1, 2, 3, 10] median."""
    gen = torch.Generator(dev).manual_seed(3)

    def case(label, b, c, n_rows, r, g, dtype=torch.float32, sketch=None):
        if sketch is None:
            sketch = torch.randn((c, n_rows, r), generator=gen, device=dev).to(dtype)
        idx = torch.randint(0, r, (b, n_rows), generator=gen, device=dev, dtype=torch.int32)
        rec = check_query(timer, sketch, idx, g)
        print("kernel_case " + json.dumps(dict(kernel="race_query", entry=label, B=b, C=c,
                                               L=n_rows, R=r, g=g, dtype=str(dtype), **rec)),
              flush=True)

    for name in DATASETS:
        case(name, *paper_shape(name), 8)
    b, c, n_rows, r = paper_shape("adult")
    case("g=5", b, c, n_rows, r, 5)
    case("g=1 (mean)", b, c, n_rows, r, 1)
    case("L % g != 0", b, c, n_rows + 3, r, 8)
    case("ragged B", 777, c, n_rows, r, 8)
    case("bf16 sketch", b, c, n_rows, r, 8, torch.bfloat16)
    case("5 classes", 300, 5, 640, 16, 8)
    case("tied means", 1000, 2, 64, 4, 8,
         sketch=torch.randint(0, 2, (2, 64, 4), generator=gen, device=dev).float())
    case("L < g (NaN)", 50, 1, 5, 16, 8)
    s = torch.tensor([1.0, 2.0, 3.0, 10.0], device=dev).reshape(1, 4, 1)
    got = race_query(s, torch.zeros((3, 4), dtype=torch.int32, device=dev), n_groups=4)
    if not bool((got == 2.5).all()):
        raise AssertionError(f"median of [1, 2, 3, 10] is {got.tolist()}, not 2.5")
    print("race_query: median of [1, 2, 3, 10] = 2.5 (midpoint), every case within "
          "race_query_tol and bit-stable", flush=True)


def paper_run(name):
    """``run_dataset(name)`` at the FULL budget in a process of the paper
    phase's pool: (the result with its tensors on the CPU, the launch
    counts of the run)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    reset_counts()
    r = paper_repro.run_dataset(name, paper_repro.FULL, 0, torch.device("cuda"))
    torch.cuda.synchronize()
    launched = counts()
    parts = r["parts"]
    r["parts"] = dict(parts, **{k: tree_to(parts[k], "cpu")
                                for k in ("state", "queries", "kparams")})
    return r, launched


def tree_to(tree, dev):
    """The tensors of a tree of dicts moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if torch.is_tensor(tree) else tree


def paper_phase(dev, timer):
    """The paper's recipe on all six datasets at the FULL budget through
    run_dataset, each in a spawned process (all at once), then each
    dataset's kernels checked here; returns (race_query record of the
    first dataset's query, race_query launches over the phase)."""
    import concurrent.futures
    import multiprocessing

    budget = paper_repro.FULL
    chunks = -(-budget["n_points"] // 4096)
    want = {"lsh_hash": chunks + 1, "race_update": chunks, "race_query": 1}
    with concurrent.futures.ProcessPoolExecutor(
            len(DATASETS), mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = list(pool.map(paper_run, DATASETS))
    first, n_query = None, 0
    for name, (r, launched) in zip(DATASETS, runs):
        expect_launches(f"paper {name}", launched, want)
        n_query += launched["race_query"]
        sk, state, q, kparams = (tree_to(r["parts"][k], dev)
                                 for k in ("sketch", "state", "queries", "kparams"))
        cfg = sk.config
        w, b = state["hash"]["w"], state["hash"]["b"]
        idx = sk.lsh.hash(state["hash"], q)
        mism = check_hash_indices(idx, lsh_hash_ref(q, w, b, cfg.bandwidth, cfg.n_buckets),
                                  q, w, b, cfg.bandwidth)
        qrec = check_query(timer, sk.debiased(state), idx, cfg.n_groups)
        points, alphas = kparams["points"], kparams["alphas"]
        pidx = sk.lsh.hash(state["hash"], points)
        zeros = torch.zeros_like(state["array"])
        if not torch.equal(race_update(zeros, pidx, alphas.contiguous()), state["array"]):
            raise AssertionError(f"paper {name}: the frozen array is not race_update of the "
                                 f"anchors")
        urec = check_race(timer, zeros, pidx, alphas.contiguous(), "sketch")
        shape = dict(B=q.shape[0], C=cfg.n_outputs, L=cfg.n_rows, R=cfg.n_buckets,
                     g=cfg.n_groups, M=points.shape[0])
        print("kernel_case " + json.dumps(dict(kernel="race_query", entry=f"paper {name}",
                                               idx_mismatches=mism, **shape, **qrec)))
        print("kernel_case " + json.dumps(dict(kernel="race_update",
                                               entry=f"freeze {name} (C, L, R)", **shape,
                                               **urec)))
        print(f"paper {name} ({r['task']}, data checksum {r['data_checksum']}): NN "
              f"{r['nn']:.4f} Kernel {r['kernel']:.4f} RS {r['rs']:.4f}; memory "
              f"{r['mem_reduction']:.1f}x, FLOPs {r['flop_reduction']:.1f}x fewer; seconds "
              f"{ {k: round(v, 3) for k, v in r['stage_seconds'].items()} } (total "
              f"{r['seconds']:.2f}); launches {launched}; {mism} query index mismatches at "
              f"floor boundaries", flush=True)
        if r["task"] == "classification" and not (r["kernel"] >= r["nn"] - 0.08
                                                  and r["rs"] >= r["kernel"] - 0.10):
            raise AssertionError(f"paper {name}: kernel {r['kernel']} vs NN {r['nn']} (limit "
                                 f"-0.08) or sketch {r['rs']} vs kernel (limit -0.10) off")
        first = first or qrec
    return first, n_query


def lm_distill_phase():
    """The serve CLI's ``--sketch-head`` without ``--head-path`` at full
    width (distill in process, freeze, generate), then ``--engine --tenants
    3`` over 2 slots; launch counts zeroed before and read after each."""
    def cli(argv):
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out = buf.getvalue()
        print(out.rstrip())
        mse = float(out.split("distill MSE: ")[1].split()[0])
        if not math.isfinite(mse):
            raise AssertionError(f"serve {' '.join(argv)}: distill MSE {mse}")
        return out, counts(), dt

    # Both runs decode in megasteps; the one capture of each warms its step
    # up WARMUP_STEPS times first, and those launches run too.
    base = ["--prompt-len", str(PROMPT), "--gen", str(GEN)]
    out, launched, dt = cli(["--sketch-head", "--batch", str(BATCH), "--decode-chunk",
                             str(GEN), *base])
    if "head=sketch/fused " not in out:
        raise AssertionError("serve --sketch-head did not serve the fused sketch head")
    expect_launches("serve --sketch-head --decode-chunk", launched,
                    {"lsh_hash": 1, "fused_decode": GEN - 1 + WARMUP_STEPS})
    print(f"serve --sketch-head --decode-chunk {GEN} (no --head-path): {dt:.2f} s wall, "
          f"launches {launched}")
    out, launched, dt = cli(["--sketch-head", "--engine", "--tenants", "3", "--batch",
                             str(TENANT_SLOTS), "--requests", str(N_REQUESTS), "--stats-json",
                             "--decode-chunk", str(ENGINE_CHUNK), *base])
    stats = json.loads(out.split("STATS_JSON ")[1].splitlines()[0])
    capacity = stats["tenants"]["capacity"]
    expect_launches("serve --engine --tenants 3 --decode-chunk", launched, {
        "lsh_hash": 3, "fused_decode": capacity * (stats["decode_steps"] + WARMUP_STEPS)})
    if (stats["requests"] != N_REQUESTS or not stats["tenants"]["evictions"]
            or stats["megasteps"] >= stats["decode_steps"]):
        raise AssertionError(f"serve --engine --tenants 3 --decode-chunk: {stats}")
    print(f"serve --engine --tenants 3 --decode-chunk {ENGINE_CHUNK}: {dt:.2f} s wall, "
          f"{stats['decode_steps']} decode steps in {stats['megasteps']} ticks, "
          f"launches {launched}")


def flash_cases():
    """(label, B, S, H, Hkv, dh, dtype, window, softcap) of the flash phase:
    gemma2-27b's heads at the main path's and the long prefill's shapes
    (each layer kind, and softcap-free for the library yardstick), ragged
    and f32 cases, the heads of stablelm-12b (dh=160, GQA 4) and
    musicgen-large (dh=64, MHA), and deepseek-v3's MLA prefill (q/k head
    dim 128 + 64 = 192, V padded to it, H = Hkv = 128)."""
    bf16, f32 = torch.bfloat16, torch.float32
    g = (32, 16, 128)
    cases = []
    for label, b, s in (("main prefill", BATCH, PROMPT), ("long prefill", 1, GEMMA_LONG)):
        cases += [(f"{label}, local", b, s, *g, bf16, 4096, 50.0),
                  (f"{label}, global", b, s, *g, bf16, None, 50.0),
                  (f"{label}, softcap-free", b, s, *g, bf16, None, None)]
    return cases + [
        ("ragged S=200, window 64 (band starts mid-tile)", 2, 200, 8, 4, 128, f32, 64, None),
        ("S=256, window 32, softcap 30", 2, 256, 8, 4, 128, f32, 32, 30.0),
        ("dh=160, Hkv=8, S=1000", 2, 1000, 32, 8, 160, bf16, None, None),
        ("dh=64, MHA, S=1000", 2, 1000, 32, 32, 64, bf16, None, None),
        (MLA_PREFILL, BATCH, PROMPT, 128, 128, 192, bf16, None, None)]


def flex_call(qt, kt, vt, window, cap):
    """One compiled ``flex_attention`` call computing the softcapped
    function on (B, H, S, dh) inputs: ``cap·tanh(s/cap)`` as its score_mod,
    the causal (and window) block mask, GQA not expanded."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        keep = q_idx >= kv_idx
        return keep if window is None else keep & (q_idx - kv_idx < window)

    s = qt.shape[2]
    block_mask = create_block_mask(mask_mod, None, None, s, s, device=qt.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(qt, kt, vt, score_mod=score_mod, block_mask=block_mask,
                        enable_gqa=True)


def check_flash(timer, gen, b, s, h, hkv, dh, dtype, window, cap):
    """flash_attention against flash_attention_ref on random inputs, every
    element within ``flash_attn_tol`` (the bound of two evaluations, for
    bf16 with the kernel on the tensor cores, plus one bf16 ulp for bf16
    outputs; ``tol_ratio`` is the largest error over that bound,
    ``f32_tol_ratio`` over the f32 bound of PR 15), two launches bit for
    bit equal; timed beside the plain version
    and one PyTorch call computing the same function:
    ``scaled_dot_product_attention`` without a softcap (GQA, causal or a
    boolean window mask), compiled ``flex_attention`` with one; returns the
    record."""
    dev = gen.device
    q = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    got = flash_attention(q, k, v, window=window, softcap=cap)
    again = flash_attention(q, k, v, window=window, softcap=cap)
    want = flash_attention_ref(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("flash_attn: two launches gave different bits")
    bf16 = dtype == torch.bfloat16
    tol = flash_attn_tol(q, k, v, window, cap)
    err = assert_flash_attn_close(got, want, tol)
    tol_ratio = flash_attn_tol_ratio(got, want, tol)
    del tol
    f32_tol_ratio = flash_attn_tol_ratio(
        got, want, flash_attn_tol(q, k, v, window, cap, tensor_cores=False))
    rec = dict(max_abs_err=err, tol_ratio=tol_ratio, f32_tol_ratio=f32_tol_ratio,
               ms=timer.ms(lambda: flash_attention(q, k, v, window=window, softcap=cap)),
               plain_ms=timer.ms(lambda: flash_attention_ref(q, k, v, window=window,
                                                             softcap=cap)))
    del got, again
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if cap is None:
        mask = None
        if window is not None:
            i = torch.arange(s, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=mask is None, enable_gqa=True)
        rec["library"] = "scaled_dot_product_attention"
    else:
        lib = flex_call(qt, kt, vt, window, cap)
        rec["library"] = "flex_attention (torch.compile)"
    lerr = float((lib().transpose(1, 2).float() - want.float()).abs().max())
    # A yardstick, checked loosely: its bf16 path rounds p to bf16 before
    # p·v, so it sits a few bf16 ulps from the f32 function.
    if not lerr < 0.05:
        raise AssertionError(f"{rec['library']} disagrees by {lerr}")
    rec["library_ms"], rec["library_max_abs_err"] = timer.ms(lib), lerr
    del want
    rec["bytes"], rec["ops"] = flash_attn_work(b, s, h, hkv, dh, window, q.element_size())
    # bf16 inputs: their products at the tensor cores' bf16 peak (the
    # kernel's path); f32 inputs: at the CUDA cores' f32 peak.
    rec["bound_ms"], rec["bound_by"] = bound(
        rec["bytes"], rec["ops"], BF16_TC_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
    rec["f32_core_bound_ms"] = bound(rec["bytes"], rec["ops"])[0]
    rec["bf16_tensor_core_ms"] = rec["ops"] / BF16_TC_FLOP_PER_S * 1e3
    if bf16:    # the kernel's own products: q.k once, p.v in three bf16 terms
        rec["kernel_tensor_core_ms"] = 2 * rec["bf16_tensor_core_ms"]
    return rec


def flash_phase(dev, timer):
    """The flash_attn kernel against its plain version at every case of
    ``flash_cases``; returns {label: record}."""
    gen = torch.Generator(dev).manual_seed(8)
    recs = {}
    for label, b, s, h, hkv, dh, dtype, window, cap in flash_cases():
        rec = check_flash(timer, gen, b, s, h, hkv, dh, dtype, window, cap)
        recs[label] = rec
        print("kernel_case " + json.dumps(dict(
            kernel="flash_attn", entry=label, B=b, S=s, H=h, Hkv=hkv, dh=dh,
            dtype=str(dtype), window=window, softcap=cap, **rec)), flush=True)
        free_card()
    print("flash_attn: every case within its tolerance of the plain version and bit-stable "
          "over two launches", flush=True)
    return recs


def flash_bwd_cases():
    """(label, B, S, H, Hkv, dh, dtype, window, softcap, flex) of the
    flash_attn_bwd phase: musicgen-large's training shapes (the train
    CLI's and the step at length), gemma2-27b's
    layer (GQA 32/16, dh 128, softcap 50) at the 4160-token length with its
    4096 window (and the softcap-free twin) and with a 64-token window
    that bites, stablelm-12b's dh 160, deepseek-v3's MLA dh 192, and the
    f32 path.  ``flex``: the yardstick is compiled flex_attention's
    backward (else SDPA's on the softcap-free function)."""
    bf16, f32 = torch.bfloat16, torch.float32
    g = (32, 16, 128)
    return [
        (MUSICGEN_TRAIN, TRAIN_BATCH, TRAIN_SEQ, 32, 32, 64, bf16, None, None, False),
        ("musicgen-large training at length (B 4, S 2048, MHA 32, dh 64)", *TRAIN_LONG, 32,
         32, 64, bf16, None, None, False),
        ("gemma2 layer, S=4160, window 4096, softcap 50", 1, GEMMA_LONG, *g, bf16, 4096,
         50.0, True),
        ("gemma2 layer, S=4160, window 4096, softcap-free", 1, GEMMA_LONG, *g, bf16, 4096,
         None, False),
        ("gemma2 layer, S=1024, window 64, softcap 50 (yardstick softcap-free)", 2, 1024, *g,
         bf16, 64, 50.0, False),
        ("stablelm dh=160, Hkv=8, S=1000", 2, 1000, 32, 8, 160, bf16, None, None, False),
        ("MLA dh=192, H=Hkv=128, S=32", BATCH, PROMPT, 128, 128, 192, bf16, None, None, False),
        ("f32, S=200, window 64, softcap 30", 2, 200, 8, 4, 128, f32, 64, 30.0, False)]


def check_flash_bwd(timer, gen, b, s, h, hkv, dh, dtype, window, cap, flex):
    """The forward with lse against without (the same output bits) and its
    lse within ``flash_attn_lse_tol`` of the plain one; then
    flash_attention_bwd against flash_attention_bwd_ref on the same q, k,
    v, out, dout and lse, dq, dk and dv within ``flash_attn_bwd_tol`` (plus
    one bf16 ulp for bf16), two launches bit for bit equal; timed beside
    the plain version and the backward of one PyTorch call computing the
    forward (SDPA without the softcap, compiled flex_attention with it);
    returns the record."""
    dev = gen.device
    q = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    dout = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dtype)
    plain_out = flash_attention(q, k, v, window=window, softcap=cap)
    out, lse = flash_attention_lse(q, k, v, window=window, softcap=cap)
    if not torch.equal(out, plain_out):
        raise AssertionError("flash_attn: writing lse changed the output's bits")
    del plain_out
    lse_ref = flash_attention_lse_ref(q, k, v, window=window, softcap=cap)[1]
    lse_tol = flash_attn_lse_tol(q, k, window, cap)
    lse_ratio = float(((lse.double() - lse_ref.double()).abs() / lse_tol).max())
    if not lse_ratio <= 1.0:
        raise AssertionError(f"flash_attn lse beyond its bound: ratio {lse_ratio}")
    del lse_ref, lse_tol
    got = flash_attention_bwd(q, k, v, out, dout, lse, window=window, softcap=cap)
    again = flash_attention_bwd(q, k, v, out, dout, lse, window=window, softcap=cap)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError("flash_attn_bwd: two launches gave different bits")
    del again
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, window=window, softcap=cap)
    tols = flash_attn_bwd_tol(q, k, v, out, dout, lse, window, cap)
    rec = dict(lse_tol_ratio=lse_ratio)
    errs = []
    for name, x, y, t in zip(("dq", "dk", "dv"), got, want, tols):
        errs.append(assert_flash_attn_close(x, y, t, name=f"flash_attn_bwd {name}"))
        rec[f"tol_ratio_{name}"] = flash_attn_tol_ratio(x, y, t)
    del tols
    rec["max_abs_err"] = max(errs)
    rec["tol_ratio"] = max(rec[f"tol_ratio_{n}"] for n in ("dq", "dk", "dv"))
    rec["ms"] = timer.ms(lambda: flash_attention_bwd(q, k, v, out, dout, lse, window=window,
                                                     softcap=cap))
    rec["plain_ms"] = timer.ms(lambda: flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                                               window=window, softcap=cap))
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    if flex:
        lo = flex_call(qt, kt, vt, window, cap)()
        rec["library"] = "flex_attention (torch.compile) backward"
    else:
        mask = None
        if window is not None:
            i = torch.arange(s, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        lo = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                            is_causal=mask is None, enable_gqa=True)
        rec["library"] = ("scaled_dot_product_attention backward"
                          + (" (softcap-free twin)" if cap else ""))

    def lib():
        return torch.autograd.grad(lo, (qt, kt, vt), dot, retain_graph=True)

    if not cap or flex:
        # A yardstick, checked loosely (its bf16 path rounds p to bf16):
        # each gradient within 5 % in norm of the plain backward's.
        for name, x, y in zip(("dq", "dk", "dv"), lib(), want):
            x = x.transpose(1, 2).float()
            rel = float((x - y.float()).norm() / y.float().norm().clamp_min(1e-30))
            if not rel < 0.05:
                raise AssertionError(f"{rec['library']} {name} disagrees by {rel} in norm")
    rec["library_ms"] = timer.ms(lib)
    del lo, got, want
    pairs = b * h * live_pairs(s, window)
    rec["bytes"], rec["ops"], rec["recompute_ops"] = flash_attn_bwd_work(
        b, s, h, hkv, dh, window, q.element_size())
    peak = BF16_TC_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["ops"], peak)
    rec["bound_with_recompute_ms"] = bound(rec["bytes"], rec["ops"] + rec["recompute_ops"],
                                           peak)[0]
    if dtype == torch.bfloat16:
        # The tensor-core kernels' own products: dK/dV 9 (s twice, dp, three
        # split terms each for dv and dk), dQ 5 (s, dp, three for dq).
        rec["kernel_tensor_core_ms"] = 28 * dh * pairs / BF16_TC_FLOP_PER_S * 1e3
    else:
        # The CUDA-core kernels': s and dp in both kernels, dv, dk, dq.
        rec["kernel_f32_core_ms"] = 14 * dh * pairs / F32_FLOP_PER_S * 1e3
    return rec


def flash_bwd_phase(dev, timer):
    """flash_attn_bwd against its plain version at every case of
    ``flash_bwd_cases``; returns {label: record}."""
    gen = torch.Generator(dev).manual_seed(9)
    recs = {}
    for label, b, s, h, hkv, dh, dtype, window, cap, flex in flash_bwd_cases():
        t0 = time.perf_counter()
        rec = check_flash_bwd(timer, gen, b, s, h, hkv, dh, dtype, window, cap, flex)
        rec["seconds"] = round(time.perf_counter() - t0, 1)
        recs[label] = rec
        print("kernel_case " + json.dumps(dict(
            kernel="flash_attn_bwd", entry=label, B=b, S=s, H=h, Hkv=hkv, dh=dh,
            dtype=str(dtype), window=window, softcap=cap, **rec)), flush=True)
        free_card()
    print("flash_attn_bwd: every case within its bound of the plain backward, bit-stable "
          "over two launches; the forward's output bits unchanged by lse", flush=True)
    return recs


def start_dryrun():
    """The dry run's four cells, each ``python -m repro_torch.launch.dryrun``
    in a process of its own (its fake group apart from this process's
    NCCL group, and the CPU work beside the card's), all at once."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        out = DRYRUN_RESULTS / f"{arch}__{shape}__{mesh}.json"
        out.unlink(missing_ok=True)
        procs[arch, shape, mesh] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", mesh, "--device", "cuda"], cwd=Path(__file__).resolve().parent,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return time.perf_counter(), procs


def dryrun_phase(started):
    """Waits for the dry run's cells (``start_dryrun``): each exits 0 with
    per-rank FLOPs, ``n_devices`` 256 or 512, and flash_attn traced on the
    train cells; a decode cell on 2×16×16 moves no more collective bytes a
    rank than on 16×16; prints each cell's per-rank FLOPs, collective bytes
    and argument + temp bytes beside the card's memory."""
    t0, procs = started
    card = torch.cuda.get_device_properties(0).total_memory
    failed = []
    coll = {}
    for (arch, shape, mesh), proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append(f"{arch} {shape} {mesh}: rc {proc.returncode}\n{log[-3000:]}")
            continue
        rec = json.loads((DRYRUN_RESULTS / f"{arch}__{shape}__{mesh}.json").read_text())
        want_ranks = 512 if mesh == "multi" else 256
        calls = rec["kernels"].get("flash_attn", 0)
        if (not rec["flops"] > 0 or rec["n_devices"] != want_ranks
                or (shape.startswith("train") and not calls > 0)):
            failed.append(f"{arch} {shape} {mesh}: {json.dumps(rec)[:2000]}")
            continue
        coll[arch, shape, mesh] = rec["collective_bytes"]["total"]
        mem = rec["memory_analysis"]
        held = mem["argument_size_bytes"] + mem["temp_size_bytes"]
        print(f"dry run {arch} × {shape} × {mesh} ({rec['n_devices']} ranks, {rec['device']}, "
              f"traced in {rec['trace_s']} s): per rank {rec['flops']:.4e} flops, "
              f"{rec['bytes_accessed']:.4e} B accessed, collectives "
              f"{json.dumps(rec['collective_bytes'])}, arguments "
              f"{mem['argument_size_bytes'] / 2 ** 30:.2f} GiB + temp "
              f"{mem['temp_size_bytes'] / 2 ** 30:.2f} GiB = {held / 2 ** 30:.2f} GiB of the "
              f"card's {card / 2 ** 30:.2f} GiB ({'fits' if held <= card else 'does not fit'}); "
              f"kernels {rec['kernels']}", flush=True)
    for (arch, shape, mesh), multi in coll.items():
        single = coll.get((arch, shape, "single"))
        if mesh == "multi" and shape.startswith("decode") and single is not None:
            if multi > single:
                failed.append(f"{arch} {shape}: {multi:.4e} collective bytes a rank on "
                              f"2×16×16, more than 16×16's {single:.4e}")
            else:
                print(f"dry run {arch} × {shape}: collective bytes a rank {multi:.4e} on "
                      f"2×16×16, at most 16×16's {single:.4e}", flush=True)
    if failed:
        raise AssertionError("dry run cells failed:\n" + "\n".join(failed))
    print(f"dry run: {len(procs)} cells in {time.perf_counter() - t0:.1f} s wall (in parallel "
          f"with the phases before)", flush=True)


def fake_like(tree):
    """A fake tensor (``FakeTensorMode`` active) of each leaf's shape,
    strides, dtype and device."""
    return tree_map(lambda t: torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype, device=t.device), tree)


def calibrate(label, fn, args, fake_args, want):
    """The dry run's analyzer on a real step ``fn(*args)`` and on its fake
    trace ``fn(*fake_args())`` (built inside a ``FakeTensorMode``) at one
    rank: equal FLOPs, the fake trace's kernel calls equal to the real
    run's launches (and to ``want``), and the predicted peak (arguments +
    temp) against the allocator's (the step's arguments plus what
    ``max_memory_allocated`` rose above the memory held before it) within
    PEAK_RATIO_BOUND.  Returns the real step's result."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    free_card()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    real = analyze(fn, *args)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    launched = {k: n for k, n in counts().items() if n}
    rose = torch.cuda.max_memory_allocated() - before
    t0 = time.perf_counter()
    with FakeTensorMode():
        fake = analyze(fn, *fake_args())
    fake_s = time.perf_counter() - t0
    rmem, fmem = real["memory"], fake["memory"]
    measured = rmem["argument_size_bytes"] + rose
    predicted = fmem["argument_size_bytes"] + fmem["temp_size_bytes"]
    ratio = measured / predicted
    print(f"calibration, {label}: flops real {real['flops']:.6e}, fake {fake['flops']:.6e}; "
          f"kernel calls fake {fake['kernels']}, real {real['kernels']}, launches {launched}; "
          f"peak predicted {predicted / 2 ** 30:.3f} GiB (arguments "
          f"{fmem['argument_size_bytes'] / 2 ** 30:.3f} + temp "
          f"{fmem['temp_size_bytes'] / 2 ** 30:.3f}; the real run's own count: temp "
          f"{rmem['temp_size_bytes'] / 2 ** 30:.3f}), measured {measured / 2 ** 30:.3f} GiB "
          f"(max_memory_allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, "
          f"{before / 2 ** 30:.3f} held before); ratio {ratio:.4f}; real step {real_s:.2f} s "
          f"under the analyzer, fake trace {fake_s:.2f} s", flush=True)
    if real["flops"] != fake["flops"]:
        raise AssertionError(f"{label}: the real step's flops {real['flops']} != the fake "
                             f"trace's {fake['flops']}")
    if not fake["kernels"] == real["kernels"] == launched == want:
        raise AssertionError(f"{label}: kernel calls fake {fake['kernels']}, real "
                             f"{real['kernels']}, launches {launched}, want {want}")
    if not PEAK_RATIO_BOUND[0] <= ratio <= PEAK_RATIO_BOUND[1]:
        raise AssertionError(f"{label}: measured over predicted peak {ratio:.4f} outside "
                             f"{PEAK_RATIO_BOUND}")
    return real["result"]


def train_batch(cfg, b, s, step, dev):
    """The train CLI's batch of ``step`` (``data.pipeline``) on ``dev``."""
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                      n_encoder_tokens=cfg.n_encoder_tokens, d_model=cfg.d_model)
    return {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(data, step).items()}


def kernel_share(fn):
    """``fn`` once under torch.profiler (device activity only): (its
    result, kernel ms, kernel launches, ms of each attention kernel that
    ran (flash_attn's forward, flash_attn_bwd's D, dK/dV and dQ), the top
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    by_name = {}
    n = 0
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n += 1
    attn = {}
    for key in FLASH_FWD_KERNELS + FLASH_BWD_KERNELS:
        t = sum(t for name, t in by_name.items() if key in name)
        if t:
            attn[key] = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (out, sum(by_name.values()), n, attn,
            [(name[:50], round(t, 2)) for name, t in top])


def attention_split(attn, label):
    """(attention ms, the backward's ms) of ``kernel_share``'s per-kernel
    attention times; raises if no backward attention kernel ran."""
    bwd = sum(t for key, t in attn.items() if key in FLASH_BWD_KERNELS)
    if not bwd > 0:
        raise AssertionError(f"the profiled {label} shows no backward attention kernel")
    return sum(attn.values()), bwd


def train_phase(dev, timer):
    """musicgen-large at full width and depth through ``launch.train.train``
    (TRAIN_STEPS steps at B, S = TRAIN_BATCH, TRAIN_SEQ): per step, flash_attn
    launched twice a layer (forward and remat recompute) and flash_attn_bwd
    once; finite losses, the last below the first; the peak memory.  Then
    on the trained state: ms a step split into forward+backward and the
    optimizer (CUDA events), a profiled step (busy share, attention's
    share, top kernels), and one step at TRAIN_LONG (ungated: attention's
    share at length).  Returns the launch counts of the run."""
    from repro_torch.launch import train as train_cli
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    n_attn = attn_layers(cfg)
    per_step = {"flash_attn": 2 * n_attn, "flash_attn_bwd": n_attn}
    total = {name: 0 for name in KERNELS}
    steps = []

    def on_step(step, metrics):
        launched = counts()
        expect_launches(f"train step {step}", launched, per_step)
        for name, n in launched.items():
            total[name] += n
        steps.append(metrics)
        reset_counts()

    torch.cuda.reset_peak_memory_stats()
    lines = []
    reset_counts()
    out = train_cli.train(TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                          device=dev, log_every=1, on_step=on_step, log=lines.append)
    t_run = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = out["losses"]
    for line in lines:
        print(f"  train: {line}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{TRAIN_ARCH} training: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{TRAIN_ARCH} training: the loss did not fall: {losses}")
    params, opt_state = out["params"], out["opt_state"]
    n_params = sum(t.numel() for t in leaves(params))
    state_gib = (sum(t.numel() * t.element_size() for t in leaves(params)) * 2 + sum(
        t.numel() * t.element_size() for t in leaves(list(opt_state)))) / 2 ** 30
    print(f"{TRAIN_ARCH} training at full width and depth ({cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B params, state {state_gib:.1f} GiB with the grads): "
          f"{TRAIN_STEPS} steps of B={TRAIN_BATCH}, S={TRAIN_SEQ} in {out['seconds']:.1f} s; "
          f"losses {[round(x, 4) for x in losses]}; launches a step {per_step}; "
          f"peak {peak:.1f} GiB allocated; {t_run:.1f} s with the init", flush=True)

    opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=max(TRAIN_STEPS // 10, 1),
                              total_steps=TRAIN_STEPS)
    split = []
    for i in range(3):
        batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS + i, dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        _, _, grads = steps_mod.loss_and_grads(params, batch, cfg, opt_cfg)
        ev[1].record()
        params, opt_state, _ = adamw_update(grads, opt_state, opt_cfg, params=params)
        ev[2].record()
        torch.cuda.synchronize()
        del grads
        split.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                      (time.perf_counter() - t0) * 1e3))
    fb, opt, wall = (float(np.median([x[j] for x in split])) for j in range(3))
    # The optimizer's least traffic: each grad, moment and master read once,
    # each moment, master and param written once.
    opt_bytes = 2 * sum(t.numel() * t.element_size() for t in leaves(
        [params, opt_state.mu, opt_state.nu, opt_state.master]))
    opt_bound = opt_bytes / HBM_BYTES_PER_S * 1e3
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS + 3, dev)
    (params, opt_state, _), kt, n_k, by_kernel, top = kernel_share(
        lambda: steps_mod.train_step(params, opt_state, batch, cfg, opt_cfg))
    attn, bwd = attention_split(by_kernel, "train step")
    split = {k: round(v, 2) for k, v in by_kernel.items()}
    print(f"{TRAIN_ARCH} train step (B={TRAIN_BATCH}, S={TRAIN_SEQ}): forward+backward "
          f"{fb:.2f} ms, optimizer {opt:.2f} ms (bound {opt_bound:.2f} ms: "
          f"{opt_bytes / 1e9:.1f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; CUDA events, median "
          f"of 3), wall {wall:.2f} "
          f"ms; profiled: {kt:.2f} ms of kernels in {n_k} launches (busy {kt / wall:.3f} "
          f"of the unprofiled wall), attention kernels {attn:.2f} ms ({attn / kt:.3f}; "
          f"backward {bwd:.2f} ms; {split}); "
          f"top kernels {top}; {time.perf_counter() - t_phase:.1f} s so far", flush=True)
    del batch
    free_card()

    b, s = TRAIN_LONG
    batch = train_batch(cfg, b, s, 0, dev)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_counts()
    params, opt_state, m = steps_mod.train_step(params, opt_state, batch, cfg, opt_cfg)
    torch.cuda.synchronize()
    lwall = (time.perf_counter() - t0) * 1e3
    expect_launches(f"train step at B={b}, S={s}", counts(), per_step)
    (params, opt_state, m), kt, n_k, by_kernel, top = kernel_share(
        lambda: steps_mod.train_step(params, opt_state, batch, cfg, opt_cfg))
    attn, bwd = attention_split(by_kernel, "train step at length")
    split = {k: round(v, 2) for k, v in by_kernel.items()}
    lpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    params, opt_state, _ = calibrate(
        f"{TRAIN_ARCH} train step at B={b}, S={s}",
        lambda p, o, bt: steps_mod.train_step(p, o, bt, cfg, opt_cfg),
        (params, opt_state, batch),
        lambda: (steps_mod.abstract_params(cfg), steps_mod.abstract_opt_state(cfg),
                 fake_like(batch)), per_step)
    print(f"{TRAIN_ARCH} train step at B={b}, S={s}: {lwall:.1f} ms wall, loss "
          f"{float(m['loss']):.4f}; profiled {kt:.1f} ms of kernels in {n_k} launches (busy "
          f"{kt / lwall:.3f}), attention kernels {attn:.1f} ms ({attn / kt:.3f}; backward "
          f"{bwd:.1f} ms, {bwd / attn_layers(cfg):.2f} a layer; {split}); top kernels "
          f"{top}; peak {lpeak:.1f} GiB; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total, dict(losses=losses, peak_gib=peak, fwd_bwd_ms=fb, optimizer_ms=opt,
                       optimizer_bound_ms=opt_bound, step_wall_ms=wall,
                       long_step_wall_ms=lwall, long_attention_share=attn / kt)


def resume_kwargs(dev):
    """``launch.train.train``'s arguments for the resume checks."""
    return dict(steps=RESUME_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev,
                n_layers=RESUME_LAYERS, ckpt_every=RESUME_AT, log=lambda line: None)


def check_resumed(label, cont, resumed):
    """A run restored from the RESUME_AT checkpoint against the
    continuous one: it starts after RESUME_AT, and its losses and every
    leaf of its params and optimizer state (a DTensor's full tensor) equal
    the continuous run's bit for bit.  Returns the number of leaves."""
    from repro_torch.sharding.ctx import replicated
    if resumed["start"] != RESUME_AT + 1:
        raise AssertionError(f"{label}: resume started at {resumed['start']}")
    a = list(leaves([cont["params"], list(cont["opt_state"])]))
    r = list(leaves([resumed["params"], list(resumed["opt_state"])]))
    bad = [i for i, (x, y) in enumerate(zip(a, r))
           if not torch.equal(replicated(x), replicated(y))]
    if bad or cont["losses"][RESUME_AT + 1:] != resumed["losses"]:
        raise AssertionError(f"{label}: the resumed run differs from the continuous one: "
                             f"leaves {bad}, losses {cont['losses']} vs {resumed['losses']}")
    return len(a)


def resume_phase(dev):
    """musicgen-large at RESUME_LAYERS layers through the train entry
    point: RESUME_STEPS steps saving a checkpoint at RESUME_AT, then a new
    run from that checkpoint to RESUME_STEPS; its final params and
    optimizer state equal the continuous run's bit for bit.  A restore
    of that checkpoint into a fresh state allocates on the card no more
    than the largest leaf beyond the state it fills (it copies in place,
    so musicgen's 42 GiB state at full depth restores on one card)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adamw import init_adamw
    t0 = time.perf_counter()
    kw = resume_kwargs(dev)
    with tempfile.TemporaryDirectory() as tmp:
        cont = train_cli.train(TRAIN_ARCH, ckpt_dir=tmp, **kw)
        resumed = train_cli.train(TRAIN_ARCH, ckpt_dir=tmp, **kw)
        params = model.init_model(get_config(TRAIN_ARCH).scaled(n_layers=RESUME_LAYERS),
                                  torch.Generator(dev).manual_seed(1))
        template = (params, init_adamw(params))
        largest = max(t.numel() * t.element_size() for t in leaves([params, list(template[1])]))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        restored, _ = CheckpointManager(tmp).restore(template)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        del params, template, restored
    if extra > largest:
        raise AssertionError(f"a restore allocated {extra} B beyond its template, more than "
                             f"the largest leaf's {largest} B")
    n_leaves = check_resumed(TRAIN_ARCH, cont, resumed)
    print(f"{TRAIN_ARCH} at {RESUME_LAYERS} layers: resumed at step {RESUME_AT} equals the "
          f"continuous run bit for bit ({n_leaves} leaves, losses "
          f"{[round(x, 6) for x in resumed['losses']]}); the restore allocated {extra} B "
          f"beyond its template (largest leaf {largest} B); {time.perf_counter() - t0:.1f} s",
          flush=True)


def shallow(lm, n_layers):
    """``lm``'s first ``n_layers`` layers (whole periods: views of its
    period stacks) at full width, serving its head: the engine phases'
    model, whose eager, host-bound ticks take time in proportion to the
    depth."""
    def first(tree, k):
        return ({n: first(v, k) for n, v in tree.items()} if isinstance(tree, dict)
                else tree[:k])

    params = dict(lm.params, periods=first(lm.params["periods"],
                                           n_layers // len(lm.cfg.pattern)))
    return LM.from_config(lm.cfg.name, device=lm.device, params=params, head=lm.head,
                          n_layers=n_layers)


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def prefill_vs_decode(lm, prompts):
    """The teacher-forced check of the prefill path: the last prompt
    position's final hidden from the bulk prefill (flash_attn, one launch
    per layer) against the same prompt fed one token at a time through
    decode steps (plain attention over the cache, no flash), under the
    bf16 backbone rule."""
    cfg, dev = lm.cfg, prompts.device
    b, p = prompts.shape
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts()
        hidden, _ = model.forward(lm.params, prompts, cfg,
                                  cache=model.init_decode_cache(cfg, b, p, device=dev),
                                  cache_pos=0, return_hidden=True)
        torch.cuda.synchronize()
        expect_launches("flash prefill", counts(), {"flash_attn": cfg.n_layers})
        cache = model.init_decode_cache(cfg, b, p, device=dev)
        reset_counts()
        for t in range(p):
            step, cache = model.decode_step(lm.params, cache, prompts[:, t:t + 1], cfg,
                                            cache_pos=t, return_hidden=True)
        torch.cuda.synchronize()
        expect_launches("token-by-token prompt", counts(), {})
    got, want = step.cpu().numpy(), hidden[:, -1].cpu().numpy()
    norm_err, max_err = bf16_backbone_errors(got, want)
    assert_bf16_backbone_close(got, want)
    print(f"{cfg.name} teacher-forced prefill check: the flash prefill's last hidden vs {p} "
          f"decode steps without flash: {norm_err:.3g} in norm, {max_err:.3g} of the largest "
          f"(limits {BF16_NORM_TOL}, {BF16_MAX_TOL})", flush=True)


def gemma_main_path(dev, timer):
    """Full-width, full-depth gemma2-27b: LM.generate through the dense and
    the fused head (flash_attn once per layer in the prefill, none in
    decode), the decode step's profile, the prefill check, and the sketch
    kernels against their plain versions on a teacher-forced decode
    step's hidden."""
    lm, _, frozen, gen = build_served(GEMMA, dev)
    cfg = lm.cfg
    heads = {"dense": lm.head, "fused": SketchHead(cfg=SERVE_HEAD, backend="fused",
                                                   params=frozen)}
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    want = {"dense": {"flash_attn": cfg.n_layers},
            "fused": {"flash_attn": cfg.n_layers, "fused_decode": GEN - 1}}
    runs = generate_runs(lm, heads, prompts, want)
    steps = step_profile(lm, heads, prompts, runs["fused"][-1]["tokens"])
    loop_args = (lm, heads, prompts, want, {n: r[-1]["tokens"] for n, r in runs.items()},
                 steps)
    prefill_vs_decode(lm, prompts)

    # Teacher-forced: the flash prefill, then one decode step's hidden, the
    # input fused_decode takes on this path (B=4, d_model 4608, V=256000).
    with torch.inference_mode():
        cache = model.init_decode_cache(cfg, BATCH, PROMPT + GEN, device=dev)
        _, cache = prefill_step(lm.params, prompts, cfg, cache)
        tok = runs["fused"][-1]["tokens"][:, PROMPT:PROMPT + 1]
        hidden, _ = model.decode_step(lm.params, cache, tok, cfg, cache_pos=PROMPT,
                                      return_hidden=True)
    del cache
    if hidden.shape != (BATCH, cfg.d_model) or not bool(hidden.isfinite().all()):
        raise AssertionError(f"{cfg.name} decode hidden not finite or mis-shaped")
    for name, rec in check_and_time(timer, SERVE_HEAD, frozen, hidden, None).items():
        print("kernel_case " + json.dumps(dict(
            kernel=name, arch=cfg.name, entry="teacher-forced decode hidden",
            L=SERVE_HEAD.n_rows, R=SERVE_HEAD.n_buckets, K=SERVE_HEAD.k,
            d_proj=SERVE_HEAD.proj_dim, r=SERVE_HEAD.bandwidth, B=BATCH, d=cfg.d_model,
            V=cfg.vocab_size, quant="f32", **rec)), flush=True)
    return lm, frozen, runs, loop_args


def gemma_engine_phase(lm, frozen):
    """gemma2-27b through the engine, dense and fused: four requests
    arriving together over four slots equal LM.generate of the same batch;
    six staggered requests over two slots, every step held by
    ``check_staggered``; flash_attn launched once per layer per prefill
    batch."""
    cfg, dev = lm.cfg, lm.device
    together = torch.randint(0, cfg.vocab_size, (SLOTS, PROMPT),
                             generator=torch.Generator(dev).manual_seed(5), device=dev)
    stream = engine_stream(cfg.vocab_size, GEMMA_STAGGERED, PROMPT, GEN, 1, 0)
    for name, head in (("dense", DenseHead()),
                       ("fused", SketchHead(cfg=SERVE_HEAD, backend="fused", params=frozen))):
        served = lm.with_head(head)
        want = served.generate(together, GEN)[:, PROMPT:].tolist()
        torch.cuda.synchronize()
        reset_counts()
        got = served.serve([(p, GEN) for p in together.cpu().numpy()], n_slots=SLOTS)
        expect_launches(f"{cfg.name} engine {name} (together)", counts(),
                        {"flash_attn": cfg.n_layers,
                         "fused_decode": GEN - 1 if name == "fused" else 0})
        if [got[i] for i in range(SLOTS)] != want:
            raise AssertionError(f"{cfg.name} engine {name}: requests arriving together "
                                 f"differ from LM.generate of the same batch")
        print(f"{cfg.name} engine {name}: {SLOTS} requests arriving together equal "
              f"LM.generate of the same batch token for token")
        eng, fin, dt, launched = run_engine(served, stream, TENANT_SLOTS)
        engine_report(f"{cfg.name} {served.head.describe()}", eng, fin, dt, launched)
        want_launches = {"flash_attn": cfg.n_layers * eng.stats["prefill_batches"]}
        if name == "fused":
            want_launches["fused_decode"] = eng.stats["decode_steps"]
        expect_launches(f"{cfg.name} engine {name}", launched, want_launches)
        rec_fin, ticks, admitted = record_engine(served, stream, TENANT_SLOTS)
        if rec_fin != fin:
            raise AssertionError(f"{cfg.name} engine {name}: a second run of the stream gave "
                                 f"other tokens")
        check_staggered(f"{cfg.name} {name}", served, stream, fin, ticks, admitted, frozen)


def functional_copies(cfg, cache):
    """The two cache copies of the functional decode step, alone: each
    layer's rows cloned (``attention``'s scalar branch), then each
    period's layers restacked (``forward``)."""
    for c in cache["periods"].values():
        layers = [KVCache(*(x[i].clone() for x in c)) for i in range(cfg.n_periods)]
        KVCache(*(torch.stack(leaf) for leaf in zip(*layers)))


def step_at_context(lm, cache, tok, pos, step):
    """(median wall ms of 5 synchronized decode steps after one, peak GiB
    the step allocated above what was allocated before it)."""
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(lm.params, cache, tok, lm.cfg, pos=pos)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(lm.params, cache, tok, lm.cfg, pos=pos)
    torch.cuda.synchronize()
    return float(np.median(walls[1:])), (torch.cuda.max_memory_allocated() - before) / 2 ** 30


def gemma_long_prefill(lm, timer):
    """B=1, a 4160-token prompt (past the 4096 window): the bulk prefill
    (flash_attn once per layer; the last position alone unembedded; wall
    time, peak memory and the attention kernels' share under
    torch.profiler), the local layers' rings checked slot by slot against
    the first layer's keys; a decode step at that context, functional
    (its two cache copies timed alone) against in place; then
    LM.generate of 4 new tokens."""
    from torch.profiler import ProfilerActivity, profile

    cfg, dev = lm.cfg, lm.device
    prompt = torch.randint(0, cfg.vocab_size, (1, GEMMA_LONG),
                           generator=torch.Generator(dev).manual_seed(6), device=dev)
    max_seq = GEMMA_LONG + 4
    with torch.inference_mode():
        fresh = model.init_decode_cache(cfg, 1, max_seq, device=dev)
        prefill_step(lm.params, prompt, cfg, fresh)                 # warm-up
        del fresh
        free_card()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits, cache = prefill_step(lm.params, prompt, cfg,
                                     model.init_decode_cache(cfg, 1, max_seq, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_launches(f"{cfg.name} long prefill", counts(), {"flash_attn": cfg.n_layers})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if logits.shape != (1, cfg.vocab_size) or not bool(logits.isfinite().all()):
            raise AssertionError("long prefill logits not finite or mis-shaped")

        # The first local layer's ring against its keys, recomputed here.
        ring = cache["periods"]["pos0"].k[0, 0]                    # (size, Hkv, dh)
        size, a = ring.shape[0], cfg.attention
        p0 = model._index(lm.params["periods"]["pos0"], 0)
        x = embed_scaled(prompt, lm.params["embed"], cfg.d_model)
        h = rms_norm(x, p0["norm1"], cfg.norm_eps)
        keys = apply_rope((h @ p0["mixer"]["wk"]).reshape(1, GEMMA_LONG, a.n_kv_heads,
                                                          a.head_dim),
                          torch.arange(GEMMA_LONG, device=dev), a.rope_theta)[0]
        j = torch.arange(size, device=dev)
        held = GEMMA_LONG - 1 - ((GEMMA_LONG - 1 - j) % size)
        wrapped = int((held >= size).sum())            # slots written over once at least
        last = torch.arange(GEMMA_LONG - size, GEMMA_LONG, device=dev)
        if (size != a.window or wrapped != min(size, GEMMA_LONG - size)
                or not torch.equal(held.sort().values, last) or not torch.equal(ring, keys[held])):
            raise AssertionError(f"long prefill: the ring of {size} slots does not hold the "
                                 f"last {size} positions ({wrapped} wrapped)")
        del x, h, keys, ring
        free_card()

        # One decode step at this context: the functional step copies the
        # 1.55 GB of KV caches twice, the in-place step writes one slot.
        tok = logits.argmax(-1)[:, None]
        kv_gb = sum(x.numel() * x.element_size() for c in cache["periods"].values()
                    for x in c) / 1e9
        copy_ms = timer.ms(lambda: functional_copies(cfg, cache), reps=5, warmup=1)
        func_ms, func_gib = step_at_context(lm, cache, tok, GEMMA_LONG, serve_step)
        inplace_ms, inplace_gib = step_at_context(lm, cache, tok, GEMMA_LONG, serve_step_)
        print(f"{cfg.name} decode step at {GEMMA_LONG} tokens of context (B=1, {kv_gb:.2f} GB "
              f"of KV caches): functional {func_ms:.2f} ms wall, {func_gib:.2f} GiB above "
              f"the cache, of which the two cache copies alone take {copy_ms:.3f} ms "
              f"(CUDA events, median of 5); in place {inplace_ms:.2f} ms wall, "
              f"{inplace_gib:.2f} GiB above the cache, no copy", flush=True)
        del cache, logits, tok
        free_card()

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill_step(lm.params, prompt, cfg,
                         model.init_decode_cache(cfg, 1, max_seq, device=dev))
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        attn_ms = sum(e.time_range.elapsed_us() for e in kernels
                      if "flash_attn" in e.name) / 1e3
        free_card()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        tokens = lm.generate(prompt, 4)
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
    expect_launches(f"{cfg.name} long generate", counts(), {"flash_attn": cfg.n_layers})
    if tokens.shape != (1, GEMMA_LONG + 4) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"long generate: bad tokens {tuple(tokens.shape)}")
    with torch.inference_mode():
        calibrate(f"{cfg.name} prefill of {GEMMA_LONG} tokens",
                  lambda p, t, c: prefill_step(p, t, cfg, c),
                  (lm.params, prompt, model.init_decode_cache(cfg, 1, max_seq, device=dev)),
                  lambda: (steps_mod.abstract_params(cfg), fake_like(prompt),
                           steps_mod.abstract_cache(cfg, 1, max_seq)),
                  {"flash_attn": cfg.n_layers})
    share = ("not measured (the profiler saw no device events)" if not kernels else
             f"flash_attn {attn_ms:.3f} ms of {busy:.3f} ms of kernels "
             f"({attn_ms / busy:.3f} of the kernel time, {attn_ms / (wall * 1e3):.3f} of "
             f"the wall)")
    print(f"{cfg.name} long prefill: B=1, {GEMMA_LONG} tokens in {wall * 1e3:.1f} ms wall, "
          f"peak {peak:.1f} GiB allocated; {share}; ring of {size} slots holds the last "
          f"{size} positions ({wrapped} wrapped); generate of 4 new tokens "
          f"{gen_wall * 1e3:.1f} ms wall, launches flash_attn {cfg.n_layers}", flush=True)


def attn_layers(cfg):
    """The layers of ``cfg`` that run flash_attn in a prefill: the causal
    self-attention and MLA layers, the prologue's included (an ``xattn``
    layer attends to the encoder states in plain PyTorch)."""
    return sum(cfg.layer_kind(j) in blocks.SEQ_KINDS for j in range(cfg.n_layers))


def encoder_states(cfg, gen):
    """Stub encoder states (BATCH, n_encoder_tokens, d) bf16 from ``gen``
    for an arch with cross-attention layers (its vision frontend is a
    stub), else None."""
    if not cfg.n_encoder_tokens:
        return None
    return torch.randn((BATCH, cfg.n_encoder_tokens, cfg.d_model), generator=gen,
                       device=gen.device).to(torch.bfloat16)


def mesh_phase(dev, timer, lm, frozen, runs):
    """The multi-GPU path on the card's one-rank NCCL group (docstring
    item 19); returns the phase's timings."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.optim.compress import compressed_psum, init_error_feedback

    store = dist.TCPStore("127.0.0.1", 0, 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        return _mesh_checks(dev, timer, lm, frozen, runs, parse_mesh("1x1", "cuda"),
                            compressed_psum, init_error_feedback)
    finally:
        dist.destroy_process_group()


def _mesh_checks(dev, timer, lm, frozen, runs, mesh, compressed_psum,
                 init_error_feedback):
    out = {}
    head = SketchHead(cfg=SERVE_HEAD, backend="fused", params=frozen)
    want = runs["fused"][-1]["tokens"]
    prompts = want[:, :PROMPT]
    plain = lm.with_head(head)
    meshed = LM.from_config("rwkv6-1.6b", device=dev, params=lm.params, head=head,
                            mesh=mesh)
    if not all(type(t).__name__ == "DTensor" for t in leaves(meshed.params)):
        raise AssertionError("mesh LM params are not DTensors")
    if not any(p.is_shard() for t in leaves(meshed.params) for p in t.placements):
        raise AssertionError("no mesh LM param is sharded: the 1x1 mesh would run "
                             "replicated DTensors only")
    for chunk in (1, 16):
        meshed.generate(prompts, 2, decode_chunk=chunk)          # warm-up, capture
        plain.generate(prompts, 2, decode_chunk=chunk)
        times = {"plain": [], "mesh": []}
        for who in ("plain", "mesh", "mesh", "plain"):
            served = plain if who == "plain" else meshed
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            tokens = served.generate(prompts, GEN, decode_chunk=chunk)
            torch.cuda.synchronize()
            times[who].append(time.perf_counter() - t0)
            launched = counts()
            expect_launches(f"rwkv6 {who} decode_chunk {chunk}", launched,
                            {"fused_decode": GEN - 1})
            if not torch.equal(tokens, want):
                raise AssertionError(f"rwkv6 {who} generate at decode_chunk {chunk} "
                                     "differs from the main path's fused tokens")
        out[f"rwkv6 decode_chunk {chunk}"] = times
        print(f"mesh 1x1 rwkv6-1.6b fused generate (4x{GEN} new tokens) at decode_chunk "
              f"{chunk}: plain {times['plain']} s, 1x1 mesh {times['mesh']} s "
              f"(tokens equal the main path's; fused_decode {GEN - 1} a generate)",
              flush=True)
    del meshed, plain

    glm, _, gfrozen, ggen = build_served(GEMMA, dev, n_layers=2)
    gprompts = torch.randint(0, glm.cfg.vocab_size, (BATCH, PROMPT), generator=ggen,
                             device=dev)
    gmesh = glm.with_mesh(mesh)
    for who, served in (("plain", glm), ("mesh", gmesh)):
        served.generate(gprompts, 2)
    got = {}
    for who, served in (("plain", glm), ("mesh", gmesh), ("mesh", gmesh), ("plain", glm)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got[who] = served.generate(gprompts, GEN)
        torch.cuda.synchronize()
        out.setdefault(f"gemma2 {who}", []).append(time.perf_counter() - t0)
        expect_launches(f"gemma2 2-layer {who}", counts(), {"flash_attn": 2})
    if not torch.equal(got["mesh"], got["plain"]):
        raise AssertionError("gemma2 2-layer tokens on the 1x1 mesh differ from off it")
    print(f"mesh 1x1 gemma2-27b (2 layers) dense generate: plain {out['gemma2 plain']} s, "
          f"1x1 mesh {out['gemma2 mesh']} s (tokens equal; flash_attn 2 a generate "
          "through the DTensor wrapper)", flush=True)
    del glm, gmesh, gfrozen
    free_card()

    gen = torch.Generator(dev).manual_seed(26)
    hidden = torch.randn((BATCH, D_MODEL), generator=gen, device=dev)
    n_rows = SERVE_HEAD.n_rows
    for quant in (None, "int8", "int4"):
        head_q = frozen if quant is None else quantize_head(frozen, quant)
        store, scale = head_q["array"], head_q.get("scale")
        deq = store if quant is None else dequantize_sketch_ref(store, scale, quant)
        atol = gather_atol(n_rows, float(deq.abs().max()))
        kw = dict(bandwidth=SERVE_HEAD.bandwidth, n_buckets=SERVE_HEAD.n_buckets,
                  quant=quant)
        whole_idx = torch.empty((BATCH, n_rows), dtype=torch.int32, device=dev)
        whole = fused_decode_logits(hidden, frozen["proj"], frozen["w"], frozen["b"], store,
                                    scale=scale, idx_out=whole_idx, **kw)
        worst = 0.0
        for m in (2, 4):
            ls = n_rows // m
            total = torch.zeros_like(whole)
            for part in range(m):
                rows = slice(part * ls, (part + 1) * ls)
                srows = slice(part * ls // 2, (part + 1) * ls // 2) if quant == "int4" else rows
                st = store[srows].contiguous()
                sc = None if scale is None else scale[rows].contiguous()
                w, b = frozen["w"][rows].contiguous(), frozen["b"][rows].contiguous()
                idx = torch.empty((BATCH, ls), dtype=torch.int32, device=dev)
                part_out = fused_decode_logits(hidden, frozen["proj"], w, b, st, scale=sc,
                                               idx_out=idx, row_start=part * ls, **kw)
                torch.cuda.synchronize()
                if not torch.equal(idx, whole_idx[:, rows]):
                    raise AssertionError(f"fused_decode row_start {part * ls} ({quant}): "
                                         "indices differ from the whole launch's columns")
                ref_idx = torch.empty_like(idx)
                ref = fused_decode_ref(hidden, frozen["proj"], w, b, st, SERVE_HEAD.bandwidth,
                                       SERVE_HEAD.n_buckets, sc, quant, idx_out=ref_idx,
                                       row_start=part * ls)
                check_hash_indices(idx, ref_idx, hidden, w, b, SERVE_HEAD.bandwidth,
                                   proj=frozen["proj"])
                same = (idx == ref_idx).all(dim=1)
                torch.testing.assert_close(part_out[same], ref[same], rtol=0, atol=atol)
                total += part_out * (ls / n_rows)
            err = float((total - whole).abs().max())
            worst = max(worst, err)
            if err > atol:
                raise AssertionError(f"fused_decode {m} row shards ({quant}): the parts' sum "
                                     f"is {err:.3g} from the whole launch (bound {atol:.3g})")
        print(f"fused_decode global-row input ({quant or 'f32'}): halves and quarters with "
              f"row_start, indices equal the whole launch's columns; parts' sum within "
              f"{worst:.3g} of the whole (gather bound {atol:.3g}: f32 reassociation of "
              "L/m-term means)", flush=True)

    partial_product_check(timer, gen, dev, out)
    out["smoke archs"] = mesh_smoke_archs(mesh)

    g = {"w": torch.randn((2048, 512), generator=gen, device=dev),
         "b": torch.linspace(-1, 1, 512, device=dev)}
    mean, new_e = compressed_psum(g, init_error_feedback(g))
    for k in g:
        err = float((mean[k] + new_e[k] - g[k]).abs().max())
        if err > 1e-5 * float(g[k].abs().max()):
            raise AssertionError(f"compressed_psum over one rank: mean + error is {err:.3g} "
                                 f"from the gradient ({k})")
    print("compressed_psum of CUDA gradients over the one-rank NCCL group: mean + new "
          "error = the gradient", flush=True)
    out["resume"] = mesh_resume(dev)
    return out


def mesh_resume(dev):
    """musicgen-large at full width and RESUME_LAYERS layers through the
    train entry point on the one-rank mesh (the initialised group):
    RESUME_STEPS steps saving at RESUME_AT (every leaf gathered, rank 0
    writing), then a new mesh run restored from that checkpoint (each
    rank's own blocks); its losses, params and optimizer state equal the
    continuous mesh run's bit for bit, and each of its steps launches
    flash_attn twice a layer and flash_attn_bwd once.  Returns its seconds
    and the resumed run's launches."""
    from repro_torch.launch import train as train_cli
    from repro_torch.sharding.ctx import is_dtensor
    t0 = time.perf_counter()
    kw = resume_kwargs(dev)
    with tempfile.TemporaryDirectory() as tmp:
        cont = train_cli.train(TRAIN_ARCH, ckpt_dir=tmp, **kw)
        reset_counts()
        resumed = train_cli.train(TRAIN_ARCH, ckpt_dir=tmp, **kw)
        launched = counts()
    n_steps = RESUME_STEPS - RESUME_AT - 1
    expect_launches(f"{TRAIN_ARCH} mesh resume ({n_steps} steps)", launched,
                    {"flash_attn": 2 * RESUME_LAYERS * n_steps,
                     "flash_attn_bwd": RESUME_LAYERS * n_steps})
    if not is_dtensor(cont["params"]["embed"]):
        raise AssertionError("the mesh run's params are not DTensors")
    n_leaves = check_resumed(f"{TRAIN_ARCH} on the mesh", cont, resumed)
    seconds = round(time.perf_counter() - t0, 1)
    print(f"mesh 1x1 {TRAIN_ARCH} at {RESUME_LAYERS} layers: checkpoint at step {RESUME_AT} "
          f"written from the mesh, the resumed mesh run equals the continuous one bit for "
          f"bit ({n_leaves} leaves, losses {[round(x, 6) for x in resumed['losses']]}); "
          f"launches over its {n_steps} steps {launched}; {seconds} s", flush=True)
    return {"seconds": seconds, "launches": launched}


def mesh_smoke_archs(mesh):
    """Every family's smoke model but MLA's on the 1x1 mesh (DTensor's
    propagation on this card's PyTorch through each family's layers):
    ``generate`` at decode_chunk 1 and 4, and the engine where the arch
    has one, equal to the same model off the mesh.  deepseek-v3-671b's
    smoke head dim (24) is below the flash kernel's multiple of 16, so it
    cannot prefill on the card at smoke size.  Returns seconds per arch."""
    seconds = {}
    for arch in MESH_SMOKE_ARCHS:
        t0 = time.perf_counter()
        lm = LM.from_config(arch, smoke=True, device="cuda")
        cfg = lm.cfg
        gen = torch.Generator("cuda").manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, 6), generator=gen, device="cuda")
        enc = None
        if cfg.n_encoder_tokens:
            enc = torch.randn((BATCH, cfg.n_encoder_tokens, cfg.d_model), generator=gen,
                              device="cuda").to(torch.bfloat16)
        want = lm.generate(prompts, 5, encoder_states=enc)
        meshed = lm.with_mesh(mesh)
        for chunk in (1, 4):
            got = meshed.generate(prompts, 5, encoder_states=enc, decode_chunk=chunk)
            if not torch.equal(got, want):
                raise AssertionError(f"{arch} smoke on the 1x1 mesh at decode_chunk {chunk} "
                                     "differs from off it")
        if not cfg.n_encoder_tokens:
            served = meshed.serve([(prompts[i].cpu().numpy(), 5) for i in range(BATCH)],
                                  n_slots=BATCH)
            if any(list(served[i]) != want[i, 6:].tolist() for i in range(BATCH)):
                raise AssertionError(f"{arch} smoke engine on the 1x1 mesh differs from "
                                     "generate off it")
        seconds[arch] = round(time.perf_counter() - t0, 2)
    print(f"mesh 1x1 smoke streams of {len(seconds)} archs (generate at decode_chunk 1 "
          f"and 4, the engine) equal off the mesh; seconds {seconds}", flush=True)
    return seconds


def partial_product_check(timer, gen, dev, out):
    """A rank's product of a contraction-sharded weight (``layers.matmul``
    on a mesh whose model axis has more than one rank, which the card's one
    rank never runs): rwkv6's w_o at decode (B 4, d 2048) split in halves,
    the bf16 blocks multiplied with an f32 result (``out_dtype``), timed
    beside the bf16 product of the same blocks and the f32 product of
    widened blocks; the rounded result within one bf16 ulp of the bf16
    product."""
    x = torch.randn((BATCH, 1, D_MODEL // 2), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((D_MODEL // 2, D_MODEL), generator=gen, device=dev)
         * D_MODEL ** -0.5).to(torch.bfloat16)
    with torch.no_grad():
        part = layers._partial_product(x, w)
        plain = x @ w
    if part.dtype != torch.float32:
        raise AssertionError(f"partial product is {part.dtype}, not f32")
    ulp = 2.0 ** (torch.floor(torch.log2(plain.float().abs().clamp_min(1e-30))) - 7)
    if bool(((part.to(torch.bfloat16).float() - plain.float()).abs() > ulp).any()):
        raise AssertionError("partial product rounded to bf16 is beyond one ulp of the "
                             "bf16 product")
    with torch.no_grad():
        ms = {"f32_out": timer.ms(lambda: layers._partial_product(x, w)),
              "bf16": timer.ms(lambda: x @ w),
              "widened_f32": timer.ms(lambda: x.float() @ w.float())}
    out["partial product ms"] = ms
    print(f"contraction-sharded product (rwkv6 w_o half, x {tuple(x.shape)}, w "
          f"{tuple(w.shape)}): bf16 blocks to f32 {ms['f32_out']:.4f} ms, bf16 product "
          f"{ms['bf16']:.4f} ms, widened f32 blocks {ms['widened_f32']:.4f} ms; rounded "
          "within one bf16 ulp of the bf16 product", flush=True)


def arch_phase(dev, arch, n_layers, per_layer=False, extra=None):
    """An arch at full width (``n_layers`` deep when given; drawn a layer
    at a time with ``per_layer``): ``LM.generate`` of BATCH x PROMPT
    prompts (with stub encoder states where the arch cross-attends) for
    GEN new tokens through the dense and the fused head at decode_chunk 1
    and 16 (after a warm-up and the capture), equal streams, launch counts
    (flash_attn once per attention or MLA layer in the prefill,
    fused_decode GEN - 1), new tok/s, the peak memory and the phase's
    seconds.  ``extra(lm, frozen, prompts, dense_stream, encoder states)``
    runs after, on the same model."""
    t_phase = time.perf_counter()
    lm, _, frozen, gen = build_served(arch, dev, n_layers, per_layer)
    cfg = lm.cfg
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    enc = encoder_states(cfg, gen)
    heads = {"dense": lm.head, "fused": SketchHead(cfg=SERVE_HEAD, backend="fused",
                                                   params=frozen)}
    want = {"dense": {"flash_attn": attn_layers(cfg)},
            "fused": {"flash_attn": attn_layers(cfg), "fused_decode": GEN - 1}}
    dense_stream = None
    torch.cuda.reset_peak_memory_stats()
    tps = {}
    for name, head in heads.items():
        served = lm.with_head(head)
        served.generate(prompts, GEN, encoder_states=enc)                   # warm-up
        served.generate(prompts, GEN, decode_chunk=16, encoder_states=enc)  # the capture
        streams = {}
        for k in (1, 16):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            tokens = served.generate(prompts, GEN, decode_chunk=k, encoder_states=enc)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            expect_launches(f"{cfg.name} {name} decode_chunk={k}", counts(), want[name])
            if (tokens.shape != (BATCH, PROMPT + GEN) or int(tokens.min()) < 0
                    or int(tokens.max()) >= cfg.vocab_size):
                raise AssertionError(f"{cfg.name} {name}: bad tokens {tuple(tokens.shape)}")
            streams[k] = tokens
            tps[(name, k)] = round(BATCH * GEN / dt, 1)
        if not torch.equal(streams[1], streams[16]):
            raise AssertionError(f"{cfg.name} {name}: decode_chunk=16 gave another stream "
                                 f"than decode_chunk=1")
        if name == "dense":
            dense_stream = streams[1]
        for loop in served._loops.values():
            loop.close()
        served._loops.clear()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    depth = (f"{cfg.n_layers} layers" if n_layers is None else
             f"{cfg.n_layers} of {get_config(arch).n_layers} layers")
    n_params = sum(t.numel() for t in leaves(lm.params))
    print(f"{cfg.name} at full width, {depth} ({n_params / 1e9:.2f} B params"
          f"{', drawn a layer at a time' if per_layer else ''}"
          f"{', stub encoder states ' + str(tuple(enc.shape)) if enc is not None else ''}"
          f"): dense and fused streams "
          f"equal at decode_chunk 1 and 16; launches flash_attn {attn_layers(cfg)} a "
          f"prefill, fused_decode {GEN - 1} a fused generate; new tok/s {tps}; init peak "
          f"{init_peak:.1f} GiB, generate peak {peak:.1f} GiB allocated; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if extra is not None:
        extra(lm, frozen, prompts, dense_stream, enc)
    del lm, frozen, heads, served, enc
    free_card()
    print(f"{cfg.name} freed: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved", flush=True)


def draft_launches(head):
    """The kernels one draft step of ``head`` launches (per step)."""
    if not head.needs_hidden:
        return []
    return ["fused_decode"] if head.backend == "fused" else ["lsh_hash", "sketch_head"]


def spec_tick_ms(loop, k, tok, reps=5):
    """Wall ms of one speculative tick of ``k`` draft steps (k replays, the
    verify, the acceptance, the rollback) with its host fetch of ``m``;
    median of ``reps`` after one more.  The carry is reloaded each time."""
    walls = []
    for _ in range(reps + 1):
        loop.load(tok, PROMPT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m, _, _ = loop.run(k)
        int(m)
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls[1:]))


def dense_draft_check(lm, prompts, dense):
    """The dense head as the draft: ``generate(spec_decode=4)`` accepts
    every draft (rate exactly 1.0) and gives the dense stream, and on one
    tick the verify's logits equal the captured draft steps' logits bit
    for bit (the same (B, 1, d) unembed, eager and replayed)."""
    cfg, dev = lm.cfg, prompts.device
    served = lm.with_head(DenseHead())
    tokens, stats = served.generate(prompts, GEN, spec_decode=4, return_stats=True)
    if stats["accepted_draft_tokens"] != stats["draft_tokens"] or not torch.equal(tokens, dense):
        raise AssertionError(f"{cfg.name} dense-head draft: acceptance "
                             f"{stats['accepted_draft_tokens']}/{stats['draft_tokens']}, or "
                             f"another stream than dense decode")
    with torch.inference_mode():
        cache = model.init_decode_cache(cfg, prompts.shape[0], PROMPT + GEN, device=dev)
        logits, cache = prefill_step_(lm.params, prompts, cfg, cache)
        loop = SpecLoop(lm.params, cfg, DenseHead(), cache, k=4, masked=False,
                        per_slot=False, record_logits=True)
        loop.load(logits.argmax(-1), PROMPT)
        _, m, acc, _ = loop.run(4)
        same = torch.equal(loop.verify_logits, loop.draft_logits)
    loop.close()
    if int(m) != 4 or not bool((acc == 4).all()) or not same:
        raise AssertionError(f"{cfg.name} dense-head draft tick: m={int(m)}, acc "
                             f"{acc.tolist()}, verify logits equal the draft logits: {same}")
    print(f"{cfg.name} spec generate, dense-head draft K=4: acceptance "
          f"{stats['accepted_draft_tokens']}/{stats['draft_tokens']} = 1.0 exactly, "
          f"{stats['verify_calls']} verify calls, the dense stream; one tick's verify "
          f"logits equal its {int(m)} captured draft steps' logits bit for bit", flush=True)


def spec_phase(lm, heads, prompts, want_launches, eager, steps):
    """``LM.generate(spec_decode=K)`` for K in SPEC_KS through each sketched
    head (BATCH x PROMPT prompts, GEN new tokens), after a run that
    captures the draft step: launch counts zeroed before and checked after
    each run (each draft head's kernels once a draft step, flash_attn once
    a layer in the prefill), every stream equal to the eager dense one;
    acceptance rate, mean ``m``, ms a tick (the tick alone, its host fetch
    included) beside the captured step's ms, and new tok/s.  Then the
    dense head as the draft (``dense_draft_check``)."""
    cfg, dense = lm.cfg, eager["dense"]
    prefill = {"flash_attn": cfg.n_layers} if "flash_attn" in want_launches["dense"] else {}
    for name, head in heads.items():
        if not head.needs_hidden:
            continue
        served = lm.with_head(head)
        for k in SPEC_KS:
            served.generate(prompts, GEN, spec_decode=k)                  # the capture
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            tokens, stats = served.generate(prompts, GEN, spec_decode=k, return_stats=True)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launched = counts()
            want = dict(prefill, **{w: stats["decode_steps"] for w in draft_launches(head)})
            expect_launches(f"{cfg.name} {name} spec_decode={k}", launched, want)
            if not torch.equal(tokens, dense):
                raise AssertionError(f"{cfg.name} {name} spec_decode={k}: another stream "
                                     f"than dense decode")
            loop = next(v for key, v in served._loops.items() if key[:2] == ("spec", k))
            if loop.graph is None:
                raise AssertionError(f"{cfg.name} {name}: the draft step was not captured")
            tick = spec_tick_ms(loop, k, tokens[:, PROMPT])
            rate = stats["accepted_draft_tokens"] / stats["draft_tokens"]
            print(f"{cfg.name} spec generate head={name} K={k}: the dense stream token for "
                  f"token; acceptance {stats['accepted_draft_tokens']}/{stats['draft_tokens']} "
                  f"= {rate:.3f}, mean m {(GEN - 1) / stats['verify_calls']:.3f} over "
                  f"{stats['verify_calls']} ticks, {stats['decode_steps']} draft steps; "
                  f"{tick:.3f} ms a tick of {k} draft steps (captured step "
                  f"{steps[name]:.3f} ms); {BATCH * GEN / dt:.1f} new tok/s (prefill "
                  f"included); launches {launched}", flush=True)
        for loop in served._loops.values():
            loop.close()
    dense_draft_check(lm, prompts, dense)


def spec_engine_phase(lm, frozen):
    """The engine's speculative ticks (spec_decode 4, fused head) against
    the dense engine (decode_chunk 1) on N_REQUESTS staggered requests
    over SLOTS slots: every stream equal.  Prompt lengths all differ, so
    every prefill is a batch of one in both engines whatever the clock
    does (a spec tick advances it by m).  fused_decode once a draft step,
    the capture's warm-up steps once."""
    cfg, dev = lm.cfg, lm.device
    rng = np.random.default_rng(12)
    stream = [(rng.integers(0, cfg.vocab_size, 20 + i, dtype=np.int32),
               GEN if i % 2 else GEN // 4, i) for i in range(N_REQUESTS)]
    max_seq = 20 + N_REQUESTS + GEN
    results = {}
    for name, head, spec in (("dense", DenseHead(), 0),
                             ("fused", SketchHead(cfg=SERVE_HEAD, backend="fused",
                                                  params=frozen), 4)):
        eng = lm.with_head(head).engine(SLOTS, max_seq, spec_decode=spec)
        for p, g, a in stream:
            eng.submit(p, g, arrival=a)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        fin = eng.run()
        torch.cuda.synchronize()
        results[name] = (eng, fin, time.perf_counter() - t0, counts())
        eng.close()
    (d_eng, d_fin, d_dt, _), (eng, fin, dt, launched) = results["dense"], results["fused"]
    expect_launches("spec engine", launched,
                    {"fused_decode": eng.stats["decode_steps"] + WARMUP_STEPS,
                     "flash_attn": attn_layers(cfg) * eng.stats["prefill_batches"]})
    if fin != d_fin:
        raise AssertionError("spec engine: a stream differs from the dense engine's")
    st, n_new = eng.stats, sum(len(v) for v in fin.values())
    print(f"{cfg.name} spec engine (fused drafts, K=4): all {len(fin)} streams equal the dense "
          f"engine's; {st['verify_calls']} verify calls, acceptance "
          f"{st['accepted_draft_tokens']}/{st['draft_tokens']} = "
          f"{st['accepted_draft_tokens'] / st['draft_tokens']:.3f}, {st['megasteps']} ticks, "
          f"{st['host_syncs']} host syncs, {st['decode_steps']} draft steps, "
          f"{n_new / dt:.1f} new tok/s ({dt * 1e3 / st['megasteps']:.2f} ms a tick); dense "
          f"engine {d_eng.stats['megasteps']} ticks, {d_eng.stats['host_syncs']} host syncs, "
          f"{n_new / d_dt:.1f} new tok/s ({d_dt * 1e3 / d_eng.stats['megasteps']:.2f} ms a "
          f"tick); launches {launched}", flush=True)


def time_decode_ticks(backend, name):
    """Wrap ``backend.<name>`` (an engine's per-token decode call) to
    record each call's wall ms between two synchronizations; returns the
    list it fills.  The engine syncs on the logits right after the call,
    so the added synchronizations cost next to nothing."""
    fn, walls = getattr(backend, name), []

    def timed_call(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(backend, name, timed_call)
    return walls


def paged_phase(lm, frozen):
    """The paged engine (PAGE_SIZE tokens a page, fused head) against the
    contiguous engine on one trace of N_REQUESTS staggered requests over
    SLOTS slots: every third prompt one of two shared prompts (lengths 24
    and 40: partial last pages, so decode writes fork them), the others of
    lengths of their own, so every prefill is a batch of one in both
    engines.  Every stream equal, prefix hits > 0, COW copies > 0 where
    there are arenas; fused_decode once a tick, flash_attn once a layer a
    prefill (none at a hit).  Prints hits and queries, pages in use and
    their peak, COW copies, ms a tick and new tok/s of each engine."""
    cfg, dev = lm.cfg, lm.device
    rng = np.random.default_rng(11)
    shared = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in (24, 40)]
    lengths = iter(n for n in range(17, 64) if n not in (24, 40))
    stream = []
    for i in range(N_REQUESTS):
        prompt = (shared[(i // 3) % 2] if i % 3 == 2 else
                  rng.integers(0, cfg.vocab_size, next(lengths), dtype=np.int32))
        stream.append((prompt, GEN if i % 2 else GEN // 4, i))
    max_seq = 64 + GEN
    served = lm.with_head(SketchHead(cfg=SERVE_HEAD, backend="fused", params=frozen))
    attn = attn_layers(cfg) > 0
    results = {}
    for paged in (False, True):
        eng = served.engine(SLOTS, max_seq, paged=paged, page_size=PAGE_SIZE)
        for p, g, a in stream:
            eng.submit(p, g, arrival=a)
        ticks = time_decode_ticks(eng.backend, "paged_decode" if paged else "decode")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        fin = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = {"fused_decode": eng.stats["decode_steps"]}
        if attn:
            want["flash_attn"] = attn_layers(cfg) * eng.stats["prefill_batches"]
        expect_launches(f"{cfg.name} {'paged' if paged else 'contiguous'} engine", counts(),
                        want)
        results[paged] = (eng, fin, dt, float(np.median(ticks)))
    (c_eng, c_fin, c_dt, c_tick), (eng, fin, dt, tick) = results[False], results[True]
    st, n_new = eng.stats, sum(len(v) for v in fin.values())
    if fin != c_fin:
        raise AssertionError(f"{cfg.name} paged engine: a stream differs from the contiguous "
                             f"engine's")
    if not st["prefix_hits"] or (attn and not st["cow_copies"]):
        raise AssertionError(f"{cfg.name} paged engine: {st['prefix_hits']} prefix hits, "
                             f"{st['cow_copies']} COW copies")
    eng.page_pool.check_invariants(eng.prefix.external_refs())
    print(f"{cfg.name} paged engine (page {PAGE_SIZE}, fused head): all {len(fin)} streams "
          f"equal the contiguous engine's; prefix hits {st['prefix_hits']}/"
          f"{st['prefix_queries']}, prefill batches {st['prefill_batches']} (contiguous "
          f"{c_eng.stats['prefill_batches']}), pages in use {st['pages_in_use']} (peak "
          f"{st['pages_in_use_peak']} of {eng.page_pool.num_pages}), {st['cow_copies']} COW "
          f"copies; {dt * 1e3 / st['megasteps']:.2f} ms a tick with admissions and "
          f"{n_new / dt:.1f} new tok/s against the contiguous engine's "
          f"{c_dt * 1e3 / c_eng.stats['megasteps']:.2f} ms and {n_new / c_dt:.1f} "
          f"({st['megasteps']} and {c_eng.stats['megasteps']} ticks); the decode call alone "
          f"(gather, step, commit) {tick:.2f} ms against {c_tick:.2f} ms (medians)", flush=True)


def timed_print(label, fn, *args):
    """``fn(*args)``, then a line with its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"{label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def spec_engines_phase(lm, frozen, prompts, dense, enc):
    """After an arch's generate cells (jamba, deepseek, llama): spec
    generate at K=4 with the dense-head draft (acceptance 1.0) and with
    fused drafts (rejections: jamba's mamba rows restored from their
    snapshots, the MLA latent rewound by position), each the dense stream
    bit for bit; then, for an arch the engine serves (no encoder states),
    the paged engine against the contiguous one (``paged_phase``: jamba's
    mamba state rows in the prefix cache, deepseek's latent pages) and the
    speculative engine against the dense one (``spec_engine_phase``)."""
    cfg = lm.cfg
    t0 = time.perf_counter()
    for name, head in (("dense-head", DenseHead()),
                       ("fused", SketchHead(cfg=SERVE_HEAD, backend="fused", params=frozen))):
        served = lm.with_head(head)
        served.generate(prompts, GEN, spec_decode=4, encoder_states=enc)  # the capture
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        tokens, stats = served.generate(prompts, GEN, spec_decode=4, return_stats=True,
                                        encoder_states=enc)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        want = dict({"flash_attn": attn_layers(cfg)},
                    **{w: stats["decode_steps"] for w in draft_launches(head)})
        expect_launches(f"{cfg.name} spec {name}", counts(), want)
        if not torch.equal(tokens, dense):
            raise AssertionError(f"{cfg.name} spec generate ({name} draft): another stream "
                                 f"than dense decode")
        if name == "dense-head" and stats["accepted_draft_tokens"] != stats["draft_tokens"]:
            raise AssertionError(f"{cfg.name}: the dense-head draft was rejected")
        print(f"{cfg.name} spec generate K=4, {name} draft: the dense stream token for "
              f"token; acceptance {stats['accepted_draft_tokens']}/{stats['draft_tokens']}, "
              f"{stats['verify_calls']} ticks; {BATCH * GEN / dt:.1f} new tok/s (prefill "
              f"included); launches {want}", flush=True)
        for loop in served._loops.values():
            loop.close()
        served._loops.clear()
    print(f"{cfg.name} spec generate: {time.perf_counter() - t0:.1f} s", flush=True)
    if enc is None:
        timed_print(f"{cfg.name} paged engine", paged_phase, lm, frozen)
        timed_print(f"{cfg.name} spec engine", spec_engine_phase, lm, frozen)


def seeded_phase(lm, prompts, timer):
    """Seeded sampling on full-width rwkv6-1.6b (``Sampler(**SEEDED)``,
    the reference tests' "seeded"): (a) the card's threefry keys, a chain
    of splits, random bits and uniforms of a (4, 65536) draw equal to the
    CPU port's bit for bit; (b) ``generate`` at decode_chunk 1 and 16 the
    same stream; (c) spec generate at K=4 with the dense-head draft that
    stream; (d) the engine at decode_chunk 4 the streams of decode_chunk
    1 (12 staggered requests over 4 slots); (e) the captured step's
    ms/step greedy, seeded and seeded with top_p 0.95, and the top-p
    sort's share of that step (the sort of (4, 65536) logits timed
    alone)."""
    cfg, dev = lm.cfg, lm.device
    shape = (BATCH, cfg.vocab_size)
    for seed in (0, 7, 2 ** 31 - 1):
        key, ckey = sampling.prng_key(seed, dev), sampling.prng_key(seed)
        for _ in range(3):
            keys, ckeys = sampling.split(key), sampling.split(ckey)
            if not torch.equal(keys.cpu(), ckeys):
                raise AssertionError(f"seed {seed}: the card's split differs from the CPU's")
            for got, want in ((sampling.random_bits(keys[1], shape),
                               sampling.random_bits(ckeys[1], shape)),
                              (sampling.uniform(keys[1], shape, sampling.F32_TINY, 1.0),
                               sampling.uniform(ckeys[1], shape, sampling.F32_TINY, 1.0))):
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"seed {seed}: the card's bits or uniforms differ "
                                         f"from the CPU's")
            key, ckey = keys[0], ckeys[0]
    print(f"seeded: threefry keys, 3 chained splits, random bits and uniforms of a {shape} "
          f"draw at seeds 0, 7, 2^31-1 equal on the card and the CPU bit for bit", flush=True)
    sampler = Sampler(**SEEDED)
    dense = lm.with_head(DenseHead())
    greedy = dense.generate(prompts, GEN)
    host = dense.generate(prompts, GEN, sampler=sampler)
    dense.generate(prompts, GEN, sampler=sampler, decode_chunk=16)       # the capture
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    chunk = dense.generate(prompts, GEN, sampler=sampler, decode_chunk=16)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    expect_launches("seeded generate", counts(), {})
    spec, stats = dense.generate(prompts, GEN, sampler=sampler, spec_decode=4,
                                 return_stats=True)
    if not (torch.equal(chunk, host) and torch.equal(spec, host)):
        raise AssertionError("seeded: decode_chunk 16 or spec_decode 4 gave another stream "
                             "than the per-token loop")
    if stats["accepted_draft_tokens"] != stats["draft_tokens"] or torch.equal(host, greedy):
        raise AssertionError("seeded: the dense-head draft was rejected, or the seeded "
                             "stream is the greedy one")
    print(f"seeded generate {sampler.describe()}: decode_chunk 1 and 16 and spec K=4 "
          f"(dense-head draft, acceptance 1.0) the same stream; "
          f"{float((host != greedy).float().mean()):.3f} of its tokens differ from greedy; "
          f"{BATCH * GEN / dt:.1f} new tok/s at decode_chunk 16", flush=True)
    stream = engine_stream(cfg.vocab_size, N_REQUESTS, PROMPT, GEN, 1, 0)
    fins = {}
    for c in (1, ENGINE_CHUNK):
        eng = dense.engine(SLOTS, PROMPT + GEN, sampler=sampler, decode_chunk=c)
        for p, g, a in stream:
            eng.submit(p, g, arrival=a)
        fins[c] = eng.run()
        eng.close()
    if fins[ENGINE_CHUNK] != fins[1]:
        raise AssertionError("seeded engine: decode_chunk 4 gave other streams than 1")
    print(f"seeded engine: {len(fins[1])} requests over {SLOTS} slots, decode_chunk "
          f"{ENGINE_CHUNK} the streams of decode_chunk 1", flush=True)
    ms = {}
    for label, smp in (("greedy", Sampler()), ("seeded", sampler),
                       ("seeded top_p 0.95", Sampler(**dict(SEEDED, top_p=0.95)))):
        dense.generate(prompts, GEN, sampler=smp, decode_chunk=16)
        loop = next(v for k, v in dense._loops.items() if k[0] == "chunk" and k[4] == smp)
        ms[label] = megastep_ms(loop, 16)
    logits = torch.randn(shape, device=dev)
    sort_ms = timer.ms(lambda: torch.sort(logits, dim=-1, descending=True))
    filt_ms = timer.ms(lambda: sampling.filter_logits(Sampler(**dict(SEEDED, top_p=0.95)),
                                                      logits))
    for loop in dense._loops.values():
        loop.close()
    dense._loops.clear()
    print(f"seeded captured step (B={BATCH}, V={cfg.vocab_size}, decode_chunk 16): "
          f"{ {k: round(v, 3) for k, v in ms.items()} } ms/step; the top-p sort alone "
          f"{sort_ms:.3f} ms ({sort_ms / ms['seeded top_p 0.95']:.3f} of the top_p step), "
          f"the whole filter {filt_ms:.3f} ms", flush=True)


def cache_gib(cache):
    return sum(x.numel() * x.element_size() for c in cache["periods"].values()
               for x in c) / 2 ** 30


def memo_phase(glm, frozen):
    """gemma2-27b at full width: (a) ``generate`` at decode_chunk 16 over
    MEMO_PROMPTS (B=BATCH), each stream equal to decode_chunk 1's, the
    memo's size after each held to one loop; (b) B=1 and a MEMO_LONG-token
    prompt: the peak allocated above the resident state at decode_chunk 1
    and at 16, whose gap must stay below one KV cache (the loop prefills
    into its own cache); the memory reserved before and after the loops
    are closed (their graph pools released); (c) speculative decode at
    that wrapped ring (K=4, fused drafts, 8 new tokens): the dense stream,
    with the ring snapshot's bytes."""
    cfg, dev = glm.cfg, glm.device
    lm = glm.with_head(DenseHead())
    gen = torch.Generator(dev).manual_seed(7)
    for p in MEMO_PROMPTS:
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, p), generator=gen, device=dev)
        want = lm.generate(prompts, GEN)
        got = lm.generate(prompts, GEN, decode_chunk=16)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or len(lm._loops) != 1:
            raise AssertionError(f"memo: prompt {p}: {len(lm._loops)} loops, or another stream "
                                 f"than decode_chunk 1")
        print(f"{cfg.name} memo: prompt {p}, decode_chunk 16 equal to 1, {len(lm._loops)} loop "
              f"in the memo, {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved",
              flush=True)
    prompt = torch.randint(0, cfg.vocab_size, (1, MEMO_LONG), generator=gen, device=dev)
    kv = cache_gib(model.init_decode_cache(cfg, 1, MEMO_LONG + 8, device="meta"))
    peaks, streams = {}, {}
    for k in (1, 16):
        free_card()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        streams[k] = lm.generate(prompt, 8, decode_chunk=k)
        torch.cuda.synchronize()
        peaks[k] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if not torch.equal(streams[16], streams[1]) or not peaks[16] - peaks[1] < kv:
        raise AssertionError(f"memo: long prompt peaks {peaks} GiB (one KV cache {kv:.3f} GiB), "
                             f"or another stream at decode_chunk 16")
    free_card()
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    n_loops = len(lm._loops)
    for loop in lm._loops.values():
        loop.close()
    lm._loops.clear()
    free_card()
    print(f"{cfg.name} memo: B=1, {MEMO_LONG}-token prompt, 8 new tokens: peak above the "
          f"resident state {peaks[1]:.3f} GiB at decode_chunk 1, {peaks[16]:.3f} GiB at 16 "
          f"(gap {peaks[16] - peaks[1]:.3f} GiB, one KV cache {kv:.3f} GiB), equal streams; "
          f"{n_loops} loops in the memo; reserved {reserved:.2f} GiB -> "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB after closing them", flush=True)

    spec = glm.with_head(SketchHead(cfg=SERVE_HEAD, backend="fused", params=frozen))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tokens, stats = spec.generate(prompt, 8, spec_decode=4, return_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    expect_launches("spec at the wrapped ring", counts(),
                    {"flash_attn": cfg.n_layers,
                     "fused_decode": stats["decode_steps"] + WARMUP_STEPS})
    (loop,) = spec._loops.values()
    snap = sum(x.numel() * x.element_size() for s in loop.snap["periods"].values()
               if s is not None for x in s)
    ring = loop.cache["periods"]["pos0"].k
    whole = 2 * 4 * ring.numel() * ring.element_size()
    if not torch.equal(tokens, streams[1]) or snap == 0:
        raise AssertionError("spec at the wrapped ring: another stream than dense decode")
    loop.close()
    print(f"{cfg.name} spec at the wrapped ring (B=1, {MEMO_LONG}-token prompt, ring of "
          f"{ring.shape[2]} slots, K=4, fused drafts): the dense stream; acceptance "
          f"{stats['accepted_draft_tokens']}/{stats['draft_tokens']}, {stats['verify_calls']} "
          f"ticks; ring snapshot {snap / 2 ** 20:.3f} MiB for K=4 (whole rings each step would "
          f"be {whole / 2 ** 30:.3f} GiB); {dt:.2f} s with the prefill", flush=True)



def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build the kernels and run the kernel and hash phases only "
                         "(kernel_case lines, no result line)")
    ap.add_argument("--csrc", type=Path, default=None,
                    help="build the kernels from this csrc directory (another "
                         "checkout's, to time its kernels through these wrappers)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    if args.csrc is not None:
        _build.CSRC = args.csrc.resolve()
    if os.environ.get("PYTHONHASHSEED") != "0":
        # The tabular datasets are seeded with hash(name): pin it.
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  dict(os.environ, PYTHONHASHSEED="0"))
    # torch.compile's caches (the flex_attention yardstick) stay in the
    # checkout's git-ignored build directory.
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(_build.BUILD_DIR / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
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
    print(f"kernel build: {seconds:.2f} s for {', '.join(_build.sources())}"
          + (f" (from {args.csrc})" if args.csrc is not None else ""))
    ptxas = {name: ptxas_report(name, log) for name, log in logs.items()}
    timer = Timer(dev)

    phase_seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("kernels", kernel_phase, dev, timer)
    timed("lsh_hash", hash_phase, dev, timer)
    if args.kernels:
        print(f"phase seconds: {phase_seconds}")
        print(card_line())
        return
    dryrun = start_dryrun()
    timed("race_update", race_phase, dev, timer)
    flash = timed("flash_attn", flash_phase, dev, timer)
    flash_bwd = timed("flash_attn_bwd", flash_bwd_phase, dev, timer)
    timed("dry run", dryrun_phase, dryrun)
    timed("backbone", backbone_phase, dev)
    runs, recs, lm, frozen, kparams, loop_args = timed("main path", main_path, dev, timer)
    loop_ms = timed("decode loop", decode_loop_phase, *loop_args)
    timed("spec generate", spec_phase, *loop_args[:5], loop_ms)
    timed("seeded sampling", seeded_phase, lm, loop_args[2], timer)
    del loop_args
    timed("mesh", mesh_phase, dev, timer, lm, frozen, runs)
    refresh_launches, recs["race_update"] = timed("refresh f32", refresh_phase, dev, timer, lm,
                                                  kparams, None)
    timed("refresh int8", refresh_phase, dev, timer, lm, kparams, "int8")
    timed("engine", engine_phase, dev, shallow(lm, ENGINE_LAYERS), frozen, kparams)
    timed("spec engine", spec_engine_phase, lm, frozen)
    timed("paged engine", paged_phase, lm, frozen)
    timed("race_query", query_phase, dev, timer)
    recs["race_query"], query_launches = timed("paper", paper_phase, dev, timer)
    timed("lm distill", lm_distill_phase)
    del lm, frozen, kparams
    free_card()
    glm, gfrozen, gruns, loop_args = timed("gemma2 main path", gemma_main_path, dev, timer)
    loop_ms = timed("gemma2 decode loop", decode_loop_phase, *loop_args)
    timed("gemma2 spec generate", spec_phase, *loop_args[:5], loop_ms)
    del loop_args
    timed("gemma2 engine", gemma_engine_phase, shallow(glm, ENGINE_LAYERS), gfrozen)
    timed("gemma2 paged engine", paged_phase, glm, gfrozen)
    free_card()
    timed("gemma2 memo", memo_phase, glm, gfrozen)
    del gfrozen
    free_card()
    timed("gemma2 long prefill", gemma_long_prefill, glm, timer)
    del glm
    free_card()
    for arch, n_layers, per_layer in PLAIN_ARCHS:
        timed(arch, arch_phase, dev, arch, n_layers, per_layer)
    for arch, n_layers in MOE_ARCHS:
        timed(arch, arch_phase, dev, arch, n_layers, True,
              spec_engines_phase if arch.startswith("jamba") else None)
    for arch, n_layers, per_layer in NEW_ARCHS:
        timed(arch, arch_phase, dev, arch, n_layers, per_layer, spec_engines_phase)
    train_launches, _ = timed("musicgen-large training", train_phase, dev, timer)
    free_card()
    timed("training resume", resume_phase, dev)
    print(f"phase seconds: {phase_seconds}")
    long, mla = flash["long prefill, global"], flash[MLA_PREFILL]
    recs["flash_attn"] = dict(flash["main prefill, global"],
                              ms_softcap_free=flash["main prefill, softcap-free"]["ms"],
                              library_ms_softcap_free=flash["main prefill, softcap-free"][
                                  "library_ms"],
                              **{f"long_prefill_{k}": long[k] for k in (
                                  "ms", "bound_ms", "f32_core_bound_ms",
                                  "bf16_tensor_core_ms", "library_ms")},
                              **{f"mla_prefill_{k}": mla[k] for k in (
                                  "ms", "plain_ms", "bound_ms", "library_ms",
                                  "max_abs_err", "tol_ratio")})
    recs["flash_attn_bwd"] = dict(flash_bwd[MUSICGEN_TRAIN], cases={
        label: {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "bound_with_recompute_ms", "library_ms", "library",
                                    "tol_ratio", "lse_tol_ratio")}
        | {k: rec[k] for k in ("kernel_tensor_core_ms", "kernel_f32_core_ms") if k in rec}
        for label, rec in flash_bwd.items()}, ptxas=ptxas.get("flash_attn_bwd"))

    line = []
    for name, (_, source, replaces) in KERNELS.items():
        rec = recs[name]
        if name == "race_update":
            launches = refresh_launches[name]
        elif name == "race_query":
            launches = query_launches
        elif name == "flash_attn":
            launches = gruns["fused"][-1]["launches"][name]
        elif name == "flash_attn_bwd":
            launches = train_launches[name]
        else:
            launches = runs["two_kernel" if name != "fused_decode" else "fused"][-1][
                "launches"][name]
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches, max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                         plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                         bound_by=rec["bound_by"], library_ms=rec["library_ms"],
                         **{k: v for k, v in rec.items()
                            if k.endswith("softcap_free") or k in ("cases", "ptxas")
                            or k.startswith(("long_prefill_", "mla_prefill_"))}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
