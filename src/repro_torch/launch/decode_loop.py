"""On-device decode megasteps: K decode steps per host round trip.

The per-token loop pays the host for every step: thousands of kernel
launches made from Python, and a sync to sample.  A megastep runs K
steps with the sampler and EOS retirement inside, and only a (K, B) token
block (plus the small carry) crosses to the host, once: the JAX package's
``jitted_megastep`` (a ``lax.scan`` with the cache donated) in PyTorch.

:class:`DecodeLoop` holds one decode step on static buffers: the decode
cache (written in place by ``serve_step_``), the last token, ``pos``,
``active`` and, for per-tenant heads, the slot → bank-row binding.  On a
CUDA device the step is captured once as a CUDA graph and each megastep
replays it K times, so one capture serves every K; on the CPU the same
step runs eagerly on the same buffers.  A capture that fails raises.

Semantics are the JAX package's, bit for bit inside the port: each step
feeds the previous token through ``serve_step_`` and takes the argmax;
with ``masked``, retired rows emit ``pad_id`` and their cache rows freeze;
a scalar ``pos`` (static generate) advances by 1 a step, a (B,) ``pos``
(the engine) where a slot is active, the EOS step included.

A replayed graph runs kernels without passing through their Python
wrappers, so the capture records each wrapper's ``launches`` delta and
every replay adds it back: the counts still say what ran on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.sampler import Sampler
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.fused_decode.ops import fused_decode_logits
from repro_torch.kernels.lsh_hash.ops import lsh_hash
from repro_torch.kernels.race_query.ops import race_query
from repro_torch.kernels.race_update.ops import race_update
from repro_torch.kernels.sketch_head.ops import sketch_head_logits
from repro_torch.launch.steps import serve_step_
from repro_torch.models.config import ModelConfig

#: The kernel wrappers whose ``launches`` a replay adds to.
COUNTED = (fused_decode_logits, lsh_hash, sketch_head_logits, race_update,
           race_query, flash_attention)

WARMUP_STEPS = 2


def _counts() -> list:
    return [w.launches for w in COUNTED]


class DecodeLoop:
    """One decode step on static buffers, run K times per :meth:`run`.

    Args:
      params / cfg: the backbone.
      head: the serving head (``DenseHead`` or a ``SketchHead``); a
        per-tenant spec takes its bank as ``head_params``.
      cache: the static decode cache (B rows); the loop writes into it.
      sampler: greedy ``Sampler``.
      masked: carry a (B,) active mask (engine slots, EOS retirement).
      eos_id / pad_id: with ``masked``, rows that emit ``eos_id`` retire;
        retired rows emit ``pad_id``.
      per_slot: (B,) positions advancing where active (the engine), else
        one scalar depth advancing by 1 a step (static generate).
      head_params: a per-tenant head's bank and ``"tenant_ids"`` (from
        ``HeadCache.bank_params``): the bank tensors are captured as they
        are, ``tenant_ids`` into a static buffer that :meth:`load` fills.

    Everything runs in ``torch.inference_mode``: the static buffers are
    inference tensors, and a cache given in (an engine's pool) is written
    in place there.  On a CUDA device the constructor warms the step up on
    a side stream and captures it.  The warm-up runs with ``active`` all False where the
    step is masked, so the cache keeps its contents; an unmasked loop's
    cache holds nothing of value until :meth:`load_cache`.

    Raises:
      ValueError: ``eos_id`` without ``masked``.
      RuntimeError: the capture failed (e.g. a host sync in the step).
    """

    @torch.inference_mode()
    def __init__(self, params: dict, cfg: ModelConfig, head, cache: dict,
                 *, sampler: Optional[Sampler] = None, masked: bool,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 per_slot: bool, head_params: Optional[dict] = None):
        if eos_id is not None and not masked:
            raise ValueError("eos_id retirement needs masked=True")
        leaf = next(iter(cache["periods"].values()))[0]
        self.device, b = leaf.device, leaf.shape[1]
        self.params, self.cfg, self.head, self.cache = params, cfg, head, cache
        self.sampler = sampler or Sampler()
        self.eos_id, self.pad_id, self.per_slot = eos_id, pad_id, per_slot
        self.tok = torch.zeros(b, dtype=torch.int64, device=self.device)
        self.pos = torch.zeros((b,) if per_slot else (), dtype=torch.int64,
                               device=self.device)
        self.active = (torch.ones(b, dtype=torch.bool, device=self.device)
                       if masked else None)
        self.head_params = None
        if head_params is not None:
            self.head_params = dict(head_params)
            self.head_params["tenant_ids"] = head_params["tenant_ids"].clone()
        self.graph = None
        self.launches = [0] * len(COUNTED)      # per replay, by COUNTED
        if self.device.type == "cuda":
            self._capture()

    def _step(self) -> None:
        logits, _ = serve_step_(self.params, self.cache, self.tok[:, None],
                                self.cfg, head=self.head, active=self.active,
                                pos=self.pos, head_params=self.head_params)
        nxt = self.sampler.sample(logits)
        if self.active is not None:
            nxt = torch.where(self.active, nxt, self.pad_id)
        if self.per_slot:
            self.pos.add_(self.active if self.active is not None else 1)
        else:
            self.pos.add_(1)
        if self.eos_id is not None:
            self.active &= nxt != self.eos_id
        self.tok.copy_(nxt)

    def _capture(self) -> None:
        dev = self.device
        if self.active is not None:
            self.active.fill_(False)     # the warm-up writes no row's state
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step()
        after = _counts()
        # The capture recorded these launches; none of them ran.
        for w, n in zip(COUNTED, before):
            w.launches = n
        self.launches = [a - b for a, b in zip(after, before)]
        self.graph = graph

    def launches_per_step(self) -> dict:
        """Each wrapper's launches in one step of the captured graph (by
        wrapper name; empty off the card)."""
        return {w.__name__: n for w, n in zip(COUNTED, self.launches) if n}

    @torch.inference_mode()
    def load_cache(self, cache: dict) -> None:
        """Copy ``cache`` (same shapes) into the static cache."""
        for name, c in self.cache["periods"].items():
            for dst, src in zip(c, cache["periods"][name]):
                dst.copy_(src)

    @torch.inference_mode()
    def load(self, tok, pos, active=None, head_params=None) -> None:
        """Set the carry for the next :meth:`run`: the last tokens (B,),
        ``pos`` (scalar or (B,)), ``active`` (B,) of a masked loop, and a
        per-tenant head's binding (its bank must be the captured one)."""
        dev = self.device
        self.tok.copy_(torch.as_tensor(tok).to(dev, torch.int64))
        self.pos.copy_(torch.as_tensor(pos).to(dev, torch.int64))
        if self.active is not None:
            self.active.copy_(torch.as_tensor(active).to(dev, torch.bool))
        if head_params is not None:
            for k, v in head_params.items():
                if k != "tenant_ids" and v is not self.head_params[k]:
                    raise ValueError(
                        f"head_params[{k!r}] is not the bank tensor this "
                        "decode loop was built on")
            self.head_params["tenant_ids"].copy_(head_params["tenant_ids"])

    @torch.inference_mode()
    def run(self, k: int) -> torch.Tensor:
        """``k`` decode steps from the loaded carry; returns the (k, B)
        int64 token block on the device (no host sync)."""
        if k < 1:
            raise ValueError(f"a megastep needs k >= 1, got {k}")
        block = torch.empty((k, self.tok.shape[0]), dtype=torch.int64,
                            device=self.device)
        for i in range(k):
            if self.graph is None:
                self._step()
            else:
                self.graph.replay()
                for w, n in zip(COUNTED, self.launches):
                    w.launches += n
            block[i].copy_(self.tok)
        return block


def _empty_like(cache: dict) -> dict:
    return {"periods": {name: type(c)(*(torch.empty_like(x) for x in c))
                        for name, c in cache["periods"].items()}}


def decode_chunks(params: dict, cache: dict, first_logits: torch.Tensor, *,
                  cfg: ModelConfig, head, sampler: Sampler, gen_len: int,
                  start_pos: int, chunk: int, eos_id: Optional[int] = None,
                  pad_id: int = 0, loops: Optional[dict] = None
                  ) -> torch.Tensor:
    """The static-batch decode loop as megasteps of ``chunk`` steps.

    The first token comes from the prefill's ``first_logits``, then the
    remaining ``gen_len - 1`` steps run as ``chunk``-sized megasteps (and
    one shorter remainder).  With ``eos_id``, once every row has retired
    the remaining chunks are skipped and the tail is padding: the host
    loop's early exit at chunk granularity, one host sync a chunk.

    Args:
      cache: the prefilled decode cache (read once, into the loop's own).
      loops: a dict that memoizes the :class:`DecodeLoop` (and its capture)
        per (cfg, head, sampler, cache shapes (B and max_seq), masked,
        eos_id, pad_id, device); a fresh loop is built when None.  The loops hold the
        params and head they were built on, so the dict belongs to one
        model and head (``LM`` keeps one).

    Returns:
      (B, gen_len) int64 tokens (prompt excluded), on the device.
    """
    if chunk < 1:
        raise ValueError(f"decode_chunk must be >= 1, got {chunk}")
    b = first_logits.shape[0]
    masked = eos_id is not None
    shapes = tuple(tuple(leaf.shape) for c in cache["periods"].values()
                   for leaf in c)            # B and max_seq
    key = (cfg, head, sampler, shapes, masked, eos_id, pad_id,
           str(first_logits.device))
    loop = None if loops is None else loops.get(key)
    if loop is None:
        loop = DecodeLoop(params, cfg, head, _empty_like(cache),
                          sampler=sampler, masked=masked, eos_id=eos_id,
                          pad_id=pad_id, per_slot=False)
        if loops is not None:
            loops[key] = loop
    tok0 = sampler.sample(first_logits)
    loop.load_cache(cache)
    loop.load(tok0, start_pos, None if not masked else tok0 != eos_id)
    blocks, todo = [tok0[:, None]], gen_len - 1
    while todo > 0:
        k = min(chunk, todo)
        blocks.append(loop.run(k).T)
        todo -= k
        if masked and todo > 0 and not bool(loop.active.any()):
            blocks.append(torch.full((b, todo), pad_id, dtype=torch.int64,
                                     device=tok0.device))
            break
    return torch.cat(blocks, dim=1)
