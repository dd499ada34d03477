"""On-device decode megasteps: K decode steps per host round trip.

The per-token loop pays the host for every step: thousands of kernel
launches made from Python, and a sync to sample.  A megastep runs K
steps with the sampler and EOS retirement inside, and only a (K, B) token
block (plus the small carry) crosses to the host, once: the JAX package's
``jitted_megastep`` (a ``lax.scan`` with the cache donated) in PyTorch.

:class:`DecodeLoop` holds one decode step on static buffers: the decode
cache (written in place by ``serve_step_``), the last token, ``pos``,
``active``, for per-tenant heads the slot → bank-row binding and, for an
arch with ``xattn`` layers, the encoder states (``load`` copies them in
before the replays: a captured graph may hold no copy from the host).  On a
CUDA device the step is captured once as a CUDA graph and each megastep
replays it K times, so one capture serves every K; on the CPU the same
step runs eagerly on the same buffers.  A capture that fails raises.

Semantics are the JAX package's, bit for bit inside the port: each step
feeds the previous token through ``serve_step_`` and samples the next
(the argmax, or a seeded draw that splits the carried key once: the
key is a static (2,) device tensor the step updates in place, which
``load`` sets before a run); with ``masked``, retired rows emit
``pad_id`` and their cache rows freeze; a scalar ``pos`` (static generate)
advances by 1 a step, a (B,) ``pos`` (the engine) where a slot is active,
the EOS step included.  The key chain is the one the per-token loop walks,
so a seed gives the same stream at every K.

A replayed graph runs kernels without passing through their Python
wrappers, so the capture records each wrapper's ``launches`` delta and
every replay adds it back: the counts still say what ran on the card.

:class:`SpecLoop` is the speculative twin (the JAX package's
``jitted_spec_megastep``): the serving head drafts K tokens through K
replays of one captured step, each recording its final hidden, its draft
token, its keys before and after its sample, and what the rollback needs
(``models.model.cache_snapshot_``); then, on the device and with no host
sync, the dense head verifies every drafted position
(``dense_verify_logits``, one (B, 1, d) unembed a position, the dense
step's own product) by replaying the sampler on the recorded pre-sample
keys, the longest matching prefix plus the bonus token commits, ``m`` =
the least over active rows, the cache rewinds to step ``m``
(``cache_rollback_``) and the key to step ``m - 1``'s post-sample key.
The tokens are the dense head's, bit for bit, greedy or seeded; the draft
head only sets how many commit a tick.  The host fetches ``m`` with the
block, once a tick.

A loop owns a full decode cache (on the card, a graph pool too), so the
memo that ``generate`` keeps (``LM._loops``) is bounded: one loop per
(kind, batch size, retirement spec), a new ``max_seq`` replacing the old
loop, and at most :data:`MAX_LOOPS` loops, the least recently used
dropped first (:func:`memo_loop`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.sampler import Sampler
from repro_torch.kernels.common import operand_mesh
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.fused_decode.ops import fused_decode_logits
from repro_torch.kernels.lsh_hash.ops import lsh_hash
from repro_torch.kernels.race_query.ops import race_query
from repro_torch.kernels.race_update.ops import race_update
from repro_torch.kernels.sketch_head.ops import sketch_head_logits
from repro_torch.launch.steps import serve_step_
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.ctx import (is_dtensor, like, replicated, serving,
                                     serving_method)
from repro_torch.sharding.local import index_copy_, new_zeros, spec_of

#: The kernel wrappers whose ``launches`` a replay adds to.
COUNTED = (fused_decode_logits, lsh_hash, sketch_head_logits, race_update,
           race_query, flash_attention)

WARMUP_STEPS = 2

#: The most loops a memo keeps (each holds a decode cache).
MAX_LOOPS = 4


def _counts() -> list:
    return [w.launches for w in COUNTED]


class DecodeLoop:
    """One decode step on static buffers, run K times per :meth:`run`.

    Args:
      params / cfg: the backbone.
      head: the serving head (``DenseHead`` or a ``SketchHead``); a
        per-tenant spec takes its bank as ``head_params``.
      cache: the static decode cache (B rows); the loop writes into it.
      sampler: the ``Sampler`` (greedy when omitted).
      masked: carry a (B,) active mask (engine slots, EOS retirement).
      eos_id / pad_id: with ``masked``, rows that emit ``eos_id`` retire;
        retired rows emit ``pad_id``.
      per_slot: (B,) positions advancing where active (the engine), else
        one scalar depth advancing by 1 a step (static generate).
      head_params: a per-tenant head's bank and ``"tenant_ids"`` (from
        ``HeadCache.bank_params``): the bank tensors are captured as they
        are, ``tenant_ids`` into a static buffer that :meth:`load` fills.
      encoder_states: (B, T, d) states of the ``xattn`` layers: copied
        into a static buffer that :meth:`load` refills.

    Everything runs in ``torch.inference_mode`` (on a mesh, a cache of
    DTensors, in ``sharding.ctx.serving``'s no-grad mode): the static
    buffers are inference tensors, and a cache given in (an engine's pool)
    is written in place there.  On a CUDA device the constructor warms the step up on
    a side stream and captures it.  The warm-up runs with ``active`` all False where the
    step is masked, so the cache keeps its contents; an unmasked loop's
    cache holds nothing of value until :meth:`load_cache`.

    Raises:
      ValueError: ``eos_id`` without ``masked``.
      RuntimeError: the capture failed (e.g. a host sync in the step).
    """

    def __init__(self, params: dict, cfg: ModelConfig, head, cache: dict,
                 *, sampler: Optional[Sampler] = None, masked: bool,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 per_slot: bool, head_params: Optional[dict] = None,
                 encoder_states: Optional[torch.Tensor] = None):
        if eos_id is not None and not masked:
            raise ValueError("eos_id retirement needs masked=True")
        self.mesh = operand_mesh(*model.cache_leaves(cache))
        with serving(self.mesh):
            self._setup(params, cfg, head, cache, sampler, eos_id, pad_id,
                        masked, per_slot, head_params, encoder_states)

    def _setup(self, params, cfg, head, cache, sampler, eos_id, pad_id,
               masked, per_slot, head_params, encoder_states) -> None:
        leaf = next(model.cache_leaves(cache))
        self.device, b = leaf.device, leaf.shape[1]
        self.params, self.cfg, self.head, self.cache = params, cfg, head, cache
        self.sampler = sampler or Sampler()
        self.eos_id, self.pad_id, self.per_slot = eos_id, pad_id, per_slot
        self.tok = torch.zeros(b, dtype=torch.int64, device=self.device)
        self.pos = torch.zeros((b,) if per_slot else (), dtype=torch.int64,
                               device=self.device)
        self.active = (torch.ones(b, dtype=torch.bool, device=self.device)
                       if masked else None)
        self.key = self.sampler.init_key(self.device)
        self.head_params = None
        if head_params is not None:
            self.head_params = dict(head_params)
            self.head_params["tenant_ids"] = head_params["tenant_ids"].clone()
        self.enc = (None if encoder_states is None
                    else encoder_states.to(self.device, copy=True))
        self.shapes = _shapes(cache, encoder_states)
        self.graph = None
        self.launches = [0] * len(COUNTED)      # per replay, by COUNTED
        if self.device.type == "cuda":
            self._capture()

    def _step(self) -> None:
        logits, _ = serve_step_(self.params, self.cache, self.tok[:, None],
                                self.cfg, head=self.head, active=self.active,
                                pos=self.pos, head_params=self.head_params,
                                encoder_states=self.enc)
        nxt = self._sample(logits)
        if self.active is not None:
            nxt = torch.where(self.active, nxt, self.pad_id)
        if self.per_slot:
            self.pos.add_(self.active if self.active is not None else 1)
        else:
            self.pos.add_(1)
        if self.eos_id is not None:
            self.active &= nxt != self.eos_id
        self.tok.copy_(nxt)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """The step's tokens; a seeded draw writes the split key back into
        the static ``key``."""
        key, nxt = self.sampler.sample(self.key, logits)
        if key is not self.key:
            self.key.copy_(key)
        return nxt

    def _capture(self) -> None:
        dev = self.device
        if self.active is not None:
            self.active.fill_(False)     # the warm-up writes no row's state
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._warm_step()
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

    def _warm_step(self) -> None:
        """One warm-up step before the capture."""
        self._step()

    def close(self) -> None:
        """Release the captured graph (its private pool), the static
        buffers and the model it holds (params and head), so that a closed
        loop keeps no device memory alive; the loop cannot run after this."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.cache = self.head_params = self.enc = None
        self.params = self.head = None

    def _replay(self) -> None:
        """One step: a replay of the captured graph (adding each wrapper's
        recorded launches), or the step itself off the card."""
        if self.graph is None:
            self._step()
            return
        self.graph.replay()
        for w, n in zip(COUNTED, self.launches):
            w.launches += n

    def launches_per_step(self) -> dict:
        """Each wrapper's launches in one step of the captured graph (by
        wrapper name; empty off the card)."""
        return {w.__name__: n for w, n in zip(COUNTED, self.launches) if n}

    @serving_method
    def load_cache(self, cache: dict) -> None:
        """Copy ``cache`` (same shapes) into the static cache."""
        for dst, src in zip(model.cache_leaves(self.cache),
                            model.cache_leaves(cache)):
            dst.copy_(like(src, dst))

    @serving_method
    def load(self, tok, pos, active=None, head_params=None,
             key=None, encoder_states=None) -> None:
        """Set the carry for the next :meth:`run`: the last tokens (B,),
        ``pos`` (scalar or (B,)), ``active`` (B,) of a masked loop, a
        per-tenant head's binding (its bank must be the captured one),
        the sampler's chain ``key`` and the encoder states (each kept
        from the last run when None)."""
        dev = self.device
        if key is not None:
            self.key.copy_(key)
        if encoder_states is not None:
            want = None if self.enc is None else tuple(self.enc.shape)
            if want != tuple(encoder_states.shape):
                raise ValueError(f"this decode loop holds encoder states of "
                                 f"shape {want}, got "
                                 f"{tuple(encoder_states.shape)}")
            self.enc.copy_(encoder_states)
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

    @serving_method
    def run(self, k: int) -> torch.Tensor:
        """``k`` decode steps from the loaded carry; returns the (k, B)
        int64 token block on the device (no host sync)."""
        if k < 1:
            raise ValueError(f"a megastep needs k >= 1, got {k}")
        block = torch.empty((k, self.tok.shape[0]), dtype=torch.int64,
                            device=self.device)
        for i in range(k):
            self._replay()
            block[i].copy_(self.tok)
        return block


class SpecLoop(DecodeLoop):
    """Speculative decode on static buffers: K draft steps through the
    serving head (one captured step replayed), the dense verify, the
    acceptance and the rollback, per :meth:`run`.

    Args (besides :class:`DecodeLoop`'s, without ``head_params``):
      k: the most draft steps a tick (the snapshot buffers' depth).
      record_logits: keep each draft step's (B, V) logits in
        ``draft_logits`` and each tick's verify logits in
        ``verify_logits`` (for checks; off when serving).

    The draft step records, before it writes, what the rollback needs
    (``model.cache_snapshot_`` into ``snap``), then its hidden and draft
    token; ``step`` (a device index) counts the steps of the tick.  The
    warm-up before the capture runs with ``active`` all False where the
    step is masked, so the cache keeps its contents; its snapshot and
    hidden writes go to the static buffers, which a tick overwrites before
    it reads them.
    """

    def __init__(self, params: dict, cfg: ModelConfig, head, cache: dict,
                 *, k: int, sampler: Optional[Sampler] = None, masked: bool,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 per_slot: bool, record_logits: bool = False,
                 encoder_states: Optional[torch.Tensor] = None):
        if k < 1:
            raise ValueError(f"a spec loop needs k >= 1, got {k}")
        with serving(operand_mesh(*model.cache_leaves(cache))):
            self._setup_spec(cfg, cache, k, record_logits)
        super().__init__(params, cfg, head, cache, sampler=sampler,
                         masked=masked, eos_id=eos_id, pad_id=pad_id,
                         per_slot=per_slot, encoder_states=encoder_states)

    def _setup_spec(self, cfg, cache, k, record_logits) -> None:
        leaf = next(model.cache_leaves(cache))
        dev, b = leaf.device, leaf.shape[1]
        self.k = k
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        # On a mesh the hiddens keep the decode step's batch layout, so
        # the verify's unembed runs the dense step's own local products.
        self.hiddens = new_zeros(leaf, (k, b, cfg.d_model), torch.float32,
                                 (None, spec_of(leaf)[1], None)
                                 if is_dtensor(leaf) else None)
        self.drafts = torch.zeros((k, b), dtype=torch.int64, device=dev)
        self.pre_keys = torch.zeros((k, 2), dtype=torch.int64, device=dev)
        self.post_keys = torch.zeros((k, 2), dtype=torch.int64, device=dev)
        self.snap = model.init_spec_snapshot(cfg, cache, k)
        self.draft_logits = self.verify_logits = None
        if record_logits:
            self.draft_logits = torch.zeros((k, b, cfg.vocab_size),
                                            dtype=torch.float32, device=dev)

    def _warm_step(self) -> None:
        self.step.zero_()               # keep the step index inside the buffers
        self._step()

    def close(self) -> None:
        super().close()
        self.snap = self.hiddens = self.drafts = self.draft_logits = None
        self.verify_logits = self.pre_keys = self.post_keys = None

    def _step(self) -> None:
        b = self.tok.shape[0]
        model.cache_snapshot_(self.cfg, self.cache, self.snap, self.step,
                              model._slot_positions(self.pos, b, self.device))
        logits, _, hidden = serve_step_(
            self.params, self.cache, self.tok[:, None], self.cfg,
            head=self.head, active=self.active, pos=self.pos,
            return_hidden=True, encoder_states=self.enc)
        self.pre_keys.index_copy_(0, self.step, self.key[None])
        nxt = self._sample(logits)
        self.post_keys.index_copy_(0, self.step, self.key[None])
        if self.active is not None:
            nxt = torch.where(self.active, nxt, self.pad_id)
        if self.per_slot:
            self.pos.add_(self.active if self.active is not None else 1)
        else:
            self.pos.add_(1)
        index_copy_(self.hiddens, 0, self.step, hidden[None])
        self.drafts.index_copy_(0, self.step, nxt[None])
        if self.draft_logits is not None:
            self.draft_logits.index_copy_(0, self.step, logits[None])
        self.tok.copy_(nxt)
        self.step.add_(1)

    @serving_method
    def run(self, k: int):
        """One tick of ``k`` (<= the loop's depth) draft steps from the
        loaded carry, verified and committed on the device.

        Returns device tensors ``(block, m, acc, adv)``: the (k, B) verify
        tokens, of which rows < ``m`` (0-d) are committed (``pad_id`` past
        a row's EOS and on inactive rows), each row's committed accepted
        drafts (B,) and its emitted tokens (B,).  The carry (cache,
        ``tok``, ``pos``, ``active``) is left at the committed step."""
        if not 1 <= k <= self.k:
            raise ValueError(f"a spec tick needs 1 <= k <= {self.k}, got {k}")
        pos_in = self.pos.clone()
        self.step.zero_()
        for _ in range(k):
            self._replay()
        dense = replicated(model.dense_verify_logits(
            self.params, self.hiddens[:k], self.cfg))          # (k, B, V)
        if self.draft_logits is not None:
            self.verify_logits = dense
        # The sampler replayed on each draft step's pre-sample key: where
        # the prefix matched, the dense draw dense decode would make.
        verify = torch.stack([self.sampler.sample(self.pre_keys[i], d)[1]
                              for i, d in enumerate(dense)])
        active = self.active
        if active is not None:
            verify = torch.where(active[None], verify, self.pad_id)
        drafts = self.drafts[:k]
        a = torch.cumprod((drafts == verify).long(), dim=0).sum(0)
        n = (a + 1).clamp(max=k)
        if active is not None:
            n = torch.where(active, n, k)     # parked rows set no limit
        m = n.min()
        steps = torch.arange(k, device=self.device)[:, None]
        if active is not None:
            hits = (verify == self.eos_id if self.eos_id is not None
                    else torch.zeros_like(verify, dtype=torch.bool))
            prior = hits.long().cumsum(0) - hits.long()       # EOS before i
            alive = active[None] & (prior == 0)
        else:
            alive = torch.ones_like(verify, dtype=torch.bool)
        committed = alive & (steps < m)
        block = torch.where(committed, verify, self.pad_id)
        adv = committed.long().sum(0)
        acc = torch.minimum(a, adv)
        if active is not None and self.eos_id is not None:
            active &= ~(hits & (steps < m)).any(0)
        model.cache_rollback_(self.cfg, self.cache, self.snap, m, k)
        last = (m - 1).reshape(1)
        self.tok.copy_(block.index_select(0, last)[0])
        self.key.copy_(self.post_keys.index_select(0, last)[0])
        self.pos.copy_(pos_in + (adv if self.per_slot else m))
        return block, m, acc, adv


def _shapes(cache: dict, encoder_states=None) -> tuple:
    """The static buffers' shapes: the cache's leaves, and the encoder
    states' (None without them)."""
    return (tuple(tuple(leaf.shape) for leaf in model.cache_leaves(cache)),
            None if encoder_states is None else tuple(encoder_states.shape))


def _zeros_like(cache: dict, device) -> dict:
    """A zero cache of ``cache``'s shapes and dtypes on ``device`` (the
    template may live on the meta device)."""
    return model.map_cache(
        lambda x: torch.zeros(x.shape, dtype=x.dtype, device=device), cache)


def memo_loop(loops: Optional[dict], key: tuple, shapes: tuple, build):
    """The loop memoized under ``key`` if its cache has ``shapes``, else
    ``build()``; a loop of other shapes (another ``max_seq``) is closed
    before the new one is built, and beyond :data:`MAX_LOOPS` the least
    recently used loops are closed first, so a memo holds at most
    MAX_LOOPS decode caches and never two under one key.  ``loops=None``
    builds a loop that is not kept."""
    if loops is None:
        return build()
    loop = loops.pop(key, None)
    if loop is not None and loop.shapes != shapes:
        loop.close()
        loop = None
    if loop is None:
        while len(loops) >= MAX_LOOPS:
            loops.pop(next(iter(loops))).close()
        loop = build()
    loops[key] = loop                       # most recently used last
    return loop


def generate_loop(params: dict, cfg: ModelConfig, *, head, sampler: Sampler,
                  template: dict, device, masked: bool,
                  eos_id: Optional[int] = None, pad_id: int = 0,
                  spec_k: int = 0, loops: Optional[dict] = None,
                  encoder_states: Optional[torch.Tensor] = None, mesh=None):
    """The static-batch loop over a decode cache shaped as ``template``
    (a cache, or one made on the meta device): a :class:`DecodeLoop`, or
    with ``spec_k`` a :class:`SpecLoop` of that depth, from the memo
    ``loops`` (one loop per kind, depth, batch size and retirement spec;
    see :func:`memo_loop`).  ``generate`` prefills into the loop's own
    cache (``loop.cache``), so no second cache is made.  With
    ``encoder_states`` the loop keeps a static buffer of their shape, which
    ``load`` fills.  On a ``mesh`` (by default the mesh of a ``template``
    of DTensors) the loop's cache is placed by ``cache_shardings``."""
    from repro_torch.launch.steps import place_cache

    if mesh is None:
        mesh = operand_mesh(*model.cache_leaves(template))
    device = torch.device(device)
    b = next(model.cache_leaves(template)).shape[1]
    key = ("spec" if spec_k else "chunk", spec_k, cfg, head, sampler, b,
           masked, eos_id, pad_id, str(device), id(mesh))

    def build():
        cache = place_cache(_zeros_like(template, device), mesh, b)
        enc = (None if encoder_states is None
               else torch.zeros_like(encoder_states, device=device))
        if spec_k:
            return SpecLoop(params, cfg, head, cache, k=spec_k,
                            sampler=sampler, masked=masked, eos_id=eos_id,
                            pad_id=pad_id, per_slot=False,
                            encoder_states=enc)
        return DecodeLoop(params, cfg, head, cache, sampler=sampler,
                          masked=masked, eos_id=eos_id, pad_id=pad_id,
                          per_slot=False, encoder_states=enc)

    return memo_loop(loops, key, _shapes(template, encoder_states), build)


def decode_chunks(params: dict, cache: dict, first_logits: torch.Tensor, *,
                  cfg: ModelConfig, head, sampler: Sampler, gen_len: int,
                  start_pos: int, chunk: int, eos_id: Optional[int] = None,
                  pad_id: int = 0, loops: Optional[dict] = None,
                  stats: Optional[dict] = None,
                  encoder_states: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The static-batch decode loop as megasteps of ``chunk`` steps.

    The first token comes from the prefill's ``first_logits``, then the
    remaining ``gen_len - 1`` steps run as ``chunk``-sized megasteps (and
    one shorter remainder).  With ``eos_id``, once every row has retired
    the remaining chunks are skipped and the tail is padding: the host
    loop's early exit at chunk granularity, one host sync a chunk.

    Args:
      cache: the prefilled decode cache: the loop's own ``loop.cache``
        (``generate`` prefills into it), or another cache of its shapes,
        which is copied in.
      loops: the memo of :func:`generate_loop` (``LM`` keeps one); a
        fresh loop is built when None.  The loops hold the params and head
        they were built on, so the dict belongs to one model and head.
      stats: a dict that gets the decode steps run (``decode_steps``).
      encoder_states: (B, T, d) states of the ``xattn`` layers.

    Returns:
      (B, gen_len) int64 tokens (prompt excluded), on the device.
    """
    if chunk < 1:
        raise ValueError(f"decode_chunk must be >= 1, got {chunk}")
    b = first_logits.shape[0]
    masked = eos_id is not None
    loop = generate_loop(params, cfg, head=head, sampler=sampler,
                         template=cache, device=first_logits.device,
                         masked=masked, eos_id=eos_id, pad_id=pad_id,
                         loops=loops, encoder_states=encoder_states)
    if cache is not loop.cache:
        loop.load_cache(cache)
    key, tok0 = sampler.sample(sampler.init_key(first_logits.device),
                               first_logits)
    loop.load(tok0, start_pos, None if not masked else tok0 != eos_id,
              key=key, encoder_states=encoder_states)
    blocks, todo, steps = [tok0[:, None]], gen_len - 1, 0
    while todo > 0:
        k = min(chunk, todo)
        blocks.append(loop.run(k).T)
        todo, steps = todo - k, steps + k
        if masked and todo > 0 and not bool(loop.active.any()):
            blocks.append(torch.full((b, todo), pad_id, dtype=torch.int64,
                                     device=tok0.device))
            break
    if stats is not None:
        stats["decode_steps"] = steps
    return torch.cat(blocks, dim=1)


def spec_decode_chunks(params: dict, cache: dict, first_logits: torch.Tensor,
                       *, cfg: ModelConfig, head, sampler: Sampler,
                       gen_len: int, start_pos: int, spec_k: int,
                       eos_id: Optional[int] = None, pad_id: int = 0,
                       loops: Optional[dict] = None,
                       encoder_states: Optional[torch.Tensor] = None):
    """The static-batch speculative decode loop (``generate(spec_decode=K)``).

    As :func:`decode_chunks`, but each tick is a :class:`SpecLoop` tick of
    ``min(spec_k, tokens still to emit)`` draft steps, committing its
    ``m`` verified tokens; the host fetches ``m`` with the block (one sync
    a tick).  The first token comes from the prefill's dense logits.

    Returns ``(tokens, stats)``: (B, gen_len) int64 tokens (prompt
    excluded) and the backbone's draft steps (``decode_steps``),
    ``verify_calls``, ``draft_tokens`` and ``accepted_draft_tokens``.
    """
    if spec_k < 1:
        raise ValueError(f"spec_decode must be >= 1, got {spec_k}")
    b = first_logits.shape[0]
    masked = eos_id is not None
    loop = generate_loop(params, cfg, head=head, sampler=sampler,
                         template=cache, device=first_logits.device,
                         masked=masked, eos_id=eos_id, pad_id=pad_id,
                         spec_k=spec_k, loops=loops,
                         encoder_states=encoder_states)
    if cache is not loop.cache:
        loop.load_cache(cache)
    key, tok0 = sampler.sample(sampler.init_key(first_logits.device),
                               first_logits)
    loop.load(tok0, start_pos, None if not masked else tok0 != eos_id,
              key=key, encoder_states=encoder_states)
    blocks, todo = [tok0[:, None]], gen_len - 1
    stats = {"decode_steps": 0, "verify_calls": 0, "draft_tokens": 0,
             "accepted_draft_tokens": 0}
    while todo > 0:
        kk = min(spec_k, todo)
        block, m, acc, _ = loop.run(kk)
        parts = [m.reshape(1), acc.sum().reshape(1), block.reshape(-1)]
        if masked:
            parts.append(loop.active.any().long().reshape(1))
        host = torch.cat(parts).cpu()                   # the tick's one sync
        m = int(host[0])
        blocks.append(host[2:2 + kk * b].reshape(kk, b)[:m].T.to(tok0.device))
        stats["decode_steps"] += kk
        stats["verify_calls"] += 1
        stats["draft_tokens"] += kk * b
        stats["accepted_draft_tokens"] += int(host[1])
        todo -= m
        if masked and todo > 0 and not bool(host[-1]):
            blocks.append(torch.full((b, todo), pad_id, dtype=torch.int64,
                                     device=tok0.device))
            break
    return torch.cat(blocks, dim=1), stats
