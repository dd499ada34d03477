"""Continuous-batching serve engine: a pool of decode-cache slots and FIFO
admission.

The static path (``launch.serve.generate``) runs one batch from prefill to
its last token.  This engine owns ``n_slots`` decode-cache rows and a
request queue instead:

* **admit** — whenever a slot is free and a request has arrived, its
  prompt is bulk-prefilled into a fresh cache (the static path's prefill)
  and the filled rows are copied into the pool (``cache_slot_insert_``);
  arrivals with equal prompt lengths prefill as one batch, and identical
  prompts in that batch prefill once (``cache_expand_rows``).
* **decode** — one ``serve_step_`` per tick advances every occupied slot;
  an active-slot mask keeps free slots' rows bitwise unchanged.  With
  ``decode_chunk=K`` the tick is a megastep instead
  (``launch/decode_loop.py``: K steps, the sampler and EOS retirement on
  the device, a CUDA graph of one step replayed K times on the card),
  clamped so that no slot overshoots its budget and no arrival waits past
  its tick while a slot is free; the streams (greedy or seeded) do not
  change with K.
* **retire** — a sequence leaves on EOS or its own ``max_new_tokens``; the
  tick's retired slots are reset together (``cache_slot_reset_``) to fresh
  rows.

``EngineBackend`` keeps the pool one set of tensors for the engine's life:
admission, decode and reset write into it in place and hand back the same
tensors (a captured step holds their pointers); the engine rebinds
``self.pool`` to what a backend returns, as the JAX package's does, so a
functional backend (the tests' numpy fake) works unchanged.

With ``head_cache=`` (a ``repro_torch.api.HeadCache``) the engine serves
per-tenant sketch heads: every request names its tenant, its slot decodes
through that tenant's bank row, and ``refresh``/``publish`` fold live
traffic into a tenant's head with double buffering.

With ``spec_decode=K`` each tick is a speculative tick instead
(``decode_loop.SpecLoop``): the engine's head drafts up to K tokens for
every occupied slot, the dense head verifies them, and the ``m`` steps
every active slot agrees on commit; the clock advances by ``m``, and the
streams are the dense engine's.

With ``paged=True`` the attention and MLA caches live in page arenas
addressed through a host page table (``launch/paging.py``), a recurrent state (rwkv,
mamba) in one row a slot: identical prompts hit the prefix cache and skip
their prefill (the entry's pages are mapped shared, its state rows and
first logits restored), a shared page is copied before a decode write
lands on it (copy-on-write), and each tick gathers every slot's view, runs
the same in-place decode step and commits the written position back.  The
streams are the contiguous engine's.

Token selection is the ``sampler``'s (greedy by default): a seeded one
walks the JAX package's key chain, the root key from the engine's
construction, one sample (one split) per admission group over its rows in
arrival order and per decode step over every slot; megasteps and
speculative ticks carry the key on the device and hand it back.

Scheduling is the JAX package's ``launch/engine.py``; the model compute
sits behind ``EngineBackend``.  As there, an arch with cross-attention
layers (encoder states) is refused: a request carries no states.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.heads import DenseHead
from repro_torch.api.sampler import Sampler
from repro_torch.launch.decode_loop import DecodeLoop, SpecLoop
from repro_torch.launch.steps import (_constrain_cache, place_cache,
                                     prefill_step, serve_step_)
from repro_torch.models import blocks
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.ctx import serving_method
from repro_torch.models.model import (cache_expand_rows, cache_slot_insert_,
                                      cache_slot_reset_, init_decode_cache)


@dataclasses.dataclass
class Request:
    """One request: prompt tokens, generation budget, the engine tick at
    which it is visible, and (per-tenant engines) its tenant."""
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new_tokens: int
    arrival: int = 0
    tenant: Optional[object] = None


class RequestQueue:
    """Arrival-ordered request queue, FIFO on ties: a binary heap keyed on
    ``(arrival, submission index)``."""

    def __init__(self):
        self._heap: List[tuple] = []
        self._pushed = 0

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (req.arrival, self._pushed, req))
        self._pushed += 1

    def peek(self) -> Request:
        return self._heap[0][2]

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        return len(self._heap)


class SlotScheduler:
    """Slot-pool bookkeeping: a slot is never assigned twice, every
    admitted request retires once, and ``n_free + n_active == n_slots``.
    Free slots go out lowest index first, so runs are deterministic."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots))
        self.owner: Dict[int, int] = {}       # slot -> rid
        self.retired: Dict[int, int] = {}     # rid -> retire count

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return len(self.owner)

    def active_slots(self) -> List[int]:
        return sorted(self.owner)

    def admit(self, rid: int) -> int:
        if not self._free:
            raise RuntimeError("no free slot")
        if rid in self.owner.values() or rid in self.retired:
            raise RuntimeError(f"request {rid} already admitted")
        slot = min(self._free)
        self._free.remove(slot)
        self.owner[slot] = rid
        return slot

    def retire(self, slot: int) -> int:
        rid = self.owner.pop(slot)
        self.retired[rid] = self.retired.get(rid, 0) + 1
        self._free.append(slot)
        return rid


class EngineBackend:
    """The model compute behind the engine, on ``device``: prefill into a
    fresh cache, slot insert / reset / row expansion into the pool in
    place, one decode step through ``head`` (or through ``head_params``
    given per call), and a megastep of K of them.

    Every op runs in ``sharding.ctx.serving(mesh)`` (inference mode off a
    mesh).  On a ``mesh`` the params and head arrays are DTensors
    (``LM.with_mesh``), the pool is placed by ``cache_shardings`` (the
    paged arenas by ``page_pool_shardings``) and every op keeps it placed:
    the in-place slot ops write each rank's own rows, and the logits come
    back replicated.

    Raises:
      NotImplementedError: ``cfg`` has encoder states (``xattn`` layers),
        which the engine's requests do not carry (as in the JAX package).
    """

    def __init__(self, params, cfg: ModelConfig, *, head=None,
                 device="cuda", mesh=None):
        if cfg.n_encoder_tokens:
            raise NotImplementedError(
                "engine serving of encoder-conditioned archs needs "
                "per-request encoder states; use launch.serve.generate")
        self.params = params
        self.cfg = cfg
        self.head = head or DenseHead()
        self.device = torch.device(device)
        self.mesh = mesh
        self._loops: Dict[tuple, DecodeLoop] = {}

    @serving_method
    def init_pool(self, n_slots: int, max_seq: int) -> dict:
        return place_cache(init_decode_cache(self.cfg, n_slots, max_seq,
                                             device=self.device),
                           self.mesh, n_slots)

    @serving_method
    def prefill(self, prompts: np.ndarray, max_seq: int):
        """Bulk-prefill (G, P) prompts → ((G, V) logits, filled cache)."""
        tokens = torch.as_tensor(prompts, device=self.device).long()
        fresh = place_cache(init_decode_cache(self.cfg, tokens.shape[0],
                                              max_seq, device=self.device),
                            self.mesh, tokens.shape[0])
        return prefill_step(self.params, tokens, self.cfg, fresh)

    @serving_method
    def insert(self, pool: dict, filled: dict, slots) -> dict:
        """``filled``'s rows into ``pool``'s ``slots``, in place."""
        return cache_slot_insert_(self.cfg, pool, filled, slots)

    @serving_method
    def reset(self, pool: dict, slots) -> dict:
        """``slots`` of ``pool`` zeroed, in place."""
        return cache_slot_reset_(self.cfg, pool, slots)

    @serving_method
    def expand_rows(self, filled: dict, inv) -> dict:
        return cache_expand_rows(self.cfg, filled, inv)

    @serving_method
    def decode(self, pool: dict, tokens: np.ndarray, pos: np.ndarray,
               active: np.ndarray, head_params=None):
        """One decode step of every slot, written into ``pool`` → ((n_slots,
        V) logits, pool)."""
        dev = self.device
        return serve_step_(
            self.params, pool,
            torch.as_tensor(tokens, device=dev).long()[:, None], self.cfg,
            head=self.head, active=torch.as_tensor(active, device=dev),
            pos=torch.as_tensor(pos, device=dev), head_params=head_params)

    @serving_method
    def megastep(self, pool: dict, tokens: np.ndarray, pos: np.ndarray,
                 active: np.ndarray, key: torch.Tensor, k: int,
                 sampler: Sampler, eos_id: Optional[int], head_params=None):
        """K decode steps of every slot, the sampler (from chain ``key``)
        and EOS retirement on the device, written into ``pool``
        (``launch/decode_loop.py``; one capture per pool and spec on the
        card).  Returns the (k, n_slots) token block, ``pool``, the last
        tokens and ``pos`` as numpy arrays (the block and the carry come in
        one copy), and the chain's key after the K samples."""
        memo = (id(pool), sampler, eos_id)     # the loop holds its pool
        loop = self._loops.get(memo)
        if loop is None:
            loop = DecodeLoop(self.params, self.cfg, self.head, pool,
                              sampler=sampler, masked=True, eos_id=eos_id,
                              per_slot=True, head_params=head_params)
            self._loops[memo] = loop
        loop.load(tokens, pos, active, head_params, key=key)
        out = torch.cat([loop.run(k), loop.pos[None]]).cpu().numpy()
        return (out[:k].astype(np.int32), pool, out[k - 1].astype(np.int32),
                out[k].astype(np.int32), loop.key.clone())


    @serving_method
    def spec_megastep(self, pool: dict, tokens: np.ndarray, pos: np.ndarray,
                      active: np.ndarray, key: torch.Tensor, k: int,
                      sampler: Sampler, eos_id: Optional[int],
                      k_max: Optional[int] = None):
        """One speculative tick of every slot (``decode_loop.SpecLoop``, one
        loop per pool and spec, ``k_max`` deep): ``k`` draft steps through
        the head, the dense verify, the commit of ``m`` steps, all on the
        device, written into ``pool``, from chain ``key``.  Returns the
        (k, n_slots) verify block, ``m``, each slot's accepted drafts,
        ``pool``, the last tokens and ``pos`` (from one copy to the host),
        and the key after the ``m`` committed samples."""
        memo = ("spec", id(pool), sampler, eos_id)
        loop = self._loops.get(memo)
        if loop is None:
            loop = SpecLoop(self.params, self.cfg, self.head, pool,
                            k=k_max or k, sampler=sampler, masked=True,
                            eos_id=eos_id, per_slot=True)
            self._loops[memo] = loop
        loop.load(tokens, pos, active, key=key)
        block, m, acc, _ = loop.run(k)
        b = block.shape[1]
        out = torch.cat([m.reshape(1), block.reshape(-1), acc, loop.tok,
                         loop.pos]).cpu().numpy().astype(np.int32)
        rest = out[1 + k * b:]
        return (out[1:1 + k * b].reshape(k, b), int(out[0]), rest[:b], pool,
                rest[b:2 * b], rest[2 * b:], loop.key.clone())

    def close(self) -> None:
        """Release the megastep and speculative loops (their captured
        graphs, graph pools and static buffers)."""
        for loop in self._loops.values():
            loop.close()
        self._loops.clear()

    # -- the paged pool ------------------------------------------------------

    def paged_geometries(self, max_seq: int) -> list:
        """The distinct (size, ring) sequence geometries of the paged layers:
        where each family writes a position, for the write-page logic."""
        geoms = {blocks.paged_geometry(self.cfg, k, max_seq)
                 for k in set(self.cfg.pattern)}
        return sorted(g for g in geoms if g is not None)

    @serving_method
    def init_paged(self, n_slots: int, max_seq: int, page_size: int,
                   num_pages: int):
        """The paged engine's device state: (page arenas, state rows)."""
        del max_seq
        return (place_cache(model_mod.init_paged_cache(
                    self.cfg, num_pages, page_size, device=self.device),
                    self.mesh, paged=True),
                place_cache(model_mod.init_paged_state(
                    self.cfg, n_slots, device=self.device),
                    self.mesh, n_slots))

    @serving_method
    def paged_decode(self, pages: dict, state: dict, table: np.ndarray,
                     tokens: np.ndarray, pos: np.ndarray, active: np.ndarray,
                     *, max_seq: int, page_size: int, head_params=None):
        """One paged decode tick: each slot's view gathered through the page
        table, the state rows merged in, the same in-place decode step as
        the contiguous engine's on that tree (the state is written where it
        lives), then the written position committed back to the arenas.
        Returns ((n_slots, V) logits, pages, state)."""
        del page_size
        dev = self.device
        pt = torch.as_tensor(table, device=dev)
        posd = torch.as_tensor(pos, device=dev).long()
        view = _constrain_cache(
            model_mod.paged_gather_cache(self.cfg, pages, pt, max_seq))
        full = model_mod.merge_paged_view(self.cfg, view, state)
        logits, _ = serve_step_(
            self.params, full,
            torch.as_tensor(tokens, device=dev).long()[:, None], self.cfg,
            head=self.head, active=torch.as_tensor(active, device=dev),
            pos=posd, head_params=head_params)
        model_mod.paged_commit_cache(self.cfg, pages, view, pt, posd, max_seq)
        return logits, pages, state

    @serving_method
    def paged_insert(self, pages: dict, filled: dict, pt_rows: np.ndarray,
                     *, max_seq: int, page_size: int) -> dict:
        """Freshly prefilled rows into their newly mapped pages, in place."""
        del max_seq, page_size
        return model_mod.paged_insert_cache(
            self.cfg, pages, filled, torch.as_tensor(pt_rows,
                                                     device=self.device))

    @serving_method
    def page_copy(self, pages: dict, src_ids, dst_ids, *, max_seq: int,
                  page_size: int) -> dict:
        """The copy-on-write fork: pages ``src_ids`` → ``dst_ids`` in every
        arena, in place."""
        del max_seq, page_size
        dev = self.device
        return model_mod.paged_copy_pages(
            self.cfg, pages, torch.as_tensor(src_ids, device=dev).long(),
            torch.as_tensor(dst_ids, device=dev).long())

    @serving_method
    def state_rows(self, filled: dict, row: int):
        """Copies of one prefilled row's recurrent state (what a
        prefix-cache entry keeps), or None for a model without rwkv or
        mamba layers."""
        rows = model_mod.extract_state_rows(self.cfg, filled, row)
        if all(c is None for _, c in model_mod.cache_stacks(rows)):
            return None
        return rows

    @serving_method
    def state_restore(self, state: dict, entry_state: dict,
                      slot: int) -> dict:
        """A prefix entry's state rows into ``slot``, in place."""
        return cache_slot_insert_(self.cfg, state, entry_state, [slot])


class ServeEngine:
    """Continuous-batching engine over a ``backend`` and ``n_slots`` cache
    rows.  ``submit()`` requests, then ``run()`` (or ``step()`` tick by
    tick); ``finished[rid]`` holds each request's generated tokens (prompt
    excluded), picked by ``sampler`` (greedy when omitted; a seeded one
    carries its key chain in ``_key``, rooted at construction).

    ``decode_chunk=K`` (> 1) decodes each tick as a megastep of up to K
    steps (``_chunk_for``) through ``backend.megastep``; ``spec_decode=K``
    as a speculative tick of up to K draft steps through
    ``backend.spec_megastep``; ``paged=True`` keeps the caches in a page
    pool with a prefix cache (``page_size`` tokens a page, ``num_pages``
    pages, sized from ``n_slots`` and ``max_seq`` when omitted).

    Raises:
      ValueError: ``decode_chunk < 1``, ``spec_decode < 0``,
        ``spec_decode`` with ``decode_chunk > 1`` or ``head_cache``,
        ``paged`` with ``decode_chunk > 1`` or ``spec_decode``,
        ``page_size < 1``, or a backend without the ops a mode needs.
    """

    def __init__(self, backend, n_slots: int, max_seq: int, *,
                 eos_id: Optional[int] = None,
                 sampler: Optional[Sampler] = None, decode_chunk: int = 1,
                 spec_decode: int = 0, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 head_cache=None):
        if head_cache is not None and spec_decode:
            raise ValueError("spec_decode and per-tenant heads are mutually "
                             "exclusive: the draft/verify tick cannot rebind "
                             "per-slot tenant heads mid-draft")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        if spec_decode < 0:
            raise ValueError(f"spec_decode must be >= 0, got {spec_decode}")
        if spec_decode and decode_chunk > 1:
            raise ValueError("spec_decode and decode_chunk > 1 are mutually "
                             "exclusive: the speculative tick already "
                             "advances up to K tokens")
        if decode_chunk > 1 and not hasattr(backend, "megastep"):
            raise ValueError("decode_chunk > 1 needs a backend with a "
                             "megastep; this backend has none")
        if spec_decode and not hasattr(backend, "spec_megastep"):
            raise ValueError("spec_decode needs a backend with a "
                             "spec_megastep; this backend has none")
        if paged:
            if decode_chunk > 1:
                raise ValueError("paged=True runs the host decode loop; "
                                 "decode_chunk > 1 is not supported")
            if spec_decode:
                raise ValueError("paged=True and spec_decode are mutually "
                                 "exclusive")
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if not hasattr(backend, "init_paged"):
                raise ValueError("paged=True needs a backend with the paged "
                                 "pool ops (init_paged, paged_decode, ...); "
                                 "this backend has none")
        self.backend = backend
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.sampler = sampler or Sampler()
        self._key = self.sampler.init_key(getattr(backend, "device", "cpu"))
        self.decode_chunk = decode_chunk
        self.spec_decode = spec_decode
        self.paged = paged
        self.page_size = page_size
        self.pool = None
        if paged:
            from repro_torch.launch.paging import PagePool, PrefixCache
            npp = -(-max_seq // page_size)          # page-table width
            if num_pages is None:
                # Every slot's whole budget plus a prefix-cache working set;
                # LRU eviction absorbs the rest.
                num_pages = 1 + (n_slots + 8) * (npp + 1)
            self.pages, self.state = backend.init_paged(
                n_slots, max_seq, page_size, num_pages)
            self.page_pool = PagePool(num_pages, n_slots, npp)
            self.prefix = PrefixCache(self.page_pool)
            self._geoms = backend.paged_geometries(max_seq)
            self._has_state = any(
                c is not None for _, c in model_mod.cache_stacks(self.state))
        else:
            self.pool = backend.init_pool(n_slots, max_seq)
        self.head_cache = head_cache
        self.slot_tenant: List[Optional[object]] = [None] * n_slots
        self._refresh: Dict = {}            # tenant -> f32 shadow head
        self.sched = SlotScheduler(n_slots)
        self.pos = np.zeros(n_slots, np.int32)         # tokens cached per slot
        self.last_tok = np.zeros(n_slots, np.int32)    # sampled, not cached
        self.remaining = np.zeros(n_slots, np.int32)   # tokens still to emit
        self.queue = RequestQueue()
        self.outputs: Dict[int, List[int]] = {}
        self.finished: Dict[int, List[int]] = {}
        self.now = 0                                   # engine tick clock
        self._next_rid = 0
        self._rids: set = set()
        self._pending_reset: List[int] = []            # slots retired this tick
        self.stats = {"refreshes": 0, "publishes": 0, "decode_steps": 0,
                      "active_slot_steps": 0, "admitted": 0, "retired": 0,
                      "prefill_batches": 0, "megasteps": 0, "host_syncs": 0,
                      "verify_calls": 0, "draft_tokens": 0,
                      "accepted_draft_tokens": 0, "dedup_saved": 0,
                      "prefix_hits": 0, "prefix_queries": 0,
                      "page_allocs": 0, "cow_copies": 0, "pages_in_use": 0,
                      "pages_in_use_peak": 0}

    # -- request intake ----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, arrival: int = 0,
               rid: Optional[int] = None, tenant=None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.head_cache is not None and tenant is None:
            raise ValueError("this engine serves per-tenant heads "
                             "(head_cache=); every submit needs tenant=")
        if self.head_cache is None and tenant is not None:
            raise ValueError("tenant= needs a per-tenant engine — pass "
                             "head_cache= to make_engine/ServeEngine")
        if len(prompt) + max_new_tokens > self.max_seq + 1:
            # The last sampled token is never written back to the cache.
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine's max_seq ({self.max_seq})")
        if rid is None:
            rid = self._next_rid
        if rid in self._rids:
            raise ValueError(f"request id {rid} already submitted")
        self._rids.add(rid)
        self._next_rid = max(self._next_rid, rid) + 1
        self.queue.push(Request(rid, prompt, max_new_tokens, arrival, tenant))
        return rid

    # -- scheduling --------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        self.stats["host_syncs"] += 1
        self._key, toks = self.sampler.sample(
            self._key.to(logits.device), logits)
        return toks.cpu().numpy().astype(np.int32)

    def _pop_admission_batch(self) -> List[Request]:
        batch: List[Request] = []
        while (self.queue and self.queue.peek().arrival <= self.now
               and self.sched.n_free > len(batch)):
            batch.append(self.queue.pop())
        return batch

    def _bind_tenants(self, group: List[Request], slots: np.ndarray) -> None:
        """Pin each admitted request's tenant in the HeadCache and record
        the slot → tenant binding.  Runs before ``_finish_admit``: a request
        that retires at once releases its pin inside ``_retire``."""
        if self.head_cache is None:
            return
        for r, s in zip(group, slots):
            self.head_cache.acquire(r.tenant)
            self.slot_tenant[int(s)] = r.tenant

    def _finish_admit(self, group: List[Request], slots: np.ndarray,
                      first: np.ndarray, plen: int) -> None:
        self.stats["admitted"] += len(group)
        for i, r in enumerate(group):
            s = int(slots[i])
            self.pos[s] = plen
            self.last_tok[s] = first[i]
            self.remaining[s] = r.max_new_tokens - 1
            self.outputs[r.rid] = [int(first[i])]
            if (self.remaining[s] == 0
                    or (self.eos_id is not None
                        and int(first[i]) == self.eos_id)):
                self._retire(s)

    @staticmethod
    def _by_len(batch: List[Request]) -> Dict[int, List[Request]]:
        by_len: Dict[int, List[Request]] = {}
        for r in batch:
            by_len.setdefault(len(r.prompt), []).append(r)
        return by_len

    def _admit(self) -> None:
        """FIFO admission into free slots; equal-length prompts arriving
        together prefill as one batch, identical prompts in it once."""
        if self.paged:
            return self._admit_paged()
        batch = self._pop_admission_batch()
        for plen, group in self._by_len(batch).items():
            uniq: Dict[bytes, int] = {}
            rows: List[np.ndarray] = []
            inv: List[int] = []
            for r in group:
                key = r.prompt.tobytes()
                if key not in uniq:
                    uniq[key] = len(rows)
                    rows.append(r.prompt)
                inv.append(uniq[key])
            logits, filled = self.backend.prefill(np.stack(rows),
                                                  self.max_seq)
            if len(rows) < len(group):
                logits = logits[torch.as_tensor(inv, device=logits.device)]
                filled = self.backend.expand_rows(filled, inv)
                self.stats["dedup_saved"] += len(group) - len(rows)
            first = self._sample(logits)
            slots = np.asarray([self.sched.admit(r.rid) for r in group])
            self._bind_tenants(group, slots)
            # A slot freed by an immediate retirement earlier in this round
            # may be handed out again: the insert overwrites the whole row,
            # and its deferred reset would clobber the new request.
            self._pending_reset = [s for s in self._pending_reset
                                   if s not in slots]
            self.pool = self.backend.insert(self.pool, filled, slots.tolist())
            self.stats["prefill_batches"] += 1
            self._finish_admit(group, slots, first, plen)

    def _admit_paged(self) -> None:
        """Paged admission: a prefix-cache hit maps the entry's pages shared
        (copy-on-write through the refcounts) and restores its state rows
        and first logits; misses prefill once per distinct prompt, scatter
        into fresh pages and register an entry.  One sample per
        prompt-length group over its rows in arrival order, as the
        contiguous engine samples."""
        batch = self._pop_admission_batch()
        for plen, group in self._by_len(batch).items():
            plans = []                     # (request, kind, key, ref)
            miss_rows: List[np.ndarray] = []
            seen_miss: Dict[bytes, int] = {}
            for r in group:
                key = r.prompt.tobytes()
                entry = self.prefix.get(key)
                if entry is not None:
                    plans.append((r, "hit", key, entry))
                elif key in seen_miss:
                    plans.append((r, "dup", key, seen_miss[key]))
                    self.stats["dedup_saved"] += 1
                else:
                    seen_miss[key] = len(miss_rows)
                    miss_rows.append(r.prompt)
                    plans.append((r, "miss", key, seen_miss[key]))
            logits_u = filled = None
            if miss_rows:
                logits_u, filled = self.backend.prefill(np.stack(miss_rows),
                                                        self.max_seq)
                self.stats["prefill_batches"] += 1
            first = self._sample(torch.stack(
                [p[3].logits if p[1] == "hit" else logits_u[p[3]]
                 for p in plans]))
            slots = np.asarray([self.sched.admit(r.rid) for r in group])
            self._bind_tenants(group, slots)
            self._pending_reset = [s for s in self._pending_reset
                                   if s not in slots]
            # Misses first: fresh pages, one scatter for all their rows,
            # then their prefix entries.
            n_alloc = -(-plen // self.page_size)
            miss_slots, miss_pt = [], []
            for p, slot in zip(plans, slots):
                if p[1] != "miss":
                    continue
                ids = self._alloc_pages(n_alloc)
                self.page_pool.map_slot(int(slot), ids, owned=True)
                miss_slots.append(int(slot))
                miss_pt.append(self.page_pool.table[int(slot)].copy())
            if miss_slots:
                self.pages = self.backend.paged_insert(
                    self.pages, filled, np.stack(miss_pt),
                    max_seq=self.max_seq, page_size=self.page_size)
                if self._has_state:
                    self.state = self.backend.insert(self.state, filled,
                                                     miss_slots)
                for p, slot in zip(plans, slots):
                    if p[1] == "miss":
                        self.prefix.register(
                            p[2], self.page_pool.slot_pages(int(slot)),
                            self.backend.state_rows(filled, p[3]),
                            logits_u[p[3]].clone(), plen)
            # Hits and same-batch duplicates share the entry's pages and
            # restore its state rows.
            for p, slot in zip(plans, slots):
                if p[1] == "miss":
                    continue
                entry = p[3] if p[1] == "hit" else self.prefix.peek(p[2])
                self.page_pool.map_slot(int(slot), entry.page_ids,
                                        owned=False)
                if entry.state is not None:
                    self.state = self.backend.state_restore(
                        self.state, entry.state, int(slot))
            self._finish_admit(group, slots, first, plen)
        self._sync_page_stats()

    def _alloc_pages(self, n: int) -> List[int]:
        """``n`` pages, evicting LRU prefix entries until they fit."""
        while True:
            ids = self.page_pool.alloc(n)
            if ids is not None:
                return ids
            if not self.prefix.evict_lru():
                raise RuntimeError(
                    f"page pool exhausted: {n} pages requested, "
                    f"{self.page_pool.n_free} free and nothing left to "
                    f"evict; raise num_pages or lower n_slots/max_seq")

    def _ensure_write_pages(self, active_slots: List[int]) -> None:
        """Before a paged tick, make the page each active slot writes (one
        per sequence geometry) mapped and private: unmapped → a fresh page;
        shared (a prefix entry or another slot refers to it) → a copy
        (COW).  Without the copy, a divergent write would reach every
        sharer."""
        copies = []                         # (src, dst) page-id pairs
        for s in active_slots:
            pos = int(self.pos[s])
            idxs = {(pos % size if ring else min(pos, size - 1))
                    // self.page_size for size, ring in self._geoms}
            for j in sorted(idxs):
                pid = int(self.page_pool.table[s, j])
                if pid == 0:
                    (new,) = self._alloc_pages(1)
                    self.page_pool.map_index(s, j, new)
                elif self.page_pool.refcount[pid] > 1:
                    (new,) = self._alloc_pages(1)
                    self.page_pool.remap(s, j, new)
                    copies.append((pid, new))
                    self.stats["cow_copies"] += 1
        if copies:
            src, dst = zip(*copies)
            self.pages = self.backend.page_copy(
                self.pages, np.asarray(src), np.asarray(dst),
                max_seq=self.max_seq, page_size=self.page_size)

    def _sync_page_stats(self) -> None:
        self.stats["page_allocs"] = self.page_pool.page_allocs
        self.stats["pages_in_use"] = self.page_pool.pages_in_use
        self.stats["pages_in_use_peak"] = self.page_pool.peak_in_use
        self.stats["prefix_hits"] = self.prefix.hits
        self.stats["prefix_queries"] = self.prefix.queries

    def _retire(self, slot: int) -> None:
        rid = self.sched.retire(slot)
        self.finished[rid] = self.outputs[rid]
        if self.head_cache is not None and self.slot_tenant[slot] is not None:
            self.head_cache.release(self.slot_tenant[slot])
            self.slot_tenant[slot] = None
        self._pending_reset.append(slot)
        if self.paged:
            # Unmap the slot's pages: the ones a prefix entry shares stay,
            # the rest return to the free list.
            self.page_pool.clear_slot(slot)
        self.stats["retired"] += 1

    # -- per-tenant heads --------------------------------------------------

    def _head_params_now(self):
        """This tick's head params: the HeadCache bank plus the slot → bank
        row binding (free slots point at row 0; their logits are dropped),
        or ``None`` on a single-tenant engine."""
        if self.head_cache is None:
            return None
        ids = np.zeros(self.n_slots, np.int32)
        for s, t in enumerate(self.slot_tenant):
            if t is not None:
                ids[s] = self.head_cache.slot(t)
        return self.head_cache.bank_params(ids)

    def refresh(self, tenant, hidden: torch.Tensor, *,
                targets: Optional[torch.Tensor] = None,
                alphas: Optional[torch.Tensor] = None,
                lr: float = 1.0) -> None:
        """Fold live-traffic (hidden, logit) pairs into ``tenant``'s head.

        The fold goes into an f32 shadow of the tenant's head, a clone of
        its bank row (dequantized when the bank is int8/int4) that the
        engine owns and updates in place; decodes keep reading the bank row,
        bitwise unchanged, until :meth:`publish`.  Exactly one of ``alphas``
        ((M, V) direct weights) or ``targets`` ((M, V) teacher logits for
        the residual fold, scaled by ``lr``); the tenant must be resident.
        """
        if self.head_cache is None:
            raise ValueError("refresh needs a per-tenant engine — pass "
                             "head_cache= to make_engine/ServeEngine")
        from repro_torch.core.sketch_lm_head import (dequantize_head,
                                                     refresh_head)
        spec = self.backend.head
        with torch.no_grad():
            if tenant not in self._refresh:
                self._refresh[tenant] = dequantize_head(
                    self.head_cache.tenant_params(tenant), spec.quant)
            shadow = self._refresh[tenant]
            self._refresh[tenant] = refresh_head(
                shadow, spec.cfg, hidden, targets=targets, alphas=alphas,
                lr=lr, pred_backend=spec.backend, out=shadow["array"])
        self.stats["refreshes"] += 1

    def pending_refresh(self, tenant) -> dict:
        """The f32 shadow head holding ``tenant``'s refreshes not yet
        published (the engine's own tensors: read, do not write)."""
        if tenant not in self._refresh:
            raise ValueError(f"no pending refresh for tenant {tenant!r}; "
                             f"call engine.refresh(...) first")
        return self._refresh[tenant]

    def publish(self, tenant) -> None:
        """Commit ``tenant``'s pending refreshes: re-quantize the f32 shadow
        to the bank's storage (once per publish, not per refresh) and write
        it into the tenant's bank row between ticks."""
        if tenant not in self._refresh:
            raise ValueError(f"no pending refresh for tenant {tenant!r}; "
                             f"call engine.refresh(...) first")
        from repro_torch.core.sketch_lm_head import quantize_head
        with torch.no_grad():
            params = quantize_head(self._refresh.pop(tenant),
                                   self.backend.head.quant)
            self.head_cache.publish(tenant, params)
        self.stats["publishes"] += 1

    # -- the engine tick ---------------------------------------------------

    def step(self) -> None:
        """One tick: admit into free slots, decode every occupied slot one
        token, retire, and reset the retired slots together."""
        with torch.no_grad():
            self._step()

    def _chunk_for(self, active_slots: List[int],
                   base: Optional[int] = None) -> int:
        """This tick's megastep length: ``base`` (``decode_chunk``, or the
        speculative draft length) clamped so that no occupied slot
        overshoots its budget and, while a slot is free, no queued arrival
        waits past its arrival tick."""
        chunk = min(base or self.decode_chunk,
                    int(min(self.remaining[s] for s in active_slots)))
        if self.queue and self.sched.n_free:
            chunk = min(chunk, max(1, self.queue.peek().arrival - self.now))
        return max(1, chunk)

    def _emit(self, s: int, tok: int) -> bool:
        """Append a decoded token to slot ``s``'s request; retire it on its
        budget or EOS.  Returns whether it retired."""
        self.outputs[self.sched.owner[s]].append(tok)
        self.remaining[s] -= 1
        if (self.remaining[s] == 0
                or (self.eos_id is not None and tok == self.eos_id)):
            self._retire(s)
            return True
        return False

    def _decode_megastep(self, active: np.ndarray, active_slots: List[int],
                         chunk: int) -> None:
        """Advance every occupied slot ``chunk`` tokens in one megastep, then
        walk the (chunk, n_slots) block for retirements (a row that emits
        EOS mid-chunk is frozen on the device; its later entries are
        padding and are skipped)."""
        block, self.pool, self.last_tok, self.pos, self._key = (
            self.backend.megastep(
                self.pool, self.last_tok, self.pos, active, self._key, chunk,
                self.sampler, self.eos_id,
                head_params=self._head_params_now()))
        self.stats["host_syncs"] += 1
        self.stats["decode_steps"] += chunk
        for s in active_slots:
            for i in range(chunk):
                self.stats["active_slot_steps"] += 1
                if self._emit(s, int(block[i, s])):
                    break

    def _decode_spec_megastep(self, active: np.ndarray,
                              active_slots: List[int], draft_k: int) -> int:
        """One speculative tick: ``draft_k`` drafts through the head, the
        dense verify, and the ``m`` committed steps walked as in
        ``_decode_megastep`` (an EOS mid-block retires; a retired row's
        later entries are padding).  Returns ``m``, the clock's advance."""
        block, m, acc, self.pool, self.last_tok, self.pos, self._key = (
            self.backend.spec_megastep(
                self.pool, self.last_tok, self.pos, active, self._key,
                draft_k, self.sampler, self.eos_id, k_max=self.spec_decode))
        self.stats["host_syncs"] += 1
        self.stats["decode_steps"] += draft_k      # the backbone's steps
        self.stats["verify_calls"] += 1
        self.stats["draft_tokens"] += draft_k * len(active_slots)
        self.stats["accepted_draft_tokens"] += int(acc[active_slots].sum())
        for s in active_slots:
            for i in range(m):
                self.stats["active_slot_steps"] += 1
                if self._emit(s, int(block[i, s])):
                    break
        return m

    def _step(self) -> None:
        self._admit()
        active_slots = self.sched.active_slots()
        advanced = 1
        if active_slots:
            active = np.zeros(self.n_slots, bool)
            active[active_slots] = True
            self.stats["megasteps"] += 1
            if self.spec_decode:
                advanced = self._decode_spec_megastep(
                    active, active_slots,
                    self._chunk_for(active_slots, base=self.spec_decode))
            elif self.decode_chunk > 1:
                advanced = self._chunk_for(active_slots)
                self._decode_megastep(active, active_slots, advanced)
            else:
                if self.paged:
                    self._ensure_write_pages(active_slots)
                    logits, self.pages, self.state = self.backend.paged_decode(
                        self.pages, self.state, self.page_pool.table,
                        self.last_tok, self.pos, active,
                        max_seq=self.max_seq, page_size=self.page_size,
                        head_params=self._head_params_now())
                else:
                    logits, self.pool = self.backend.decode(
                        self.pool, self.last_tok, self.pos, active,
                        head_params=self._head_params_now())
                nxt = self._sample(logits)
                self.stats["decode_steps"] += 1
                self.stats["active_slot_steps"] += len(active_slots)
                for s in active_slots:
                    tok = int(nxt[s])
                    self.pos[s] += 1
                    self.last_tok[s] = tok
                    self._emit(s, tok)
        if self._pending_reset:
            if not self.paged:
                self.pool = self.backend.reset(self.pool, self._pending_reset)
            elif self._has_state:
                # The pages were unmapped at retirement (unmapped entries
                # read the zero page); only the state rows are zeroed.
                self.state = self.backend.reset(self.state,
                                                self._pending_reset)
            self._pending_reset = []
        if self.paged:
            self._sync_page_stats()
        self.now += advanced

    def close(self) -> None:
        """Release the backend's captured loops, if it keeps any (on the
        card, their graphs and graph pools); a later megastep or
        speculative tick builds a new one."""
        if hasattr(self.backend, "close"):
            self.backend.close()

    def run(self) -> Dict[int, List[int]]:
        """Tick until the queue drains and every slot retires."""
        while self.queue or self.sched.n_active:
            if not self.sched.n_active and self.queue.peek().arrival > self.now:
                self.now = self.queue.peek().arrival  # idle: jump to arrival
            self.step()
        return self.finished

    @property
    def slot_utilization(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        steps = self.stats["decode_steps"]
        return (self.stats["active_slot_steps"] / (steps * self.n_slots)
                if steps else 0.0)


def make_engine(params, cfg: ModelConfig, n_slots: int, max_seq: int, *,
                head=None, sampler: Optional[Sampler] = None,
                eos_id: Optional[int] = None, decode_chunk: int = 1,
                spec_decode: int = 0, paged: bool = False,
                page_size: int = 16, num_pages: Optional[int] = None,
                head_cache=None, device="cuda", mesh=None) -> ServeEngine:
    """An engine over a real model on ``device``: the serving entry point
    behind ``LM.engine``/``LM.serve``.  ``head_cache=`` (a ``HeadCache``)
    makes it per-tenant: ``head`` is then the shared ``SketchHead`` spec
    (config, backend, quant) while each slot decodes through its tenant's
    bank row; every ``submit`` needs ``tenant=``, and
    ``engine.refresh(tenant, …)``/``engine.publish(tenant)`` fold live
    traffic into a tenant's head.  ``spec_decode``, ``paged``,
    ``page_size`` and ``num_pages`` are :class:`ServeEngine`'s.  On a
    ``mesh`` (a ``DeviceMesh``; the params and head placed on it) the pool
    and every engine op run SPMD over it (:class:`EngineBackend`)."""
    if head_cache is not None:
        from repro_torch.api.heads import SketchHead
        if not isinstance(head, SketchHead):
            raise ValueError(
                "head_cache= (per-tenant serving) needs a SketchHead spec "
                f"for head=; got "
                f"{type(head).__name__ if head is not None else None}")
        head = dataclasses.replace(head, params=None, per_tenant=True)
    backend = EngineBackend(params, cfg, head=head, device=device, mesh=mesh)
    return ServeEngine(backend, n_slots, max_seq, eos_id=eos_id,
                       sampler=sampler, decode_chunk=decode_chunk,
                       spec_decode=spec_decode, paged=paged,
                       page_size=page_size, num_pages=num_pages,
                       head_cache=head_cache)
