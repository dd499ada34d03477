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
  its tick while a slot is free; greedy streams do not change with K.
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

Scheduling is the JAX package's ``launch/engine.py``; the model compute
sits behind ``EngineBackend``.  Not ported here: speculative decode
(ROADMAP module item 6), the paged pool (item 7) and seeded sampling
(item 5).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.heads import DenseHead
from repro_torch.api.sampler import Sampler
from repro_torch.launch.decode_loop import DecodeLoop
from repro_torch.launch.steps import prefill_step, serve_step_
from repro_torch.models.config import ModelConfig
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
    given per call), and a megastep of K of them."""

    def __init__(self, params, cfg: ModelConfig, *, head=None,
                 device="cuda"):
        self.params = params
        self.cfg = cfg
        self.head = head or DenseHead()
        self.device = torch.device(device)
        self._loops: Dict[tuple, DecodeLoop] = {}

    def init_pool(self, n_slots: int, max_seq: int) -> dict:
        return init_decode_cache(self.cfg, n_slots, max_seq,
                                 device=self.device)

    def prefill(self, prompts: np.ndarray, max_seq: int):
        """Bulk-prefill (G, P) prompts → ((G, V) logits, filled cache)."""
        tokens = torch.as_tensor(prompts, device=self.device).long()
        fresh = init_decode_cache(self.cfg, tokens.shape[0], max_seq,
                                  device=self.device)
        return prefill_step(self.params, tokens, self.cfg, fresh)

    def insert(self, pool: dict, filled: dict, slots) -> dict:
        """``filled``'s rows into ``pool``'s ``slots``, in place."""
        return cache_slot_insert_(self.cfg, pool, filled, slots)

    def reset(self, pool: dict, slots) -> dict:
        """``slots`` of ``pool`` zeroed, in place."""
        return cache_slot_reset_(self.cfg, pool, slots)

    def expand_rows(self, filled: dict, inv) -> dict:
        return cache_expand_rows(self.cfg, filled, inv)

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

    def megastep(self, pool: dict, tokens: np.ndarray, pos: np.ndarray,
                 active: np.ndarray, k: int, sampler: Sampler,
                 eos_id: Optional[int], head_params=None):
        """K decode steps of every slot, the sampler and EOS retirement on
        the device, written into ``pool`` (``launch/decode_loop.py``; one
        capture per pool and spec on the card).  Returns the (k, n_slots)
        token block, ``pool``, and the last tokens and ``pos`` as numpy
        arrays: the block and the carry come in one copy."""
        key = (id(pool), sampler, eos_id)      # the loop holds its pool
        loop = self._loops.get(key)
        if loop is None:
            loop = DecodeLoop(self.params, self.cfg, self.head, pool,
                              sampler=sampler, masked=True, eos_id=eos_id,
                              per_slot=True, head_params=head_params)
            self._loops[key] = loop
        loop.load(tokens, pos, active, head_params)
        out = torch.cat([loop.run(k), loop.pos[None]]).cpu().numpy()
        return (out[:k].astype(np.int32), pool, out[k - 1].astype(np.int32),
                out[k].astype(np.int32))


class ServeEngine:
    """Continuous-batching engine over a ``backend`` and ``n_slots`` cache
    rows.  ``submit()`` requests, then ``run()`` (or ``step()`` tick by
    tick); ``finished[rid]`` holds each request's generated tokens (prompt
    excluded).  Greedy: the sampler takes each row's first maximum.

    ``decode_chunk=K`` (> 1) decodes each tick as a megastep of up to K
    steps (``_chunk_for``) through ``backend.megastep``.

    Raises:
      NotImplementedError: ``spec_decode`` or ``paged`` (later slices of
        the port).
    """

    def __init__(self, backend, n_slots: int, max_seq: int, *,
                 eos_id: Optional[int] = None,
                 sampler: Optional[Sampler] = None, decode_chunk: int = 1,
                 spec_decode: int = 0, paged: bool = False,
                 head_cache=None):
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        if decode_chunk > 1 and not hasattr(backend, "megastep"):
            raise ValueError("decode_chunk > 1 needs a backend with a "
                             "megastep; this backend has none")
        if spec_decode:
            raise NotImplementedError(
                "speculative decode (spec_decode) is not ported yet: ROADMAP "
                "module item 6")
        if paged:
            raise NotImplementedError(
                "the paged cache pool is not ported yet: ROADMAP module "
                "item 7")
        self.backend = backend
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.sampler = sampler or Sampler()
        self.decode_chunk = decode_chunk
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
                      "dedup_saved": 0}

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
        return self.sampler.sample(logits).cpu().numpy().astype(np.int32)

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

    def _admit(self) -> None:
        """FIFO admission into free slots; equal-length prompts arriving
        together prefill as one batch, identical prompts in it once."""
        batch = self._pop_admission_batch()
        by_len: Dict[int, List[Request]] = {}
        for r in batch:
            by_len.setdefault(len(r.prompt), []).append(r)
        for plen, group in by_len.items():
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

    def _retire(self, slot: int) -> None:
        rid = self.sched.retire(slot)
        self.finished[rid] = self.outputs[rid]
        if self.head_cache is not None and self.slot_tenant[slot] is not None:
            self.head_cache.release(self.slot_tenant[slot])
            self.slot_tenant[slot] = None
        self._pending_reset.append(slot)
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

    def _chunk_for(self, active_slots: List[int]) -> int:
        """This tick's megastep length: ``decode_chunk`` clamped so that no
        occupied slot overshoots its budget and, while a slot is free, no
        queued arrival waits past its arrival tick."""
        chunk = min(self.decode_chunk,
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
        block, self.pool, self.last_tok, self.pos = self.backend.megastep(
            self.pool, self.last_tok, self.pos, active, chunk, self.sampler,
            self.eos_id, head_params=self._head_params_now())
        self.stats["host_syncs"] += 1
        self.stats["decode_steps"] += chunk
        for s in active_slots:
            for i in range(chunk):
                self.stats["active_slot_steps"] += 1
                if self._emit(s, int(block[i, s])):
                    break

    def _step(self) -> None:
        self._admit()
        active_slots = self.sched.active_slots()
        advanced = 1
        if active_slots:
            active = np.zeros(self.n_slots, bool)
            active[active_slots] = True
            self.stats["megasteps"] += 1
            if self.decode_chunk > 1:
                advanced = self._chunk_for(active_slots)
                self._decode_megastep(active, active_slots, advanced)
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
            self.pool = self.backend.reset(self.pool, self._pending_reset)
            self._pending_reset = []
        self.now += advanced

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
                spec_decode: int = 0, paged: bool = False, head_cache=None,
                device="cuda") -> ServeEngine:
    """An engine over a real model on ``device``: the serving entry point
    behind ``LM.engine``/``LM.serve``.  ``head_cache=`` (a ``HeadCache``)
    makes it per-tenant: ``head`` is then the shared ``SketchHead`` spec
    (config, backend, quant) while each slot decodes through its tenant's
    bank row; every ``submit`` needs ``tenant=``, and
    ``engine.refresh(tenant, …)``/``engine.publish(tenant)`` fold live
    traffic into a tenant's head."""
    if head_cache is not None:
        from repro_torch.api.heads import SketchHead
        if not isinstance(head, SketchHead):
            raise ValueError(
                "head_cache= (per-tenant serving) needs a SketchHead spec "
                f"for head=; got "
                f"{type(head).__name__ if head is not None else None}")
        head = dataclasses.replace(head, params=None, per_tenant=True)
    backend = EngineBackend(params, cfg, head=head, device=device)
    return ServeEngine(backend, n_slots, max_seq, eos_id=eos_id,
                       sampler=sampler, decode_chunk=decode_chunk,
                       spec_decode=spec_decode, paged=paged,
                       head_cache=head_cache)
