"""Logit heads: the dense unembed, or the Representer-Sketch head on one of
its decode backends (``fused``, ``two_kernel``, ``ref``); and the
``HeadCache`` that pages per-tenant sketch heads into a bank on the
device."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.sketch_lm_head import (HEAD_BACKENDS, QUANT_MODES,
                                             apply_head, load_head_full,
                                             save_head)
from repro_torch.models.config import SketchHeadConfig
from repro_torch.sharding.ctx import like, replicated


@dataclasses.dataclass(frozen=True)
class DenseHead:
    """The backbone's own ``h · Wᵀ`` unembed; carries no state."""

    kind = "dense"
    needs_hidden = False
    params = None

    def to(self, device) -> "DenseHead":
        return self

    def describe(self) -> str:
        return self.kind


@dataclasses.dataclass(frozen=True)
class SketchHead:
    """The Representer-Sketch head: frozen ``params`` ({"proj", "w", "b",
    "array"} + "scale" when quantized), its config, decode ``backend`` and
    count storage ``quant``.

    ``per_tenant`` declares the multi-tenant binding: the runtime params
    are then a bank (leading axis T on every leaf, from
    :meth:`HeadCache.bank_params`) plus a ``"tenant_ids"`` (B,) leaf that
    maps each batch slot to its tenant's bank row.

    >>> SketchHead(backend="two_kernel", quant="int8").describe()
    'sketch/two_kernel/int8'
    >>> SketchHead(per_tenant=True).describe()
    'sketch/fused/tenants'
    """

    kind = "sketch"
    needs_hidden = True

    cfg: SketchHeadConfig = dataclasses.field(default_factory=SketchHeadConfig)
    backend: str = "fused"
    quant: Optional[str] = None
    per_tenant: bool = False
    params: Optional[dict] = dataclasses.field(default=None, compare=False,
                                               repr=False)

    def __post_init__(self):
        if self.backend not in HEAD_BACKENDS:
            raise ValueError(f"unknown sketch-head backend {self.backend!r}; "
                             f"expected one of {HEAD_BACKENDS}")
        if self.quant not in QUANT_MODES:
            raise ValueError(f"unknown sketch-head quant mode {self.quant!r}; "
                             f"expected one of {QUANT_MODES}")

    def apply(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """Sketched (B, V) f32 logits for (B, d) hiddens on ``backend``; on
        a ``per_tenant`` spec ``params`` is the bank with its
        ``"tenant_ids"`` leaf.  Params placed on a mesh (DTensors) run the
        row-sharded path (the count rows over its ``model`` axis, one
        all-reduce a step)."""
        if params is None:
            raise ValueError("SketchHead.apply needs the frozen head params; "
                             "freeze them with freeze_head or load them with "
                             "SketchHead.load")
        if self.per_tenant:
            if "tenant_ids" not in params:
                raise ValueError(
                    "per_tenant SketchHead.apply needs a 'tenant_ids' leaf "
                    "in params — pass HeadCache.bank_params(slot_tenants)")
            bank = {k: v for k, v in params.items() if k != "tenant_ids"}
            return apply_head(bank, hidden, self.cfg, backend=self.backend,
                              quant=self.quant,
                              tenant_ids=params["tenant_ids"])
        return apply_head(params, hidden, self.cfg, backend=self.backend,
                          quant=self.quant)

    def with_params(self, params: dict) -> "SketchHead":
        return dataclasses.replace(self, params=params)

    def with_backend(self, backend: str) -> "SketchHead":
        return dataclasses.replace(self, backend=backend)

    def to(self, device) -> "SketchHead":
        """This head with its params on ``device``."""
        if self.params is None:
            return self
        return self.with_params({k: v.to(device)
                                 for k, v in self.params.items()})

    def describe(self) -> str:
        """``sketch/<backend>[/<quant>][/tenants]``."""
        base = f"sketch/{self.backend}"
        if self.quant is not None:
            base = f"{base}/{self.quant}"
        return f"{base}/tenants" if self.per_tenant else base

    def save(self, path) -> None:
        """Write params, config, kind, backend and quant as a v2 archive."""
        if self.params is None:
            raise ValueError("cannot save a SketchHead without params")
        save_head(path, self.params, self.cfg, kind=self.kind,
                  backend=self.backend, quant=self.quant)

    @classmethod
    def load(cls, path, device="cuda") -> "SketchHead":
        """A head from an archive of either package, on the backend it was
        saved with (v1 archives: ``fused``)."""
        return load_head(path, device)


def load_head(path, device="cuda") -> SketchHead:
    """Load a saved head; only the ``sketch`` kind has archives."""
    params, cfg, meta = load_head_full(path, device)
    if meta["kind"] != SketchHead.kind:
        raise KeyError(f"head kind {meta['kind']!r} is not ported; only "
                       f"'sketch' archives load")
    return SketchHead(cfg=cfg, backend=meta["backend"], quant=meta["quant"],
                      params=params)


class HeadCache:
    """LRU pager of per-tenant sketch heads into one bank on the device.

    Up to ``capacity`` tenants' frozen head params are resident in a bank:
    one ``(capacity, …)`` tensor per head leaf, on the device of the first
    head loaded.  ``acquire`` pages a tenant in on a miss through
    ``loader`` and pins it (a refcount), so a tenant with live engine slots
    is never evicted mid-decode; ``release`` unpins.  Eviction is LRU over
    unpinned tenants; freed bank rows are reused lowest index first, so
    replays are deterministic.  ``stats`` counts hits, misses, loads and
    evictions.

    Writes into the bank (a load into a freed row, ``publish``) are in
    place, on the current stream, so they follow the decode launches
    already queued there.  What :meth:`tenant_params` returns is a clone
    that no later write changes.

    On a mesh (``mesh=``) the bank's leaves are DTensors placed by
    ``sharding.rules.head_bank_shardings``: each tenant's row is laid out
    as a single-tenant head is (the count rows and scales over ``model``),
    and the tenant axis is never sharded.

    Not thread-safe; the engine drives it from one loop.
    """

    def __init__(self, loader, capacity: int, mesh=None):
        """Args:
          loader: ``loader(tenant) -> dict`` of the tenant's frozen head
            tensors; every head must match the first one's leaves, shapes
            and dtypes.
          capacity: most resident tenants (bank rows), at least 1.
          mesh: the serving ``DeviceMesh`` the bank is placed on, or None.
        """
        if capacity < 1:
            raise ValueError(f"HeadCache capacity must be >= 1, got "
                             f"{capacity}")
        self._loader = loader
        self.capacity = capacity
        self.mesh = mesh
        self._bank: Optional[Dict[str, torch.Tensor]] = None
        self._slot_of: Dict[Any, int] = {}         # tenant -> bank row
        self._refs: Dict[Any, int] = {}            # tenant -> live pins
        self._lru: list = []                       # LRU → MRU residents
        self.stats = {"hits": 0, "misses": 0, "loads": 0, "evictions": 0}

    def _init_bank(self, params: dict) -> None:
        self._bank = {k: torch.zeros((self.capacity, *v.shape),
                                     dtype=v.dtype, device=v.device)
                      for k, v in params.items()}
        if self.mesh is not None:
            from repro_torch.launch.mesh import distribute_tree
            from repro_torch.sharding.rules import head_bank_shardings

            self._bank = distribute_tree(
                self._bank, head_bank_shardings(self._bank, self.mesh),
                self.mesh)

    def _write_slot(self, slot: int, params: dict) -> None:
        extra = set(params) - set(self._bank)
        missing = set(self._bank) - set(params)
        if extra or missing:
            raise ValueError(
                f"tenant head leaves {sorted(params)} differ from the bank's "
                f"{sorted(self._bank)}; all tenants must share one "
                f"quantization mode and config")
        for k, v in params.items():
            if tuple(v.shape) != tuple(self._bank[k].shape[1:]):
                raise ValueError(
                    f"tenant head leaf {k!r} has shape {tuple(v.shape)}, the "
                    f"bank holds {tuple(self._bank[k].shape[1:])}")
        for k, v in params.items():
            row = self._bank[k][slot]
            row.copy_(like(v, row))

    def _touch(self, tenant) -> None:
        if tenant in self._lru:
            self._lru.remove(tenant)
        self._lru.append(tenant)

    def _free_slot(self) -> int:
        used = set(self._slot_of.values())
        for s in range(self.capacity):
            if s not in used:
                return s
        for victim in self._lru:            # least recently used unpinned
            if self._refs.get(victim, 0) == 0:
                slot = self._slot_of.pop(victim)
                self._lru.remove(victim)
                self._refs.pop(victim, None)
                self.stats["evictions"] += 1
                return slot
        raise RuntimeError(
            f"HeadCache: all {self.capacity} resident tenants are pinned "
            f"by live slots; raise capacity or drain requests")

    def acquire(self, tenant) -> int:
        """Pin ``tenant`` resident (paging it in on a miss); returns its bank
        row.  Each ``acquire`` is balanced by one :meth:`release`."""
        if tenant in self._slot_of:
            self.stats["hits"] += 1
            self._refs[tenant] = self._refs.get(tenant, 0) + 1
            self._touch(tenant)
            return self._slot_of[tenant]
        self.stats["misses"] += 1
        params = self._loader(tenant)
        self.stats["loads"] += 1
        if self._bank is None:
            self._init_bank(params)
        slot = self._free_slot()
        self._write_slot(slot, params)
        self._slot_of[tenant] = slot
        self._refs[tenant] = self._refs.get(tenant, 0) + 1
        self._touch(tenant)
        return slot

    def release(self, tenant) -> None:
        """Unpin one reference; the tenant stays resident until evicted."""
        refs = self._refs.get(tenant, 0)
        if refs <= 0:
            raise ValueError(f"release of tenant {tenant!r} with no "
                             f"outstanding acquire")
        self._refs[tenant] = refs - 1

    def slot(self, tenant) -> int:
        """The resident bank row of ``tenant`` (KeyError if paged out)."""
        return self._slot_of[tenant]

    def resident(self) -> list:
        """Resident tenants, least recently used first."""
        return list(self._lru)

    def tenant_params(self, tenant) -> dict:
        """The resident tenant's params: clones of its bank row, which a
        later ``publish`` or eviction does not change."""
        slot = self._slot_of[tenant]
        return {k: replicated(v[slot]).clone() for k, v in self._bank.items()}

    def publish(self, tenant, params: dict) -> None:
        """Overwrite a resident tenant's bank row: the refresh commit.

        The copy is queued on the current stream behind the decodes
        already launched, so they read the old row and the next tick reads
        the new one.
        """
        if tenant not in self._slot_of:
            raise KeyError(f"tenant {tenant!r} is not resident; acquire it "
                           f"before publishing a refresh")
        self._write_slot(self._slot_of[tenant], params)
        self._touch(tenant)

    def bank_params(self, tenant_ids) -> dict:
        """The bank (its own tensors, not copies) plus ``"tenant_ids"``:
        the (B,) int32 bank row of each engine slot, on the bank's device —
        what a ``per_tenant`` :class:`SketchHead` takes as params."""
        if self._bank is None:
            raise RuntimeError("HeadCache is empty; acquire a tenant first")
        out = dict(self._bank)
        dev = next(iter(self._bank.values())).device
        out["tenant_ids"] = torch.as_tensor(tenant_ids, dtype=torch.int32,
                                            device=dev)
        return out
