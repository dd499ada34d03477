"""Logit heads: the dense unembed, or the Representer-Sketch head on one of
its decode backends (``fused``, ``two_kernel``, ``ref``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.sketch_lm_head import (HEAD_BACKENDS, QUANT_MODES,
                                             apply_head, load_head_full,
                                             save_head)
from repro_torch.models.config import SketchHeadConfig


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

    >>> SketchHead(backend="two_kernel", quant="int8").describe()
    'sketch/two_kernel/int8'
    """

    kind = "sketch"
    needs_hidden = True

    cfg: SketchHeadConfig = dataclasses.field(default_factory=SketchHeadConfig)
    backend: str = "fused"
    quant: Optional[str] = None
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
        """Sketched (B, V) f32 logits for (B, d) hiddens on ``backend``."""
        if params is None:
            raise ValueError("SketchHead.apply needs the frozen head params; "
                             "freeze them with freeze_head or load them with "
                             "SketchHead.load")
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
        base = f"sketch/{self.backend}"
        return base if self.quant is None else f"{base}/{self.quant}"

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
