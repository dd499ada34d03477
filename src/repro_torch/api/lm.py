"""The ``LM`` facade: backbone params + config + a logit head, on a device.

    from repro_torch.api import LM, Sampler, SketchHead

    lm = LM.from_config("rwkv6-1.6b")                     # on the card
    tokens = lm.generate(prompts, max_new_tokens=16)
    tokens = lm.generate(prompts, 16, sampler=Sampler(temperature=0.9,
                                                      top_k=12, seed=7))
    tokens = lm.generate(prompts, 16, decode_chunk=16)    # one megastep
    tokens = lm.generate(prompts, 16, spec_decode=4)      # drafts, dense verify
    tokens = lm.generate(prompts, 16, encoder_states=enc) # cross-attention archs
    lm = lm.with_mesh("2x2")          # SPMD over a (data, model) mesh
    lm = lm.with_head(SketchHead.load("head.npz"))        # sketched decode
    finished = lm.serve([(prompt, 16, arrival), ...])     # continuous batching
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.api.heads import DenseHead
from repro_torch.models.config import ModelConfig


def check_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device when no card
    is present (entry points never fall back to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return device


@dataclasses.dataclass
class LM:
    """A servable model.

    Attributes:
      params: the backbone parameter tree (``models.model.init_model``).
      cfg: the architecture's ``ModelConfig``.
      head: ``DenseHead`` (default) or a ``SketchHead`` with params.
      device: where params, head params and tokens live.
      mesh: a ``DeviceMesh`` with ``("data", "model")`` axes, or None.
        On a mesh the params and head arrays are DTensors placed by
        ``sharding/rules.py`` (build it with :meth:`from_config` or
        :meth:`with_mesh`), every rank runs the same calls (SPMD), and
        tokens come back replicated, the same on every rank.

    ``generate(decode_chunk=K > 1)`` and ``generate(spec_decode=K)``
    memoize their decode loops in the LM (on the card a captured CUDA
    graph, holding this LM's params and head).  A loop owns the call's
    decode cache, so the memo is bounded: at most one loop per (kind,
    spec depth, sampler, batch size, eos_id/pad_id), a call with another
    ``max_seq`` replacing that loop, and at most
    ``launch.decode_loop.MAX_LOOPS`` (4) loops in all, the least recently
    used dropped first (its cache and graph freed).  ``with_head`` starts
    a new memo.
    """

    params: Any
    cfg: ModelConfig
    head: Any = dataclasses.field(default_factory=DenseHead)
    device: torch.device = torch.device("cuda")
    mesh: Any = None
    _loops: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @classmethod
    def from_config(cls, arch: str, *, smoke: bool = False, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    head=None, params: Any = None,
                    n_layers: Optional[int] = None, mesh=None) -> "LM":
        """Build an LM from a ported arch config.

        Args:
          arch: a ported architecture name (``repro_torch.configs``).
          smoke: use the arch's CPU-scale smoke variant.
          device: ``"cuda"`` (default) or ``"cpu"``.
          generator: draws the random init (a ``torch.Generator`` on
            ``device``; seed 0 when omitted).
          head: the serving head (dense when omitted).
          params: backbone params to serve instead of a random init.
          n_layers: serve the arch at this depth (whole periods of its
            pattern) at full width; the config's own depth when omitted.
          mesh: a ``DeviceMesh`` or a ``"<data>x<model>"`` spec
            (``launch.mesh.parse_mesh``): params and head arrays are
            placed on it by ``sharding/rules.py``.

        Raises:
          KeyError: the arch is not ported.
          RuntimeError: ``device`` is CUDA and no card is present.
          ValueError: a mesh spec the process group cannot make.
        """
        from repro_torch.configs import get_config
        from repro_torch.models.model import init_model

        cfg = get_config(arch, smoke=smoke)
        if n_layers is not None:
            cfg = cfg.scaled(n_layers=n_layers)
        device = check_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device).manual_seed(0)
            params = init_model(cfg, generator)
        lm = cls(params, cfg, (head or DenseHead()).to(device), device)
        return lm.with_mesh(mesh) if mesh is not None else lm

    def with_head(self, head) -> "LM":
        """The same model serving through ``head`` (moved to this device,
        and placed on this LM's mesh)."""
        head = head.to(self.device)
        if self.mesh is not None and head.params is not None:
            from repro_torch.launch.mesh import place_serving_state
            _, head = place_serving_state(None, head, self.mesh)
        return dataclasses.replace(self, head=head)

    def with_mesh(self, mesh) -> "LM":
        """This model placed on a mesh (a ``DeviceMesh`` or a
        ``"<data>x<model>"`` spec), or with ``None`` gathered back to one
        device: params and head arrays as DTensors by the rules, or as
        full plain tensors on ``device``.  Starts a new loop memo."""
        from repro_torch.launch.mesh import (gather_tree, parse_mesh,
                                             place_serving_state)

        mesh = parse_mesh(mesh, self.device.type)
        params, head = self.params, self.head
        if self.mesh is not None:
            params = gather_tree(params, self.device)
            if head.params is not None:
                head = head.with_params(gather_tree(head.params, self.device))
        if mesh is not None:
            params, head = place_serving_state(params, head, mesh)
        return dataclasses.replace(self, params=params, head=head, mesh=mesh)

    def generate(self, prompts, max_new_tokens: int, *,
                 sampler=None, eos_id: Optional[int] = None, pad_id: int = 0,
                 decode_chunk: int = 1, spec_decode: int = 0,
                 return_stats: bool = False, encoder_states=None):
        """Bulk prefill + decode: (B, P) prompts → (B, P + max_new_tokens)
        int64 tokens (prompt included), picked by ``sampler`` (a
        ``Sampler``; greedy when omitted; a seeded one gives the same
        stream at every ``decode_chunk`` and ``spec_decode``).  With ``eos_id``,
        a sequence that emits it is finished and later positions hold
        ``pad_id``.  ``decode_chunk=K`` (> 1) decodes K tokens per
        megastep (``launch/decode_loop.py``), with the same tokens.
        ``spec_decode=K`` (> 0) drafts up to K tokens a tick through this
        LM's head and verifies them with the dense head: the tokens are
        the dense head's, bit for bit; it excludes ``decode_chunk > 1``.
        ``return_stats=True`` returns ``(tokens, stats)``: the decode
        steps, and with ``spec_decode`` the verify calls, draft tokens and
        accepted draft tokens.  ``encoder_states`` (B, T, d_model) are
        what an arch's cross-attention layers attend to (the vision
        frontend is a stub: the caller brings the states)."""
        from repro_torch.launch.serve import generate

        prompts = torch.as_tensor(prompts, device=self.device).long()
        if prompts.dim() == 1:
            prompts = prompts[None]
        if encoder_states is not None:
            encoder_states = torch.as_tensor(encoder_states,
                                             device=self.device)
        return generate(self.params, self.cfg, prompts, max_new_tokens,
                        head=self.head, sampler=sampler, eos_id=eos_id,
                        pad_id=pad_id,
                        decode_chunk=decode_chunk, spec_decode=spec_decode,
                        return_stats=return_stats, loops=self._loops,
                        encoder_states=encoder_states, mesh=self.mesh)

    # -- continuous batching -------------------------------------------------

    def engine(self, n_slots: int, max_seq: int, *,
               sampler=None, eos_id: Optional[int] = None, head_cache=None,
               decode_chunk: int = 1, spec_decode: int = 0,
               paged: bool = False, page_size: int = 16,
               num_pages: Optional[int] = None):
        """A fresh continuous-batching ``ServeEngine`` over this model and
        head, on this LM's device.

        Args:
          n_slots: decode-cache slot-pool size.
          max_seq: per-slot cache length (prompt + generation budget).
          sampler: the sampling policy (greedy when omitted).
          eos_id: optional early-retirement token.
          head_cache: a ``HeadCache`` for per-tenant serving: this LM's
            head (a ``SketchHead``) becomes the shared spec and each slot
            decodes through its request's tenant's bank row; every
            ``submit`` then needs ``tenant=``.
          decode_chunk: tokens decoded per occupied slot between
            admission checks: ``K > 1`` runs each tick as a megastep of up
            to K steps (``launch/decode_loop.py``), with the same greedy
            streams.
          spec_decode: speculative draft length: every tick drafts up to
            K tokens through this LM's head and the dense head verifies
            them, with the dense streams; excludes ``decode_chunk > 1`` and
            ``head_cache``.
          paged: keep the attention caches in a shared page pool with
            per-slot page tables and an exact-prompt prefix cache
            (``launch/paging.py``) instead of contiguous slot rows: the
            same streams, repeated prompts prefill once.  Excludes
            ``decode_chunk > 1`` and ``spec_decode``.
          page_size: tokens a page (paged only).
          num_pages: the page pool's size (paged only; sized from
            ``n_slots`` and ``max_seq`` when omitted).

        Raises:
          ValueError: an excluded combination, a negative ``spec_decode``
            or ``page_size < 1``.
        """
        from repro_torch.launch.engine import make_engine

        return make_engine(self.params, self.cfg, n_slots, max_seq,
                           head=self.head, sampler=sampler, eos_id=eos_id,
                           decode_chunk=decode_chunk, spec_decode=spec_decode,
                           paged=paged, page_size=page_size,
                           num_pages=num_pages, head_cache=head_cache,
                           device=self.device, mesh=self.mesh)

    def serve(self, requests: Iterable, *, n_slots: int = 4,
              max_seq: Optional[int] = None, sampler=None,
              eos_id: Optional[int] = None, decode_chunk: int = 1,
              spec_decode: int = 0, paged: bool = False,
              page_size: int = 16) -> Dict[int, List[int]]:
        """Serve ``(prompt, max_new_tokens[, arrival])`` requests through
        the engine; returns each request's generated tokens (prompt
        excluded) by request id, in submission order from 0.  ``max_seq``
        defaults to the longest request; ``decode_chunk``,
        ``spec_decode``, ``paged`` and ``page_size`` are the engine's (see
        :meth:`engine`)."""
        import numpy as np

        reqs = []
        for r in requests:
            prompt = np.asarray(r[0], np.int32).reshape(-1)
            reqs.append((prompt, int(r[1]), int(r[2]) if len(r) > 2 else 0))
        if not reqs:
            return {}
        if max_seq is None:
            max_seq = max(len(p) + g for p, g, _ in reqs)
        engine = self.engine(n_slots, max_seq, sampler=sampler, eos_id=eos_id,
                             decode_chunk=decode_chunk,
                             spec_decode=spec_decode, paged=paged,
                             page_size=page_size)
        for prompt, max_new, arrival in reqs:
            engine.submit(prompt, max_new, arrival=arrival)
        return engine.run()
