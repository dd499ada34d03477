"""The ``LM`` facade: backbone params + config + a logit head, on a device.

    from repro_torch.api import LM, SketchHead

    lm = LM.from_config("rwkv6-1.6b")                     # on the card
    tokens = lm.generate(prompts, max_new_tokens=16)
    lm = lm.with_head(SketchHead.load("head.npz"))        # sketched decode
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

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
    """

    params: Any
    cfg: ModelConfig
    head: Any = dataclasses.field(default_factory=DenseHead)
    device: torch.device = torch.device("cuda")

    @classmethod
    def from_config(cls, arch: str, *, smoke: bool = False, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    head=None, params: Any = None) -> "LM":
        """Build an LM from a ported arch config.

        Args:
          arch: a ported architecture name (``repro_torch.configs``).
          smoke: use the arch's CPU-scale smoke variant.
          device: ``"cuda"`` (default) or ``"cpu"``.
          generator: draws the random init (a ``torch.Generator`` on
            ``device``; seed 0 when omitted).
          head: the serving head (dense when omitted).
          params: backbone params to serve instead of a random init.

        Raises:
          KeyError: the arch is not ported.
          RuntimeError: ``device`` is CUDA and no card is present.
        """
        from repro_torch.configs import get_config
        from repro_torch.models.model import init_model

        cfg = get_config(arch, smoke=smoke)
        device = check_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device).manual_seed(0)
            params = init_model(cfg, generator)
        return cls(params, cfg, (head or DenseHead()).to(device), device)

    def with_head(self, head) -> "LM":
        """The same model serving through ``head`` (moved to this device)."""
        return dataclasses.replace(self, head=head.to(self.device))

    def generate(self, prompts, max_new_tokens: int, *,
                 eos_id: Optional[int] = None, pad_id: int = 0
                 ) -> torch.Tensor:
        """Greedy bulk prefill + decode: (B, P) prompts → (B, P +
        max_new_tokens) int64 tokens (prompt included).  With ``eos_id``,
        a sequence that emits it is finished and later positions hold
        ``pad_id``."""
        from repro_torch.launch.serve import generate

        prompts = torch.as_tensor(prompts, device=self.device).long()
        if prompts.dim() == 1:
            prompts = prompts[None]
        return generate(self.params, self.cfg, prompts, max_new_tokens,
                        head=self.head, eos_id=eos_id, pad_id=pad_id)
