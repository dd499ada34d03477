"""The serving surface: ``LM``, its logit heads, the per-tenant
``HeadCache`` and the sampler."""

from repro_torch.api.heads import DenseHead, HeadCache, SketchHead, load_head
from repro_torch.api.lm import LM
from repro_torch.api.sampler import Sampler

__all__ = ["LM", "DenseHead", "HeadCache", "SketchHead", "Sampler",
           "load_head"]
