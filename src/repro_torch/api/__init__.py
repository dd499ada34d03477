"""The serving surface: ``LM``, its logit heads and the sampler."""

from repro_torch.api.heads import DenseHead, SketchHead, load_head
from repro_torch.api.lm import LM
from repro_torch.api.sampler import Sampler

__all__ = ["LM", "DenseHead", "SketchHead", "Sampler", "load_head"]
