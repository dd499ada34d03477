"""The serving surface: ``LM``, its logit heads, the per-tenant
``HeadCache`` and the sampler; and the paper's core objects,
``RepresenterSketch`` and ``SketchConfig``."""

from repro_torch.api.heads import (HEAD_KINDS, DenseHead, HeadCache,
                                   LogitHead, SketchHead, get_head_class,
                                   load_head, register_head)
from repro_torch.api.lm import LM
from repro_torch.api.sampler import Sampler
from repro_torch.core.sketch import RepresenterSketch, SketchConfig

__all__ = ["LM", "LogitHead", "DenseHead", "HeadCache", "SketchHead",
           "Sampler", "HEAD_KINDS", "register_head", "get_head_class",
           "load_head", "RepresenterSketch", "SketchConfig"]
