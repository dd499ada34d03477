"""Architecture registry: ``--arch <id>`` → ModelConfig, every arch of the
JAX package's registry, and the dry run's step shapes and cells."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1b6",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
}

#: (seq_len, global_batch, step kind) of each dry-run shape.
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def arch_names() -> List[str]:
    return list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    """The full (or ``smoke``) config of an architecture.

    Raises:
      KeyError: ``name`` is unknown; the message names the ported archs.
    """
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported to repro_torch; "
                       f"ported: {list(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG


def cells(include_skipped: bool = False):
    """Yield the (arch, shape) dry-run cells: ``long_500k`` only for a
    ``subquadratic`` arch unless ``include_skipped``."""
    for arch in _MODULES:
        cfg = get_config(arch)
        for shape in SHAPES:
            if (shape == "long_500k" and not cfg.subquadratic
                    and not include_skipped):
                continue
            yield arch, shape
