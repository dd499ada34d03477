"""Architecture registry: ``--arch <id>`` → ModelConfig, every arch of the
JAX package's registry."""

from __future__ import annotations

import importlib
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
