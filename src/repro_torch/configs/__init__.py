"""Assigned-architecture configs (--arch <id>) of the LM appendix: a copy of
``repro.configs``, plain data the port may not import (DESIGN.md §9)."""
from typing import Dict

from .base import (LONG_CONTEXT_FAMILIES, SHAPES, ModelConfig, ShapeConfig,
                   cell_is_runnable)


def _load() -> Dict[str, ModelConfig]:
    from . import (falcon_mamba_7b, granite_3_8b, grok_1_314b,
                   kimi_k2_1t_a32b, minitron_4b, pixtral_12b, qwen1_5_32b,
                   whisper_small, yi_9b, zamba2_7b)
    mods = [minitron_4b, granite_3_8b, qwen1_5_32b, yi_9b, pixtral_12b,
            falcon_mamba_7b, whisper_small, kimi_k2_1t_a32b, grok_1_314b,
            zamba2_7b]
    return {m.CONFIG.name: m.CONFIG for m in mods}


ARCHS: Dict[str, ModelConfig] = _load()


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
