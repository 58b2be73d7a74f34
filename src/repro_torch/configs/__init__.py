"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    MLAConfig, MoEConfig, ModelConfig, SSMConfig, EncDecConfig, VLMConfig,
    ShapeConfig, SHAPES, SHAPES_BY_NAME, reduced, shape_applicable)

_ARCH_MODULES: Dict[str, str] = {
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1p5_0p5b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1p5_7b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama_3p2_vision_90b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_family(name: str) -> Dict[str, ModelConfig]:
    """Paper RAG model families: 'qwen3' (Fig. 5) or 'bge' (Fig. 6)."""
    if name == "qwen3":
        return importlib.import_module("repro_torch.configs.qwen3_family").FAMILY
    if name == "bge":
        return importlib.import_module("repro_torch.configs.bge_family").FAMILY
    raise KeyError(f"unknown family {name!r}; known: qwen3, bge")
