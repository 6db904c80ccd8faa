"""Architecture registry: one module per assigned architecture.

``get_config("<arch-id>")`` accepts the dashed public id (e.g.
``qwen2-vl-72b``) or the underscored module name.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

ARCH_IDS: List[str] = [
    "qwen2-vl-72b",
    "mistral-nemo-12b",
    "smollm-360m",
    "gemma3-12b",
    "qwen3-4b",
    "xlstm-350m",
    "hymba-1.5b",
    "seamless-m4t-medium",
    "granite-moe-1b-a400m",
    "qwen2-moe-a2.7b",
    # paper's own evaluation family (small-scale stand-in used in experiments)
    "llama-mini",
]

_cache: Dict[str, ModelConfig] = {}


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    key = arch_id.replace("_", "-")
    # tolerate either separator
    for cand in (arch_id, key):
        if cand in _cache:
            return _cache[cand]
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(key)}")
    cfg = mod.CONFIG
    _cache[key] = cfg
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
