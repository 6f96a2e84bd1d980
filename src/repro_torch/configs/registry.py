"""Architecture registry of the port (the configs it can serve so far)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = ["qwen2-7b", "granite-20b", "deepseek-v2-lite-16b"]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"{name!r} is not ported yet; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG
