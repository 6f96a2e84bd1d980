"""Architecture registry of the port (``repro/configs/registry.py``): the
configs it runs and each shape cell's input shapes."""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPE_PRESETS, ModelConfig, ShapeConfig

# The dense, hybrid and moe configs the port runs, in the reference's
# order; the other families' configs (xlstm, whisper, llava) are not ported
# (ROADMAP Queue 1).
ARCH_IDS = [
    "qwen2-72b",
    "qwen2-7b",
    "deepseek-67b",
    "granite-20b",
    "hymba-1.5b",
    "deepseek-v2-lite-16b",
    "kimi-k2-1t-a32b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_MODULES["paper-bert"] = "paper_bert"


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"{name!r} is not ported yet; ported: {list_archs()} "
                       f"and 'paper-bert'")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def shape_preset(name: str) -> ShapeConfig:
    return SHAPE_PRESETS[name]


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> tuple[dict, dict]:
    """(shape tree, logical-axes tree) of one (arch, shape) cell's train or
    prefill inputs (``registry.py:45``): tensors on the ``meta`` device
    stand for the reference's ``jax.ShapeDtypeStruct``. The decode cells
    (a token and the whole KV cache) need the cache specs of the
    reference's ``serve/kv_cache.py``, which only its dry-run reads: not
    ported (ROADMAP Queue 1, multi-device)."""
    if shape.kind not in ("train", "prefill"):
        raise NotImplementedError("decode batch specs come with the dry-run "
                                  "(ROADMAP Queue 1, multi-device)")
    if cfg.family not in ("dense", "moe", "hybrid"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    b, s = shape.global_batch, shape.seq_len
    return ({"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")},
            {"tokens": ("batch", "seq")})
