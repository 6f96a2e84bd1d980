"""Architecture registry of the port (``repro/configs/registry.py``): the
configs it runs and each shape cell's input shapes (train, prefill and
decode cells)."""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPE_PRESETS, ModelConfig, ShapeConfig

# Every config of the reference's registry, in its order.
ARCH_IDS = [
    "qwen2-72b",
    "qwen2-7b",
    "deepseek-67b",
    "granite-20b",
    "xlstm-350m",
    "whisper-base",
    "hymba-1.5b",
    "deepseek-v2-lite-16b",
    "kimi-k2-1t-a32b",
    "llava-next-34b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_MODULES["paper-bert"] = "paper_bert"

ENCODER_SEQ = 1500  # whisper's stub frame count (``registry.py:29``)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {list_archs()} "
                       f"and 'paper-bert'")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def shape_preset(name: str) -> ShapeConfig:
    return SHAPE_PRESETS[name]


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> tuple[dict, dict]:
    """(shape tree, logical-axes tree) of one (arch, shape) cell's inputs
    (``registry.py:45``): tensors on the ``meta`` device stand for the
    reference's ``jax.ShapeDtypeStruct``. Train and prefill cells take the
    full sequence: Whisper's batch carries ``frames`` (b, ENCODER_SEQ,
    d_model) fp32 beside the tokens, LLaVA's ``patches`` (b, p, 1024) fp32
    and s - p tokens. Decode cells take one new token (b, 1) and the whole
    cache of ``serve/kv_cache.py:cache_specs`` in the compute dtype (a
    spec's own dtype where it has one)."""
    from repro_torch.models.model import torch_dtype
    from repro_torch.models.params import abstract_params, logical_axes
    from repro_torch.serve.kv_cache import cache_specs

    b, s = shape.global_batch, shape.seq_len

    def meta(*shape_, dtype=torch.float32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "decode":
        cspecs = cache_specs(cfg, b, s)
        return ({"tokens": meta(b, 1, dtype=torch.int32),
                 "cache": abstract_params(cspecs, dtype=torch_dtype(cfg.compute_dtype))},
                {"tokens": ("cache_batch", None), "cache": logical_axes(cspecs)})
    specs: dict = {}
    axes: dict = {}
    if cfg.family == "audio":
        specs["frames"] = meta(b, ENCODER_SEQ, cfg.d_model)
        axes["frames"] = ("batch", None, None)
    elif cfg.family == "vlm":
        # the patch prefix takes up to half the sequence (``registry.py:57``)
        p = min(cfg.num_patches, s // 2)
        specs["patches"] = meta(b, p, 1024)
        axes["patches"] = ("batch", None, None)
        s -= p
    specs["tokens"] = meta(b, s, dtype=torch.int32)
    axes["tokens"] = ("batch", "seq")
    return specs, axes
