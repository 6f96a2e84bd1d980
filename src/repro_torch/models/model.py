"""Dense decoder assembly: parameter specs, embedding, unembedding and the
working-precision copy (the dense family of ``repro/models/model.py``).

The forward passes the serving path runs live in ``serve/prefill.py``
(whole prompt) and ``serve/decode.py`` (one token per lane)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import gqa_specs
from repro_torch.models.layers import mlp_specs
from repro_torch.models.params import ParamSpec, stack_layer_specs

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def _norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def dense_layer_specs(cfg: ModelConfig) -> dict:
    if cfg.mla or cfg.moe:
        raise NotImplementedError("MLA / MoE layers are not ported yet")
    return {"norm_attn": _norm_spec(cfg.d_model), "attn": gqa_specs(cfg),
            "norm_mlp": _norm_spec(cfg.d_model),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.act)}


def model_specs(cfg: ModelConfig) -> dict:
    """``repro/models/model.py:264`` for ``family="dense"``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    d, v = cfg.d_model, cfg.vocab_padded
    specs: dict = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), scale=0.02),
        "final_norm": _norm_spec(d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    layer = dense_layer_specs(cfg)
    if cfg.scan_layers:
        specs["layers"] = stack_layer_specs(layer, cfg.num_layers)
    else:
        specs["layers"] = [layer for _ in range(cfg.num_layers)]
    return specs


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s parameter dict: a view into the stacked ``layers`` axis
    (``scan_layers=True``) or the i-th entry of the unrolled list."""
    layers = params["layers"]
    if isinstance(layers, list):
        return layers[i]

    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i]

    return take(layers)


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(torch_dtype(cfg.compute_dtype))


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    return x @ w


def working_params(params, cfg: ModelConfig):
    """Cast fp32 master params to the compute dtype once
    (``repro/models/model.py:382``); a no-op when the dtypes match. Returns
    a new tree; non-fp32 leaves pass through untouched."""
    dt = torch_dtype(cfg.compute_dtype)
    if not cfg.cast_params_once or dt == torch_dtype(cfg.param_dtype):
        return params

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v) for v in t]
        return t.to(dt) if t.dtype == torch.float32 else t

    return cast(params)
