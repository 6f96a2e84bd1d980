"""Decoder assembly (``repro/models/model.py``): parameter specs of the
dense family and of the ``moe`` family (GQA or MLA attention, MoE
feed-forward), embedding, unembedding, the working-precision copy, and the
full-sequence forward and loss the trainer differentiates (dense family
only: training MLA needs attention impls that are not ported).

    model_forward(params, cfg, batch)  -> (logits (B,S,V), aux)
    loss_fn(params, cfg, batch)        -> (loss, metrics)

The forward passes the serving path runs live in ``serve/prefill.py``
(whole prompt) and ``serve/decode.py`` (one token per lane)."""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, resolve_remat
from repro_torch.models.attention import gqa_forward, gqa_specs, mla_specs
from repro_torch.models.layers import mlp_forward, mlp_specs, rms_norm
from repro_torch.models.moe import moe_specs
from repro_torch.models.params import ParamSpec, stack_layer_specs, tree_leaves
from repro_torch.train.losses import next_token_loss

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def _norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def dense_layer_specs(cfg: ModelConfig) -> dict:
    """``model.py:66``: GQA or MLA attention, SwiGLU MLP or MoE."""
    specs = {"norm_attn": _norm_spec(cfg.d_model),
             "attn": mla_specs(cfg) if cfg.mla else gqa_specs(cfg),
             "norm_mlp": _norm_spec(cfg.d_model)}
    if cfg.moe:
        specs["moe"] = moe_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, cfg.act)
    return specs


def model_specs(cfg: ModelConfig) -> dict:
    """``repro/models/model.py:264`` for ``family`` "dense" and "moe"."""
    if cfg.family not in ("dense", "moe"):
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


def dense_layer_forward(p, cfg: ModelConfig, x, positions, impl, mode):
    """Pre-norm attention + SwiGLU block (``model.py:79``). Returns
    (x, aux); aux is 0 for the dense family."""
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    attn_out, _ = gqa_forward(p["attn"], cfg, h, positions, impl=impl, mode=mode)
    x = x + attn_out
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    x = x + mlp_forward(p["mlp"], h, cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _unstacked_layers(params) -> list:
    """The per-layer parameter dicts: the unrolled list as it is, or the
    stacked ``layers`` axis unbound once (one backward node per leaf
    instead of one full-size gradient per layer and leaf)."""
    layers = params["layers"]
    if isinstance(layers, list):
        return layers

    def unbind(t):
        return ({k: unbind(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.unbind(t))

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]

    slices = unbind(layers)
    return [pick(slices, i) for i in range(tree_leaves(layers)[0].shape[0])]


def _ss_stats_policy(ctx, op, *args, **kwargs):
    """``remat="ss_stats"`` (``save_only_these_names("ss_bv", "ss_stats")``,
    ``model.py:355``): keep only the outputs of K1's op, BV and its fp32
    (m, l), so the recompute skips K1; recompute everything else."""
    if op is torch.ops.repro_torch.landmark_summary.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


# The matrix products with no batch dims: the projections and the MLP
# (``models/attention.py:project_heads``, ``layers.mlp_forward``) dispatch
# to these. Batched products (``aten.bmm``, ``aten.baddbmm``: the landmark
# and core einsums) and the kernels' ops are recomputed.
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"`` (``checkpoint_dots_with_no_batch_dims``)."""
    if op in _NO_BATCH_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = {"ss_stats": _ss_stats_policy, "dots": _dots_policy}


def _run_trunk(params, cfg: ModelConfig, x, positions, impl, mode):
    """The decoder trunk, layer by layer (``model.py:325``). Returns
    (x, aux). ``remat`` (``"auto"`` resolved for x's device: ``ss_stats``
    on the card, ``full`` on the CPU) picks what each layer keeps for its
    backward: ``"none"`` every activation; ``"full"`` only the layer's
    inputs (``torch.utils.checkpoint``, non-reentrant); ``"ss_stats"`` and
    ``"dots"`` a selective checkpoint (``REMAT_POLICIES``)."""
    remat = resolve_remat(cfg.remat, "gpu" if x.is_cuda else "cpu")
    if remat not in ("none", "full", *REMAT_POLICIES):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unstacked_layers(params):
        if remat == "none":
            x, a = dense_layer_forward(lp, cfg, x, positions, impl, mode)
        else:
            kw = {} if remat == "full" else {"context_fn": partial(
                create_selective_checkpoint_contexts, REMAT_POLICIES[remat])}
            x, a = checkpoint(dense_layer_forward, lp, cfg, x, positions, impl,
                              mode, use_reentrant=False, **kw)
        aux = aux + a
    return x, aux


def model_forward(params, cfg: ModelConfig, batch: dict, mode: str = "train"):
    """Full-sequence causal forward (``model.py:399``) of the dense family.
    ``batch["tokens"]`` (B, S) int. The fp32 master ``params`` are cast to
    the working copy here, inside the autograd graph, so gradients reach
    the masters. Returns (logits (B,S,V) in the compute dtype, aux).
    The ``moe`` family is served, not trained: its MLA needs the
    ``chunked`` / ``spectral_shift`` attention impls, not ported."""
    if cfg.family != "dense" or cfg.mla or cfg.moe:
        raise NotImplementedError(f"training family {cfg.family!r} is not ported yet")
    params = working_params(params, cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, aux = _run_trunk(params, cfg, x, positions, cfg.attention_impl, "causal")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """Next-token cross entropy (``model.py:456``). Returns (loss, metrics)."""
    logits, aux = model_forward(params, cfg, batch)
    ce_loss, metrics = next_token_loss(logits, batch["tokens"])
    loss = ce_loss + cfg.router_aux_coef * aux
    metrics["aux"] = aux
    return loss, metrics


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
