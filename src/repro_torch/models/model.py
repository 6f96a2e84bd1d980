"""Decoder assembly (``repro/models/model.py``): parameter specs of the
dense family, the ``moe`` family (GQA or MLA attention, MoE feed-forward)
and the ``hybrid`` family (Hymba: GQA attention and a mamba selective SSM
in parallel, then an MLP), embedding, unembedding, the working-precision
copy, and the full-sequence forward and loss the trainer differentiates.

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
from repro_torch.models.attention import gqa_forward, gqa_specs, mla_forward, mla_specs
from repro_torch.models.layers import mlp_forward, mlp_specs, rms_norm
from repro_torch.models.moe import moe_forward, moe_specs
from repro_torch.models.ssm import mamba_forward, mamba_specs
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


def hymba_layer_specs(cfg: ModelConfig) -> dict:
    """``model.py:102``: the mamba branch runs over the full width
    (d_inner = d_model), dt rank max(d / 16, 8)."""
    d = cfg.d_model
    return {
        "norm_mix": _norm_spec(d),
        "attn": gqa_specs(cfg),
        "mamba": mamba_specs(d, d, cfg.ssm_state, cfg.conv_width, max(d // 16, 8)),
        "gate_attn": ParamSpec((d,), ("embed",), init="ones"),
        "gate_ssm": ParamSpec((d,), ("embed",), init="ones"),
        "norm_mlp": _norm_spec(d),
        "mlp": mlp_specs(d, cfg.d_ff, cfg.act),
    }


def _layer_specs_for(cfg: ModelConfig) -> dict:
    """``model.py:256`` for the families the port runs."""
    if cfg.family in ("dense", "moe"):
        return dense_layer_specs(cfg)
    if cfg.family == "hybrid":
        return hymba_layer_specs(cfg)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def model_specs(cfg: ModelConfig) -> dict:
    """``repro/models/model.py:264`` for ``family`` "dense", "moe" and
    "hybrid"."""
    layer = _layer_specs_for(cfg)
    d, v = cfg.d_model, cfg.vocab_padded
    specs: dict = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), scale=0.02),
        "final_norm": _norm_spec(d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    if cfg.scan_layers:
        specs["layers"] = stack_layer_specs(layer, cfg.num_layers)
    else:
        specs["layers"] = [layer for _ in range(cfg.num_layers)]
    return specs


def dense_layer_forward(p, cfg: ModelConfig, x, positions, impl, mode):
    """Pre-norm attention (GQA, or MLA with ``cfg.mla``) and a SwiGLU MLP
    or, with ``cfg.moe``, the MoE feed-forward (``model.py:79``). Returns
    (x, aux): the MoE load-balance loss, else 0. The expert-parallel
    ``moe_impl="ep"`` is multi-device and refused."""
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if cfg.mla:
        attn_out = mla_forward(p["attn"], cfg, h, positions, impl=impl, mode=mode)
    else:
        attn_out, _ = gqa_forward(p["attn"], cfg, h, positions, impl=impl, mode=mode)
    x = x + attn_out
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    if cfg.moe:
        if cfg.moe_impl == "ep":
            raise NotImplementedError("moe_impl 'ep' (expert parallel) is multi-device: "
                                      "not ported yet")
        ff, aux = moe_forward(p["moe"], cfg, h)
    else:
        ff = mlp_forward(p["mlp"], h, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ff, aux


def hymba_layer_forward(p, cfg: ModelConfig, x, positions, impl, mode):
    """Hymba (``model.py:115``): attention heads and mamba heads in
    parallel on the same normed input, mixed by per-channel gates, then a
    SwiGLU MLP. Returns (x, 0)."""
    h = rms_norm(x, p["norm_mix"], cfg.norm_eps)
    attn_out, _ = gqa_forward(p["attn"], cfg, h, positions, impl=impl, mode=mode)
    ssm_out, _ = mamba_forward(p["mamba"], h, cfg.ssm_state, chunk=cfg.ssm_chunk)
    x = x + (p["gate_attn"].to(x.dtype) * attn_out + p["gate_ssm"].to(x.dtype) * ssm_out)
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    x = x + mlp_forward(p["mlp"], h, cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


LAYER_FORWARD = {"dense": dense_layer_forward, "moe": dense_layer_forward,
                 "hybrid": hymba_layer_forward}


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
    ``"dots"`` a selective checkpoint (``REMAT_POLICIES``). The layer
    function is the family's (``model.py:336``); aux sums over layers."""
    layer_fn = LAYER_FORWARD[cfg.family]
    remat = resolve_remat(cfg.remat, "gpu" if x.is_cuda else "cpu")
    if remat not in ("none", "full", *REMAT_POLICIES):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unstacked_layers(params):
        if remat == "none":
            x, a = layer_fn(lp, cfg, x, positions, impl, mode)
        else:
            kw = {} if remat == "full" else {"context_fn": partial(
                create_selective_checkpoint_contexts, REMAT_POLICIES[remat])}
            x, a = checkpoint(layer_fn, lp, cfg, x, positions, impl, mode,
                              use_reentrant=False, **kw)
        aux = aux + a
    return x, aux


def model_forward(params, cfg: ModelConfig, batch: dict, mode: str = "train"):
    """Full-sequence causal forward (``model.py:399``) of the dense, moe
    and hybrid families (``cfg.mla`` / ``cfg.moe`` honoured whatever the
    family, as the reference's ``dense_layer_forward`` does).
    ``batch["tokens"]`` (B, S) int. The fp32 master ``params`` are cast to
    the working copy here, inside the autograd graph, so gradients reach
    the masters. Returns (logits (B,S,V) in the compute dtype, aux: the
    MoE load-balance loss summed over layers)."""
    if cfg.family not in LAYER_FORWARD:
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
