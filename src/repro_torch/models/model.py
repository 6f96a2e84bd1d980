"""Model assembly (``repro/models/model.py``): parameter specs of every
family the reference runs, embedding, unembedding, the working-precision
copy, and the full-sequence forward and loss the trainer differentiates:

* ``dense`` and ``vlm`` (LLaVA: a two-layer gelu projector of the stub's
  1024-wide patch features, prepended to the token embeddings of the
  dense decoder; labels on the text positions only);
* ``moe`` (GQA or MLA attention, MoE feed-forward);
* ``hybrid`` (Hymba: GQA attention and a mamba selective SSM in parallel,
  then an MLP);
* ``ssm`` (xLSTM: mLSTM blocks, every ``slstm_every``-th an sLSTM block;
  an unrolled list of ``{"kind_mlstm": ...}`` / ``{"kind_slstm": ...}``);
* ``audio`` (Whisper: a pre-LN encoder over the stub's frame embeddings,
  bidirectional under ``encoder_attention_impl``, and a decoder of causal
  self-attention, cross attention and a gelu MLP, with LayerNorm).

The ``ssm`` and ``audio`` trunks run without remat, as the reference's
unrolled loops (``model.py:328``, ``:424``) do.

    model_forward(params, cfg, batch)  -> (logits (B,S,V), aux)
    loss_fn(params, cfg, batch)        -> (loss, metrics)

Under a sequence shard (``distributed.sharding.sharding_rules`` with the
"seq" rule over ranks) a rank runs its slice of the sequence: positions
start at its global offset, attention goes through the context-parallel
attention (``spectral_shift_fused``) or over keys gathered from every
shard (``full``, ``chunked``: ``models/attention.py:gather_keys``), and
the loss divides by the global token count
(``train/losses.py:sharded_token_loss``). The dense, hybrid and ssm
families run so: the recurrences take the state their earlier shards
carry (``distributed/seq_parallel.py``: conv halos, the mamba scan's
affine carry, the mLSTM / sLSTM state chain). Whisper runs its whole
encoder on every rank and its decoder's token shard against it
(``_whisper_forward``), LLaVA its slice of the joint sequence [patches,
text] (``model_forward``). MoE (routing over the whole row) raises; under
a split of the batch alone every family runs.

Under a parameter layout (``distributed.sharding.active_layout``: the
dense family on a mesh under the parameter rules) ``params`` are the
rank's slices: every leaf's FSDP dims are all-gathered just before use
(``gather_params``: the top-level leaves at the start, a layer's inside
its remat boundary, so the recompute gathers again and no gathered layer
outlives its backward), then cast to the working copy; the layer runs
tensor-parallel (``models/attention.py``, ``models/layers.py``); the
embedding is a masked lookup of the rank's vocab rows summed over the
vocab's axes, and the logits are the rank's vocab columns, which the
vocab-parallel cross entropy takes (``train/losses.py``).

The forward passes the serving path runs live in ``serve/prefill.py``
(whole prompt) and ``serve/decode.py`` (one token per lane)."""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, resolve_remat
from repro_torch.distributed.mesh import fsdp_gather, tp_copy, vocab_shard_index
from repro_torch.distributed.seq_parallel import active_shard
from repro_torch.distributed.sharding import (Placement, active_layout, active_reduce_axes,
                                              active_seq_sharding, logical_constraint,
                                              seq_offset, whole_sequence)
from repro_torch.models.attention import (cross_attention_forward,
                                          cross_attention_specs, gqa_forward,
                                          gqa_specs, mla_forward, mla_specs)
from repro_torch.models.layers import (gelu, layer_norm, mlp_forward, mlp_specs,
                                       rms_norm, sinusoidal_positions)
from repro_torch.models.moe import moe_forward, moe_forward_ep, moe_specs
from repro_torch.models.ssm import (_causal_conv, mamba_forward, mamba_specs,
                                    mlstm_chunked, mlstm_fresh_state, slstm_fresh_state,
                                    slstm_scan, state_dtype)
from repro_torch.models.params import (ParamSpec, stack_layer_specs, tree_leaves,
                                      tree_map)
from repro_torch.train.losses import next_token_loss, sharded_token_loss

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


# -- xLSTM blocks (``model.py:136-204``) ------------------------------------
def mlstm_block_specs(cfg: ModelConfig) -> dict:
    """``model.py:136``: up-projection by 2, causal conv, q/k/v and the
    (input, forget) gates per head, an inner norm, the output gate z."""
    d = cfg.d_model
    di = 2 * d
    h = cfg.num_heads
    return {
        "norm": _norm_spec(d),
        "w_up": ParamSpec((d, 2 * di), ("embed", "ff")),
        "conv_w": ParamSpec((cfg.conv_width, di), (None, "ff"), scale=0.3),
        "conv_b": ParamSpec((di,), ("ff",), init="zeros"),
        "w_q": ParamSpec((di, di), ("ff", "ff_out")),
        "w_k": ParamSpec((di, di), ("ff", "ff_out")),
        "w_v": ParamSpec((di, di), ("ff", "ff_out")),
        "w_if": ParamSpec((di, 2 * h), ("ff", None), scale=0.05),
        "b_if": ParamSpec((2 * h,), (None,), init="zeros"),
        "ln_inner": ParamSpec((di,), ("ff",), init="ones"),
        "w_down": ParamSpec((di, d), ("ff", "embed")),
    }


def mlstm_block_forward(p, cfg: ModelConfig, x):
    """``model.py:154``: x (B,S,D) -> x + the block's output. Under a
    sequence shard the conv takes the previous shard's last rows
    (``SeqShard.halo``) and the cell its state from the previous shard
    (``SeqShard.chain``)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dt = x.dtype
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    up = xn @ p["w_up"].to(dt)
    di = up.shape[-1] // 2
    xm, z = up[..., :di], up[..., di:]
    shard = active_shard()
    # under a shard the previous shard's last rows lead, the context F.pad gives
    ctx = xm if shard is None else torch.cat([shard.halo(xm, p["conv_w"].shape[0] - 1),
                                              xm], dim=1)
    xc = F.silu(_causal_conv(ctx, p["conv_w"], p["conv_b"])[:, -s:])

    def to_heads(a):
        return a.reshape(b, s, h, di // h).transpose(1, 2)

    q = to_heads(xc @ p["w_q"].to(dt))
    k = to_heads(xc @ p["w_k"].to(dt))
    v = to_heads(xm @ p["w_v"].to(dt))
    gates = xc @ p["w_if"].to(dt) + p["b_if"].to(dt)            # (B,S,2H)
    ilog = gates[..., :h].transpose(1, 2)                        # (B,H,S)
    flog = F.logsigmoid(gates[..., h:].float()).transpose(1, 2)
    if shard is None:
        core, _ = mlstm_chunked(q, k, v, ilog, flog, chunk=cfg.ssm_chunk)
    else:   # the (C, n, m) state handed from shard to shard
        core, _ = shard.chain(
            lambda st: mlstm_chunked(q, k, v, ilog, flog, state=st, chunk=cfg.ssm_chunk,
                                     exact_final=True),
            mlstm_fresh_state(b, h, di // h, x.device, state_dtype(q)), anchor=p["b_if"])
    core = core.transpose(1, 2).reshape(b, s, di)
    core = rms_norm(core, p["ln_inner"], cfg.norm_eps)
    return x + (core * F.silu(z)) @ p["w_down"].to(dt)


def slstm_block_specs(cfg: ModelConfig) -> dict:
    """``model.py:178``: per-head gates (input, forget, cell, output) from x
    and block-diagonal recurrent weights, an inner norm, a gelu MLP."""
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    return {
        "norm": _norm_spec(d),
        "w_g": ParamSpec((d, h, 4, dh), ("embed", "heads", None, "head_dim")),
        "b_g": ParamSpec((h, 4, dh), ("heads", None, "head_dim"), init="zeros"),
        "r_w": ParamSpec((h, 4, dh, dh), ("heads", None, "head_dim", None), scale=0.05),
        "ln_inner": ParamSpec((d,), ("embed",), init="ones"),
        "w_out": ParamSpec((d, d), ("embed", "ff")),
        "w_down": ParamSpec((d, d), ("ff", "embed")),
    }


def slstm_block_forward(p, cfg: ModelConfig, x):
    """``model.py:193``: x (B,S,D) -> x + the block's output. Under a
    sequence shard the cell's (c, n, m, h) comes from the previous shard
    (``SeqShard.chain``)."""
    b, s, d = x.shape
    dt = x.dtype
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    xg = torch.einsum("bsd,dhge->bshge", xn, p["w_g"].to(dt)) + p["b_g"].to(dt)
    shard = active_shard()
    if shard is None:
        hs, _ = slstm_scan(xg, p["r_w"])
    else:
        h = cfg.num_heads
        hs, _ = shard.chain(lambda st: slstm_scan(xg, p["r_w"], state=st),
                            slstm_fresh_state(b, h, d // h, x.device, state_dtype(xg)),
                            anchor=p["b_g"])
    hs = rms_norm(hs.reshape(b, s, d), p["ln_inner"], cfg.norm_eps)
    return x + gelu(hs @ p["w_out"].to(dt)) @ p["w_down"].to(dt)


def is_slstm(cfg: ModelConfig, i: int) -> bool:
    """Whether block ``i`` of an xLSTM stack is sLSTM (``model.py:276``)."""
    return bool(cfg.slstm_every) and (i + 1) % cfg.slstm_every == 0


# -- whisper layers: pre-LN, LayerNorm, gelu MLP (``model.py:208-253``) -----
def _ln_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def _ln(x, p, cfg: ModelConfig):
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def whisper_enc_layer_specs(cfg: ModelConfig) -> dict:
    return {"ln_attn": _ln_specs(cfg.d_model), "attn": gqa_specs(cfg),
            "ln_mlp": _ln_specs(cfg.d_model),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, "gelu")}


def whisper_enc_layer_forward(p, cfg: ModelConfig, x, positions, impl):
    """``model.py:224``: bidirectional self-attention under ``impl``."""
    attn, _ = gqa_forward(p["attn"], cfg, _ln(x, p["ln_attn"], cfg), positions,
                          impl=impl, mode="bidir")
    x = x + attn
    return x + mlp_forward(p["mlp"], _ln(x, p["ln_mlp"], cfg), "gelu")


def whisper_dec_layer_specs(cfg: ModelConfig) -> dict:
    return {"ln_self": _ln_specs(cfg.d_model), "self_attn": gqa_specs(cfg),
            "ln_cross": _ln_specs(cfg.d_model), "cross_attn": cross_attention_specs(cfg),
            "ln_mlp": _ln_specs(cfg.d_model),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, "gelu")}


def whisper_dec_layer_forward(p, cfg: ModelConfig, x, enc_out, positions, impl,
                              cross_impl):
    """``model.py:243``: causal self-attention under ``impl``, cross
    attention under ``cross_impl``, the gelu MLP."""
    attn, _ = gqa_forward(p["self_attn"], cfg, _ln(x, p["ln_self"], cfg), positions,
                          impl=impl, mode="causal")
    x = x + attn
    x = x + cross_attention_forward(p["cross_attn"], cfg, _ln(x, p["ln_cross"], cfg),
                                    enc_out, impl=cross_impl)
    return x + mlp_forward(p["mlp"], _ln(x, p["ln_mlp"], cfg), "gelu")


def _layer_specs_for(cfg: ModelConfig) -> dict:
    """``model.py:256``: the uniform trunk's layer."""
    if cfg.family in ("dense", "moe", "vlm"):
        return dense_layer_specs(cfg)
    if cfg.family == "hybrid":
        return hymba_layer_specs(cfg)
    raise NotImplementedError(f"unknown family {cfg.family!r}")


def model_specs(cfg: ModelConfig) -> dict:
    """``repro/models/model.py:264``: every family's parameter tree."""
    d, v = cfg.d_model, cfg.vocab_padded
    specs: dict = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), scale=0.02),
        "final_norm": _norm_spec(d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    if cfg.family == "ssm":
        specs["layers"] = [
            {"kind_slstm": slstm_block_specs(cfg)} if is_slstm(cfg, i)
            else {"kind_mlstm": mlstm_block_specs(cfg)} for i in range(cfg.num_layers)]
        return specs
    if cfg.family == "audio":
        specs["enc_proj"] = ParamSpec((d, d), ("embed", "ff"))
        specs["enc_layers"] = [whisper_enc_layer_specs(cfg)
                               for _ in range(cfg.encoder_layers)]
        specs["enc_ln"] = _ln_specs(d)
        specs["dec_pos"] = ParamSpec((4096, d), (None, "embed"), scale=0.02)
        specs["layers"] = [whisper_dec_layer_specs(cfg) for _ in range(cfg.num_layers)]
        specs["dec_ln"] = _ln_specs(d)
        return specs
    layer = _layer_specs_for(cfg)
    if cfg.scan_layers:
        specs["layers"] = stack_layer_specs(layer, cfg.num_layers)
    else:
        specs["layers"] = [layer for _ in range(cfg.num_layers)]
    if cfg.family == "vlm":
        # the stub frontend's 1024-wide patch features -> a two-layer
        # projector into the embedding space
        specs["mm_proj"] = {"w1": ParamSpec((1024, d), (None, "embed")),
                            "w2": ParamSpec((d, d), ("embed", "ff"))}
    return specs


def dense_layer_forward(p, cfg: ModelConfig, x, positions, impl, mode):
    """Pre-norm attention (GQA, or MLA with ``cfg.mla``) and a SwiGLU MLP
    or, with ``cfg.moe``, the MoE feed-forward (``model.py:79``). Returns
    (x, aux): the MoE load-balance loss, else 0. ``moe_impl="ep"`` runs
    ``moe_forward_ep``, which falls back to ``moe_forward`` off a mesh."""
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if cfg.mla:
        attn_out = mla_forward(p["attn"], cfg, h, positions, impl=impl, mode=mode)
    else:
        attn_out, _ = gqa_forward(p["attn"], cfg, h, positions, impl=impl, mode=mode)
    x = x + attn_out
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    if cfg.moe:
        moe_fn = moe_forward_ep if cfg.moe_impl == "ep" else moe_forward
        ff, aux = moe_fn(p["moe"], cfg, h)
    else:
        ff = mlp_forward(p["mlp"], h, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ff, aux


def hymba_layer_forward(p, cfg: ModelConfig, x, positions, impl, mode):
    """Hymba (``model.py:115``): attention heads and mamba heads in
    parallel on the same normed input, mixed by per-channel gates, then a
    SwiGLU MLP. Returns (x, 0). Under a sequence shard the mamba scan
    takes its conv context and entering state from the earlier shards
    (``mamba_forward(shard=)``: all-gathers, which a remat recompute
    reruns in the same order on every rank)."""
    h = rms_norm(x, p["norm_mix"], cfg.norm_eps)
    attn_out, _ = gqa_forward(p["attn"], cfg, h, positions, impl=impl, mode=mode)
    ssm_out, _ = mamba_forward(p["mamba"], h, cfg.ssm_state, chunk=cfg.ssm_chunk,
                               shard=active_shard())
    x = x + (p["gate_attn"].to(x.dtype) * attn_out + p["gate_ssm"].to(x.dtype) * ssm_out)
    h = rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    x = x + mlp_forward(p["mlp"], h, cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


LAYER_FORWARD = {"dense": dense_layer_forward, "moe": dense_layer_forward,
                 "vlm": dense_layer_forward, "hybrid": hymba_layer_forward}


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


# the ops whose outputs remat="ss_stats" keeps, by name (the B-side op is
# registered only once the context-parallel attention is imported)
_SS_STATS_OPS = ("repro_torch::landmark_summary", "repro_torch::landmark_summary_sp")


def _ss_stats_policy(ctx, op, *args, **kwargs):
    """``remat="ss_stats"`` (``save_only_these_names("ss_bv", "ss_stats")``,
    ``model.py:355``): keep only the outputs of K1's op, BV and its fp32
    (m, l), or under a sequence shard the merged global ones of the
    context-parallel B-side (``kernels/sharded.py``), so the recompute
    skips K1; recompute everything else."""
    if op.name() in _SS_STATS_OPS:
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


def gather_params(tree, placements, cfg: ModelConfig):
    """A tree of slices made whole where the model needs it whole (each
    leaf's ``Placement.gather`` dims, all-gathered as one flat buffer per
    set of axes: ``mesh.fsdp_gather``), then cast to the working copy
    (``working_params``). The tensor-parallel dims stay the rank's."""
    layout = active_layout()
    leaves, places = tree_leaves(tree), tree_leaves(placements)
    out = list(leaves)
    groups: dict = {}
    for i, pl in enumerate(places):
        if pl.gather:
            (dim, axes), = pl.gather     # a dense leaf has one FSDP dim
            groups.setdefault(axes, []).append((i, dim))
    for axes, members in groups.items():
        full = fsdp_gather([leaves[i] for i, _ in members], [d for _, d in members],
                           layout.mesh.mesh_id, ",".join(axes))
        for (i, _), t in zip(members, full):
            out[i] = t
    it = iter(out)
    return working_params(tree_map(lambda _: next(it), tree), cfg)


def _layer_placements(layout, params) -> list:
    """Each layer's leaf placements (the stacked ``layers`` dim dropped)."""
    places = layout.placements["layers"]
    if isinstance(places, list):
        return places
    one = tree_map(lambda p: Placement(p.dims[1:], tuple((d - 1, a) for d, a in p.gather)),
                   places)
    return [one] * tree_leaves(params["layers"])[0].shape[0]


def _sharded_layer(layer_fn, placements):
    """``layer_fn`` on a layer's slices: gathered and cast first, inside the
    remat boundary."""
    def run(lp, cfg, x, positions, impl, mode):
        return layer_fn(gather_params(lp, placements, cfg), cfg, x, positions, impl, mode)

    return run


def _run_trunk(params, cfg: ModelConfig, x, positions, impl, mode):
    """The decoder trunk, layer by layer (``model.py:325``). Returns
    (x, aux). ``remat`` (``"auto"`` resolved for x's device: ``ss_stats``
    on the card, ``full`` on the CPU) picks what each layer keeps for its
    backward: ``"none"`` every activation; ``"full"`` only the layer's
    inputs (``torch.utils.checkpoint``, non-reentrant); ``"ss_stats"`` and
    ``"dots"`` a selective checkpoint (``REMAT_POLICIES``). The layer
    function is the family's (``model.py:336``); aux sums over layers. The
    ``ssm`` stack runs its blocks in order, without remat (``model.py:328``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        for lp in params["layers"]:
            if "kind_slstm" in lp:
                x = slstm_block_forward(lp["kind_slstm"], cfg, x)
            else:
                x = mlstm_block_forward(lp["kind_mlstm"], cfg, x)
        return x, aux
    layer_fn = LAYER_FORWARD[cfg.family]
    remat = resolve_remat(cfg.remat, "gpu" if x.is_cuda else "cpu")
    if remat not in ("none", "full", *REMAT_POLICIES):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    layout = active_layout()
    layers = _unstacked_layers(params)
    fns = ([_sharded_layer(layer_fn, pl) for pl in _layer_placements(layout, params)]
           if layout is not None else [layer_fn] * len(layers))
    for fn, lp in zip(fns, layers):
        if remat == "none":
            x, a = fn(lp, cfg, x, positions, impl, mode)
        else:
            kw = {} if remat == "full" else {"context_fn": partial(
                create_selective_checkpoint_contexts, REMAT_POLICIES[remat])}
            x, a = checkpoint(fn, lp, cfg, x, positions, impl, mode,
                              use_reentrant=False, **kw)
        aux = aux + a
    return x, aux


def model_forward(params, cfg: ModelConfig, batch: dict, mode: str = "train"):
    """Full-sequence forward (``model.py:399``) of every family (``cfg.mla``
    / ``cfg.moe`` honoured whatever the family, as the reference's
    ``dense_layer_forward`` does). ``batch["tokens"]`` (B, S) int; the
    ``vlm`` family's ``batch["patches"]`` (B, P, 1024), projected and put
    ahead of the tokens; the ``audio`` family's ``batch["frames"]`` (B,
    S_enc, D) (``_whisper_forward``). The fp32 master ``params`` are cast
    to the working copy here, inside the autograd graph, so gradients reach
    the masters. Returns (logits (B, S [+ P], V) in the compute dtype, aux:
    the MoE load-balance loss summed over layers).

    Under a sequence shard a rank holds its slice of the sequence: for
    ``vlm`` its slice [a, b) of the joint sequence [patches, text], so
    ``batch["patches"]`` holds the patch rows [a, min(b, p)) (perhaps none)
    and ``batch["tokens"]`` the text tokens of [max(a, p), b) (perhaps
    none); ``mm_proj`` works row by row, so projecting only the rank's
    patch rows is exact. MoE raises: its routing spans the whole row."""
    if cfg.family not in (*LAYER_FORWARD, "ssm", "audio"):
        raise NotImplementedError(f"unknown family {cfg.family!r}")
    if active_seq_sharding()[1] and cfg.moe:
        raise NotImplementedError(
            f"family {cfg.family!r} (MoE) under a sequence shard: the routing of tokens "
            f"over the whole row does not run sequence-parallel")
    layout = active_layout()
    if layout is None:
        params = working_params(params, cfg)
    else:   # the top-level leaves whole (bar the vocab's split), the layers later
        top = {k: v for k, v in params.items() if k != "layers"}
        params = dict(gather_params(top, {k: layout.placements[k] for k in top}, cfg),
                      layers=params["layers"])
    if cfg.family == "audio":
        return _whisper_forward(params, cfg, batch)
    dt = torch_dtype(cfg.compute_dtype)
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, tokens)
    if cfg.family == "vlm":
        mp = params["mm_proj"]
        pe = gelu(batch["patches"].to(dt) @ mp["w1"].to(dt)) @ mp["w2"].to(dt)
        x = _joint_rows(pe, x)
    b, s = x.shape[:2]
    # global positions: a sequence shard's rows start at its offset
    positions = (seq_offset(s) + torch.arange(s, device=x.device)).expand(b, s)
    x, aux = _run_trunk(params, cfg, x, positions, cfg.attention_impl, "causal")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), aux


def _joint_rows(pe: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``vlm`` rank's rows of the joint sequence: its projected patches
    (B, P_loc, D), then its text embeddings (B, S_loc, D); the patch prefix
    comes first, so a slice's patches precede its text."""
    return torch.cat([pe, x], dim=1)


def _dec_pos_rows(pos_emb: torch.Tensor, offset: int, s: int, n: int):
    """The learned decoder positions of rows [offset, offset + s) of an
    n-token decoder sequence, or None past ``dec_pos``'s rows (the
    reference adds them only when n <= 4096, ``model.py:444``)."""
    return pos_emb[offset:offset + s] if n <= pos_emb.shape[0] else None


def _whisper_forward(params, cfg: ModelConfig, batch: dict):
    """``model.py:424``: the encoder over ``frames`` projected by
    ``enc_proj`` plus sinusoidal positions, ``encoder_attention_impl``
    bidirectional; then the decoder, whose learned positions ``dec_pos``
    are added only when s <= 4096, causal self-attention under
    ``attention_impl`` and cross attention under
    ``encoder_attention_impl``. Returns (logits, 0).

    Under a sequence shard only the decoder's tokens are split: the
    encoder's rows are whole on every rank (the reference lays ``frames``
    out as ("batch", None, None)), so it runs on the rank's rows under
    ``whole_sequence`` whatever its impl, and its parameters' gradients are
    summed over the sequence's ranks with the rest. The decoder's s is the
    rank's share of the global length n: ``dec_pos`` is added when n <=
    4096 at the rank's global rows, positions are global, self attention
    gathers the keys (``chunked``) and cross attention takes the global
    Q~ (``models/attention.py:cross_attention_forward``)."""
    dt = torch_dtype(cfg.compute_dtype)
    frames = batch["frames"].to(dt)
    b, s_enc, _ = frames.shape
    with whole_sequence():
        enc = frames @ params["enc_proj"].to(dt)
        enc = enc + sinusoidal_positions(s_enc, cfg.d_model, frames.device).to(dt)
        pos_enc = torch.arange(s_enc, device=frames.device).expand(b, s_enc)
        for lp in params["enc_layers"]:
            enc = whisper_enc_layer_forward(lp, cfg, enc, pos_enc, cfg.encoder_attention_impl)
        enc = _ln(enc, params["enc_ln"], cfg)

    tokens = batch["tokens"]
    s = tokens.shape[1]
    mesh, axes, _ = active_seq_sharding()
    n = s * (mesh.axis_size(axes) if axes else 1)
    offset = seq_offset(s)
    x = _embed_tokens(params, cfg, tokens)
    pos = _dec_pos_rows(params["dec_pos"], offset, s, n)
    if pos is not None:
        x = x + pos.to(dt)
    positions = (offset + torch.arange(s, device=x.device)).expand(b, s)
    for lp in params["layers"]:
        x = whisper_dec_layer_forward(lp, cfg, x, enc, positions, cfg.attention_impl,
                                      cfg.encoder_attention_impl)
    x = _ln(x, params["dec_ln"], cfg)
    return _unembed(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """Next-token cross entropy (``model.py:456``) plus the MoE aux; the
    ``vlm`` patch prefix carries no labels. Returns (loss, metrics). A
    rank's slice of a batch split over a mesh carries ``targets``
    (``data/pipeline.py:make_global_batch``): its loss is then the rank's
    share of the global mean (``sharded_token_loss``), its MoE aux the
    whole batch's (``models/moe.py:batch_means``), of which it counts its
    share, and the metrics are global. A ``vlm`` rank's ``targets`` are
    its slice of the joint sequence's (0 at the patch positions); its text
    rows are the last of its slice, and only they are scored. A rank with
    no text row (a slice of patches only) adds a zero-weighted sum of its
    logits, so its loss stays connected to its trunk and its backward runs
    every collective the other ranks' do."""
    logits, aux = model_forward(params, cfg, batch)
    share = aux
    targets = batch.get("targets")
    joint = logits
    if cfg.family == "vlm":
        n_text = batch["tokens"].shape[1]
        logits = logits[:, logits.shape[1] - n_text:]
        if targets is not None:
            targets = targets[:, targets.shape[1] - n_text:]
    if targets is not None:
        mesh, axes = active_reduce_axes()
        layout = active_layout()
        ce_loss, metrics = sharded_token_loss(
            logits, targets, mesh=mesh, axes=axes,
            vocab_axes=layout.tp.vocab if layout is not None else ())
        if mesh is not None:
            share = aux / mesh.axis_size(axes)
        if logits.shape[1] == 0:
            ce_loss = ce_loss + 0.0 * joint[:, -1:].float().sum()
    else:
        ce_loss, metrics = next_token_loss(logits, batch["tokens"])
    loss = ce_loss + cfg.router_aux_coef * share
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


def _vocab_axes() -> tuple:
    layout = active_layout()
    return layout.tp.vocab if layout is not None else ()


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings. Vocab-parallel (the vocab split over the
    "model" axes): the rank looks up the tokens among its own rows, zeros
    the rest and the lookups are summed over the vocab's axes."""
    axes = _vocab_axes()
    table = params["embed"]
    if not axes:
        return table[tokens].to(torch_dtype(cfg.compute_dtype))
    index, mine = vocab_shard_index(tokens, active_layout().mesh, axes, table.shape[0])
    x = table[index].to(torch_dtype(cfg.compute_dtype))
    x = x * mine[..., None].to(x.dtype)
    return logical_constraint(x, ("batch", "seq", "embed_act"), partial=axes)


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The logits; vocab-parallel, the rank's vocab columns (x enters them
    through ``tp_copy``)."""
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    axes = _vocab_axes()
    if axes:
        x = tp_copy(x, active_layout().mesh.mesh_id, ",".join(axes))
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
