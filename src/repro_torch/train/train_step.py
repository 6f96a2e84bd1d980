"""Train / grad / eval step factories (``repro/train/train_step.py``).

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` with optional microbatch gradient accumulation in
fp32. Gradients come from ``torch.autograd.grad`` of ``loss_fn`` with
respect to every parameter leaf, the counterpart of ``jax.value_and_grad``.
The optimizer writes the parameters and its moments in place (see
``optim/adamw.py``); the returned trees are the ones passed in.

Under a mesh (``distributed.sharding.sharding_rules``) each rank's loss is
its share of the global mean (``losses.sharded_token_loss``): the step
sums the gradients and the loss over every axis the batch or the sequence
spans, as one flat fp32 buffer, before the optimizer, so the grad norm,
the clipping and the update are the same on every rank. Under a parameter
layout (``distributed.sharding.active_layout``) a leaf's gradient is its
slice's, and the step sums it over the batch's and sequence's axes that
the slice is not split over: the FSDP gather's backward has already summed
it over the axes it was gathered over, an expert slice's cotangent holds
every source rank's tokens (the all-to-all's backward), and over the
tensor-parallel axes nothing is summed (each rank's slice is complete:
``tp_copy`` summed the shares where a whole activation entered the
slice's work).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed.sharding import active_layout, active_reduce_axes
from repro_torch.models.model import loss_fn, model_forward
from repro_torch.models.params import flatten_with_paths, tree_leaves, tree_map
from repro_torch.optim.adamw import adamw_update


def value_and_grad(params, cfg: ModelConfig, batch: dict):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; grads mirror the
    parameter tree. The parameters themselves are not modified."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, cfg, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                         materialize_grads=True))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _: next(grads), live)


# The most elements one gradient all-reduce moves (256 MB of fp32): a larger
# group of leaves goes in several, so its flat copies stay small beside the
# gradients themselves.
ALL_REDUCE_BUCKET = 1 << 26


def _buckets(members: list, leaves: list) -> list:
    """``members`` (leaf indices) in order, cut into runs of at most
    ``ALL_REDUCE_BUCKET`` elements (a larger leaf alone)."""
    out, size = [[]], 0
    for i in members:
        n = leaves[i].numel()
        if out[-1] and size + n > ALL_REDUCE_BUCKET:
            out.append([])
            size = 0
        out[-1].append(i)
        size += n
    return out


def _sum_over_ranks(loss, grads):
    """Under a mesh, the loss and every gradient leaf summed (fp32) over the
    axes the batch or the sequence spans (a leaf of a parameter layout:
    those its slice is not split over), the leaves that share the axes as
    one flat buffer a bucket (``ALL_REDUCE_BUCKET``); as they are
    otherwise."""
    mesh, axes = active_reduce_axes()
    if mesh is None or mesh.axis_size(axes) == 1:
        return loss, grads
    leaves = tree_leaves(grads)
    layout = active_layout()
    split = ([pl.split for pl in tree_leaves(layout.placements)]
             if layout is not None else [()] * len(leaves))
    groups: dict = {}
    for i, done in enumerate(split):
        groups.setdefault(tuple(a for a in axes if a not in done), []).append(i)
    out = [g.float() for g in leaves]
    for sum_axes, members in groups.items():
        if mesh.axis_size(sum_axes) == 1:
            continue
        for bucket in _buckets(members, leaves):
            flat = mesh.all_reduce(torch.cat([out[i].reshape(-1) for i in bucket]), "sum",
                                   sum_axes)
            for i, part in zip(bucket, flat.split([leaves[i].numel() for i in bucket])):
                out[i] = part.view(leaves[i].shape)
    it = iter(out)
    return mesh.all_reduce(loss, "sum", axes), tree_map(lambda _: next(it), grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, lr_fn: Callable):
    def train_step(params, opt_state, batch):
        if tcfg.microbatches > 1:
            # Grad accumulation: split the batch dim into microbatches and
            # sum their fp32 grads.
            mb = tcfg.microbatches
            micro = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            losses = []
            for i in range(mb):
                loss_i, _, g_i = value_and_grad(params, cfg,
                                                {k: v[i] for k, v in micro.items()})
                tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
                losses.append(loss_i)
            grads = tree_map(lambda g: g / mb, grads)
            loss = torch.stack(losses).mean()
            metrics = {}
        else:
            loss, metrics, grads = value_and_grad(params, cfg, batch)
        loss, grads = _sum_over_ranks(loss, grads)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params,
                                                      tcfg, lr_fn, active_layout())
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_grad_step(cfg: ModelConfig):
    """Forward + backward only, no optimizer update: the cell the
    gradient-parity checks compare across routes (under a mesh, the
    gradients and loss summed over the batch's and sequence's axes)."""

    def grad_step(params, batch):
        loss, _, grads = value_and_grad(params, cfg, batch)
        return _sum_over_ranks(loss, grads)

    return grad_step


def make_eval_step(cfg: ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(params, cfg, batch)

    return eval_step


def make_prefill_step(cfg: ModelConfig):
    """The full-sequence forward returning logits, the inference-prefill
    cell (``train_step.py:89``), with no autograd graph."""

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = model_forward(params, cfg, batch, mode="prefill")
        return logits

    return prefill_step


def _cache_horizon(cache) -> int:
    """The sequence length of a decode cache: the seq dim of its first
    ``k`` (GQA) or ``latent`` (MLA) leaf; 0 for state with none (xLSTM)."""
    for path, leaf in flatten_with_paths(cache["layers"]).items():
        if path.split("::")[-1] in ("k", "latent"):
            return leaf.shape[-2]
    return 0


def make_serve_step(cfg: ModelConfig):
    """One batched decode step against the whole cache (``train_step.py:99``):
    the cache tree (``registry.batch_specs``' structure) in the engine's
    storage keys (``kv_cache.storage_from_tree``), then
    ``serve/decode.py:decode_step`` on the gather route at the cache's
    horizon, with no autograd graph; a scalar ``pos`` (the reference's cache,
    ``registry.batch_specs``) stands for every lane. Returns (logits (B, 1, V), the new
    state): ``pos`` + 1 and each layer's leaves with the new token's k / v
    where the reference's returns the committed cache (the engine commits
    it, ``serve/paged.py``)."""
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kv_cache import storage_from_tree

    def serve_step(params, cache, tokens):
        pos = cache["pos"]
        if pos.ndim == 0:   # one position for every lane, as the reference's
            pos = pos.expand(tokens.shape[0])
        state = {"pos": pos, "layers": storage_from_tree(cache)}
        with torch.no_grad():
            return decode_step(params, cfg, state, tokens, seq_max=_cache_horizon(cache))

    return serve_step
