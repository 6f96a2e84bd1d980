"""Loss functions of the trainer (``repro/train/losses.py``).

``next_token_loss`` is the LM objective: masked next-token cross entropy
in fp32, with optional z-loss (a logit-norm regularizer) and label
smoothing. ``sharded_token_loss`` is a rank's share of it when the batch's
rows and sequence are split over a mesh, and takes logits whose vocab is
split too (vocab-parallel: the rank's columns, never gathered).
"""
from __future__ import annotations

import torch


def _masked_ce(logits, targets, *, z_loss: float, label_smoothing: float, total,
               vocab=None):
    """CE of fp32 ``logits`` (b, s, V) against ``targets`` (b, s), 0 =
    none, divided by the token count ``total`` gives; the metrics go
    through ``total`` too (identity on one device, a sum over ranks on a
    mesh). ``vocab`` (mesh, axes): the logits are this rank's columns of a
    vocab split over ``axes``; the max is all-reduced (no gradient), the
    sum-exp, the gold logit and the logits' sum summed over ``axes``
    (``tp_reduce``: each rank's gradient reaches its own columns). Returns
    (loss, metrics)."""
    targets = targets.long()
    lg = logits.float()
    if vocab is None:
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, targets[..., None])[..., 0]
    else:
        from repro_torch.distributed.mesh import tp_reduce, vocab_shard_index

        mesh, axes = vocab
        cols, tag = lg.shape[-1], ",".join(axes)
        top = mesh.all_reduce(lg.detach().amax(dim=-1), "max", axes)
        logz = top + torch.log(tp_reduce(torch.exp(lg - top[..., None]).sum(dim=-1),
                                         mesh.mesh_id, tag))
        index, mine = vocab_shard_index(targets, mesh, axes, cols)
        gold = torch.gather(lg, -1, index[..., None])[..., 0]
        gold = tp_reduce(gold * mine.float(), mesh.mesh_id, tag)
    ce_tok = logz - gold
    if label_smoothing:
        # Uniform smoothing: (1-eps)*gold + eps*mean over vocab.
        if vocab is None:
            mean_lp = torch.mean(lg, dim=-1) - logz
        else:
            mean_lp = (tp_reduce(lg.sum(dim=-1), mesh.mesh_id, tag)
                       / (cols * mesh.axis_size(axes)) - logz)
        ce_tok = (1 - label_smoothing) * ce_tok - label_smoothing * mean_lp
    mask = (targets != 0).float()
    denom = torch.clamp(total(mask.sum()), min=1.0)
    ce = torch.sum(ce_tok * mask) / denom
    ce_all = total(ce)
    metrics = {"ce": ce_all, "tokens": denom}
    loss = ce
    if z_loss:
        zl = torch.sum(torch.square(logz) * mask) / denom
        loss = loss + z_loss * zl
        metrics["z_loss"] = total(zl)
    metrics["ppl_proxy"] = torch.exp(torch.clamp(ce_all, max=20.0))
    return loss, metrics


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
                    z_loss: float = 0.0, label_smoothing: float = 0.0):
    """Masked next-token CE (``losses.py:14``). logits (B, S, V): position t
    predicts token t + 1; tokens (B, S) int, 0 = pad. Returns
    (loss, metrics)."""
    return _masked_ce(logits[:, :-1], tokens[:, 1:], z_loss=z_loss,
                      label_smoothing=label_smoothing, total=lambda x: x)


def sharded_token_loss(logits: torch.Tensor, targets: torch.Tensor, *, mesh, axes,
                       z_loss: float = 0.0, label_smoothing: float = 0.0,
                       vocab_axes: tuple = ()):
    """A rank's share of the global next-token CE, for a batch whose rows
    and sequence are split over the mesh ``axes``. logits (b, s, V) are the
    rank's positions; targets (b, s) int the token each predicts (the next
    position's, which for a shard's last position is the first token of
    the next slice), 0 = none (pad, or the last global position). The
    token count is summed over ``axes``, so the ranks' losses add up to
    ``next_token_loss`` of the whole batch and their gradients, summed over
    ``axes``, to its gradient. Returns (loss, metrics): loss the rank's
    share; metrics the global values (not differentiable). ``vocab_axes``:
    the logits hold this rank's columns of a vocab split over them
    (vocab-parallel), the loss the whole vocab's."""
    def total(x):
        return mesh.all_reduce(x.detach(), "sum", axes) if mesh is not None else x.detach()

    return _masked_ce(logits, targets, z_loss=z_loss, label_smoothing=label_smoothing,
                      total=total, vocab=(mesh, vocab_axes) if vocab_axes else None)
