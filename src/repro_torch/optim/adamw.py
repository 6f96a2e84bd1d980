"""AdamW with decoupled weight decay and global-norm clipping
(``repro/optim/adamw.py``).

Hand-rolled, as the reference's is, and not ``torch.optim.AdamW``: that
one places eps and the decoupled decay differently, so parameters would
drift from the reference's. State is a plain tree mirroring the
parameters. Where JAX donates the old buffers, the update here writes the
parameters and both moments in place, so a step holds no second copy of
them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the parameters' device
    m: dict
    v: dict


def adamw_init(params) -> AdamWState:
    """Zero fp32 moments beside each parameter, step 0."""
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0].device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree, layout=None) -> torch.Tensor:
    """The l2 norm of every leaf together. ``layout`` (a parameter layout,
    ``distributed/sharding.py``): the leaves are the rank's slices, and
    the squares of each are summed over the mesh axes that leaf is split
    over (one all-reduce per set of axes), never over those it is
    replicated on, so every rank gets the single device's norm."""
    squares = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if layout is None:
        return torch.sqrt(torch.stack(squares).sum())
    groups: dict = {}
    for sq, pl in zip(squares, tree_leaves(layout.placements)):
        groups.setdefault(pl.split, []).append(sq)
    total = [layout.mesh.all_reduce(torch.stack(g).sum(), "sum", axes) if axes
             else torch.stack(g).sum() for axes, g in sorted(groups.items())]
    return torch.sqrt(torch.stack(total).sum())


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, tcfg: TrainConfig,
                 lr_fn: Callable[[torch.Tensor], torch.Tensor], layout=None):
    """One AdamW step (``adamw.py:38``), in place on ``params`` and the
    moments of ``state`` (under a parameter ``layout``, on the rank's
    slices: the update is elementwise, the norm ``global_norm``'s).
    Returns (params, new_state, metrics)."""
    step = state.step + 1
    gnorm = global_norm(grads, layout)
    clip_scale = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = tcfg.beta1, tcfg.beta2
    lr = lr_fn(step).float()
    stepf = step.float()
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        g = g.float() * clip_scale
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        delta = ((m_new / bc1) / (torch.sqrt(v_new / bc2) + 1e-8)
                 + tcfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    return (params, AdamWState(step=step, m=state.m, v=state.v),
            {"grad_norm": gnorm, "lr": lr})
